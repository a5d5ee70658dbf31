"""Run the mesh phase's serving cells of ``chip_smoke.py`` alone, on 4
ranks over ``gloo`` (staged through host memory on the card).

    python3 tools/mesh_serve_cells.py [cuda|cpu] [GENERIC_DOMAIN]

On the card (the default, with the domain 1024 of a full run) it builds
the kernels, writes the cells' inputs from seed 0, runs
``chip_smoke._mesh_serve`` on every rank with its shards on ``cuda:0``
and checks the answers with ``chip_smoke._check_mesh_serve``, printing
the cells' lines and each rank's seconds; the comparison with the serve
phase's one-device answers is not measured (that phase does not run).
``cpu 64`` rehearses the same path on the CPU in about half a minute.
Exits nonzero when a cell fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def _rank(rank, world, cfg):
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device=cfg["device"], backend="gloo")
    t0 = time.perf_counter()
    out = cs._mesh_serve(mesh, cfg, rank)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv) -> int:
    device = argv[0] if argv else "cuda"
    domain = int(argv[1]) if len(argv) > 1 else 1024
    from repro_torch.launch.mesh import launch_ranks

    if device == "cuda":
        from repro_torch.kernels import _build

        print(cs._card_line(), flush=True)
        print(f"build: {sorted(_build.build_all())}", flush=True)
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        want = cs._mesh_serve_inputs(
            types.SimpleNamespace(seed=0, generic_domain=domain), Path(tmp),
            None)
        print(f"inputs in {time.perf_counter() - t0:.1f}s", flush=True)
        cfg = {"dir": tmp, "device": device, "generic_n": domain}
        ranks = launch_ranks(_rank, cs.MESH_RANKS, cfg, store_dir=tmp,
                             backend="gloo", timeout=cs.MESH_TIMEOUT)
    print(f"rank seconds {[round(r['seconds'], 1) for r in ranks]}")
    failed = cs._check_mesh_serve(ranks, want)
    print(f"failed {failed}; {time.perf_counter() - t0:.1f}s in all")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
