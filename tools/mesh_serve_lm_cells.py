"""Run the mesh phase's LM serve cell of ``chip_smoke.py`` alone, on 4
ranks of a (data 2, model 2) mesh over ``gloo`` staged through host
memory, all on ``cuda:0``.

    python3 tools/mesh_serve_lm_cells.py

It builds the kernels, makes the cell's prompts, bar and one-device
yardstick with ``chip_smoke._mesh_serve_lm_inputs`` (B2 held to its plain
version at a rank's local shape and timed), runs
``chip_smoke._mesh_serve_lm`` on every rank and checks them with
``chip_smoke._check_mesh_serve_lm``, printing the cell's lines and the
seconds of each part.  Exits nonzero when the cell fails.
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
    return cs._mesh_serve_lm(cfg)


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import launch_ranks

    if not torch.cuda.is_available():
        print("mesh_serve_lm_cells: no CUDA device", file=sys.stderr)
        return 1
    print(cs._card_line(), flush=True)
    print(f"build: {sorted(_build.build_all())}", flush=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        want = cs._mesh_serve_lm_inputs(types.SimpleNamespace(seed=0),
                                        Path(tmp), device)
        torch.cuda.empty_cache()
        print(f"inputs in {time.perf_counter() - t0:.1f}s", flush=True)
        t1 = time.perf_counter()
        cfg = {"dir": tmp, "device": "cuda", "backend": "gloo", "seed": 0}
        ranks = launch_ranks(_rank, cs.MESH_RANKS, cfg, store_dir=tmp,
                             backend="gloo", timeout=cs.MESH_TIMEOUT)
        print(f"ranks in {time.perf_counter() - t1:.1f}s", flush=True)
    failed = cs._check_mesh_serve_lm(ranks, want)
    print(f"failed {failed}; {time.perf_counter() - t0:.1f}s in all")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
