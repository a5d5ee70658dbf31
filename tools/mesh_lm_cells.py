"""Run the mesh phase's LM cells of ``chip_smoke.py`` alone, on 4 ranks of
a (data 2, model 2) mesh over ``gloo`` staged through host memory, all on
``cuda:0``.

    python3 tools/mesh_lm_cells.py [ARCH ...]

ARCH is any of ``chip_smoke.MESH_LM_CELLS`` (phi4_mini_3_8b, minicpm3_4b,
whisper_medium, mamba2_130m, hymba_1_5b); all of them when none is named
(``mamba2_130m hymba_1_5b``: the ssm and hybrid cells alone).  It builds
the kernels, makes each cell's batch, bars and one-device yardsticks with
``chip_smoke._mesh_lm_inputs`` (B2-B4 held to their plain versions at a
rank's local shapes and timed), runs ``chip_smoke._mesh_lm`` on every rank
(the train step, its planted fault, serving and its planted fault) and
checks them with ``chip_smoke._check_mesh_lm``, printing the cells' lines
and the seconds of each part.  Exits nonzero when a cell fails.
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
    out, seconds = {}, {}
    for arch in cfg["archs"]:
        t0 = time.perf_counter()
        out.update(cs._mesh_lm(cfg, arch))
        seconds[arch] = round(time.perf_counter() - t0, 1)
    out["seconds"] = seconds
    return out


def main(argv) -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import launch_ranks

    archs = argv or list(cs.MESH_LM_CELLS)
    unknown = sorted(set(archs) - set(cs.MESH_LM_CELLS))
    if unknown:
        print(f"mesh_lm_cells: no cell {unknown}; the cells are "
              f"{list(cs.MESH_LM_CELLS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("mesh_lm_cells: no CUDA device", file=sys.stderr)
        return 1
    print(cs._card_line(), flush=True)
    print(f"build: {sorted(_build.build_all())}", flush=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        want = {}
        for arch in archs:
            want[arch] = cs._mesh_lm_inputs(types.SimpleNamespace(seed=0),
                                            Path(tmp), device, arch)
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cfg = {"dir": tmp, "device": "cuda", "backend": "gloo", "seed": 0,
               "archs": archs}
        ranks = launch_ranks(_rank, cs.MESH_RANKS, cfg, store_dir=tmp,
                             backend="gloo", timeout=cs.MESH_TIMEOUT)
        print(f"ranks in {time.perf_counter() - t1:.1f}s, rank 0's cells in "
              f"s {ranks[0]['seconds']}", flush=True)
    failed = []
    for arch in archs:
        failed += cs._check_mesh_lm(ranks, want[arch], arch)
    print(f"failed {failed}; {time.perf_counter() - t0:.1f}s in all")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
