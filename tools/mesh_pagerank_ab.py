"""Time the mesh phase's PageRank cell for several source trees in turns,
so that two commits compare on one card in one run.

    python3 tools/mesh_pagerank_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``git archive`` of a commit unpacked
into a directory); its ``src/`` goes first on the path of a subprocess
that runs PageRank on 2^25 vertices (the ``chip_smoke.py`` webgraph from
seed 0, made once by this checkout's ``chip_smoke.py``) over 4 ranks on
``cuda:0`` with ``gloo`` staged through host memory, three runs of 20
supersteps, and prints ms a superstep of each run.  List the trees in an
order that cancels drift (parent, change, change, parent, ...).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

N_LOG2, SUPERSTEPS, RUNS, RANKS = 25, 20, 3, 4


def _program(n):
    import torch

    from repro_torch.core.pregel import VertexProgram

    return VertexProgram(
        init_vertex=lambda ids, outdeg: torch.stack(
            [torch.full((n,), 1.0 / n, device=ids.device), outdeg], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / n + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool, device=s.device)),
        combine="sum")


def _rank(rank, world, d, n, device):
    from repro_torch.carry import graph_from_numpy
    from repro_torch.core.pregel import compile_pregel
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device=device, backend="gloo")
    src, dst = np.load(os.path.join(d, "src.npy")), \
        np.load(os.path.join(d, "dst.npy"))
    g = graph_from_numpy(n, src, dst,
                         np.bincount(src, minlength=n).astype(np.float32),
                         device="cpu")
    ex = compile_pregel(_program(n), g, mesh=mesh)
    out = []
    for _ in range(RUNS):
        res = ex.run(max_iters=SUPERSTEPS)
        out.append(res.seconds / res.iterations * 1e3)
    return out


def _one_tree(tree, d, n, device):
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.launch.mesh import launch_ranks

    with tempfile.TemporaryDirectory(dir=d) as store:
        got = launch_ranks(_rank, RANKS, d, n, device, store_dir=store,
                           backend="gloo", timeout=900)
    print(f"tree {tree}: ms/superstep of each run on rank 0 "
          f"{[round(x, 3) for x in got[0]]}; the last run a rank "
          f"{[round(x[-1], 3) for x in got]}", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--tree"]:
        _one_tree(argv[1], argv[2], int(argv[3]), argv[4])
        return 0
    device = os.environ.get("MESH_AB_DEVICE", "cuda")
    n_log2 = int(os.environ.get("MESH_AB_LOG2", N_LOG2))
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as d:
        src, dst = cs._webgraph(1 << n_log2, 0)
        np.save(os.path.join(d, "src.npy"), src)
        np.save(os.path.join(d, "dst.npy"), dst)
        del src, dst
        if device == "cuda":
            print(cs._card_line(), flush=True)
        for tree in argv:
            subprocess.run([sys.executable, __file__, "--tree", tree, d,
                            str(1 << n_log2), device], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
