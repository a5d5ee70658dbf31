"""``repro_torch`` runs without JAX and without the JAX package.

A subprocess blocks ``jax`` (``sys.modules["jax"] = None`` makes any import
of it fail), imports every module of the port, checks that nothing of
``repro`` came along, and runs a 16-vertex PageRank on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROGRAM = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import numpy as np
import torch
import repro_torch

names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
assert not leaked, leaked

from repro_torch.carry import graph_from_numpy
from repro_torch.core.pregel import VertexProgram, compile_pregel

n = 16
rng = np.random.default_rng(0)
src = np.concatenate([np.arange(n), rng.integers(0, n, 32)]).astype(np.int32)
dst = np.concatenate([(np.arange(n) + 1) % n,
                      rng.integers(0, n, 32)]).astype(np.int32)
outdeg = np.bincount(src, minlength=n).astype(np.float32)
prog = VertexProgram(
    init_vertex=lambda ids, od: torch.stack(
        [torch.full((n,), 1.0 / n), od], dim=1),
    message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
    apply=lambda j, s, inbox, got: (
        torch.stack([0.15 / n + 0.85 * inbox, s[:, 1]], dim=1),
        torch.ones(s.shape[0], dtype=torch.bool)),
    combine="sum",
)
g = graph_from_numpy(n, src, dst, outdeg, device="cpu")
res = compile_pregel(prog, g, device="cpu").run(max_iters=50)
P = np.zeros((n, n))
for s, d in zip(src, dst):
    P[d, s] += 1.0 / outdeg[s]
r = np.full(n, 1.0 / n)
for _ in range(50):
    r = 0.15 / n + 0.85 * P @ r
np.testing.assert_allclose(res.state[0][:, 0].numpy(), r, rtol=1e-5)
print(len(names), "modules")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROGRAM], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "modules" in out.stdout


def test_port_sources_name_neither_jax_nor_the_jax_package():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert not (mod == "jax" or mod.startswith("jax.")), path
                assert not (mod == "repro" or mod.startswith("repro.")), path
