"""LM prefill and decode on a mesh (ROADMAP A10e-2) in the port, against
the JAX package's GSPMD serve steps on 8 virtual devices and its
one-device steps.

One module fixture writes the cells' numpy weights and prompts (made from
a seed, ``_spmd_serve_lm_workloads.py``), then at once starts the JAX
package's program on 8 virtual devices in a subprocess and launches 8
``gloo`` ranks of the port (``launch_ranks``, a FileStore under
``tmp_path``), each running every cell on its mesh.  The cells: reduced
minitron-8b on ``(data 4, model 2)`` (``cache_len`` 32, the slots cut over
``model``), reduced mixtral-8x22b (EP, a 16-slot ring that prefill rolls
and decode wraps), reduced arctic-480b under ZeRO-3 with ``cache_len`` 33
(kept whole by the divisibility filter), the minitron cell on ``(pod 2,
data 2, model 2)``, and on ``(data 2, model 3)`` over 6 ranks, where only
the slots are cut (whole heads, ffn and vocab); reduced minicpm3-4b (MLA)
and whisper-medium (A10h-1); reduced mamba2-130m at its published vocab
(the SSD whole on every ``model`` rank, its cache cut over rows only) and
hymba-1.5b with 5 q / 1 kv heads, whose attention the planner replicates
(every head attended on every rank), and a 16-slot ring cut over
``model`` (A10h-2, A10h-3 case (ii)); and
reduced minitron-8b on ``(data 2, model 4)``, whose 2 kv heads 4 does not
divide, with its slots cut and whole (A10h-3 case (i)).

Bars:

* prefill's and every decode step's logits (over the real vocab) within
  1e-5 relative of the JAX package's 8-device run and of its one-device
  run; the greedy tokens equal;
* the joined caches after prefill and after decode within 1e-6 of the
  JAX package's; each cache block shaped as the reference's
  ``NamedSharding.shard_shape``; ``carry.shard_cache`` of the joined
  cache giving back each rank's blocks, ``lm.init_cache(mesh=...)`` zero
  blocks of their shapes;
* every rank's joined results bit-equal, the ranks that share rows
  (``model`` replicas) bit-equal in their tokens and, where the slots are
  whole, their cache blocks; two runs bit-identical;
* the padded vocab columns of the last ``model`` ranks' blocks are
  ``-1e30`` at every step and never sampled;
* inside the ranks (ROADMAP C1): the decode's slot write made by the
  owner alone, inside its block; the mask's global slot ids, the
  vocab-parallel lookup's local ids and the argmax's tokens in range.

In process: ``cache_specs_on`` against the reference's
``logical_to_spec`` of ``lm.cache_axes`` for all ten configs on four
meshes, the serving plans byte-equal to the reference's, every family's
steps built on a stand-in mesh, and the refusals that remain (A10h-4)
before any collective.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import _spmd_serve_lm_workloads as W
from _spmd_train_workloads import flat
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models.registry import ARCH_IDS

LOGIT_TOL = 1e-5
CACHE_TOL = 1e-6
LAUNCH_TIMEOUT = 600.0
CELLS = tuple(W.CELLS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 8 ranks' results, the JAX package's), made at once."""

    d = tmp_path_factory.mktemp("spmd_serve_lm")
    W.make_inputs(d)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, W.__file__, str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch_ranks, W.rank_main, 8, str(d),
                                store_dir=str(d), timeout=LAUNCH_TIMEOUT)
            ranks = ranks.result()
        _, err = jax_proc.communicate(timeout=LAUNCH_TIMEOUT)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, err[-4000:]
    jax = {}
    for name in CELLS:
        with np.load(d / f"{name}_jax.npz") as f:
            jax[name] = {k: f[k] for k in f.files}
    return ranks, jax


def _vocab(name):
    return W.cell_config(W.CELLS[name]).vocab


@pytest.mark.parametrize("name", CELLS)
def test_logits_match_the_jax_package(runs, name):
    ranks, jax = runs
    V = _vocab(name)
    got = ranks[0][name]["logits"][..., :V]
    assert got.shape[0] == W.CELLS[name]["steps"] + 1
    for tag in ("", "single/"):
        want = jax[name][f"{tag}logits"][..., :V]
        rel = np.abs(got - want).max(axis=(1, 2)) \
            / np.abs(want).max(axis=(1, 2))
        assert rel.max() <= LOGIT_TOL, (tag or "mesh", rel)


@pytest.mark.parametrize("name", CELLS)
def test_greedy_tokens_equal(runs, name):
    ranks, jax = runs
    got = ranks[0][name]["tokens"]
    assert got.shape == (W.PROMPT[0], W.CELLS[name]["steps"] + 1)
    for tag in ("", "single/"):
        np.testing.assert_array_equal(got, jax[name][f"{tag}tokens"])


@pytest.mark.parametrize("name", CELLS)
def test_caches_match_the_jax_package(runs, name):
    ranks, jax = runs
    for when in ("cache0", "cache1"):
        got = ranks[0][name][when]
        assert set(got) == {k[len(when) + 1:] for k in jax[name]
                            if k.startswith(when + "/")}
        for path, a in got.items():
            want = jax[name][f"{when}/{path}"]
            gap = np.abs(a - want).max() / max(1.0, np.abs(want).max())
            assert gap <= CACHE_TOL, (when, path, gap)


def _in(ranks, name):
    """The ranks' results of the cell ``name``, of the ranks on its
    mesh."""

    return [r[name] for r in ranks if r[name] is not None]


@pytest.mark.parametrize("name", CELLS)
def test_cache_blocks_are_the_reference_shard_shapes(runs, name):
    ranks, jax = runs
    L = W.CELLS[name]["cache_len"]
    cfg = W.cell_config(W.CELLS[name])
    cells = _in(ranks, name)
    assert len(cells) == np.prod(W.MESHES[W.CELLS[name]["mesh"]][0])
    for c in cells:
        shapes, tp = c["shapes"], c["tp"]
        assert set(shapes) == {k[6:] for k in jax[name]
                               if k.startswith("shape/")}
        for path, shape in shapes.items():
            assert shape == tuple(jax[name][f"shape/{path}"]), path
            if path.startswith("cross/"):
                # an encoder-decoder's cross K/V: every frame and head
                assert shape[2:] == (cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
                continue
            if path.split("/")[-1] in ("conv", "ssm"):
                # an SSM's window and state: cut over the rows only
                assert shape[2:] == ranks[0][name]["cache1"][path].shape[2:]
                continue
            # the slots are cut over model exactly where it divides them
            assert shape[2] == (L // tp if L % tp == 0 else L)


@pytest.mark.parametrize("name", CELLS)
def test_cache_blocks_carry_and_start_at_zero(runs, name):
    """On every rank the joined cache after prefill, cut again by
    ``carry.shard_cache``, gives back the rank's blocks bit for bit, and
    ``lm.init_cache(mesh=...)`` makes zero blocks of the same shapes and
    dtypes."""

    ranks, _ = runs
    assert all(c["carried"] for c in _in(ranks, name))


@pytest.mark.parametrize("name", CELLS)
def test_every_rank_agrees(runs, name):
    """Every rank's joined results are bit-equal; the ranks that hold the
    same rows (``model`` replicas) return the same tokens, and where the
    slots are whole the same cache blocks."""

    ranks, _ = runs
    cells = _in(ranks, name)
    tokens = cells[0]["tokens"]
    groups = {}
    for c in cells:
        assert c["digest"] == cells[0]["digest"]
        groups.setdefault(c["rows"], []).append(c)
    for rows, group in groups.items():
        tp = group[0]["tp"]
        # an SSM's cache has no slots: whole over model, as uncut slots are
        whole = W.CELLS[name]["cache_len"] % tp != 0 or \
            W.cell_config(W.CELLS[name]).family == "ssm"
        assert len(group) == tp
        local = group[0]["local_tokens"]
        n = local.shape[0]
        assert np.array_equal(local, tokens[rows * n:(rows + 1) * n])
        assert all(np.array_equal(c["local_tokens"], local) for c in group)
        blocks = {c["block_digest"] for c in group}
        assert len(blocks) == (1 if whole else tp)


def test_two_runs_are_bit_identical(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["again_digest"] == r[W.AGAIN]["digest"]


@pytest.mark.parametrize("name", CELLS)
def test_padded_columns_never_win(runs, name):
    """The padded columns lie in the last ``model`` ranks' vocab blocks
    (on reduced configs 128 real columns padded to 256: all of the last
    rank's block on a 2-way axis, the last two ranks' on a 4-way one;
    whisper's cell the last 103: 51,865 padded to 51,968; hymba's the last
    255: 32,001 padded to 32,256): they are -1e30 at prefill and at every
    decode step, and no token sampled lies past the real vocab."""

    ranks, _ = runs
    cfg = W.cell_config(W.CELLS[name])
    V = cfg.padded_vocab
    for c in _in(ranks, name):
        pads, tp = c["pads"], c["tp"]
        assert len(pads) == W.CELLS[name]["steps"] + 1
        n = V // tp if V % tp == 0 else V
        first = c["model"] * n if n < V else 0
        pad = max(0, first + n - max(first, cfg.vocab))
        assert all(p == (pad, True) for p in pads), pads
    assert ranks[0][name]["tokens"].max() < cfg.vocab


def _writes(r, names=CELLS):
    """The slot writes rank ``r`` makes over the audited cells ``names``:
    where the slots are cut only the owner of ``pos % L`` (or ``pos``)
    writes; an SSM's cache has no slots."""

    total = 0
    for name in names:
        cell = W.CELLS[name]
        cfg = W.cell_config(cell)
        if r[name] is None or cfg.family == "ssm":
            continue
        L, S, tp = cell["cache_len"], W.PROMPT[1], r[name]["tp"]
        for pos in range(S, S + cell["steps"]):
            slot = pos % L if cfg.window is not None else pos
            mine = L % tp != 0 or slot // (L // tp) == r[name]["model"]
            total += cfg.n_layers * mine
    return total


def test_indices_stay_in_range(runs):
    """C1 inside the ranks: the decode's local slot write (the owner
    alone, inside its block), the mask's global slot ids, the
    vocab-parallel lookup's local ids and the argmax's tokens; among
    them MLA decode's latent slot write and mask (``minicpm3``), the
    lookup and argmax over whisper's, hymba's and mamba2's published
    vocabs (mamba2's table tied to its head), hymba's ring
    writes on a cache cut over ``model`` (positions 24-31 in ``model``
    rank 1's slots 8-15, then 32-35 in rank 0's 0-3)."""

    ranks, _ = runs
    for r in ranks:
        audit = r["audit"]
        assert audit["checked"] >= 150
        assert audit["bad"] == []
        assert audit["writes"] == _writes(r)
        sites = audit["sites"]
        cell = W.CELLS["minicpm3"]
        per_layer = cell["steps"] * W.port_config(cell["arch"]).n_layers
        assert sites["minicpm3/mask"] == per_layer
        # positions 24-31 of 32 slots lie in model rank 1's block
        assert sites.get("minicpm3/write", 0) == \
            per_layer * (r["minicpm3"]["model"] == 1)
        for site in ("vocab", "argmax"):
            for name in ("whisper", "hymba_ring", "mamba2"):
                assert sites[f"{name}/{site}"] >= W.CELLS[name]["steps"]
        cell = W.CELLS["hymba_ring"]
        per_layer = cell["steps"] * W.cell_config(cell).n_layers
        assert sites["hymba_ring/mask"] == per_layer
        assert sites["hymba_ring/write"] == _writes(r, ["hymba_ring"]) \
            == W.cell_config(cell).n_layers * (
                8 if r["hymba_ring"]["model"] == 1 else 4)
        # the attention-free SSM writes no slot and masks none
        assert not {"mamba2/write", "mamba2/mask"} & set(sites)


# ---------------------------------------------------------------------------
# In process: cache specs and plans against the reference's, the refusals
# ---------------------------------------------------------------------------

SPEC_MESHES = {
    "data4-model2": (("data", 4), ("model", 2)),
    "pod2-data2-model2": (("pod", 2), ("data", 2), ("model", 2)),
    "data16-model16": (("data", 16), ("model", 16)),
    "pod2-data16-model16": (("pod", 2), ("data", 16), ("model", 16)),
}


@pytest.mark.parametrize("mesh_name", SPEC_MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    """``cache_specs_on`` at the ``decode_32k`` shape, and at one slot
    more (which no mesh axis divides), is the reference's
    ``logical_to_spec`` of ``lm.cache_axes`` leaf by leaf; the serving
    plans (``prefill_32k``, ``decode_32k``) are byte-equal to the
    reference's."""

    from repro.core.hardware import MeshSpec as JMeshSpec
    from repro.core.lm_planner import plan_lm as jplan_lm
    from repro.models import lm as jlm
    from repro.models.common import SHAPES
    from repro.models.registry import get_config as jget
    from repro.parallel import sharding as jsh
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_config

    axes = SPEC_MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=dict(axes))
    jcfg, cfg = jget(arch), get_config(arch)
    for kind in ("prefill_32k", "decode_32k"):
        jplan = jplan_lm(jcfg, kind, JMeshSpec(axes))
        plan = plan_lm(cfg, kind, MeshSpec(axes))
        assert plan.notes == jplan.notes
        assert plan.explain() == jplan.explain()
        assert plan.rules.rules == jplan.rules.rules
        assert (plan.rules.fsdp, plan.rules.expert_parallel) == \
            (jplan.rules.fsdp, jplan.rules.expert_parallel)
    B, S = SHAPES["decode_32k"]["batch"], SHAPES["decode_32k"]["seq"]
    checked = 0
    for seq in (S, S + 1):
        jaxes = flat(jlm.cache_axes(jcfg, B, seq))
        jshapes = flat(jlm.abstract_cache(jcfg, B, seq))
        specs = flat(serve.cache_specs_on(cfg, mesh, plan.rules, B, seq))
        assert set(specs) == set(jaxes)
        for path, ax in jaxes.items():
            want = jsh.logical_to_spec(jplan.rules, ax,
                                       shape=tuple(jshapes[path].shape),
                                       mesh=mesh)
            assert specs[path] == tuple(want), (path, specs[path], want)
            checked += 1
    assert checked == 2 * len(jaxes)


@pytest.mark.parametrize("arch", ("minicpm3_4b", "mamba2_130m", "hymba_1_5b",
                                  "whisper_medium", "kv_heads"))
def test_unported_paths_refuse_before_any_collective(arch):
    """On a stand-in mesh every family builds both serve steps: mla and
    encdec with their heads cut over ``model`` (A10h-1), ssm and hybrid
    (A10h-2), and kv heads that ``model`` does not divide (reduced
    minitron-8b's 2 on a 4-way axis, A10h-3).  What stays unported, q
    heads cut mid-head over a ``model`` axis that does not divide them
    (reduced minicpm3-4b, hymba-1.5b and whisper-medium with 5 heads on a
    2-way axis, the ``qkv`` rule kept on ``model``), refuses both, naming
    ROADMAP A10h-4; under the planner's own rules those heads are
    replicated and build.  A stand-in mesh has no process
    group, so any collective would fail: the refusal comes before any."""

    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.launch import serve

    tp = 4 if arch == "kv_heads" else 2
    cfg = W.port_config("minitron_8b" if arch == "kv_heads" else arch)
    axes = (("data", 2), ("model", tp))
    mesh = types.SimpleNamespace(shape=dict(axes),
                                 device=torch.device("cpu"))
    five = {"mla": {"n_heads": 5},
            "encdec": {"n_heads": 5, "n_kv_heads": 1},
            "hybrid": {"n_heads": 5, "n_kv_heads": 1}}.get(cfg.family)
    for kind in ("prefill_32k", "decode_32k"):
        def build(c, qkv=False):
            plan = dataclasses.replace(plan_lm(c, kind, MeshSpec(axes)),
                                       cfg=c)
            if qkv:
                # the planner replicates heads that model does not divide
                plan = dataclasses.replace(
                    plan, rules=plan.rules.with_rule("qkv", "model"))
            if kind == "prefill_32k":
                return serve.build_prefill_step(plan, mesh, 32)
            return serve.build_decode_step(plan, mesh, cache_len=32)

        step = build(cfg)
        assert callable(step[0])
        specs = step[1]["layers"]
        mixer = specs["ssm" if cfg.family == "ssm" else "attn"]
        cut = any("model" in str(e) for leaf in mixer.values() for e in leaf)
        # the SSD mixer whole on every model rank; attention cut over it
        assert cut == (cfg.family != "ssm")
        if five is not None:
            c5 = dataclasses.replace(cfg, **five)
            assert callable(build(c5)[0])
            with pytest.raises(NotImplementedError, match="A10h-4"):
                build(c5, qkv=True)
