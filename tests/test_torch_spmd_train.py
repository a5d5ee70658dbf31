"""The LM train step on a mesh (ROADMAP A10e-1) in the port, against the
JAX package's GSPMD step on 8 virtual devices and the port's own
one-device step.

One module fixture writes the cells' numpy weights and tokens (made from
a seed, ``_spmd_train_workloads.py``), then at once starts the JAX
package's program on 8 virtual devices in a subprocess, launches 8
``gloo`` ranks of the port on a ``(data 4, model 2)`` mesh
(``launch_ranks``, a FileStore under ``tmp_path``) and runs the port's
one-device step in process.  The cells: the reference's own (reduced
minitron-8b, the planner's ZeRO-1 plan, 2 microbatches, 4 AdamW steps),
the same model under ZeRO-3 with a mask that leaves the microbatches' and
the data shards' token counts unequal, reduced arctic-480b (MoE, EP
over ``model``, the dense residual) under ZeRO-3, reduced minicpm3-4b and
whisper-medium (A10h-1), reduced mamba2-130m at its published vocab
under ZeRO-3 (the SSD whole on every ``model`` rank, the tied table
gathered for each use), hymba-1.5b with 5 q / 1 kv heads, whose attention
the planner replicates (A10h-2, A10h-3 case (ii)), and as it is, its
attention tensor parallel (A10h-2), and reduced minitron-8b with 1 kv
head (case (i)).

Bars:

* each step's loss and grad norm within 1e-5 relative of the JAX
  package's mesh step and of the port's one-device step;
* the final params and both moments, leaf by leaf, within ``bar x max(1,
  max |ref|)``, where ``bar`` is 1e-5 or twice the distance across
  worlds measured in the same run, whichever is larger (ROADMAP C6): the
  JAX package's own one-device step from its 8-device step, and, against
  the JAX package, also the port's one-device step from the JAX
  package's.  AdamW divides by sqrt(v) ~ 4e-5 where a gradient is
  rounding noise, so the flat 1e-5 does not hold across worlds even for
  the JAX package itself (its two worlds differ by 1.3e-5 in the
  reference's cell; the port's one-device step is 4.7e-5 from the JAX
  package's in the masked cell);
* every rank's block of every leaf of ``params`` and the moments shaped
  as the reference's ``NamedSharding.shard_shape``;
* every rank's losses equal and its gathered final state bit-equal; two
  runs of the masked ZeRO-3 cell bit-identical, the second with every
  backward in another thread (where autograd runs a CUDA backward);
* every index the vocab-parallel lookup and loss and the EP dispatch hand
  to torch inside the ranks in range (C1);
* under ZeRO-1 a microbatch's gradients reach the shards by
  reduce-scatters only; under ZeRO-3 by the gathers' backward, a
  parameter gathered once a use (the head once a microbatch, a tied
  table once for the lookup and once for the loss).

In process: the port's ``logical_to_spec`` / ``spec_for_param`` /
``_zero1_spec`` against the reference's on every leaf of all ten configs
on four meshes, with ``fsdp`` on and off (a stand-in with a ``.shape``
dict for the reference's mesh), exactly equal; ``batch_fn``'s rows; and
the SSD mixer's leaves reduced over the batch axes only.
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

import _spmd_train_workloads as W
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models.registry import ARCH_IDS

TOL = 1e-5
LAUNCH_TIMEOUT = 600.0
CELLS = tuple(W.CELLS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 8 ranks' results, the port's one-device results, the JAX
    package's), all three made at once."""

    d = tmp_path_factory.mktemp("spmd_train")
    W.make_inputs(d)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, W.__file__, str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch_ranks, W.rank_main, 8, str(d),
                                store_dir=str(d), timeout=LAUNCH_TIMEOUT)
            single = {name: W.run_single(d, name) for name in CELLS}
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
    return ranks, single, jax


def _leaf_gaps(got, want):
    """``{path: max |got - want| / max(1, max |want|)}`` over the final
    state's leaves."""

    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(1.0, float(np.abs(want[k]).max())))
            for k in want}


def _jax_final(jax, name, tag=""):
    return {k[len(tag):]: v for k, v in jax[name].items()
            if k.startswith(tag) and k[len(tag):].split("/")[0]
            in ("params", "m", "v")}


@pytest.mark.parametrize("name", CELLS)
def test_losses_and_grad_norms_match(runs, name):
    ranks, single, jax = runs
    got = ranks[0][name]
    assert len(got["losses"]) == W.CELLS[name]["steps"]
    for key in ("losses", "grad_norms"):
        mesh = np.array(got[key])
        for want in (jax[name][key], np.array(single[name][key])):
            np.testing.assert_allclose(mesh, want, rtol=TOL, atol=0)
    assert got["losses"][-1] < got["losses"][0]    # lm_sharded_decreasing


@pytest.mark.parametrize("name", CELLS)
def test_final_state_matches_the_jax_package(runs, name):
    ranks, single, jax = runs
    ref = _jax_final(jax, name)
    world = max(max(_leaf_gaps(_jax_final(jax, name, "single/"),
                               ref).values()),
                max(_leaf_gaps(single[name]["final"],
                               _jax_final(jax, name, "single/")).values()))
    bar = max(TOL, 2 * world)
    gaps = _leaf_gaps(ranks[0][name]["final"], ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= bar, (worst, gaps[worst], bar, world)


@pytest.mark.parametrize("name", CELLS)
def test_final_state_matches_the_unmeshed_step(runs, name):
    ranks, single, jax = runs
    world = max(_leaf_gaps(_jax_final(jax, name, "single/"),
                           _jax_final(jax, name)).values())
    bar = max(TOL, 2 * world)
    gaps = _leaf_gaps(ranks[0][name]["final"], single[name]["final"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= bar, (worst, gaps[worst], bar, world)


@pytest.mark.parametrize("name", CELLS)
def test_blocks_are_the_reference_shard_shapes(runs, name):
    ranks, _, jax = runs
    for r in ranks:
        shapes = r[name]["shapes"]
        assert len(shapes) == len([k for k in jax[name]
                                   if k.startswith("shape/")])
        for path, shape in shapes.items():
            assert shape == tuple(jax[name][f"shape/{path}"]), path


@pytest.mark.parametrize("name", CELLS)
def test_every_rank_agrees(runs, name):
    ranks, _, _ = runs
    for r in ranks:
        assert r[name]["losses"] == ranks[0][name]["losses"]
        assert r[name]["grad_norms"] == ranks[0][name]["grad_norms"]
        assert r[name]["digest"] == ranks[0][name]["digest"]
        assert r[name]["step"] == W.CELLS[name]["steps"]


def test_two_runs_are_bit_identical(runs):
    """The second run's backward ran in another thread, as autograd runs
    a CUDA backward: its collectives and recompute found the mesh."""

    ranks, _, _ = runs
    for r in ranks:
        assert r["again_digest"] == r[W.AGAIN]["digest"]
        assert r["again_losses"] == r[W.AGAIN]["losses"]


def test_indices_stay_in_range(runs):
    """C1 inside the ranks: the vocab-parallel lookup's and loss's local
    ids and the EP dispatch's buffer rows.  Each cell's vocab ids are
    audited three times a microbatch (the lookup, the loss and the loss's
    recompute), mamba2's tied table among them."""

    ranks, _, _ = runs
    for r in ranks:
        assert r["audit"]["checked"] >= 40
        assert r["audit"]["bad"] == []
        sites = r["audit"]["sites"]
        for name in ("mamba2", "hymba", "hymba_tp", "minitron_kv1"):
            assert sites[f"{name}/vocab"] == \
                3 * W.MICROBATCHES * W.CELLS[name]["steps"]


def test_zero1_reduces_gradients_by_reduce_scatter(runs):
    ranks, _, _ = runs
    for r in ranks:
        for phases in r["zero1"]["phases"]:
            for i in range(W.MICROBATCHES):
                calls = phases[f"reduce {i}"]["calls"]
                assert set(calls) == {"psum_scatter"}, calls
                assert "psum_scatter" not in phases[f"microbatch {i}"][
                    "calls"]
            assert set(phases["update"]["calls"]) == {"all_gather"}


def test_zero3_gathers_each_parameter_once_a_use(runs):
    """Under ZeRO-3 each layer's parameters are gathered in the forward
    and again in full remat's recompute, the embedding, the head and the
    final norm once a microbatch; the gathers' backward reduce-scatters
    every gradient, so nothing is left to reduce after it."""

    _assert_zero3_gathers(runs, "zero3_masked")


def test_zero3_gathers_a_tied_table_once_a_use(runs):
    """mamba2's tied table under ZeRO-3 (A10h-2): gathered once for the
    lookup and once for the loss's head a microbatch (with the final
    norm, the 3 beside the layers'), each gather's backward a
    reduce-scatter into the one leaf."""

    _assert_zero3_gathers(runs, "mamba2")


def _assert_zero3_gathers(runs, name):
    """Each layer leaf ZeRO-3 cuts over ``data`` (those with an ``embed``
    dim: every one of minitron's, mamba2's norm, ``in_proj`` and
    ``out_proj``) gathered twice a microbatch, the embedding's three
    uses once; the leaves it leaves whole (mamba2's conv, ``A_log``,
    ``D``, ``dt_bias`` and gated norm) all-reduced after the backward,
    one ``psum`` each."""

    from repro_torch.launch import train
    from repro_torch.parallel.sharding import spec_axes

    ranks, _, _ = runs
    plan = W.port_plan(W.CELLS[name])
    cfg = plan.cfg
    assert plan.rules.fsdp
    mesh = types.SimpleNamespace(shape=dict(zip(W.MESH[1], W.MESH[0])))
    specs = W.flat(train.param_specs(cfg, mesh, plan.rules))
    cut = {k: any("data" in spec_axes(e) for e in spec)
           for k, spec in specs.items()}
    per_layer = sum(v for k, v in cut.items() if k.startswith("layers/"))
    whole = sum(not v for v in cut.values())
    gathers = 2 * per_layer * cfg.n_layers + 3
    for r in ranks:
        for phases in r[name]["phases"]:
            for i in range(W.MICROBATCHES):
                calls = phases[f"microbatch {i}"]["calls"]
                assert calls["all_gather"] == gathers
                assert calls["psum_scatter"] == gathers - per_layer * \
                    cfg.n_layers
                assert phases[f"reduce {i}"]["calls"] == (
                    {"psum": whole} if whole else {})


@pytest.mark.parametrize("name", ("mamba2", "hymba", "hymba_tp"))
def test_ssm_gradients_are_not_summed_over_model(name):
    """The SSD mixer's leaves (A10h-2) carry no ``model`` in their specs,
    so the step reduces their gradients, whole on every ``model`` rank,
    over the batch axes only and counts them once in the global norm, as
    the norms'; the hybrid's attention leaves are cut over ``model`` and
    enter the norm's ``psum`` over it where ``model`` divides the heads
    (``hymba_tp``), and are whole, as the SSD's, where the planner
    replicates them (``hymba``: 5 q heads on a 2-way axis)."""

    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import spec_axes

    plan = W.port_plan(W.CELLS[name])
    cfg = plan.cfg
    mesh = types.SimpleNamespace(
        shape=dict(zip(W.MESH[1], W.MESH[0])), axis_names=W.MESH[1],
        batch_axes=("data",))
    p_specs = train.param_specs(cfg, mesh, plan.rules)
    a_specs = train._moment_specs(p_specs, lm.abstract_params(cfg), mesh,
                                  plan.zero, plan.rules.fsdp)
    shapes = W.flat(lm.abstract_params(cfg))
    p_flat, a_flat = W.flat(p_specs), W.flat(a_specs)
    ssm = [k for k in p_flat if k.startswith("layers/ssm/")]
    attn = [k for k in p_flat if k.startswith("layers/attn/")]
    assert len(ssm) == 8 and bool(attn) == (cfg.family == "hybrid")
    tp_attn = bool(attn) and \
        cfg.n_heads % dict(zip(W.MESH[1], W.MESH[0]))["model"] == 0
    assert tp_attn == (name == "hymba_tp")
    for path in ssm + attn:
        leaf = train._leaf_plan(p_flat[path], a_flat[path],
                                tuple(shapes[path].shape), mesh)
        cut = any("model" in spec_axes(e) for e in p_flat[path])
        assert cut == (path in attn and tp_attn), path
        assert "model" not in leaf.psum_axes + leaf.scatter_axes, path
        assert ("model" in leaf.norm_axes) == cut, path
        # over data: in the step, or by a ZeRO-3 gather's backward
        held = {a for e in p_flat[path] for a in spec_axes(e)}
        assert "data" in set(leaf.psum_axes + leaf.scatter_axes) | held, \
            path


def test_ranks_out_of_lockstep_fail_instead_of_hanging(tmp_path):
    """A rank that leaves the lockstep (here: skips the step) leaves its
    partner's first collective without a peer; the launch raises within
    its timeout rather than hanging."""

    with pytest.raises(RuntimeError, match="rank 0"):
        launch_ranks(W.out_of_step, 2, store_dir=str(tmp_path), timeout=30)


# ---------------------------------------------------------------------------
# In process: the specs against the reference's, and batch_fn's rows
# ---------------------------------------------------------------------------

SPEC_MESHES = {
    "data4-model2": (("data", 4), ("model", 2)),
    "pod2-data2-model2": (("pod", 2), ("data", 2), ("model", 2)),
    "data16-model16": (("data", 16), ("model", 16)),
    "pod2-data16-model16": (("pod", 2), ("data", 16), ("model", 16)),
}


@pytest.mark.parametrize("mesh_name", SPEC_MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh_name):
    from repro.core.hardware import MeshSpec as JMeshSpec
    from repro.core.lm_planner import plan_lm as jplan_lm
    from repro.launch import train as jtrain
    from repro.models import lm as jlm
    from repro.models.registry import get_config as jget
    from repro.parallel import sharding as jsh
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.models.registry import get_config
    from repro_torch.parallel import sharding

    axes = SPEC_MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=dict(axes))
    jcfg, cfg = jget(arch), get_config(arch)
    jrules = jplan_lm(jcfg, "train_4k", JMeshSpec(axes)).rules
    rules = plan_lm(cfg, "train_4k", MeshSpec(axes)).rules
    assert jrules.rules == rules.rules
    jaxes = W.flat(jlm.param_axes(jcfg))
    jshapes = W.flat(jlm.abstract_params(jcfg))
    paxes = W.flat(lm.param_axes(cfg))
    pshapes = W.flat(lm.abstract_params(cfg))
    assert set(jaxes) == set(paxes) == set(pshapes)
    checked = 0
    for fsdp in (False, True):
        jr = dataclasses.replace(jrules, fsdp=fsdp)
        r = dataclasses.replace(rules, fsdp=fsdp)
        specs = W.flat(train.param_specs(cfg, mesh, r))
        for path, ax in jaxes.items():
            assert paxes[path] == tuple(ax)
            shape = tuple(jshapes[path].shape)
            assert tuple(pshapes[path].shape) == shape
            want = jsh.spec_for_param(jr, ax, shape=shape, mesh=mesh)
            got = sharding.spec_for_param(r, ax, shape=shape, mesh=mesh)
            assert got == tuple(want), (path, got, want)
            assert specs[path] == got
            assert sharding.logical_to_spec(r, ax) == tuple(
                jsh.logical_to_spec(jr, ax)), path
            z = train._zero1_spec(got, shape, mesh)
            jz = jtrain._zero1_spec(want, shape, mesh)
            assert z == tuple(jz), (path, z, jz)
            checked += 1
    assert checked == 2 * len(jaxes)


def test_batch_fn_gives_each_rank_its_block_of_every_microbatch():
    """The microbatch layout: data rank d's rows for microbatch i are the
    d-th block of the reference's global microbatch i (rows ``[i mb, (i+1)
    mb)``), not its block of the whole batch cut again."""

    from repro_torch.launch import train

    plan = W.port_plan(W.CELLS["zero1"])
    tokens = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    for d in range(4):
        mesh = types.SimpleNamespace(
            shape={"data": 4, "model": 2}, axis_names=("data", "model"),
            batch_axes=("data",), device=torch.device("cpu"),
            linear_index=lambda axes, d=d: d)
        _, _, batch_fn = train._build_mesh_step(plan, mesh, None, 1.0,
                                                "auto")
        rows = batch_fn({"tokens": tokens})["tokens"].numpy()
        want = np.concatenate([tokens[i * 8 + d * 2:i * 8 + d * 2 + 2]
                               for i in range(2)])
        assert np.array_equal(rows, want)
    with pytest.raises(ValueError, match="divide evenly"):
        batch_fn({"tokens": tokens[:12]})
