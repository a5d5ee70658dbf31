"""Fault tolerance on a mesh and elastic ``remesh`` in the port, against its
own uninterrupted runs and against the JAX package on one device.

One module fixture does three things on the same numpy inputs, made from
the JAX chaos program's seeds (``_spmd_ft_workloads.py``): the JAX package
writes a crashed-out checkpoint of two workloads on one device; 8 ``gloo``
ranks of the port (``launch_ranks``, a FileStore under ``tmp_path``) run
every workload of ``spmd_ft_program.py`` three ways, as the reference
does (uninterrupted, crash and restore, crash-out then ``remesh`` 8 -> 4
onto ranks 4-7 and resume from the same checkpoints), plus a crash on one
rank only, a ``remesh(None)`` 4 -> 1, the JAX checkpoints resumed, and
IMRU BGD crashed and straggling on one rank; then the JAX package, in
process on one device, runs each workload, reads the planner's notes for
a 4-shard data mesh, restores a checkpoint the ranks wrote with its own
template, and resumes it.  No 8-device JAX subprocess runs: the fault-free
mesh answers are held against those in ``test_torch_spmd.py`` and
``test_torch_spmd_generic*.py``.

Bars: every fault path within 1e-8 of the port's uninterrupted 8-rank run
(``test_spmd_ft.py``'s bar), with the same ``phase_iterations``, one
``remesh_event`` and the ``remesh(8->4: data=4)`` note; the remeshed plan's
notes equal to the JAX package's for a 4-shard data mesh plus that note,
byte for byte; a crash or a straggle on one rank moves every rank alike
(the same restarts, ``straggler_events``, notes); TC, CC and SSSP equal to
the JAX package's answers, the pipeline's ranks within 1e-6 relative,
IMRU within 1e-6 relative (``test_torch_spmd.py``'s bar); checkpoints
cross packages both ways, leaf for leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _spmd_ft_workloads as W
from repro_torch.launch.mesh import launch_ranks

FT_TOL = 1e-8            # test_spmd_ft.py's bar
REL_TOL = 1e-6           # f32 sums against the JAX package
LAUNCH_TIMEOUT = 600.0
REMESH_NOTE = "remesh(8->4: data=4)"


# ---------------------------------------------------------------------------
# The JAX package's side, one device
# ---------------------------------------------------------------------------


def _jax_relation(n, *cols):
    from repro.core.executor import Relation

    return Relation.from_columns(n, *cols)


def _jax_sssp():
    from repro.core.pregel import Graph, VertexProgram

    data = W.inputs()
    g = Graph(W.N, jnp.asarray(data["gsrc"]), jnp.asarray(data["gdst"]),
              jnp.zeros(W.N, jnp.float32),
              edge_data=jnp.asarray(data["weights"]))
    vp = VertexProgram(
        init_vertex=lambda ids, vd: jnp.where(ids == 0, 0.0,
                                              jnp.float32(1e9)),
        message=lambda j, s, ed: s + ed,
        apply=lambda j, s, inbox, got: (
            jnp.minimum(s, inbox), jnp.minimum(s, inbox) < s),
        combine="min")
    return vp, g


def _jax_compile(name, mesh_spec=None):
    """The JAX package's executable of a workload on one device; with
    ``mesh_spec`` its plan is the planner's for that mesh."""

    from repro.core import executor as JE
    from repro.core import listings as JL
    from repro.core.pregel import compile_pregel

    if name == "sssp_weighted":
        vp, g = _jax_sssp()
        return compile_pregel(vp, g, mesh_spec=mesh_spec)
    program, rels, semi = W.generic_case(name, W.inputs(), _jax_relation,
                                         JL)
    if mesh_spec is None:
        return JE.compile_program(program, rels, semi_naive=semi)
    real = JE.plan_program

    def planned(groups, specs, domain, _spec, *a, **kw):
        return real(groups, specs, domain, mesh_spec, *a, **kw)

    with mock.patch.object(JE, "plan_program", planned):
        return JE.compile_program(program, rels, semi_naive=semi)


def _jax_answer(name, res):
    if name == "sssp_weighted":
        return {"state": np.asarray(res.state[0]),
                "active": np.asarray(res.state[1])}
    return {p: (np.asarray(res.state[p].present),
                {k: np.asarray(v) for k, v in res.state[p].values.items()})
            for p in W.PREDS[name]}


def _jax_crash_out(name, directory):
    """A crashed-out JAX run on one device: its checkpoints stay behind."""

    from repro.ft import FailureInjector

    try:
        _jax_compile(name).run(
            max_iters=W.ITERS[name], checkpoint_dir=directory,
            checkpoint_every=2,
            injector=FailureInjector(crashes=list(W.CRASH_OUT)),
            max_restarts=1)
    except RuntimeError:
        return
    raise AssertionError(f"the JAX {name} run did not crash out")


def _jax_side(root, ranks):
    """The JAX package's answers, its 4-shard notes, and what it makes of
    the checkpoints the ranks wrote."""

    from repro.checkpoint import restore_pytree as jax_restore
    from repro.core.hardware import MeshSpec
    from repro.core.imru import IMRUTask, compile_imru

    from repro_torch.checkpoint import latest_step

    out = {}
    for name in W.WORKLOADS:
        one = {}
        ex = _jax_compile(name)
        res = ex.run(max_iters=W.ITERS[name], on_device=False)
        one["answer"] = _jax_answer(name, res)
        one["phases"] = list(res.phase_iterations)
        one["notes4"] = list(_jax_compile(
            name, MeshSpec((("data", 4),))).plan.notes)
        # The ranks' crashed-out checkpoint, read with the JAX template.
        snap = os.path.join(root, name, "snapshot")
        like = ex.init() if name == "sssp_weighted" else ex._ckpt_like()
        step = latest_step(snap)
        with open(os.path.join(snap, f"step_{step:08d}",
                               "MANIFEST.json")) as f:
            one["manifest"] = json.load(f)
        flat, _ = jax.tree_util.tree_flatten_with_path(like)
        one["template"] = {
            "leaf_paths": [jax.tree_util.keystr(p) for p, _ in flat],
            "shapes": [list(x.shape) for _, x in flat],
            "dtypes": [str(x.dtype) for _, x in flat]}
        tree, _, _ = jax_restore(snap, like)
        one["restored"] = {
            jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        # ... and resumed by the JAX package on one device.
        resume_dir = os.path.join(root, name, "jax_resume")
        shutil.copytree(snap, resume_dir)
        res = _jax_compile(name).run(max_iters=W.ITERS[name],
                                     checkpoint_dir=resume_dir, resume=True)
        one["resumed"] = _jax_answer(name, res)
        one["resumed_phases"] = list(res.phase_iterations)
        out[name] = one
    X, y, lr = W.imru_data()
    task = IMRUTask(init_model=lambda: jnp.zeros((W.IMRU_D,), jnp.float32),
                    map=lambda r, m: (r["x"] @ m - r["y"]) @ r["x"],
                    update=lambda j, m, g: m - lr * g)
    ex = compile_imru(task, {"x": jnp.asarray(X), "y": jnp.asarray(y)})
    out["imru"] = np.asarray(ex.run(max_iters=W.IMRU_ITERS).state)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spmd_ft")
    jax_dir = root / "jax"
    t0 = time.perf_counter()
    for name in W.FROM_JAX:
        _jax_crash_out(name, str(jax_dir / name))
    ranks = launch_ranks(W.rank_main, 8, str(root), str(jax_dir),
                         store_dir=str(root), timeout=LAUNCH_TIMEOUT)
    t1 = time.perf_counter()
    jax_side = _jax_side(str(root), ranks)
    print(f"spmd ft: ranks {t1 - t0:.1f}s (their own "
          f"{ranks[0]['seconds']:.1f}s), the JAX package "
          f"{time.perf_counter() - t1:.1f}s")
    return ranks, jax_side, root


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def _leaves(answer):
    """The arrays of an answer, in a fixed order."""

    if isinstance(answer, dict) and "state" in answer:
        return [answer["state"], answer["active"]]
    out = []
    for p in sorted(answer):
        pres, vals = answer[p]
        out.append(pres)
        out.extend(vals[k] for k in sorted(vals))
    return out


def _err(a, b):
    """The largest difference between two answers."""

    worst = 0.0
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.shape == y.shape
        worst = max(worst, float(np.max(np.abs(
            x.astype(np.float64) - y.astype(np.float64)), initial=0.0)))
    return worst


def _jax_close(name, got, want):
    """TC, CC and SSSP exact; the pipeline's f32 ranks within 1e-6 of
    their scale, its presence sets exact."""

    for x, y in zip(_leaves(got), _leaves(want), strict=True):
        if name == "pipeline" and x.dtype != bool:
            x, y = x.astype(np.float64), y.astype(np.float64)
            scale = float(np.abs(y).max(initial=0.0))
            assert float(np.abs(x - y).max(initial=0.0)) <= REL_TOL * scale
        else:
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# The reference's three ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_crash_restore_matches_uninterrupted(runs, name):
    ranks, _, _ = runs
    for r in ranks:
        out = r[name]
        assert _err(out["crash"]["answer"], out["clean"]["answer"]) \
            <= FT_TOL
        assert out["crash"]["restarts"] == 1
        assert out["crash"]["phases"] == out["clean"]["phases"]


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_remesh_8_to_4_matches_uninterrupted(runs, name):
    ranks, _, _ = runs
    for rank, r in enumerate(ranks):
        out = r[name]
        assert out["raised"] and "failure" in out["raised"], out["raised"]
        assert r["in_mesh4"] == (rank in W.SURVIVORS)
        if rank not in W.SURVIVORS:
            assert "remesh" not in out
            continue
        got = out["remesh"]
        assert _err(got["answer"], out["clean"]["answer"]) <= FT_TOL
        assert got["events"] == [REMESH_NOTE]
        assert got["notes"][-1] == REMESH_NOTE
        assert got["phases"] == out["clean"]["phases"]


@pytest.mark.parametrize("name", W.GENERIC)
def test_resumed_phase_cursor_matches_uninterrupted(runs, name):
    ranks, _, _ = runs
    for rank in W.SURVIVORS:
        out = ranks[rank][name]
        assert out["crash"]["phases"] == out["clean"]["phases"]
        assert out["remesh"]["phases"] == out["clean"]["phases"]
        assert len(out["clean"]["phases"]) == (2 if name == "pipeline"
                                               else 1)


# ---------------------------------------------------------------------------
# Lockstep: one rank's fault moves every rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_crash_on_one_rank_restarts_every_rank(runs, name):
    ranks, _, _ = runs
    for rank, r in enumerate(ranks):
        out = r[name]["lone"]
        assert out["fired"] == (1 if rank == W.LONE_RANK else 0)
        assert out["restarts"] == 1
        assert _err(out["answer"], r[name]["clean"]["answer"]) <= FT_TOL
        assert out["phases"] == r[name]["clean"]["phases"]
        assert out["stragglers"] == ranks[0][name]["lone"]["stragglers"]


def test_make_mesh_over_the_survivors(runs):
    """``make_data_mesh(4)`` in a world of 8 refuses (no prefix is taken
    unasked); ``make_mesh((2, 2), ranks=[4, 5, 6, 7])`` gives ranks 0-3
    ``None`` and runs collectives over both axes on ranks 4-7, in the
    mesh's order."""

    ranks, _, _ = runs
    for rank, r in enumerate(ranks):
        assert r["prefix"] and "ranks=" in r["prefix"]
        if rank in W.SURVIVORS:
            assert r["gathered"] == list(W.SURVIVORS)
            assert r["summed"] == sum(W.SURVIVORS)
            assert r["index"] == rank - W.SURVIVORS[0]
        else:
            assert "gathered" not in r


def test_failure_inside_a_step_propagates_on_a_mesh(runs):
    """C17: on a mesh a failure inside a superstep is not restored in
    process (the other ranks would be inside its collectives); it
    propagates after one try on every rank, checkpoints or not."""

    ranks, _, _ = runs
    for r in ranks:
        assert r["in_step"] == {"raised": "failure inside the step",
                                "tries": 1}


def test_no_extra_collective_without_fault_tolerance(runs):
    """A mesh run without checkpoints, injector or straggler hook makes
    the one agreed flag an iteration it made before (4 B of ``pmax``)."""

    ranks, _, _ = runs
    for r in ranks:
        sent, iterations = r["plain_pmax"]
        assert sent == 4 * iterations


def test_ranks_agree(runs):
    ranks, _, _ = runs
    for r in ranks[1:]:
        for name in W.WORKLOADS:
            for way in ("clean", "crash", "lone"):
                assert _err(r[name][way]["answer"],
                            ranks[0][name][way]["answer"]) == 0.0
                assert r[name][way]["notes"] == ranks[0][name][way]["notes"]


# ---------------------------------------------------------------------------
# remesh: notes, and onto one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_remeshed_notes_are_the_references_for_4_shards(runs, name):
    ranks, jax_side, _ = runs
    want = jax_side[name]["notes4"] + [REMESH_NOTE]
    for rank in W.SURVIVORS:
        assert ranks[rank][name]["remesh"]["notes"] == want


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_remesh_4_to_1_matches_uninterrupted(runs, name):
    ranks, _, _ = runs
    r = ranks[W.ONE_DEVICE_RANK][name]
    got = r["one_device"]
    assert _err(got["answer"], r["clean"]["answer"]) <= FT_TOL
    assert got["events"] == [REMESH_NOTE, "remesh(4->1: 1 device)"]
    assert got["notes"][-1] == "remesh(4->1: 1 device)"
    assert got["phases"] == r["clean"]["phases"]
    assert sum("one_device" in ranks[k][name] for k in range(8)) == 1


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_uninterrupted_matches_jax(runs, name):
    ranks, jax_side, _ = runs
    _jax_close(name, ranks[0][name]["clean"]["answer"],
               jax_side[name]["answer"])
    assert ranks[0][name]["clean"]["phases"] == jax_side[name]["phases"]


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_port_checkpoint_restores_in_jax(runs, name):
    """The ranks' crashed-out step directory: the JAX template's leaf
    paths, shapes and dtypes, and the values the port reads back."""

    from repro_torch.checkpoint import restore_pytree
    from repro_torch.checkpoint.store import _flatten

    _, jax_side, root = runs
    side = jax_side[name]
    man = side["manifest"]
    for key in ("leaf_paths", "shapes", "dtypes"):
        assert man[key] == side["template"][key]
    snap = str(root / name / "snapshot")
    like = _port_like(name)
    tree, _, _ = restore_pytree(snap, like)
    got = {path: t.numpy() for path, t in _flatten(tree)}
    assert list(got) == man["leaf_paths"] == list(side["restored"])
    for path, a in got.items():
        np.testing.assert_array_equal(a, side["restored"][path])


def _port_like(name):
    """The port's one-device restore template of a workload, on the CPU."""

    from repro_torch.carry import graph_from_numpy
    from repro_torch.core import listings
    from repro_torch.core.executor import Relation, compile_program
    from repro_torch.core.pregel import VertexProgram, compile_pregel

    data = W.inputs()
    if name == "sssp_weighted":
        g = graph_from_numpy(W.N, data["gsrc"], data["gdst"],
                             np.zeros(W.N, np.float32),
                             edge_data=data["weights"], device="cpu")
        vp = VertexProgram(
            init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, 1e9),
            message=lambda j, s, ed: s + ed,
            apply=lambda j, s, inbox, got: (torch.minimum(s, inbox),
                                            torch.minimum(s, inbox) < s),
            combine="min")
        return compile_pregel(vp, g, device="cpu").global_init()
    program, rels, semi = W.generic_case(
        name, data, lambda n, *c: Relation.from_columns(n, *c, device="cpu"),
        listings)
    return compile_program(program, rels, semi_naive=semi,
                           device="cpu")._ckpt_like()


@pytest.mark.parametrize("name", W.WORKLOADS)
def test_jax_resumes_the_ranks_checkpoint(runs, name):
    ranks, jax_side, _ = runs
    side = jax_side[name]
    assert _err(side["resumed"], side["answer"]) <= FT_TOL
    assert side["resumed_phases"] == side["phases"]
    _jax_close(name, ranks[0][name]["clean"]["answer"], side["resumed"])


@pytest.mark.parametrize("name", W.FROM_JAX)
def test_jax_checkpoint_resumes_on_the_ranks(runs, name):
    ranks, jax_side, _ = runs
    for r in ranks:
        got = r[name]["from_jax"]
        assert _err(got["answer"], r[name]["clean"]["answer"]) <= FT_TOL
        assert got["phases"] == r[name]["clean"]["phases"]
        _jax_close(name, got["answer"], jax_side[name]["answer"])


# ---------------------------------------------------------------------------
# IMRU: a replicated model, a crash, a straggler on one rank
# ---------------------------------------------------------------------------


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_imru_crash_restore_matches_uninterrupted(runs):
    ranks, _, _ = runs
    for r in ranks:
        imru = r["imru"]
        assert imru["crash_restarts"] == 1
        assert float(np.abs(imru["crash"] - imru["clean"]).max()) <= FT_TOL
        np.testing.assert_array_equal(imru["clean"],
                                      ranks[0]["imru"]["clean"])


def test_imru_straggler_on_one_rank_falls_back_on_every_rank(runs):
    ranks, _, _ = runs
    first = ranks[0]["imru"]
    assert first["straggle_events"] >= 1
    assert first["reduce"] == "kary_tree"
    assert len(first["fallbacks"]) == 1
    assert first["straggle_notes"][-1] == first["fallbacks"][0]
    assert first["fallbacks"][0].startswith(
        "straggler-fallback(kary_tree @ iteration ")
    for r in ranks:
        imru = r["imru"]
        assert imru["straggle_events"] == first["straggle_events"]
        assert imru["straggle_notes"] == first["straggle_notes"]
        assert imru["fallbacks"] == first["fallbacks"]
        np.testing.assert_array_equal(imru["straggle"], first["straggle"])
        assert _rel(imru["straggle"], imru["clean"]) <= REL_TOL


def test_imru_matches_jax(runs):
    ranks, jax_side, _ = runs
    assert _rel(ranks[0]["imru"]["clean"], jax_side["imru"]) <= REL_TOL
