"""The port's fault tolerance against the JAX package: the checkpoint store,
failure injection, the host driver's restore and replay, elastic
re-planning, bounded-staleness aggregation, and crash-restore and resume
of the generic engine, Pregel and IMRU.

The same numpy inputs go through both packages.  Required:

* a checkpoint written by either package restores in the other (same
  ``MANIFEST.json``, leaf order and dtype names), leaf values bit-equal;
* a crash-restore or resume run equal to the uninterrupted run of the same
  package, exactly for sets and min/max values and for the port's own f32
  values (the replay repeats the same operations on the same state), and
  within 1e-6 relative of the JAX package's f32 values (sums taken in
  another order; IMRU 1e-5, the bar of ``tests/test_torch_imru.py``);
* the fail-closed errors of the reference, with the same types and words.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:  # minimal images: deterministic fallback shim
    from _hypothesis_compat import given, settings, strategies as st

    def example(**_pinned):
        """The shim replays its own draws only: a pinned case needs
        hypothesis."""

        return lambda fn: fn

from repro.checkpoint import CheckpointStore as JaxStore
from repro.checkpoint import restore_pytree as jax_restore
from repro.checkpoint import save_pytree as jax_save
from repro.core import executor as JE
from repro.core import listings as JL
from repro.core.imru import IMRUTask as JaxIMRUTask
from repro.core.imru import compile_imru as jax_compile_imru
from repro.core.monoid import MonoidError as JaxMonoidError
from repro.core.pregel import Graph as JaxGraph
from repro.core.pregel import VertexProgram as JaxVertexProgram
from repro.core.pregel import compile_pregel as jax_compile_pregel
from repro.ft import ElasticPlanner as JaxElasticPlanner
from repro.ft import FailureInjector as JaxInjector
from repro.ft.elastic import stale_aggregate as jax_stale_aggregate
from repro_torch.carry import graph_from_numpy, imru_records_from_numpy
from repro_torch.checkpoint import (
    CheckpointStore,
    latest_step,
    restore_pytree,
    save_pytree,
)
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core.fixpoint import DriverConfig, HostFixpointDriver
from repro_torch.core.imru import IMRUTask, compile_imru
from repro_torch.core.monoid import MonoidError, get_monoid, \
    registered_monoids
from repro_torch.core.pregel import VertexProgram, compile_pregel
from repro_torch.ft import ElasticPlanner, FailureInjector
from repro_torch.ft.elastic import stale_aggregate

N = 24
RTOL = 1e-6          # f32 values against the JAX package (sum order)
IMRU_RTOL = 1e-5     # tests/test_torch_imru.py's bar

# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

# dtype name -> (torch dtype, jax dtype, numpy maker of values)
DTYPES = {
    "float32": (torch.float32, jnp.float32,
                lambda rng, s: rng.normal(size=s).astype(np.float32)),
    "bfloat16": (torch.bfloat16, jnp.bfloat16,
                 lambda rng, s: rng.normal(size=s).astype(np.float32)),
    "int32": (torch.int32, jnp.int32,
              lambda rng, s: rng.integers(-2**31, 2**31, s, np.int32)),
    "int64": (torch.int64, jnp.int64,
              lambda rng, s: rng.integers(-2**40, 2**40, s, np.int64)),
    "bool": (torch.bool, jnp.bool_,
             lambda rng, s: rng.integers(0, 2, s).astype(bool)),
    "float8_e4m3fn": (torch.float8_e4m3fn, jnp.float8_e4m3fn,
                      lambda rng, s: rng.uniform(-4, 4, s).astype(
                          np.float32)),
    "float8_e5m2": (torch.float8_e5m2, jnp.float8_e5m2,
                    lambda rng, s: rng.uniform(-4, 4, s).astype(np.float32)),
}


def _torch_tree(dtype_name, seed=0):
    """A nested tree of dicts and tuples with leaves of one dtype and the
    other leaves f32/int32/bool, as torch tensors."""

    rng = np.random.default_rng(seed)
    tdt, _, make = DTYPES[dtype_name]
    leaf = lambda s: torch.from_numpy(make(rng, s)).to(tdt)  # noqa: E731
    return {
        "params": {"w": leaf((4, 3)), "b": leaf((3,)),
                   "z": torch.from_numpy(rng.normal(size=(2,))
                                         .astype(np.float32))},
        "carry": (leaf((5,)), torch.tensor(7, dtype=torch.int32),
                  {"mask": torch.tensor([True, False, True])}),
        "step": leaf(()),
    }


def _bits(t):
    """A tensor's raw bits as numpy (bit-equality for every dtype)."""

    t = t.detach().cpu()
    if t.dtype == torch.bool:
        return t.numpy()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()]).numpy()


def _to_jax(t):
    """The JAX array of a torch tensor, bit for bit."""

    for name, (tdt, jdt, _) in DTYPES.items():
        if t.dtype == tdt and name in ("bfloat16", "float8_e4m3fn",
                                       "float8_e5m2"):
            return jax.lax.bitcast_convert_type(
                jnp.asarray(_bits(t)), jdt)
    return jnp.asarray(t.numpy())


def _jax_bits(a):
    a = np.asarray(a)
    if a.dtype == bool:
        return a
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32,
                   8: np.int64}[a.dtype.itemsize])


def _leaves(tree):
    from repro_torch.checkpoint.store import _flatten

    return [leaf for _, leaf in _flatten(tree)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_checkpoint_roundtrip_identity(tmp_path, dtype_name):
    tree = _torch_tree(dtype_name)
    save_pytree(str(tmp_path), 7, tree, extra={"data_step": 7})
    restored, step, extra = restore_pytree(str(tmp_path), like=tree)
    assert step == 7 and extra == {"data_step": 7}
    assert list(restored["params"]) == list(tree["params"])
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int32",
                                        "bool", "float8_e4m3fn"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype_name):
    tree = _torch_tree(dtype_name)
    save_pytree(str(tmp_path), 3, tree)
    like = jax.tree_util.tree_map(_to_jax, tree)
    got, step, _ = jax_restore(str(tmp_path), like=like)
    assert step == 3
    for a, b in zip(_leaves(tree), jax.tree_util.tree_leaves(got)):
        assert str(b.dtype) == str(a.dtype).split(".")[1]
        np.testing.assert_array_equal(_bits(a), _jax_bits(b))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int32",
                                        "bool", "float8_e5m2"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype_name):
    tree = _torch_tree(dtype_name, seed=1)
    jax_save(str(tmp_path), 5, jax.tree_util.tree_map(_to_jax, tree))
    got, step, _ = restore_pytree(str(tmp_path), like=tree)
    assert step == 5
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_manifest_is_the_references(tmp_path):
    """Leaf order, leaf paths (JAX's keystr), shapes and dtype names of a
    tree with int dict keys, a list, a None and a named tuple."""

    from typing import NamedTuple

    class Pair(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor

    tree = {"z": {2: torch.ones(2), 1: torch.zeros(3, dtype=torch.int64)},
            "a": [torch.zeros((), dtype=torch.bool), None,
                  Pair(torch.ones(1), torch.ones(2, dtype=torch.bfloat16))]}
    save_pytree(str(tmp_path / "port"), 0, tree)

    class JPair(NamedTuple):
        a: jax.Array
        b: jax.Array

    jtree = {"z": {2: jnp.ones(2), 1: jnp.zeros(3, jnp.int32)},
             "a": [jnp.asarray(False), None,
                   JPair(jnp.ones(1), jnp.ones(2, jnp.bfloat16))]}
    jax_save(str(tmp_path / "jax"), 0, jtree)
    read = lambda d: json.load(open(  # noqa: E731
        tmp_path / d / "step_00000000" / "MANIFEST.json"))
    port, ref = read("port"), read("jax")
    assert port["leaf_paths"] == ref["leaf_paths"] == [
        "['a'][0]", "['a'][2].a", "['a'][2].b", "['z'][1]", "['z'][2]"]
    assert port["shapes"] == ref["shapes"]
    # (JAX without x64 has no int64 leaf)
    assert port["dtypes"] == ["bool", "float32", "bfloat16", "int64",
                              "float32"]
    assert ref["dtypes"] == ["bool", "float32", "bfloat16", "int32",
                             "float32"]


def test_checkpoint_retention_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = _torch_tree("bfloat16")
    for s in (1, 2, 3, 4):
        store.save(s, tree)
    store.wait()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_checkpoint_crash_safety(tmp_path):
    """A torn write never corrupts LATEST (commit protocol)."""

    tree = _torch_tree("float32")
    save_pytree(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / ".tmp_ckpt_dead", exist_ok=True)
    with open(tmp_path / ".tmp_ckpt_dead" / "leaf_0.npy", "w") as f:
        f.write("garbage")
    _, step, _ = restore_pytree(str(tmp_path), like=tree)
    assert step == 1


def test_store_snapshot_is_taken_at_save(tmp_path):
    """The host copy is made before ``save`` returns: a later in-place
    write to the tensor does not reach the checkpoint."""

    t = torch.zeros(4)
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"t": t})
    t.add_(1.0)
    store.wait()
    got, _, _ = store.restore(like={"t": t})
    assert torch.equal(got["t"], torch.zeros(4))


def test_store_background_failure_surfaces_on_wait_and_next_save(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    store = CheckpointStore(str(blocker))
    store.save(1, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        store.wait()
    # the error is consumed once; a save into the same broken dir re-fails
    store.save(2, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        store.save(3, {"a": torch.zeros(2)})


def test_store_gc_drops_stale_lineage_from_reused_directory(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.zeros(2)}
    first = CheckpointStore(d, keep=3)
    for s in (16, 20, 24):
        first.save(s, tree)
    first.wait()
    second = CheckpointStore(d, keep=3)
    for s in (0, 4, 8):
        second.save(s, tree)
    second.wait()
    _, step, _ = second.restore(like=tree)
    assert step == 8
    left = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert left == ["step_00000000", "step_00000004", "step_00000008"]


def test_restore_treedef_mismatch_raises_the_references_error(tmp_path):
    save_pytree(str(tmp_path), 1, {"a": torch.zeros(3)})
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(ValueError) as port:
        store.restore(like={"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError) as ref:
        JaxStore(str(tmp_path)).restore(
            like={"a": jnp.zeros(3), "b": jnp.zeros(2)})
    assert "tree structure" in str(port.value)
    assert str(port.value) == str(ref.value)


def test_restore_shape_mismatch_refuses(tmp_path):
    save_pytree(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="refusing to restore"):
        restore_pytree(str(tmp_path), like={"a": torch.zeros(4)})


# ---------------------------------------------------------------------------
# The host driver and the injector
# ---------------------------------------------------------------------------


def _noop_driver(**kw):
    return HostFixpointDriver(
        step=lambda s, j: s, converged=lambda a, b: True, **kw
    )


def test_driver_config_default_is_fresh_per_instance():
    d1 = _noop_driver()
    d1.config.max_iters = 7
    d1.config.checkpoint_every = 99
    d2 = _noop_driver()
    assert d2.config.max_iters == 1000
    assert d2.config.checkpoint_every == 0
    assert d2.config.max_restarts == 3 and d2.config.keep_checkpoints == 3
    assert d2.config.checkpoint_dir is None


def test_driver_fail_at_is_instance_state():
    d1 = _noop_driver()
    d1.fail_at = 3
    d1._failed_once = True
    d2 = _noop_driver()
    assert d2.fail_at is None and d2._failed_once is False


def test_injector_crash_without_restore_raises():
    inj = FailureInjector(crashes=[2])
    driver = HostFixpointDriver(
        step=lambda s, j: s + 1.0,
        converged=lambda a, b: False,
        config=DriverConfig(max_iters=5),
        injector=inj,
    )
    with pytest.raises(RuntimeError, match="injected device failure"):
        driver.run(torch.zeros(2))
    assert inj.fired and inj.fired[0].kind == "crash"


def test_injector_straggle_is_detected_and_hook_fires():
    seen = []
    inj = FailureInjector(straggles=[(6, 0.3)])
    driver = HostFixpointDriver(
        step=lambda s, j: s + 1.0,
        converged=lambda a, b: False,
        config=DriverConfig(max_iters=10, straggler_factor=3.0),
        injector=inj,
        on_straggler=lambda j, dt: seen.append(j),
    )
    res = driver.run(torch.zeros(2))
    assert res.straggler_events >= 1
    assert 6 in seen
    assert any(e.kind == "straggle" for e in inj.fired)


def test_injector_schedule_matches_the_references():
    """Same schedule, same events fired in the same order, same errors."""

    def drive(inj):
        log = []
        for step in range(6):
            for chunk in range(3):
                try:
                    inj.maybe_fail_chunk(step, chunk)
                except RuntimeError as e:
                    log.append(str(e))
            try:
                inj.maybe_fail(step)
            except RuntimeError as e:
                log.append(str(e))
        return log, [(e.step, e.kind, e.detail) for e in inj.fired]

    kw = dict(crashes=(1, 4), straggles=((2, 0.0),),
              chunk_crashes=((3, 1), (5, 2)))
    assert drive(FailureInjector(**kw)) == drive(JaxInjector(**kw))


def _restoring_driver(max_restarts, select_step=None):
    """A counting driver with checkpoints every 2 iterations into a dict."""

    saved = {}
    driver = HostFixpointDriver(
        step=lambda s, j: s + 1.0,
        converged=lambda a, b: False,
        config=DriverConfig(max_iters=8, checkpoint_every=2,
                            max_restarts=max_restarts),
        save=lambda s, j: saved.update({j: s.clone()}),
        restore=lambda: (saved[max(saved)].clone(), max(saved)),
        select_step=select_step,
    )
    return driver, saved


def test_driver_restores_replays_and_counts_restarts():
    driver, saved = _restoring_driver(max_restarts=2)
    driver.fail_at = 5
    saved[0] = torch.zeros(2)
    res = driver.run(torch.zeros(2))
    assert res.restarts == 1 and driver.restarts == 1
    assert res.iterations == 8 and torch.equal(res.state, torch.full((2,), 8.))
    assert sorted(saved) == [0, 2, 4, 6, 8]


def test_driver_gives_up_after_max_restarts():
    inj = FailureInjector(crashes=[3, 4])
    driver, saved = _restoring_driver(max_restarts=1)
    driver.injector = inj
    saved[0] = torch.zeros(2)
    with pytest.raises(RuntimeError, match="at step 4"):
        driver.run(torch.zeros(2))
    assert driver.restarts == 2


def test_driver_truncates_mode_history_on_replay():
    labels = []
    driver, saved = _restoring_driver(
        max_restarts=1,
        select_step=lambda s, j: (lambda st, jj: st + 1.0, f"m{j}"))
    driver.fail_at = 5
    saved[0] = torch.zeros(2)
    res = driver.run(torch.zeros(2))
    labels = list(res.modes)
    assert labels == [f"m{j}" for j in range(8)]


# ---------------------------------------------------------------------------
# Elastic re-planning and bounded staleness
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(n_alive=st.integers(0, 600), tp=st.sampled_from([1, 2, 8, 16]),
       multi_pod=st.booleans())
def test_elastic_replan_matches_jax(n_alive, tp, multi_pod):
    def plan(planner):
        try:
            mesh, stranded = planner(tp).replan(n_alive, multi_pod=multi_pod)
        except RuntimeError as e:
            return str(e)
        return mesh.axes, stranded

    assert plan(ElasticPlanner) == plan(JaxElasticPlanner)


def test_elastic_replan_boundaries():
    ep = ElasticPlanner(model_axis=16)
    mesh, stranded = ep.replan(16)
    assert mesh.n_devices == 16 and stranded == 0
    assert mesh.size("data") == 1 and mesh.size("model") == 16
    with pytest.raises(RuntimeError, match="cannot host one model replica"):
        ep.replan(15)
    mesh, stranded = ep.replan(67)
    assert mesh.n_devices == 64 and stranded == 3
    mesh, _ = ep.replan(64, multi_pod=True)
    assert mesh.size("pod") == 2 and mesh.size("data") == 2
    mesh, _ = ep.replan(48, multi_pod=True)
    assert mesh.size("pod") == 1 and mesh.size("data") == 3


def _slabs(m, n_shards, seed):
    rng = np.random.default_rng(seed)
    shape = (n_shards, 5, 2) if m.structured else (n_shards, 5)
    return rng.normal(size=shape).astype(np.float32)


def _eligible(name):
    m = get_monoid(name)
    return name == "sum" or m.idempotent or bool(m.is_delta_safe)


@pytest.mark.parametrize("name", registered_monoids())
def test_stale_aggregate_matches_jax_and_fails_closed(name):
    m = get_monoid(name)
    partials = _slabs(m, 4, 0)
    mask = np.array([True, False, True, False])
    carry = m.identity_like(torch.from_numpy(partials[0])).numpy()
    args = lambda f: (f(partials), f(mask), f(carry))  # noqa: E731
    if not _eligible(name):
        with pytest.raises(MonoidError, match="failing closed"):
            stale_aggregate(*args(torch.from_numpy), monoid=name)
        with pytest.raises(JaxMonoidError, match="failing closed"):
            jax_stale_aggregate(*args(jnp.asarray), monoid=name)
        return
    out, late = stale_aggregate(*args(torch.from_numpy), monoid=name)
    j_out, j_late = jax_stale_aggregate(*args(jnp.asarray), monoid=name)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-6)
    np.testing.assert_allclose(late.numpy(), np.asarray(j_late), rtol=1e-6)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), steps=st.integers(2, 5))
def test_stale_aggregate_never_drops_contributions(seed, steps):
    """Fold of the emitted aggregates + the final carry == full reduce over
    every partial ever produced, under random arrival masks — for every
    eligible registered monoid (sum within 1e-4 relative of float64)."""

    rng = np.random.default_rng(seed)
    for name in registered_monoids():
        if not _eligible(name):
            continue
        m = get_monoid(name)
        carry = m.identity_like(torch.from_numpy(_slabs(m, 4, 0)[0]))
        outs, all_partials = [], []
        for _ in range(steps):
            p = torch.from_numpy(_slabs(m, 4, rng.integers(0, 2**31)))
            mask = torch.from_numpy(rng.integers(0, 2, 4).astype(bool))
            out, carry = stale_aggregate(p, mask, carry, monoid=name)
            outs.append(out)
            all_partials.append(p)
        every = torch.cat(all_partials)
        if name == "sum":
            total = sum(o.double() for o in outs) + carry.double()
            np.testing.assert_allclose(total.numpy(),
                                       every.double().sum(0).numpy(),
                                       rtol=1e-4, atol=1e-5)
        else:
            total = outs[0]
            for o in outs[1:] + [carry]:
                total = m.combine(total, o)
            want = every[0]
            for i in range(1, every.shape[0]):
                want = m.combine(want, every[i])
            np.testing.assert_allclose(total.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)


# Seed 3823 (n = 8) draws a last column that cancels to -1.8e-3 from terms
# near 1: torch's and numpy's f32 summation orders then differ by 6.7e-5
# relative, past any fixed rtol (ROADMAP C18).
@example(seed=3823, n=8)
@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 8))
def test_stale_aggregate_all_on_time_is_exact_sum(seed, n):
    rng = np.random.default_rng(seed)
    partials = rng.normal(size=(n, 5)).astype(np.float32)
    out, late = stale_aggregate(torch.from_numpy(partials),
                                torch.ones(n, dtype=torch.bool),
                                torch.zeros(5))
    # Every partial arrived, so out is torch's own sum of them plus a zero
    # carry, which adds exactly: bit-equal.
    assert torch.equal(out, torch.from_numpy(partials).sum(0))
    # numpy sums in another order: each of the n - 1 adds rounds once, so
    # the two differ by at most n * 2^-23 * sum|partials| in a column.
    bound = n * 2.0**-23 * np.abs(partials).sum(0)
    for col in range(5):
        np.testing.assert_allclose(out.numpy()[col], partials.sum(0)[col],
                                   rtol=1e-5, atol=bound[col])
    assert torch.equal(late, torch.zeros(5))


# ---------------------------------------------------------------------------
# The generic engine: crash-restore, the phase cursor, resume
# ---------------------------------------------------------------------------


def _tc_edges():
    rng = np.random.default_rng(0)
    return rng.integers(0, N, 40), rng.integers(0, N, 40)


def _tc(pkg, storage="dense-grid"):
    src, dst = _tc_edges()
    if pkg == "jax":
        return JE.compile_program(
            JL.transitive_closure_program(),
            {"edge": JE.Relation.from_columns(N, src, dst)},
            storage=storage)
    return TE.compile_program(
        TL.transitive_closure_program(),
        {"edge": TE.Relation.from_columns(N, src, dst, device="cpu")},
        storage=storage, device="cpu")


def _pipeline(pkg):
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, 40), rng.integers(0, N, 40)
    deg = np.maximum(np.bincount(src, minlength=N), 1).astype(np.float32)
    cols = (np.arange(N), np.full(N, 1.0 / N, np.float32), deg,
            np.full(N, 0.15 / N, np.float32))
    if pkg == "jax":
        rels = {"edge": JE.Relation.from_columns(N, src, dst),
                "node": JE.Relation.from_columns(N, *cols)}
        return lambda: JE.compile_program(
            JL.pagerank_threshold_program(tau=0.04), rels)
    rels = {"edge": TE.Relation.from_columns(N, src, dst, device="cpu"),
            "node": TE.Relation.from_columns(N, *cols, device="cpu")}
    return lambda: TE.compile_program(
        TL.pagerank_threshold_program(tau=0.04), rels, device="cpu")


def _dense(rel):
    if isinstance(rel, (TE.RowRelation, JE.RowRelation)):
        rel = rel.to_dense()
    present = np.asarray(rel.present)
    return present, {p: np.asarray(v)[present] for p, v in rel.values.items()}


def _assert_states_equal(a, b, rtol=0.0):
    """Presence exactly; values bit-equal (``rtol=0``) or within ``rtol``."""

    assert set(a) == set(b)
    for k in a:
        ap, av = _dense(a[k])
        bp, bv = _dense(b[k])
        np.testing.assert_array_equal(ap, bp, err_msg=k)
        for p in av:
            if rtol == 0.0:
                np.testing.assert_array_equal(av[p], bv[p], err_msg=k)
            else:
                np.testing.assert_allclose(av[p], bv[p], rtol=rtol, atol=0,
                                           err_msg=k)


@pytest.mark.parametrize("storage", ["dense-grid", "row-table"])
def test_executor_crash_restore_matches_uninterrupted_and_jax(tmp_path,
                                                              storage):
    clean = _tc("port", storage).run(max_iters=64)
    res = _tc("port", storage).run(
        max_iters=64, checkpoint_dir=str(tmp_path / "t"),
        checkpoint_every=2, injector=FailureInjector(crashes=[3]),
    )
    ref = _tc("jax", storage).run(
        max_iters=64, checkpoint_dir=str(tmp_path / "j"),
        checkpoint_every=2, injector=JaxInjector(crashes=[3]),
    )
    assert res.restarts == ref.restarts == 1 and res.converged
    assert res.iterations == ref.iterations == clean.iterations
    _assert_states_equal(clean.state, res.state)
    _assert_states_equal(ref.state, res.state)


def test_executor_ft_requires_host_driver(tmp_path):
    ex = _tc("port")
    with pytest.raises(TE.ExecutorError, match="host"):
        ex.run(max_iters=8, on_device=True, checkpoint_dir=str(tmp_path))
    with pytest.raises(TE.ExecutorError, match="resume"):
        ex.run(max_iters=8, resume=True)


def test_executor_phase_cursor_resume_skips_completed_phase(tmp_path):
    """Kill the pipeline inside the *reach* phase; the resumed run continues
    in that phase without re-running the rank phase — proven by arming a
    crash at a rank-phase global step that never fires.  The pipeline's
    ranks equal the uninterrupted port run's bit for bit and the JAX
    package's within 1e-6."""

    make = _pipeline("port")
    clean = make().run(max_iters=20)
    ref = _pipeline("jax")().run(max_iters=20)
    assert len(clean.phase_iterations) == 2
    rank_iters = clean.phase_iterations[0]
    d = str(tmp_path)
    with pytest.raises(RuntimeError, match="injected device failure"):
        make().run(
            max_iters=20, checkpoint_dir=d, checkpoint_every=4,
            injector=FailureInjector(crashes=[rank_iters]), max_restarts=0,
        )
    trap = FailureInjector(crashes=[2])  # global step 2 lives in rank
    res = make().run(
        max_iters=20, checkpoint_dir=d, checkpoint_every=4, resume=True,
        injector=trap,
    )
    assert res.restarts == 0
    assert trap.fired == []
    assert res.phase_iterations == clean.phase_iterations \
        == tuple(ref.phase_iterations)
    _assert_states_equal(clean.state, res.state)
    _assert_states_equal(ref.state, res.state, rtol=RTOL)


def test_executor_mid_phase_resume_matches_uninterrupted(tmp_path):
    clean = _tc("port").run(max_iters=64)
    d = str(tmp_path)
    with pytest.raises(RuntimeError):
        _tc("port").run(
            max_iters=64, checkpoint_dir=d, checkpoint_every=2,
            injector=FailureInjector(crashes=[3, 4]), max_restarts=1,
        )
    res = _tc("port").run(max_iters=64, checkpoint_dir=d, resume=True)
    assert res.converged
    assert res.phase_iterations == clean.phase_iterations
    _assert_states_equal(clean.state, res.state)


def test_executor_restore_refuses_a_checkpoint_of_another_phase(
        tmp_path, monkeypatch):
    """The restore hook's wrong-phase guard: a crash in phase 2 whose
    newest checkpoint belongs to phase 1 cannot rewind mid-driver."""

    rank_iters = _pipeline("port")().run(max_iters=20).phase_iterations[0]
    real = CheckpointStore.save

    def save(self, step, tree, extra=None):
        # phase 2's entry checkpoint, tagged as phase 1's would be
        if extra and extra.get("phase") == 2:
            extra = dict(extra, phase=1)
        return real(self, step, tree, extra)

    monkeypatch.setattr(CheckpointStore, "save", save)
    with pytest.raises(RuntimeError, match="cannot rewind into phase 2"):
        _pipeline("port")().run(
            max_iters=20, checkpoint_dir=str(tmp_path), checkpoint_every=50,
            injector=FailureInjector(crashes=[rank_iters]),
        )


@pytest.mark.parametrize("storage", ["dense-grid", "row-table"])
def test_jax_generic_checkpoint_resumes_in_the_port(tmp_path, storage):
    d = str(tmp_path)
    clean = _tc("port", storage).run(max_iters=64)
    with pytest.raises(RuntimeError):
        _tc("jax", storage).run(
            max_iters=64, checkpoint_dir=d, checkpoint_every=2,
            injector=JaxInjector(crashes=[3, 4]), max_restarts=1,
        )
    assert latest_step(d) == 4
    res = _tc("port", storage).run(max_iters=64, checkpoint_dir=d,
                                   resume=True)
    assert res.phase_iterations == clean.phase_iterations
    _assert_states_equal(clean.state, res.state)


@pytest.mark.parametrize("storage", ["dense-grid", "row-table"])
def test_port_generic_checkpoint_resumes_in_jax(tmp_path, storage):
    d = str(tmp_path)
    ref = _tc("jax", storage).run(max_iters=64)
    with pytest.raises(RuntimeError):
        _tc("port", storage).run(
            max_iters=64, checkpoint_dir=d, checkpoint_every=2,
            injector=FailureInjector(crashes=[3, 4]), max_restarts=1,
        )
    res = _tc("jax", storage).run(max_iters=64, checkpoint_dir=d,
                                  resume=True)
    assert res.phase_iterations == ref.phase_iterations
    _assert_states_equal(ref.state, res.state)


def test_jax_pipeline_checkpoint_resumes_in_the_port(tmp_path):
    """Mid-rank-phase checkpoint of the PageRank pipeline written by the
    JAX package; the port resumes it to the end (values within 1e-6 of
    both packages' uninterrupted runs: the first iterations were JAX's)."""

    d = str(tmp_path)
    with pytest.raises(RuntimeError):
        _pipeline("jax")().run(
            max_iters=20, checkpoint_dir=d, checkpoint_every=4,
            injector=JaxInjector(crashes=[9, 10]), max_restarts=1,
        )
    res = _pipeline("port")().run(max_iters=20, checkpoint_dir=d,
                                  resume=True)
    clean = _pipeline("port")().run(max_iters=20)
    assert res.phase_iterations == clean.phase_iterations
    _assert_states_equal(clean.state, res.state, rtol=RTOL)


# ---------------------------------------------------------------------------
# Pregel
# ---------------------------------------------------------------------------


def _pagerank_inputs():
    n = 48
    rng = np.random.default_rng(1)
    src, dst = [], []
    for v in range(n):
        for _ in range(int(rng.integers(1, 4))):
            src.append(v)
            dst.append(int(rng.integers(0, n)))
        src.append(int(rng.integers(0, n)))
        dst.append(v)
    src, dst = np.array(src, np.int32), np.array(dst, np.int32)
    return n, src, dst, np.bincount(src, minlength=n).astype(np.float32)


def _pagerank_ex(pkg, injector=None):
    n, src, dst, outdeg = _pagerank_inputs()
    if pkg == "jax":
        g = JaxGraph(n, jnp.asarray(src), jnp.asarray(dst),
                     jnp.asarray(outdeg))
        vp = JaxVertexProgram(
            init_vertex=lambda ids, vd: jnp.stack(
                [jnp.full((n,), 1.0 / n), vd], axis=1),
            message=lambda j, s, ed: s[:, 0] / jnp.maximum(s[:, 1], 1.0),
            apply=lambda j, s, inbox, got: (
                jnp.stack([0.15 / n + 0.85 * inbox, s[:, 1]], axis=1),
                jnp.ones(s.shape[0], jnp.bool_)),
            combine="sum",
        )
        return jax_compile_pregel(vp, g, injector=injector)
    g = graph_from_numpy(n, src, dst, outdeg, device="cpu")
    vp = VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.full((n,), 1.0 / n), vd], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / n + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool)),
        combine="sum",
    )
    return compile_pregel(vp, g, injector=injector, device="cpu")


def test_pregel_crash_restore_and_resume(tmp_path):
    ex = _pagerank_ex("port")
    clean = ex.run(max_iters=25, on_device=False)
    assert torch.equal(clean.state[0],
                       ex.run(max_iters=25).state[0])  # device driver
    d = str(tmp_path)
    res = ex.run(max_iters=25, checkpoint_dir=d, checkpoint_every=4,
                 injector=FailureInjector(crashes=[9]))
    assert res.restarts == 1
    assert torch.equal(res.state[0], clean.state[0])
    with pytest.raises(RuntimeError):
        ex.run(max_iters=25, checkpoint_dir=d, checkpoint_every=4,
               injector=FailureInjector(crashes=[10, 11]), max_restarts=1)
    res2 = ex.run(max_iters=25, checkpoint_dir=d, resume=True)
    assert res2.iterations == 25 - 8
    assert torch.equal(res2.state[0], clean.state[0])
    ref = _pagerank_ex("jax").run(max_iters=25, on_device=False)
    np.testing.assert_allclose(res2.state[0].numpy(),
                               np.asarray(ref.state[0]), rtol=RTOL)


def test_pregel_compile_time_injector_rides_the_bundle(tmp_path):
    clean = _pagerank_ex("port").run(max_iters=25, on_device=False)
    inj = FailureInjector(crashes=[5])
    ex = _pagerank_ex("port", injector=inj)
    assert ex.injector is inj
    from repro_torch.core.executor import build_pregel_steps

    bundle = build_pregel_steps(ex.prog, ex.graph, ex.plan, injector=inj)
    assert bundle.injector is inj
    res = ex.run(max_iters=25, checkpoint_dir=str(tmp_path),
                 checkpoint_every=2)
    assert res.restarts == 1 and inj.fired
    assert torch.equal(res.state[0], clean.state[0])


def test_pregel_ft_refuses_the_device_driver(tmp_path):
    ex = _pagerank_ex("port")
    with pytest.raises(ValueError, match="host"):
        ex.run(max_iters=3, on_device=True, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="resume"):
        ex.run(max_iters=3, resume=True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pregel_carry_checkpoint_restores_across_packages(tmp_path, writer):
    """A ``(state, active)`` carry written by one package resumes in the
    other: the finished ranks are within 1e-6 of both packages' clean
    runs (the first 8 supersteps ran in the writer)."""

    d = str(tmp_path)
    reader = "port" if writer == "jax" else "jax"
    crash = JaxInjector if writer == "jax" else FailureInjector
    with pytest.raises(RuntimeError):
        _pagerank_ex(writer).run(
            max_iters=25, checkpoint_dir=d, checkpoint_every=4,
            injector=crash(crashes=[10, 11]), max_restarts=1)
    assert latest_step(d) == 8
    res = _pagerank_ex(reader).run(max_iters=25, on_device=False,
                                   checkpoint_dir=d, resume=True)
    assert res.iterations == 17
    for pkg in ("jax", "port"):
        clean = _pagerank_ex(pkg).run(max_iters=25, on_device=False)
        np.testing.assert_allclose(np.asarray(res.state[0]),
                                   np.asarray(clean.state[0]), rtol=RTOL)


def test_pregel_semi_naive_crash_keeps_modes_aligned(tmp_path):
    """SSSP on the adaptive host driver: the replayed supersteps' mode
    labels replace the failed attempt's, as the reference's do."""

    n = 64
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    g = graph_from_numpy(n, src, dst, np.zeros(n, np.float32), device="cpu")
    vp = VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, 1e9),
        message=lambda j, s, ed: s + 1.0,
        apply=lambda j, s, inbox, got: (torch.minimum(s, inbox),
                                        torch.minimum(s, inbox) < s),
        combine="min",
    )
    ex = compile_pregel(vp, g, semi_naive=True, device="cpu")
    clean = ex.run(max_iters=200)
    res = ex.run(max_iters=200, checkpoint_dir=str(tmp_path),
                 checkpoint_every=5, injector=FailureInjector(crashes=[12]))
    assert res.restarts == 1
    assert res.modes == clean.modes
    assert torch.equal(res.state[0], clean.state[0])


# ---------------------------------------------------------------------------
# IMRU
# ---------------------------------------------------------------------------


def _bgd(pkg):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(128, 4)).astype(np.float32)
    y = X @ rng.normal(size=4).astype(np.float32)
    if pkg == "jax":
        task = JaxIMRUTask(
            init_model=lambda: jnp.zeros(4, jnp.float32),
            map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
            update=lambda j, m, g: m - 1e-4 * g, tol=1e-7)
        return jax_compile_imru(task, {"x": jnp.asarray(X),
                                       "y": jnp.asarray(y)})
    task = IMRUTask(
        init_model=lambda: torch.zeros(4),
        map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
        update=lambda j, m, g: m - 1e-4 * g, tol=1e-7)
    return compile_imru(task, imru_records_from_numpy({"x": X, "y": y},
                                                      device="cpu"),
                        device="cpu")


def test_imru_checkpoint_resume(tmp_path):
    ex = _bgd("port")
    clean = ex.run(max_iters=60, on_device=False)
    d = str(tmp_path)
    with pytest.raises(RuntimeError):
        ex.run(max_iters=60, checkpoint_dir=d, checkpoint_every=10,
               injector=FailureInjector(crashes=[25, 26]), max_restarts=1,
               straggler_fallback=False)
    res = ex.run(max_iters=60, checkpoint_dir=d, resume=True,
                 straggler_fallback=False)
    assert torch.equal(res.state, clean.state)
    ref = _bgd("jax").run(max_iters=60, on_device=False)
    np.testing.assert_allclose(res.state.numpy(), np.asarray(ref.state),
                               rtol=IMRU_RTOL)


def test_imru_crash_restore_on_the_default_driver(tmp_path):
    """FT options move the run to the host driver even with the default
    ``on_device=True``; a crash restores and the model is bit-equal."""

    ex = _bgd("port")
    clean = ex.run(max_iters=60)
    res = ex.run(max_iters=60, checkpoint_dir=str(tmp_path),
                 checkpoint_every=10,
                 injector=FailureInjector(crashes=[33]),
                 straggler_fallback=False)
    assert res.restarts == 1 and res.iterations == clean.iterations
    assert torch.equal(res.state, clean.state)


def test_imru_host_driver_checkpoint_restart(tmp_path):
    """The reference's driver-level restart: fail_at mid-run, restore from
    a store the caller wires, same fixpoint as the clean run and JAX's."""

    ex = _bgd("port")
    store = CheckpointStore(str(tmp_path), keep=2)

    def save(state, j):
        store.save(j, state)
        store.wait()

    def restore():
        state, j, _ = store.restore(like=ex.init())
        return state, j

    driver = ex.driver(DriverConfig(max_iters=60, checkpoint_every=10),
                       save=save, restore=restore)
    driver.fail_at = 25
    res = driver.run(ex.init())
    assert driver.restarts == 1
    clean = ex.run(max_iters=60, on_device=False)
    assert torch.equal(res.state, clean.state)
    ref = _bgd("jax").run(max_iters=60, on_device=False)
    np.testing.assert_allclose(res.state.numpy(), np.asarray(ref.state),
                               rtol=IMRU_RTOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_imru_model_checkpoint_restores_across_packages(tmp_path, writer):
    d = str(tmp_path)
    reader = "port" if writer == "jax" else "jax"
    crash = JaxInjector if writer == "jax" else FailureInjector
    with pytest.raises(RuntimeError):
        _bgd(writer).run(max_iters=60, checkpoint_dir=d,
                         checkpoint_every=10,
                         injector=crash(crashes=[25, 26]), max_restarts=1,
                         straggler_fallback=False)
    res = _bgd(reader).run(max_iters=60, checkpoint_dir=d, resume=True,
                           straggler_fallback=False)
    clean = _bgd("port").run(max_iters=60, on_device=False)
    np.testing.assert_allclose(np.asarray(res.state), clean.state.numpy(),
                               rtol=IMRU_RTOL)


def test_imru_straggler_triggers_kary_fallback():
    clean = _bgd("port").run(max_iters=60, on_device=False)
    ex = _bgd("port")
    res = ex.run(max_iters=60, on_device=False,
                 injector=FailureInjector(straggles=[(8, 0.25)]))
    assert res.straggler_events >= 1
    assert ex.straggler_fallbacks and ex.plan.reduce.kind == "kary_tree"
    assert any("straggler-fallback(kary_tree" in n for n in ex.plan.notes)
    np.testing.assert_allclose(res.state.numpy(), clean.state.numpy(),
                               rtol=IMRU_RTOL)
