"""The port's single-device physical operators against their JAX twins.

Each function of ``repro_torch.core.physical`` gets the same numpy inputs
as ``repro.core.physical``.  Sums agree within 1e-6 relative; max/min are
compared exactly on the rows that got a message (empty rows differ by path,
ROADMAP C4); index ops compare exactly.  The out-of-range spill row (C1)
and stable-sort ties (C2) are covered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import physical as jp
from repro_torch.core import physical as tp
from repro_torch.core.monoid import generic_segment_combine, get_monoid

RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _got_rows(ids, n, act=None):
    keep = (ids >= 0) & (ids < n)
    if act is not None:
        keep &= act
    got = np.zeros(n, bool)
    got[ids[keep]] = True
    return got


def _assert_match(got, want, op, rows):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    else:
        np.testing.assert_array_equal(got[rows], want[rows])


def _slab(seed, E=300, N=41, F=None, sort=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, E).astype(np.int32)
    if sort:
        ids = np.sort(ids)
    shape = (E,) if F is None else (E, F)
    vals = rng.normal(size=shape).astype(np.float32)
    act = rng.random(E) < 0.6
    return ids, vals, act, N


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_segment_combine_sorted_matches_jax(op, masked):
    ids, vals, act, N = _slab(1, F=3, sort=True)
    act = act if masked else None
    want = jp.segment_combine_sorted(
        jnp.asarray(vals), jnp.asarray(ids), N, op,
        edge_active=None if act is None else jnp.asarray(act))
    got = tp.segment_combine_sorted(
        _t(vals), _t(ids), N, op,
        edge_active=None if act is None else _t(act))
    _assert_match(got, want, op, _got_rows(ids, N, act))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_scatter_combine_spill_row_and_negative_ids_match_jax(op):
    ids, vals, act, N = _slab(2)
    ids[:7] = N          # the out-of-range spill id (C1): dropped
    ids[7:9] = N + 5     # beyond it: dropped too
    ids[9:12] = -1       # negative ids count from the end, as in XLA
    want = jp.scatter_combine(jnp.asarray(vals), jnp.asarray(ids), N, op,
                              edge_active=jnp.asarray(act))
    got = tp.scatter_combine(_t(vals), _t(ids), N, op, edge_active=_t(act))
    wrapped = np.where(ids < 0, ids + N, ids)
    _assert_match(got, want, op, _got_rows(wrapped, N, act))
    if op != "sum":
        # the plain scatter matches XLA on empty rows too (+-inf)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_merging_ties_keep_arrival_order():
    # Many rows per destination with magnitudes far apart: the f32 sum
    # depends on the order of addition, so only a stable sort (C2) gives
    # the reference's result bit for bit.
    rng = np.random.default_rng(3)
    E, N = 4000, 5
    ids = rng.integers(0, N, E).astype(np.int32)
    vals = (rng.normal(size=E) * 10.0 ** rng.integers(-4, 5, E)).astype(
        np.float32)
    want = jp.merging_exchange(jnp.asarray(ids), jnp.asarray(vals), N, ())
    got = tp.merging_exchange(_t(ids), _t(vals), N, ())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jp.hash_sort_exchange(jnp.asarray(ids), jnp.asarray(vals), N, ())
    got = tp.hash_sort_exchange(_t(ids), _t(vals), N, ())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_index_join_matches_jax():
    rng = np.random.default_rng(4)
    state = rng.normal(size=(50, 3)).astype(np.float32)
    ids = rng.integers(0, 50, 200).astype(np.int32)
    want = jp.index_join(jnp.asarray(state), jnp.asarray(ids))
    got = tp.index_join(_t(state), _t(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", [1, 16, 64, 300])
@pytest.mark.parametrize("E", [0, 1, 97, 250])
def test_compact_active_edges_matches_jax(E, cap):
    mask = np.random.default_rng(E + cap).random(E) < 0.3
    want_idx, want_valid = jp.compact_active_edges(jnp.asarray(mask), cap)
    got_idx, got_valid = tp.compact_active_edges(_t(mask), cap)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


EXCHANGES = ["dense_psum", "merging", "hash_sort"]


def _exchange(mod, name):
    return {
        "dense_psum": mod.dense_psum_exchange,
        "merging": mod.merging_exchange,
        "hash_sort": mod.hash_sort_exchange,
    }[name]


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("name", EXCHANGES)
def test_exchanges_match_jax(name, op):
    ids, vals, act, N = _slab(5, F=2)
    want = _exchange(jp, name)(jnp.asarray(ids), jnp.asarray(vals), N, (),
                               op, edge_mask=jnp.asarray(act))
    got = _exchange(tp, name)(_t(ids), _t(vals), N, (), op,
                              edge_mask=_t(act))
    _assert_match(got, want, op, _got_rows(ids, N, act))


@pytest.mark.parametrize("op", ["sum", "max", "min", "argmin", "mean"])
@pytest.mark.parametrize("name", ["dense_psum", "merging", "hash_sort"])
def test_fused_got_exchange_matches_jax(name, op):
    ids, vals, valid, N = _slab(6, E=200, N=29, F=2)
    if op == "argmin":
        vals[:, 0] = np.round(vals[:, 0])   # key ties exercise the payload

    def sparse(mod):
        if name == "dense_psum":
            return lambda d, f, v: mod.dense_psum_exchange(
                d, f, N, (), op, edge_mask=v, flag_cols=1)
        ex = (mod.sparse_merging_exchange if name == "merging"
              else mod.sparse_hash_sort_exchange)
        return lambda d, f, v: ex(d, f, v, N, (), op, flag_cols=1)

    j_ex, t_ex = sparse(jp), sparse(tp)
    ji, jv, jvalid = jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(valid)
    ti, tv, tvalid = _t(ids), _t(vals), _t(valid)
    want_inbox, want_got = jax.jit(lambda v, m: jp.fused_got_exchange(
        lambda fused: j_ex(ji, fused, m), v, m, op))(jv, jvalid)
    got_inbox, got = tp.fused_got_exchange(
        lambda fused: t_ex(ti, fused, tvalid), tv, tvalid, op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_got))
    rows = np.asarray(want_got)
    if op in ("sum", "mean"):
        np.testing.assert_allclose(got_inbox.numpy()[rows],
                                   np.asarray(want_inbox)[rows],
                                   rtol=RTOL, atol=RTOL)
    else:
        np.testing.assert_array_equal(got_inbox.numpy()[rows],
                                      np.asarray(want_inbox)[rows])


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("name", ["argmin", "logsumexp", "topk"])
def test_generic_segment_combine_matches_jax(name, presorted):
    from repro.core.monoid import (
        generic_segment_combine as jax_generic,
        get_monoid as jax_get_monoid,
    )

    rng = np.random.default_rng(7)
    E, N, W = 120, 13, 3
    ids = rng.integers(-1, N + 1, E).astype(np.int32)
    if presorted:
        ids = np.sort(ids)
    vals = rng.normal(size=(E, W)).astype(np.float32)
    if name == "topk":
        vals = -np.sort(-vals, axis=1)
    if name == "argmin":
        vals[:, 0] = np.round(vals[:, 0])
    act = rng.random(E) < 0.8
    want = jax.jit(lambda v, i, a: jax_generic(
        v, i, N, jax_get_monoid(name), edge_active=a, presorted=presorted,
    ))(jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(act))
    got = generic_segment_combine(_t(vals), _t(ids), N, get_monoid(name),
                                  edge_active=_t(act), presorted=presorted)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_sharded_axes_raise():
    """Axes that no mesh binds are absent, as outside ``shard_map``: the
    connectors run their one-device form, as the JAX package's do
    (sharded runs: tests/test_torch_spmd.py); a named-axis collective
    itself raises ``NameError`` there, as ``lax.axis_index`` does."""

    from repro_torch.parallel import collectives

    ids, vals, act, N = _slab(8)
    for name in EXCHANGES:
        want = _exchange(jp, name)(jnp.asarray(ids), jnp.asarray(vals), N,
                                   ("data",))
        got = _exchange(tp, name)(_t(ids), _t(vals), N, ("data",))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(NameError):
        collectives.axis_index("data")
    with pytest.raises(NameError):
        collectives.psum(_t(vals), ("data",))


@pytest.mark.parametrize("name", ["sum", "max", "min", "argmin", "topk",
                                  "mean", "logsumexp"])
def test_builtin_monoids_pass_the_law_check(name):
    from repro_torch.core.monoid import check_monoid

    check_monoid(get_monoid(name))


def test_register_monoid_fails_closed():
    from repro_torch.core.monoid import (
        CombineMonoid,
        MonoidError,
        register_monoid,
        registered_monoids,
    )

    bad = CombineMonoid("torch-test-sub", combine=torch.sub, identity=0.0)
    with pytest.raises(MonoidError, match="commutative|identity"):
        register_monoid(bad)
    assert "torch-test-sub" not in registered_monoids()
    with pytest.raises(MonoidError, match="kernel_op"):
        register_monoid(CombineMonoid("torch-test-op", combine=torch.add,
                                      identity=0.0, kernel_op="prod"))


@pytest.mark.parametrize("shape", [(0,), (0, 3), (0, 2, 2)])
@pytest.mark.parametrize("op", ["sum", "max", "min", "argmin"])
@pytest.mark.parametrize("fn", ["segment_combine_sorted", "scatter_combine"])
def test_zero_row_combines_match_jax(fn, op, shape):
    # ROADMAP C9: 0 rows give the identity-filled [n, ...] output, as in the
    # reference (exact: no value is combined).
    if op == "argmin" and shape != (0, 2):
        shape = (0, 2)  # the structured monoid takes [rows, 2] slabs only
    vals = np.zeros(shape, np.float32)
    ids = np.zeros(0, np.int32)
    want = getattr(jp, fn)(jnp.asarray(vals), jnp.asarray(ids), 5, op)
    got = getattr(tp, fn)(_t(vals), _t(ids), 5, op)
    assert tuple(got.shape) == (5,) + shape[1:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["dense_psum", "merging", "hash_sort"])
def test_zero_edge_fused_got_exchange_gets_nothing(name):
    # The reference's reshape(E, -1) refuses 0 rows here, so the port is
    # held to the result it must have: a zero inbox and no vertex got.
    ex = getattr(tp, f"{name}_exchange")
    ids = torch.zeros(0, dtype=torch.int32)
    inbox, got = tp.fused_got_exchange(
        lambda f: ex(ids, f, 6, (), "sum", flag_cols=1),
        torch.zeros((0, 2)), torch.zeros(0, dtype=torch.bool), "sum")
    assert torch.equal(inbox, torch.zeros((6, 2)))
    assert not bool(got.any()) and tuple(got.shape) == (6,)
