"""Property suite: the port's row-table primitives and operators against
the JAX package's and against set oracles.

Every primitive of ``repro_torch.core.physical``'s row section and every
row operator of the executor runs on the same seeded slabs as its JAX
counterpart: padded slabs with the valid rows strewn among padding, empty
tables, duplicate-heavy inputs, pair expansions past their capacity and
join keys held in value columns (residual conditions).  Ids, codes,
permutations and valid masks must be exactly equal (the port's int64 codes
map to the reference's uint32 ones, its sentinel 2^32 to 0xFFFFFFFF);
values within 1e-6 relative.  The operators are also held against the set
oracles of ``tests/test_rowtable_props.py``.  Runs under ``hypothesis``
when installed, else the deterministic ``tests/_hypothesis_compat`` replay.

One test drives every index that can leave its range (a pair past the
true count, a probe past the sorted prefix, an invalid row's scatter, a
compaction's empty slot) under a torch function mode that checks every
integer index torch receives: none is negative or past its dimension.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal images: deterministic fallback shim
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import algebra as JA
from repro.core import executor as JE
from repro.core import listings as JL
from repro.core import physical as JP
from repro_torch.core import algebra as TA
from repro_torch.core import executor as TE
from repro_torch.core import listings as TL
from repro_torch.core import physical as TP

CAP = 64
RTOL = 1e-6
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _ctxs(n, row_cap=256):
    j = JE._Ctx(program=None, n=n, sigs={}, relations={}, state={},
                views={}, materialized={}, connectors={}, j=jnp.int32(0),
                row_cap=row_cap)
    t = TE._Ctx(program=None, n=n, device=CPU, sigs={}, relations={},
                state={}, views={}, materialized={}, connectors={}, j=0,
                row_cap=row_cap)
    return j, t


def _slab(dims, tuples, rng, cap=CAP, vals=None):
    """numpy ``(ids, valid, cols)`` of a padded slab holding ``tuples``,
    the valid rows strewn across random slots and the padding ids random
    (so nothing relies on zero padding)."""

    k = len(dims)
    ids = rng.integers(0, 4, (cap, k)).astype(np.int32)
    valid = np.zeros(cap, bool)
    cols = {c: rng.random(cap).astype(np.float32) for c in (vals or {})}
    for slot, t in zip(rng.permutation(cap)[: len(tuples)], tuples):
        ids[slot] = t
        valid[slot] = True
        for c in cols:
            cols[c][slot] = vals[c][t]
    return ids, valid, cols


def _both_rows(dims, slab):
    ids, valid, cols = slab
    return (
        JE._Rows(tuple(dims), jnp.asarray(ids), jnp.asarray(valid),
                 {c: jnp.asarray(v) for c, v in cols.items()}),
        TE._Rows(tuple(dims), torch.from_numpy(ids),
                 torch.from_numpy(valid),
                 {c: torch.from_numpy(v) for c, v in cols.items()}),
    )


def _assert_rows_equal(want, got):
    assert got.dims == want.dims
    np.testing.assert_array_equal(_np(got.valid), _np(want.valid))
    np.testing.assert_array_equal(_np(got.ids), _np(want.ids))
    assert set(got.cols) == set(want.cols)
    valid = _np(got.valid)
    for c in want.cols:
        np.testing.assert_allclose(
            _np(got.cols[c]).reshape(-1)[valid],
            _np(want.cols[c]).reshape(-1)[valid], rtol=RTOL, atol=0)


def _out_tuples(rows):
    return set(map(tuple, _np(rows.ids)[_np(rows.valid)].tolist()))


def _rand_rel(rng, n, k, m):
    if m == 0:
        return set()
    return set(map(tuple, rng.integers(0, n, (m, k)).tolist()))


def _codes(rng, cap, n, k, dup):
    """A code slab of ``cap`` rows over ``n**k`` codes: mostly duplicates
    when ``dup``, with the largest code present."""

    hi = n ** k
    pool = rng.integers(0, hi, max(cap // 8, 1) if dup else cap)
    codes = rng.choice(pool, cap).astype(np.int64)
    if cap:
        codes[rng.integers(cap)] = hi - 1
    return codes


def _jax_key(sorted_key, n_valid):
    """The reference's sorted key with its sentinel (the invalid suffix)
    mapped to the port's."""

    key = _np(sorted_key).astype(np.int64)
    key[int(n_valid):] = TP._ROW_SENTINEL
    return key


# ---------------------------------------------------------------------------
# Primitives against the reference's
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 63), n=st.sampled_from([3, 16, 65536]),
       k=st.sampled_from([0, 1, 2]))
def test_row_codes_match_jax(seed, n, k):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (CAP, k)).astype(np.int32)
    got = TP.row_codes(torch.from_numpy(ids), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), _np(JP.row_codes(jnp.asarray(ids), n)).astype(np.int64))


def test_row_codes_keep_the_reference_guard():
    ids = np.zeros((4, 3), np.int32)
    with pytest.raises(ValueError) as want:
        JP.row_codes(jnp.asarray(ids), 2048)
    with pytest.raises(ValueError) as got:
        TP.row_codes(torch.from_numpy(ids), 2048)
    assert str(got.value) == str(want.value)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 63), cap=st.sampled_from([0, 1, 64]),
       density=st.sampled_from([0.0, 0.3, 1.0]), dup=st.booleans(),
       n=st.sampled_from([16, 65536]))
def test_sort_and_unique_runs_match_jax(seed, cap, density, dup, n):
    # n = 65536 puts the largest code, 2^32 - 1, among valid rows: the
    # reference's sentinel value, which its sort breaks ties on.
    rng = np.random.default_rng(seed)
    codes = _codes(rng, cap, n, 2, dup)
    valid = rng.random(cap) < density
    perm, skey, nv = TP.sort_row_codes(torch.from_numpy(codes),
                                       torch.from_numpy(valid))
    jperm, jskey, jnv = JP.sort_row_codes(
        jnp.asarray(codes.astype(np.uint32)), jnp.asarray(valid))
    np.testing.assert_array_equal(perm.numpy(), _np(jperm))
    np.testing.assert_array_equal(skey.numpy(), _jax_key(jskey, jnv))
    assert int(nv) == int(jnv) == int(valid.sum())
    is_new, seg = TP.unique_row_runs(skey, nv)
    jnew, jseg = JP.unique_row_runs(jskey, jnv)
    np.testing.assert_array_equal(is_new.numpy(), _np(jnew))
    np.testing.assert_array_equal(seg.numpy(), _np(jseg))
    # Set oracle: the first-occurrence rows are the distinct valid codes.
    np.testing.assert_array_equal(
        np.sort(skey.numpy()[is_new.numpy()]), np.unique(codes[valid]))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 63), lcap=st.sampled_from([1, 64]),
       rcap=st.sampled_from([1, 64]), out_cap=st.sampled_from([8, 256]),
       dup=st.booleans())
def test_join_row_codes_matches_jax_and_pair_oracle(seed, lcap, rcap,
                                                    out_cap, dup):
    rng = np.random.default_rng(seed)
    lc, rc = _codes(rng, lcap, 4, 2, dup), _codes(rng, rcap, 4, 2, dup)
    lv, rv = rng.random(lcap) < 0.8, rng.random(rcap) < 0.8
    got = TP.join_row_codes(torch.from_numpy(lc), torch.from_numpy(lv),
                            torch.from_numpy(rc), torch.from_numpy(rv),
                            out_cap)
    want = JP.join_row_codes(
        jnp.asarray(lc.astype(np.uint32)), jnp.asarray(lv),
        jnp.asarray(rc.astype(np.uint32)), jnp.asarray(rv), out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    li, ri, valid, ov = (_np(x) for x in got)
    pairs = sorted((a, b) for a in range(lcap) for b in range(rcap)
                   if lv[a] and rv[b] and lc[a] == rc[b])
    assert bool(ov) == (len(pairs) > out_cap)
    if not ov:
        assert sorted(zip(li[valid].tolist(), ri[valid].tolist())) == pairs


def test_join_row_codes_with_an_empty_side():
    for lcap, rcap in ((0, 5), (5, 0), (0, 0)):
        li, ri, valid, ov = TP.join_row_codes(
            torch.zeros(lcap, dtype=torch.int64),
            torch.ones(lcap, dtype=torch.bool),
            torch.zeros(rcap, dtype=torch.int64),
            torch.ones(rcap, dtype=torch.bool), 4)
        assert li.shape == ri.shape == valid.shape == (4,)
        assert not valid.any() and not ov


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 63), lcap=st.sampled_from([1, 64]),
       rcap=st.sampled_from([0, 1, 64]), dup=st.booleans())
def test_difference_row_codes_matches_jax(seed, lcap, rcap, dup):
    rng = np.random.default_rng(seed)
    lc, rc = _codes(rng, lcap, 8, 2, dup), _codes(rng, rcap, 8, 2, dup)
    lv, rv = rng.random(lcap) < 0.8, rng.random(rcap) < 0.8
    got = TP.difference_row_codes(torch.from_numpy(lc), torch.from_numpy(lv),
                                  torch.from_numpy(rc), torch.from_numpy(rv))
    rset = set(rc[rv].tolist())
    np.testing.assert_array_equal(
        got.numpy(), lv & np.array([c not in rset for c in lc.tolist()]))
    if rcap:
        np.testing.assert_array_equal(got.numpy(), _np(JP.difference_row_codes(
            jnp.asarray(lc.astype(np.uint32)), jnp.asarray(lv),
            jnp.asarray(rc.astype(np.uint32)), jnp.asarray(rv))))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 63), shape=st.sampled_from([(), (7,), (5, 6),
                                                       (3, 4, 2)]),
       cap=st.sampled_from([1, 16, 128]), density=st.sampled_from(
           [0.0, 0.2, 1.0]))
def test_grid_row_converters_match_jax(seed, shape, cap, density):
    rng = np.random.default_rng(seed)
    present = rng.random(shape) < density
    got = TP.grid_to_rows(torch.from_numpy(np.asarray(present)), cap)
    want = JP.grid_to_rows(jnp.asarray(present), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    ids, valid = got[0], got[1]
    if not shape:
        assert bool(TP.rows_to_grid(ids, valid, 5)) == bool(present)
        return
    n = max(shape)
    grid = np.zeros((n,) * len(shape), bool)
    grid[tuple(slice(0, d) for d in shape)] = present
    if not bool(got[3]):
        back = TP.rows_to_grid(ids, valid, n).numpy()
        np.testing.assert_array_equal(back, grid)
    lin = TP.row_linear_index(ids, valid, n)
    np.testing.assert_array_equal(
        lin.numpy(), _np(JP.row_linear_index(jnp.asarray(ids.numpy()),
                                             jnp.asarray(valid.numpy()), n)))
    np.testing.assert_array_equal(
        TP.rows_to_grid(ids, valid, n).numpy(),
        _np(JP.rows_to_grid(jnp.asarray(ids.numpy()),
                            jnp.asarray(valid.numpy()), n)))


# ---------------------------------------------------------------------------
# Operators against the reference's and the set oracles
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 31), n=st.sampled_from([4, 8, 16]),
       lm=st.sampled_from([0, 3, 20]), rm=st.sampled_from([0, 5, 20]),
       row_cap=st.sampled_from([16, 256]))
def test_join_rows_matches_jax_and_set_oracle(seed, n, lm, rm, row_cap):
    rng = np.random.default_rng(seed)
    left = _rand_rel(rng, n, 2, lm)   # (X, Y)
    right = _rand_rel(rng, n, 2, rm)  # (Y, Z)
    vals = {"W": {t: float(rng.random()) for t in left}}
    jl, tl = _both_rows(("X", "Y"), _slab(("X", "Y"), sorted(left), rng,
                                          vals=vals))
    jr, tr = _both_rows(("Y", "Z"), _slab(("Y", "Z"), sorted(right), rng))
    jctx, tctx = _ctxs(n, row_cap)
    want = JE._join_rows(jl, jr, ("Y",), jctx)
    got = TE._join_rows(tl, tr, ("Y",), tctx)
    _assert_rows_equal(want, got)
    oracle = {(x, y, z) for (x, y) in left for (y2, z) in right if y == y2}
    overflow = any(bool(f) for f in tctx.overflow)
    assert overflow == (len(oracle) > row_cap)
    if not overflow:
        assert _out_tuples(got) == oracle


def test_join_rows_residual_value_equality_matches_jax():
    # "W" is a value column on the left but a dim on the right: no shared
    # dims, so the code join is a cross product and the residual filter
    # enforces left.W == right.W.
    rng = np.random.default_rng(3)
    jl, tl = _both_rows(("X",), _slab(("X",), [(1,), (2,)], rng,
                                      vals={"W": {(1,): 5.0, (2,): 6.0}}))
    jr, tr = _both_rows(("W",), _slab(("W",), [(5,), (7,)], rng))
    jctx, tctx = _ctxs(8)
    got = TE._join_rows(tl, tr, ("W",), tctx)
    _assert_rows_equal(JE._join_rows(jl, jr, ("W",), jctx), got)
    assert _out_tuples(got) == {(1, 5)}


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 31), n=st.sampled_from([4, 8, 16]),
       lm=st.sampled_from([0, 4, 24]), rm=st.sampled_from([0, 4, 24]),
       residual=st.booleans())
def test_antijoin_rows_matches_jax_and_set_difference(seed, n, lm, rm,
                                                      residual):
    rng = np.random.default_rng(seed)
    left = _rand_rel(rng, n, 2, lm)   # (X, Y)
    right = _rand_rel(rng, n, 1, rm)  # (Y,), or (W,) on the residual path
    vals = {"W": {t: float(t[1]) for t in left}} if residual else None
    jl, tl = _both_rows(("X", "Y"), _slab(("X", "Y"), sorted(left), rng,
                                          vals=vals))
    rdim = ("W",) if residual else ("Y",)
    jr, tr = _both_rows(rdim, _slab(rdim, sorted(right), rng))
    jctx, tctx = _ctxs(n, row_cap=1024)
    keys = ("W",) if residual else ("Y",)
    got = TE._antijoin_rows(tl, tr, keys, tctx)
    _assert_rows_equal(JE._antijoin_rows(jl, jr, keys, jctx), got)
    assert _out_tuples(got) == {(x, y) for (x, y) in left
                                if (y,) not in right}


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 31), n=st.sampled_from([4, 8, 16]),
       m=st.sampled_from([0, 6, 32]), keep=st.sampled_from([("X",), ()]))
def test_project_rows_matches_jax_and_dedupes(seed, n, m, keep):
    # Duplicate-heavy by construction: many (X, Y) rows collapse onto the
    # same X once Y is projected away.
    rng = np.random.default_rng(seed)
    rel = _rand_rel(rng, n, 2, m)
    jc, tc = _both_rows(("X", "Y"), _slab(("X", "Y"), sorted(rel), rng))
    jctx, tctx = _ctxs(n)
    got = TE._project_rows(TA.Project(keep, None), tc, tctx)
    _assert_rows_equal(JE._project_rows(JA.Project(keep, None), jc, jctx),
                       got)
    assert _out_tuples(got) == {tuple(t[:len(keep)]) for t in rel}


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 15), agg=st.sampled_from(["sum", "min", "max"]),
       m=st.sampled_from([0, 5, 40]), big=st.booleans())
def test_groupby_rows_matches_jax_and_numpy_oracle(seed, agg, m, big):
    # big=True pushes n**k past the grid-lowering threshold so the
    # segmented sorted-combine path runs; big=False takes the dense
    # grid-reduce lowering.  Both must match the reference and the oracle.
    n = 2048 if big else 16
    rng = np.random.default_rng(seed)
    rel = sorted(_rand_rel(rng, n, 2, m))
    vals = {"V": {t: float(np.float32(rng.random())) for t in rel}}
    jc, tc = _both_rows(("X", "Y"), _slab(("X", "Y"), rel, rng, vals=vals))
    jctx, tctx = _ctxs(n)
    got = TE._groupby_rows(TA.GroupBy(None, ("X",), agg, "V", "acc"), tc,
                           tctx)
    _assert_rows_equal(JE._groupby_rows(
        JA.GroupBy(None, ("X",), agg, "V", "acc"), jc, jctx), got)
    combine = {"sum": lambda a: float(np.sum(np.asarray(a, np.float32))),
               "min": min, "max": max}[agg]
    oracle = {}
    for (x, y) in rel:
        oracle.setdefault(x, []).append(vals["V"][(x, y)])
    oracle = {x: combine(vs) for x, vs in oracle.items()}
    valid = got.valid.numpy()
    got_ids = got.ids.numpy()[valid][:, 0]
    got_vals = got.cols["acc"].numpy()[valid]
    assert set(got_ids.tolist()) == set(oracle)
    for x, v in zip(got_ids.tolist(), got_vals.tolist()):
        assert abs(v - oracle[x]) <= 1e-6 * max(1.0, abs(oracle[x])), (x, agg)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 31), n=st.sampled_from([4, 8]),
       m=st.sampled_from([0, 5, 30]), k=st.sampled_from([0, 1, 2]))
def test_boundary_converters_match_jax(seed, n, m, k):
    rng = np.random.default_rng(seed)
    dims = ("X", "Y")[:k]
    rel = sorted(_rand_rel(rng, n, k, m)) if k else ([()] if m else [])
    vals = {"V": {t: float(rng.random()) for t in rel}}
    jc, tc = _both_rows(dims, _slab(dims, rel, rng, vals=vals))
    jctx, tctx = _ctxs(n, row_cap=16)
    ji, ti = JE._rows_to_inter(jc, jctx), TE._rows_to_inter(tc, tctx)
    np.testing.assert_array_equal(_np(ti.present), _np(ji.present))
    np.testing.assert_allclose(_np(ti.cols["V"]), _np(ji.cols["V"]),
                               rtol=RTOL, atol=0)
    _assert_rows_equal(JE._inter_to_rows(ji, jctx),
                       TE._inter_to_rows(ti, tctx))
    assert [bool(f) for f in tctx.overflow] == \
        [bool(f) for f in jctx.overflow]


# ---------------------------------------------------------------------------
# The executable's row merge, diff and re-slab against the reference's
# ---------------------------------------------------------------------------


def _row_executables(n=8):
    src, dst = np.arange(n - 1), np.arange(1, n)
    j = JE.compile_program(
        JL.transitive_closure_program(),
        {"edge": JE.Relation.from_columns(n, src, dst)}, storage="row-table")
    t = TE.compile_program(
        TL.transitive_closure_program(),
        {"edge": TE.Relation.from_columns(n, src, dst, device="cpu")},
        storage="row-table", device="cpu")
    return j, t


def _outs(rng, n, cap, m, with_vals):
    rel = sorted(_rand_rel(rng, n, 2, m))
    vals = {"V": {t: float(rng.random()) for t in rel}} if with_vals else None
    ids, valid, cols = _slab(("X", "Y"), rel, rng, cap=cap, vals=vals)
    return ids, valid, {2: cols["V"]} if with_vals else {}


def _both_out(out):
    ids, valid, vals = out
    return (
        {"ids": jnp.asarray(ids), "present": jnp.asarray(valid),
         "values": {p: jnp.asarray(v) for p, v in vals.items()}},
        {"ids": torch.from_numpy(ids), "present": torch.from_numpy(valid),
         "values": {p: torch.from_numpy(v) for p, v in vals.items()}},
    )


def _assert_out_equal(want, got):
    np.testing.assert_array_equal(got["present"].numpy(),
                                  _np(want["present"]))
    np.testing.assert_array_equal(got["ids"].numpy(), _np(want["ids"]))
    valid = got["present"].numpy()
    for p in want["values"]:
        np.testing.assert_allclose(got["values"][p].numpy()[valid],
                                   _np(want["values"][p])[valid],
                                   rtol=RTOL, atol=0)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 31), m=st.sampled_from([0, 6, 40]),
       agg=st.sampled_from(["sum", "min", "max"]),
       new_cap=st.sampled_from([16, 64, 128]))
def test_merge_and_diff_rows_match_jax(seed, m, agg, new_cap):
    rng = np.random.default_rng(seed)
    n = 8
    j, t = _row_executables(n)
    for ex in (j, t):
        ex.sigs = dict(ex.sigs, acc=((0, 1), (2,)))
        ex.row_caps = dict(ex.row_caps, acc=new_cap)
        ex.merge_monoids = dict(ex.merge_monoids, acc=agg)
    a, b = _both_out(_outs(rng, n, 64, m, True)), \
        _both_out(_outs(rng, n, 32, m, True))
    jctx, tctx = j._ctx({}, {}, {}, jnp.int32(0)), t._ctx({}, {}, {}, 0)
    want = j._merge_rows("acc", [a[0], b[0]], jctx)
    got = t._merge_rows("acc", [a[1], b[1]], tctx)
    _assert_out_equal(want, got)
    assert [bool(f) for f in tctx.overflow] == \
        [bool(f) for f in jctx.overflow]
    # Diff of the merge against one of its parts, both ways round.
    for old, new in ((a, (want, got)), ((want, got), a)):
        jd, jc = j._diff_rows(old[0], new[0])
        td, tch = t._diff_rows(old[1], new[1])
        np.testing.assert_array_equal(td.numpy(), _np(jd))
        assert bool(tch) == bool(jc)
    # Re-slab to a smaller and a larger capacity.
    for cap in (8, 256):
        jctx, tctx = j._ctx({}, {}, {}, jnp.int32(0)), t._ctx({}, {}, {}, 0)
        _assert_out_equal(j._resize_rows(a[0], cap, jctx),
                          t._resize_rows(a[1], cap, tctx))
        assert [bool(f) for f in tctx.overflow] == \
            [bool(f) for f in jctx.overflow]


# ---------------------------------------------------------------------------
# Sentinel indices never reach torch out of range
# ---------------------------------------------------------------------------


class _IndexAudit(TorchFunctionMode):
    """Checks every integer index tensor that indexing, gathers and
    scatters receive: each must lie in ``[0, size)`` of its dimension
    (torch raises past the end on the CPU and device-asserts on CUDA, and
    wraps a negative index silently)."""

    def __init__(self):
        super().__init__()
        self.checked = 0

    def _check(self, t, dim, index):
        if not (isinstance(index, torch.Tensor) and index.numel()
                and not index.dtype.is_floating_point
                and index.dtype != torch.bool):
            return
        self.checked += 1
        lo, hi = int(index.min()), int(index.max())
        assert 0 <= lo and hi < t.shape[dim], \
            f"index [{lo}, {hi}] on a dimension of {t.shape[dim]}"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            t, idx = args[0], args[1]
            idx = idx if isinstance(idx, tuple) else (idx,)
            for dim, index in enumerate(idx):
                self._check(t, dim, index)
        elif func in (torch.Tensor.index_select, torch.index_select,
                      torch.Tensor.index_add_):
            self._check(args[0], args[1], args[2])
        elif func is torch.Tensor.scatter_reduce_:
            self._check(args[0], args[1], args[2])
        return func(*args, **kwargs)


def test_sentinel_indices_stay_in_range():
    rng = np.random.default_rng(0)
    n = 8
    with _IndexAudit() as audit:
        # join: left codes past every right code (probe past the sorted
        # prefix), slots past the pair count, invalid rows on both sides.
        lc = torch.tensor([63, 5, 63, 2], dtype=torch.int64)
        rc = torch.tensor([5, 2, 9], dtype=torch.int64)
        li, ri, valid, ov = TP.join_row_codes(
            lc, torch.tensor([True, True, False, True]), rc,
            torch.tensor([True, True, False]), 16)
        assert valid.sum() == 2 and not ov
        # difference: probes past the end, and a right side all invalid.
        keep = TP.difference_row_codes(lc, torch.ones(4, dtype=torch.bool),
                                       rc, torch.zeros(3, dtype=torch.bool))
        assert keep.all()
        # rows_to_grid / _rows_to_inter: invalid rows scatter to n**k.
        ids = torch.tensor([[7, 7], [1, 2], [0, 0]], dtype=torch.int32)
        vld = torch.tensor([False, True, False])
        assert TP.rows_to_grid(ids, vld, n).sum() == 1
        jctx, tctx = _ctxs(n, row_cap=4)
        rows = TE._Rows(("X", "Y"), ids, vld, {"V": torch.ones(3)})
        assert TE._rows_to_inter(rows, tctx).present.sum() == 1
        # _antijoin_rows with a residual key: unmatched slots go to cap_l.
        left = TE._Rows(("X",), torch.tensor([[1], [2], [3]],
                                             dtype=torch.int32),
                        torch.tensor([True, True, False]),
                        {"W": torch.tensor([5.0, 6.0, 5.0])})
        right = TE._Rows(("W",), torch.tensor([[5], [7]], dtype=torch.int32),
                         torch.tensor([True, False]), {})
        out = TE._antijoin_rows(left, right, ("W",), tctx)
        assert out.valid.tolist() == [False, True, False]
        # The executable's diff (probes past the old table) and re-slab
        # (empty compaction slots).
        j, t = _row_executables(n)
        old = _both_out(_outs(rng, n, 16, 3, False))[1]
        new = _both_out(_outs(rng, n, 16, 9, False))[1]
        old["ids"][old["present"]] = 0
        new["ids"][new["present"]] = n - 1
        delta, changed = t._diff_rows(old, new)
        assert bool(changed) and bool((delta == new["present"]).all())
        small = t._resize_rows(old, 4, t._ctx({}, {}, {}, 0))
        assert small["present"].sum() == min(4, int(old["present"].sum()))
        # grid_to_rows: empty slots past the present cells.
        g = torch.zeros((n, n), dtype=torch.bool)
        g[1, 2] = True
        ids2, valid2, lin, _ = TP.grid_to_rows(g, 8)
        assert valid2.sum() == 1 and ids2[0].tolist() == [1, 2]
    assert audit.checked >= 10
