"""The generic engine's explicit row exchanges on a mesh, in the port
against the JAX package's 8-device runs.

One module fixture runs two things at once on the same numpy inputs made
from seeds (``_spmd_generic_workloads.py``): a subprocess of the JAX
package with 8 virtual CPU devices, and 8 ``gloo`` ranks of the port
(``launch_ranks``, a FileStore under ``tmp_path``).  Between them they run
every workload of ``spmd_exchange_program.py``: transitive closure on
``gspmd`` and ``bucket-a2a`` (and with its EDB streamed in 3 chunks),
semi-naive connected components and negated reach on ``bucket-a2a``, and
the PageRank -> threshold -> reach pipeline on all three exchanges, every
predicate forced onto row tables.  Bars: presence sets and min values
exact; f32 sums within 1e-6 relative of the JAX package's 8-device answer
and of the port's single-device dense run; ``plan.notes`` byte-equal; no
``storage_fallback``; every rank's answers equal.

Inside the ranks: C1 (every integer index the exchanges, the block
converters and the sharded dense rules hand to torch lies in range, under
the audit mode of ``test_torch_spmd.py``); buckets too small set the
overflow flag on some ranks, and every rank falls back to dense grids
with the right answer; each rank holds ``n / 8`` leading rows of every
sharded grid; fault tolerance (A10c) and serving's ``run(params=)`` and
``run_batched`` (A10d) run there.
Connected components over a wide edge set (C16): the reference's
buckets overflow and it reruns on dense grids, the port's keep the row
tables, with the same labels.  In process: C2 (``row_hash_exchange``
keeps arrival order among the rows of an owner, as the reference does)
and the word packing round trip.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _spmd_generic_workloads as W
from repro_torch.core import physical as TP
from repro_torch.launch.mesh import launch_ranks

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-6
LAUNCH_TIMEOUT = 600.0
EXTRAS = ("audit", "overflow", "blocks", "refusals")


def start_jax(out_dir, part):
    """The JAX package's side of ``part``, started in a subprocess with 8
    virtual devices (the flag must be set before JAX is imported)."""

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
         f"import _spmd_generic_workloads as w; "
         f"w.jax_main({str(out_dir)!r}, {part!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def both_sides(out_dir, part, extras=()):
    """(the ranks' answers, the JAX package's), run at once."""

    t0 = time.perf_counter()
    proc = start_jax(out_dir, part)
    try:
        ranks = launch_ranks(W.rank_main, 8, part, extras,
                             store_dir=str(out_dir), timeout=LAUNCH_TIMEOUT)
        err = proc.communicate(timeout=LAUNCH_TIMEOUT)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    print(f"spmd generic {part}: both sides in "
          f"{time.perf_counter() - t0:.1f}s, the ranks' own "
          f"{ranks[0]['seconds']:.1f}s")
    return ranks, W.load_jax(out_dir, part)


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert float(np.abs(got - want).max(initial=0.0)) <= REL_TOL * scale


def check_grids(got, want, exact):
    """Presence exact; values on the present cells bit-equal (``exact``)
    or within 1e-6 relative."""

    assert set(got) == set(want)
    for pred, (pres, vals) in want.items():
        g_pres, g_vals = got[pred]
        np.testing.assert_array_equal(g_pres, pres)
        assert set(g_vals) == set(vals)
        for k, v in vals.items():
            a, b = np.where(pres, g_vals[k], 0), np.where(pres, v, 0)
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                close(a, b)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return both_sides(tmp_path_factory.mktemp("spmd_generic"), "exchange",
                      EXTRAS)


@pytest.mark.parametrize("tag", sorted(W.EXCHANGE))
def test_exchange_matches_jax(runs, tag):
    ranks, jax = runs
    got, want = ranks[0][tag], jax[tag]
    exact = not tag.startswith("pipeline")
    check_grids(got["grids"], want["grids"], exact)
    check_grids(got["grids"], got["single"], exact)
    assert got["converged"] == want["converged"]
    if exact:
        assert got["iterations"] == want["iterations"]


@pytest.mark.parametrize("tag", sorted(W.EXCHANGE))
def test_exchange_notes_match_jax(runs, tag):
    ranks, jax = runs
    assert ranks[0][tag]["notes"] == jax[tag]["notes"]
    mode = tag.split("/")[1]
    assert any(n.startswith("exchange(") and mode in n
               for n in ranks[0][tag]["notes"])


@pytest.mark.parametrize("tag", sorted(W.EXCHANGE))
def test_exchange_keeps_row_tables(runs, tag):
    ranks, jax = runs
    assert not jax[tag]["fallback"]
    assert not any(r[tag]["fallback"] for r in ranks)


def test_ranks_agree(runs):
    ranks, _ = runs
    for r in ranks[1:]:
        for tag in W.EXCHANGE:
            for pred, (pres, vals) in ranks[0][tag]["grids"].items():
                np.testing.assert_array_equal(r[tag]["grids"][pred][0], pres)
                for k, v in vals.items():
                    np.testing.assert_array_equal(
                        r[tag]["grids"][pred][1][k], v)
            assert r[tag]["iterations"] == ranks[0][tag]["iterations"]


def test_join_buckets_hold_an_even_hash(runs):
    """C16: connected components' edge side is larger than its head; the
    reference's buckets, sized by the head's cap, overflow and it reruns
    on dense grids, where the port's, sized to twice a slice's even share,
    keep the row tables; the labels agree."""

    ranks, jax = runs
    tag = "cc-wide/bucket-a2a"
    assert jax[tag]["fallback"]
    assert not any(r[tag]["fallback"] for r in ranks)
    check_grids(ranks[0][tag]["grids"], jax[tag]["grids"], True)
    check_grids(ranks[0][tag]["grids"], ranks[0][tag]["single"], True)
    assert ranks[0][tag]["notes"] == jax[tag]["notes"]


def test_exchange_indices_stay_in_range(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["audit"]["checked"] >= 100
        assert r["audit"]["bad"] == []


def test_overflow_is_agreed_and_falls_back(runs):
    ranks, jax = runs
    flags = [r["overflow"]["flags"] for r in ranks]
    # The rows lie on some ranks' slices only: their flags differ ...
    assert any(any(f) for f in flags)
    assert not all(any(f) for f in flags)
    # ... and every rank reran on dense grids, with the right closure.
    for r in ranks:
        assert r["overflow"]["fallback"]
        np.testing.assert_array_equal(r["overflow"]["tc"],
                                      jax["tc/gspmd"]["grids"]["tc"][0])


def test_each_rank_holds_a_block(runs):
    ranks, _ = runs
    rows = W.N // 8
    for r in ranks:
        b = r["blocks"]
        assert b["tc"] == b["delta"] == b["edge"] == (rows, W.N)
        assert b["rank"] == b["node"] == (rows,)
        # Every rule of the dense pipeline runs one block a rank: P2 and
        # H2 gather rank / reach and the edge grid and cut edge's target
        # axis to the block.
        assert b["sharded"] == ["edge", "hot", "node", "rank", "rankF",
                                "reach"]
        assert b["owners"] == ["H1", "H2", "H3", "P1", "P2", "P3", "P4",
                               "P5"]


@pytest.mark.parametrize("name,item", [
    ("checkpoint_dir", "A10c"), ("injector", "A10c"), ("remesh", "A10c"),
    ("params", "A10d"), ("run_batched", "A10d"),
])
def test_mesh_refusals_name_their_item(runs, name, item):
    """The options that once refused on a mesh run on every rank. A10c's:
    the closure of the plain run, one restart on every rank after a crash
    on rank 3 only, and the remesh recorded.  A10d's: ``run(params=)`` and
    ``run_batched`` over two edge bindings equal the single-device
    executable's closures and iteration counts."""

    ranks, _ = runs
    for r in ranks:
        assert r["refusals"][name] == {
            "equal": True, "restarts": int(name == "injector"),
            "events": ["remesh(8->8: data=8)"] if name == "remesh" else []}


# ---------------------------------------------------------------------------
# In process: C2, C1 at the packing, the words
# ---------------------------------------------------------------------------


def _slab():
    rng = np.random.default_rng(3)
    cap = 40
    owner = rng.integers(0, 4, cap).astype(np.int32)
    ids = rng.integers(0, 64, (cap, 2)).astype(np.int32)
    vals = rng.normal(size=cap).astype(np.float32)
    valid = rng.random(cap) < 0.8
    return owner, ids, vals, valid


def test_row_hash_exchange_keeps_arrival_order():
    """C2: within an owner's bucket the rows keep their slab order, so the
    f32 sums that follow add in the reference's order; bit-equal to the
    JAX package's buckets (one device: no axis is bound, nothing moves)."""

    import jax.numpy as jnp

    from repro.core.physical import row_hash_exchange as j_exchange

    owner, ids, vals, valid = _slab()
    got, got_valid, got_of = TP.row_hash_exchange(
        torch.from_numpy(owner), {"ids": torch.from_numpy(ids),
                                  "vals": torch.from_numpy(vals)},
        torch.from_numpy(valid), 4, 16, ("data",))
    want, want_valid, want_of = j_exchange(
        jnp.asarray(owner), {"ids": jnp.asarray(ids),
                             "vals": jnp.asarray(vals)},
        jnp.asarray(valid), 4, 16, ("data",))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got["ids"].numpy(),
                                  np.asarray(want["ids"]))
    np.testing.assert_array_equal(got["vals"].numpy(),
                                  np.asarray(want["vals"]))
    assert bool(got_of) == bool(want_of) is False
    for o in range(4):
        rows = np.flatnonzero(valid & (owner == o))
        bucket = got["vals"][o * 16:(o + 1) * 16][got_valid[o * 16:
                                                            (o + 1) * 16]]
        np.testing.assert_array_equal(bucket.numpy(), vals[rows])


def test_row_hash_exchange_spills_without_an_out_of_range_index():
    """C1 at the packing: invalid rows and the rows past a full bucket go
    to a spill slot that is sliced off (the reference scatters them out of
    range, which XLA drops and torch refuses); the flag says rows were
    dropped, as the reference's does."""

    from test_torch_spmd import _IndexAudit

    import jax.numpy as jnp

    from repro.core.physical import row_hash_exchange as j_exchange

    owner, ids, vals, valid = _slab()
    with _IndexAudit() as audit:
        got, got_valid, got_of = TP.row_hash_exchange(
            torch.from_numpy(owner), {"vals": torch.from_numpy(vals)},
            torch.from_numpy(valid), 4, 3, ("data",))
    assert audit.checked >= 1 and audit.bad == []
    want, want_valid, want_of = j_exchange(
        jnp.asarray(owner), {"vals": jnp.asarray(vals)}, jnp.asarray(valid),
        4, 3, ("data",))
    assert bool(got_of) and bool(want_of)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got["vals"].numpy(),
                                  np.asarray(want["vals"]))


def test_pack_words_round_trip():
    g = torch.Generator().manual_seed(0)
    leaves = [torch.randint(-5, 5, (7, 3), generator=g, dtype=torch.int32),
              torch.rand(7, generator=g) < 0.5,
              torch.randn(7, generator=g),
              torch.randint(-2 ** 40, 2 ** 40, (7,), generator=g,
                            dtype=torch.int64),
              torch.randn(7, 2, generator=g).to(torch.bfloat16),
              torch.randn(7, generator=g, dtype=torch.float64),
              torch.zeros(7, 0, dtype=torch.int32)]
    words, layout = TP.pack_words(leaves)
    assert words.dtype == torch.int32 and words.shape == (7, 3 + 1 + 1 + 2
                                                          + 2 + 2 + 0)
    for a, b in zip(TP.unpack_words(words, layout), leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bool else b)
