"""The generic engine's sharded dense grids and forced row tables on a mesh,
and the two listings through ``compile_program`` on it, in the port against
the JAX package's 8-device runs.

The fixture of ``test_torch_spmd_generic.py`` (the JAX package in a
subprocess with 8 virtual devices and 8 ``gloo`` ranks of the port at
once, on the inputs of ``_spmd_generic_workloads.py``) runs the workloads
of ``spmd_executor_program.py`` and ``spmd_rowtable_program.py``:

* dense grids, each rank holding and computing its block of ``n / 8``
  leading rows: transitive closure, connected components naive and
  semi-naive, the PageRank -> threshold -> reach pipeline;
* transitive closure and the pipeline with the edge set on row tables
  and the heads on sharded grids (the rules run whole, and the replicated
  slabs land on each rank's block);
* the same and negated reach forced onto row tables (the planner keeps
  these small slabs on the replicated lowering);
* Listing 1 on each connector and Listing 2 through ``compile_program``
  on the mesh, which hand them to ``compile_pregel`` / ``compile_imru``.

Bars: presence sets and min values exact, f32 sums within 1e-6 relative of
the JAX package's 8-device answer and of the port's single-device dense
run, ``plan.notes`` byte-equal, no ``storage_fallback``, the listings
bit-equal to the specialized executables on the same mesh, every rank's
answers equal.
"""

from __future__ import annotations

import numpy as np
import pytest

import _spmd_generic_workloads as W
from test_torch_spmd_generic import both_sides, check_grids, close

TAGS = sorted(W.DENSE) + sorted(W.MIXED) + sorted(W.ROWTABLE)
LISTINGS = list(W.LISTING1) + ["listing2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return both_sides(tmp_path_factory.mktemp("spmd_generic_dense"), "dense")


@pytest.mark.parametrize("tag", TAGS)
def test_engine_matches_jax(runs, tag):
    ranks, jax = runs
    got, want = ranks[0][tag], jax[tag]
    exact = not tag.endswith("pipeline")
    check_grids(got["grids"], want["grids"], exact)
    check_grids(got["grids"], got["single"], exact)
    assert got["converged"] == want["converged"]
    if exact:
        assert got["iterations"] == want["iterations"]
        assert got["phase_iterations"] == want["phase_iterations"]


@pytest.mark.parametrize("tag", TAGS)
def test_engine_notes_match_jax(runs, tag):
    ranks, jax = runs
    assert ranks[0][tag]["notes"] == jax[tag]["notes"]
    assert not jax[tag]["fallback"]
    assert not any(r[tag]["fallback"] for r in ranks)


@pytest.mark.parametrize("tag", LISTINGS)
def test_listings_through_compile_program(runs, tag):
    ranks, jax = runs
    got = ranks[0][tag]
    close(got["state"], jax[tag]["state"])
    np.testing.assert_array_equal(got["state"], got["spec"])
    assert got["notes"] == got["spec_notes"] == jax[tag]["notes"]


def test_ranks_agree(runs):
    ranks, _ = runs
    for r in ranks[1:]:
        for tag in TAGS:
            for pred, (pres, vals) in ranks[0][tag]["grids"].items():
                np.testing.assert_array_equal(r[tag]["grids"][pred][0], pres)
                for k, v in vals.items():
                    np.testing.assert_array_equal(
                        r[tag]["grids"][pred][1][k], v)
        for tag in LISTINGS:
            np.testing.assert_array_equal(r[tag]["state"],
                                          ranks[0][tag]["state"])
