"""The port's front end and planner against the JAX package's.

For the single-device cases of ``test_plan_golden.py`` the port's
``plan_pregel`` notes must be byte-equal to the JAX planner's (and to the
goldens) under the same ``TPU_V5E`` model; the Listing-1 logical plan must
be equal in structure, with and without the semi-naive rewrite.  The H100
model gets its own golden.
"""

import dataclasses

import pytest

from repro.core import algebra as jax_algebra
from repro.core import stratify as jax_stratify
from repro.core.hardware import MeshSpec as JaxMeshSpec
from repro.core.planner import plan_pregel as jax_plan_pregel
from repro.core.pregel import VertexProgram as JaxVertexProgram
from repro_torch.core import algebra, stratify
from repro_torch.core.hardware import H100_SXM, MeshSpec
from repro_torch.core.planner import PregelStats, plan_pregel
from repro_torch.core.pregel import VertexProgram
from test_plan_golden import (
    MONOID_STATS,
    PREGEL_GOLDEN,
    PREGEL_MONOID_GOLDEN,
    PREGEL_STATS,
    PREGEL_WEIGHTED_GOLDEN,
    WEIGHTED_STATS,
    _PREGEL_BASE,
)

ONE_DEVICE = (("data", 1),)

CASES = [
    (stats, semi_naive, golden[("1way", semi_naive)])
    for stats, golden in ((PREGEL_STATS, PREGEL_GOLDEN),
                          (WEIGHTED_STATS, PREGEL_WEIGHTED_GOLDEN),
                          (MONOID_STATS, PREGEL_MONOID_GOLDEN))
    for semi_naive in (False, True)
] + [
    (dataclasses.replace(PREGEL_STATS, msg_bytes=8, combine=combine), sn,
     None)
    for combine in ("mean", "max", "min", "logsumexp", "topk")
    for sn in (False, True)
]


@pytest.mark.parametrize("stats,semi_naive,golden", CASES)
def test_plan_pregel_notes_byte_equal(stats, semi_naive, golden):
    want = jax_plan_pregel(stats, JaxMeshSpec(ONE_DEVICE),
                           semi_naive=semi_naive)
    got = plan_pregel(PregelStats(**dataclasses.asdict(stats)),
                      MeshSpec(ONE_DEVICE), semi_naive=semi_naive)
    assert got.notes == want.notes
    if golden is not None:
        assert got.notes == golden
    assert got.connector == want.connector == "dense_psum"
    assert got.density_threshold == want.density_threshold
    assert got.sparse_cap_floor == want.sparse_cap_floor
    for count in (0, 1, 100, 5000, 65536):
        assert got.sparse_cap_for(count) == want.sparse_cap_for(count)


@pytest.mark.parametrize("semi_naive", [False, True])
def test_h100_plan_notes_golden(semi_naive):
    plan = plan_pregel(PregelStats(**dataclasses.asdict(PREGEL_STATS)),
                       MeshSpec(ONE_DEVICE), H100_SXM,
                       semi_naive=semi_naive)
    want = _PREGEL_BASE + (
        ("semi-naive(adaptive dense<->sparse @ density 0.5)",)
        if semi_naive else ())
    assert plan.notes == want


def _udfs(cls):
    return cls(init_vertex=lambda ids, vd: vd, message=lambda j, s, e: s,
               apply=lambda j, s, i, g: (s, g), combine="sum")


@pytest.mark.parametrize("semi_naive", [False, True])
def test_pregel_logical_plan_equal_in_structure(semi_naive):
    jax_program = _udfs(JaxVertexProgram).program()
    program = _udfs(VertexProgram).program()
    want = jax_algebra.translate(jax_program)
    got = algebra.translate(program)
    want_notes = got_notes = ()
    if semi_naive:
        want, want_notes = jax_algebra.semi_naive_rewrite(want, jax_program)
        got, got_notes = algebra.semi_naive_rewrite(got, program)
    assert got_notes == want_notes
    assert ({df.label: df.op.structure() for df in got.body}
            == {df.label: df.op.structure() for df in want.body})
    assert ([df.label for df in got.init]
            == [df.label for df in want.init])
    want_sched = jax_stratify.iteration_schedule(jax_program)
    got_sched = stratify.iteration_schedule(program)
    assert ([r.label for r in got_sched.init_rules]
            == [r.label for r in want_sched.init_rules])
    assert (stratify.delta_rewritable_rules(program)
            == jax_stratify.delta_rewritable_rules(jax_program))
