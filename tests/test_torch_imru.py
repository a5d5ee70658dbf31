"""The port's IMRU (Listing 2) against the JAX package.

The tasks of ``tests/test_imru_pregel.py`` (batch gradient descent, the
paper's §5.1 task at unit scale) go through ``compile_imru`` of both
packages on records built from the same numpy arrays.  Required: plan notes
byte-equal under the TPU model (golden notes under ``H100_SXM``); models
within ``rtol=1e-5`` of the reference's and within ``atol=1e-3`` of a
float64 GD oracle, the bars the reference's own tests use (f32 sums taken
in another order); the host and device drivers equal exactly (the same
operators).  The reference skips the records past the last whole
microbatch (ROADMAP C8); the port counts them, so it is held against the
reference only where the microbatch size divides the record count, and
against a numpy oracle where it does not.
"""

import contextlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.imru import IMRUTask as JaxIMRUTask
from repro.core.imru import compile_imru as jax_compile_imru
from repro.ft import FailureInjector
from repro_torch.carry import imru_records_from_numpy
from repro_torch.core.executor import compile_program, microbatch_slices
from repro_torch.core.fixpoint import DriverConfig, HostFixpointDriver
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.imru import IMRUExecutable, IMRUTask, compile_imru

RTOL = 1e-5
ORACLE_ATOL = 1e-3


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    return X, X @ w_true, w_true


def _tasks(d, lr, tol=1e-7, update=None):
    """(reference task, port task) of BGD on d features."""

    jax_task = JaxIMRUTask(
        init_model=lambda: jnp.zeros((d,), jnp.float32),
        map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
        update=lambda j, m, g: m - lr * g,
        tol=tol,
    )
    torch_task = IMRUTask(
        init_model=lambda: torch.zeros(d),
        map=lambda rec, m: (rec["x"] @ m - rec["y"]) @ rec["x"],
        update=update or (lambda j, m, g: m - lr * g),
        tol=tol,
    )
    return jax_task, torch_task


def _records(X, y):
    return ({"x": jnp.asarray(X), "y": jnp.asarray(y)},
            imru_records_from_numpy({"x": X, "y": y}, device="cpu"))


def _compile_both(n, d, lr, tol=1e-7, **kw):
    X, y, w_true = _data(n, d)
    jax_task, torch_task = _tasks(d, lr, tol)
    jr, tr = _records(X, y)
    jax_ex = jax_compile_imru(jax_task, jr, **kw)
    torch_ex = compile_imru(torch_task, tr, device="cpu", **kw)
    assert torch_ex.plan.notes == jax_ex.plan.notes
    return jax_ex, torch_ex, X, y, w_true


def _gd_oracle(X, y, lr, iters):
    X, y = X.astype(np.float64), y.astype(np.float64)
    w = np.zeros(X.shape[1], np.float64)
    for _ in range(iters):
        w = w - lr * (X.T @ (X @ w - y))
    return w


def test_bgd_matches_gd_oracle_and_jax():
    jax_ex, ex, X, y, _ = _compile_both(256, 6, 1e-4)
    want, got = jax_ex.run(max_iters=200), ex.run(max_iters=200)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               rtol=RTOL, atol=0)
    oracle = _gd_oracle(X, y, 1e-4, got.iterations)
    np.testing.assert_allclose(got.state.numpy(), oracle, atol=ORACLE_ATOL)


def test_bgd_converges_to_true_model():
    X, y, w_true = _data(512, 8)
    _, task = _tasks(8, 2e-5)
    ex = compile_imru(task, _records(X, y)[1], device="cpu")
    res = ex.run(max_iters=5000)
    assert res.converged
    np.testing.assert_allclose(res.state.numpy(), w_true, atol=ORACLE_ATOL)


def test_imru_pipeline_is_wired_through_datalog():
    jax_ex, ex, *_ = _compile_both(64, 4, 1e-4)
    assert ex.program.name == "imru"
    assert [df.target for df in ex.logical.body] == ["collect", "model"]
    assert ex.logical.structure() == jax_ex.logical.structure()
    assert any("loop-invariant-caching" in n for n in ex.plan.notes)
    assert any("early-aggregation" in n for n in ex.plan.notes)
    assert any("aggregation-tree" in n for n in ex.plan.notes)


def test_golden_notes_under_the_h100_model():
    X, y, _ = _data(64, 4)
    _, task = _tasks(4, 1e-4)
    ex = compile_imru(task, _records(X, y)[1], hw=H100_SXM, device="cpu")
    assert ex.plan.notes == (
        "loop-invariant-caching(training_data)",
        "early-aggregation(map-local)",
        "model-volume(replicate-params)",
        "aggregation-tree(flat)",
    )
    assert ex.stats.record_bytes == 4 * 4 + 4
    assert ex.stats.model_bytes == 4 * 4


def test_imru_microbatching_matches_unbatched_and_jax():
    runs = {}
    for mb in (1, 4):
        jax_ex, ex, *_ = _compile_both(256, 4, 1e-4, microbatches=mb)
        runs[mb] = (jax_ex.run(max_iters=50), ex.run(max_iters=50))
    np.testing.assert_allclose(runs[4][1].state.numpy(),
                               runs[1][1].state.numpy(), rtol=RTOL)
    for want, got in runs.values():
        np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                                   rtol=RTOL)


def test_host_and_device_drivers_agree():
    _, ex, *_ = _compile_both(128, 4, 1e-4, microbatches=3)
    dev = ex.run(max_iters=40)
    host = ex.run(max_iters=40, on_device=False, straggler_fallback=False)
    assert dev.iterations == host.iterations
    assert dev.converged == host.converged
    assert torch.equal(dev.state, host.state)


def test_on_iteration_hook_sees_every_iteration():
    jax_ex, ex, *_ = _compile_both(64, 4, 1e-4)
    from repro.core.fixpoint import DriverConfig as JaxDriverConfig

    seen = {"jax": [], "torch": []}
    jax_ex.driver(JaxDriverConfig(max_iters=6),
                  on_iteration=lambda j, dt: seen["jax"].append(j)
                  ).run(jax_ex.init())
    res = ex.driver(DriverConfig(max_iters=6),
                    on_iteration=lambda j, dt: seen["torch"].append(j)
                    ).run(ex.init())
    assert seen["torch"] == seen["jax"] == [1, 2, 3, 4, 5, 6]
    assert res.iterations == 6


def test_straggler_detection_logs_event():
    stragglers = []

    def slow_step(state, j):
        if j == 8:
            time.sleep(0.3)
        return state + 0.0

    driver = HostFixpointDriver(
        step=slow_step,
        converged=lambda a, b: False,
        config=DriverConfig(max_iters=12, straggler_factor=3.0),
        on_straggler=lambda j, dt: stragglers.append(j),
    )
    driver.run(torch.zeros(4))
    assert driver.straggler_events >= 1
    assert 8 in stragglers


def test_host_driver_logs_every_tenth_iteration(caplog):
    driver = HostFixpointDriver(
        step=lambda state, j: state + 1.0,
        converged=lambda a, b: False,
        config=DriverConfig(max_iters=25),
    )
    with caplog.at_level("INFO", logger="repro_torch.core.fixpoint"):
        driver.run(torch.zeros(4))
    done = [int(r.getMessage().split()[1]) for r in caplog.records
            if r.getMessage().startswith("iteration ")]
    assert done == [10, 20]


@pytest.mark.parametrize("field", ["log_every"])
def test_driver_config_rejects_fields_no_driver_reads(field):
    # The log interval is a constant: passing one fails rather than being
    # ignored.
    with pytest.raises(TypeError, match=field):
        DriverConfig(**{field: 1})


def test_straggler_triggers_the_kary_fallback_like_jax():
    # Every iteration takes at least 20 ms (the reference through its
    # injector, the port through its update UDF), iteration 8 takes 300 ms
    # more: both must fall back at iteration 8 and no other.
    base, slow, iters = 0.02, 0.3, 20
    X, y, _ = _data(128, 4)
    jax_task, _ = _tasks(4, 1e-4)
    jr, tr = _records(X, y)

    def update(j, m, g):
        time.sleep(base + (slow if j == 8 else 0.0))
        return m - 1e-4 * g

    _, torch_task = _tasks(4, 1e-4, update=update)
    jax_ex = jax_compile_imru(jax_task, jr)
    # Compile the reference's step first: its first call's jit time would
    # otherwise enter the trailing mean the detection compares against
    # (under load it can hide iteration 8's straggle).
    jax_ex.run(max_iters=1, on_device=False)
    jax_res = jax_ex.run(max_iters=iters, on_device=False,
                         injector=FailureInjector(straggles=[
                             (j, base + (slow if j == 8 else 0.0))
                             for j in range(iters)]))
    ex = compile_imru(torch_task, tr, device="cpu")
    res = ex.run(max_iters=iters, on_device=False)
    assert res.straggler_events >= 1
    assert ex.plan.reduce.kind == "kary_tree"
    assert ex.straggler_fallbacks == jax_ex.straggler_fallbacks == (
        "straggler-fallback(kary_tree @ iteration 8)",)
    assert ex.plan.notes == jax_ex.plan.notes
    np.testing.assert_allclose(res.state.numpy(), np.asarray(jax_res.state),
                               rtol=RTOL)


@pytest.mark.parametrize("n,mb,slices", [
    (10, 1, [(0, 10)]),
    (10, 3, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (10, 4, [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10)]),
    (3, 5, [(0, 1), (1, 2), (2, 3)]),
])
def test_microbatch_slices_cover_every_record(n, mb, slices):
    assert microbatch_slices(n, mb) == slices


@pytest.mark.parametrize("mb", [1, 3, 4])
def test_every_record_counts_c8(mb):
    """10 records of 1.0, map = sum, update = the statistic: the port gives
    10 at every microbatch count (the numpy oracle); the reference gives 9
    at 3 microbatches (slices of 3, the tenth record skipped: ROADMAP C8)
    and 10 where the slice size divides 10."""

    ones = np.ones((10, 1), np.float32)
    oracle = float(ones.sum())
    task = IMRUTask(init_model=lambda: torch.zeros(1),
                    map=lambda rec, m: rec.sum(0),
                    update=lambda j, m, s: s)
    ex = compile_imru(task, imru_records_from_numpy(ones, device="cpu"),
                      microbatches=mb, device="cpu")
    got = float(ex.run(max_iters=1).state[0])
    assert got == oracle
    jax_task = JaxIMRUTask(init_model=lambda: jnp.zeros(1),
                           map=lambda rec, m: rec.sum(0),
                           update=lambda j, m, s: s)
    want = float(jax_compile_imru(jax_task, jnp.asarray(ones),
                                  microbatches=mb).run(max_iters=1).state[0])
    assert ex.plan.notes == jax_compile_imru(
        jax_task, jnp.asarray(ones), microbatches=mb).plan.notes
    if 10 % max(1, 10 // mb) == 0:
        assert got == want
    else:
        assert want == 9.0  # the known difference, shown


def test_listing2_via_compile_program_matches_compile_imru():
    X, y, _ = _data(256, 8, seed=7)
    _, task = _tasks(8, 1e-3, tol=1e-9)
    recs = _records(X, y)[1]
    spec = compile_imru(task, recs, device="cpu")
    gen = compile_program(task.program(), {"training_data": recs},
                          binding=task, device="cpu")
    assert isinstance(gen, IMRUExecutable)
    assert gen.plan.notes == spec.plan.notes
    a, b = spec.run(max_iters=80), gen.run(max_iters=80)
    assert a.iterations == b.iterations
    assert float((a.state - b.state).abs().max()) <= 1e-8


@contextlib.contextmanager
def _one_rank_mesh(tmp_path):
    """A ``(1,)`` data mesh over a one-rank gloo process group."""

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_unported_options_raise(tmp_path):
    """A mesh runs (tests/test_torch_spmd.py); fault tolerance on it runs
    too (A10c, on 8 ranks in tests/test_torch_spmd_ft.py): a checkpointed
    run on a one-rank mesh, crashed and restored, equals the plain run."""

    from repro_torch.ft import FailureInjector

    X, y, _ = _data(64, 4)
    _, task = _tasks(4, 1e-4)
    recs = _records(X, y)[1]
    with _one_rank_mesh(tmp_path) as mesh:
        ex = compile_imru(task, recs, mesh=mesh)
        plain = ex.run(max_iters=4)
        res = ex.run(max_iters=4, checkpoint_dir=str(tmp_path / "ckpt"),
                     injector=FailureInjector(crashes=[2]))
    assert res.restarts == 1 and res.iterations == plain.iterations
    assert torch.equal(res.state, plain.state)


def test_compile_imru_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    X, y, _ = _data(64, 4)
    _, task = _tasks(4, 1e-4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imru_records_from_numpy({"x": X, "y": y})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_imru(task, _records(X, y)[1])


def test_bgd_config_is_the_references_and_plans_alike():
    import dataclasses

    from repro.configs import bgd as jax_bgd
    from repro.core.hardware import MeshSpec as JaxMeshSpec
    from repro.core.planner import plan_imru as jax_plan_imru
    from repro_torch.configs import bgd
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.planner import plan_imru

    assert dataclasses.asdict(bgd.STATS) == dataclasses.asdict(jax_bgd.STATS)
    for size in (1, 8):
        want = jax_plan_imru(jax_bgd.STATS, JaxMeshSpec((("data", size),)))
        got = plan_imru(bgd.STATS, MeshSpec((("data", size),)))
        assert got.notes == want.notes
        assert got.microbatches == want.microbatches
