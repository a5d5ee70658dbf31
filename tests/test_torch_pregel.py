"""The port's single-device Pregel path against the JAX package, end to end.

PageRank, SSSP, weighted SSSP and max-propagation CC, each under the three
connectors with semi-naive evaluation off and on, go through
``compile_pregel`` of both packages on graphs built from the same numpy
arrays.  Required: equal ``iterations``, ``converged`` and ``modes``;
min/max states equal exactly (order-insensitive combines); PageRank within
1e-6 relative (f32 sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pregel import Graph as JaxGraph
from repro.core.pregel import VertexProgram as JaxVertexProgram
from repro.core.pregel import compile_pregel as jax_compile_pregel
from repro_torch.carry import graph_from_numpy
from repro_torch.core.pregel import VertexProgram, compile_pregel

CONNECTORS = ["dense_psum", "merging", "hash_sort"]
PAGERANK_RTOL = 1e-6
INF = 1e9


def _random_graph(n, seed):
    """Every vertex sends 1-4 edges and receives at least one."""

    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(n):
        for _ in range(rng.integers(1, 5)):
            src.append(v)
            dst.append(int(rng.integers(0, n)))
    for v in range(n):
        src.append(int(rng.integers(0, n)))
        dst.append(v)
    return np.array(src, np.int32), np.array(dst, np.int32)


def _pagerank(n, outdeg):
    od_j, od_t = jnp.asarray(outdeg), torch.from_numpy(outdeg)
    jax_prog = JaxVertexProgram(
        init_vertex=lambda ids, vd: jnp.stack(
            [jnp.full((n,), 1.0 / n), od_j], axis=1),
        message=lambda j, s, ed: s[:, 0] / jnp.maximum(s[:, 1], 1.0),
        apply=lambda j, s, inbox, got: (
            jnp.stack([0.15 / n + 0.85 * inbox, s[:, 1]], axis=1),
            jnp.ones(s.shape[0], jnp.bool_)),
        combine="sum",
    )
    torch_prog = VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.full((n,), 1.0 / n), od_t], dim=1),
        message=lambda j, s, ed: s[:, 0] / torch.clamp(s[:, 1], min=1.0),
        apply=lambda j, s, inbox, got: (
            torch.stack([0.15 / n + 0.85 * inbox, s[:, 1]], dim=1),
            torch.ones(s.shape[0], dtype=torch.bool)),
        combine="sum",
    )
    return jax_prog, torch_prog


def _sssp(weighted):
    jax_prog = JaxVertexProgram(
        init_vertex=lambda ids, vd: jnp.where(ids == 0, 0.0,
                                              jnp.float32(INF)),
        message=(lambda j, s, ed: s + ed) if weighted
        else (lambda j, s, ed: s + 1.0),
        apply=lambda j, s, inbox, got: (
            jnp.minimum(s, inbox), jnp.minimum(s, inbox) < s),
        combine="min",
    )
    torch_prog = VertexProgram(
        init_vertex=lambda ids, vd: torch.where(ids == 0, 0.0, INF),
        message=(lambda j, s, ed: s + ed) if weighted
        else (lambda j, s, ed: s + 1.0),
        apply=lambda j, s, inbox, got: (
            torch.minimum(s, inbox), torch.minimum(s, inbox) < s),
        combine="min",
    )
    return jax_prog, torch_prog


def _max_cc():
    jax_prog = JaxVertexProgram(
        init_vertex=lambda ids, vd: ids.astype(jnp.float32),
        message=lambda j, s, ed: s,
        apply=lambda j, s, inbox, got: (
            jnp.maximum(s, inbox), jnp.maximum(s, inbox) > s),
        combine="max",
    )
    torch_prog = VertexProgram(
        init_vertex=lambda ids, vd: ids.to(torch.float32),
        message=lambda j, s, ed: s,
        apply=lambda j, s, inbox, got: (
            torch.maximum(s, inbox), torch.maximum(s, inbox) > s),
        combine="max",
    )
    return jax_prog, torch_prog


def _case(name, n=40, seed=3):
    src, dst = _random_graph(n, seed)
    vdata = np.bincount(src, minlength=n).astype(np.float32)
    edata = None
    if name == "pagerank":
        progs = _pagerank(n, vdata)
    elif name == "sssp":
        progs = _sssp(weighted=False)
    elif name == "weighted_sssp":
        progs = _sssp(weighted=True)
        edata = (((np.arange(len(src)) % 7) + 1) * 0.25).astype(np.float32)
    else:
        progs = _max_cc()
    jax_graph = JaxGraph(
        n, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(vdata),
        edge_data=None if edata is None else jnp.asarray(edata),
    )
    torch_graph = graph_from_numpy(n, src, dst, vdata, edata, device="cpu")
    return progs, jax_graph, torch_graph


def _run_both(name, connector, semi_naive, max_iters=60):
    (jax_prog, torch_prog), jg, tg = _case(name)
    jax_ex = jax_compile_pregel(jax_prog, jg, force_connector=connector,
                                semi_naive=semi_naive)
    torch_ex = compile_pregel(torch_prog, tg, force_connector=connector,
                              semi_naive=semi_naive, device="cpu")
    assert torch_ex.plan.notes == jax_ex.plan.notes
    return jax_ex.run(max_iters=max_iters), torch_ex.run(max_iters=max_iters)


def _assert_same_run(name, want, got):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.modes == want.modes
    want_state = np.asarray(want.state[0])
    got_state = got.state[0].numpy()
    np.testing.assert_array_equal(got.state[1].numpy(),
                                  np.asarray(want.state[1]))
    if name == "pagerank":
        np.testing.assert_allclose(got_state, want_state,
                                   rtol=PAGERANK_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got_state, want_state)


@pytest.mark.parametrize("semi_naive", [False, True])
@pytest.mark.parametrize("connector", CONNECTORS)
@pytest.mark.parametrize("name",
                         ["pagerank", "sssp", "weighted_sssp", "max_cc"])
def test_pregel_matches_jax(name, connector, semi_naive):
    want, got = _run_both(name, connector, semi_naive,
                          max_iters=30 if name == "pagerank" else 60)
    if name != "pagerank":
        assert got.converged
    if semi_naive and name != "pagerank":
        assert any(m.startswith("sparse@") for m in got.modes)
    _assert_same_run(name, want, got)


def test_planner_default_is_dense_psum_and_matches_jax():
    (jax_prog, torch_prog), jg, tg = _case("pagerank")
    jax_ex = jax_compile_pregel(jax_prog, jg)
    torch_ex = compile_pregel(torch_prog, tg, device="cpu")
    assert torch_ex.plan.connector == "dense_psum"
    assert torch_ex.plan.notes == jax_ex.plan.notes
    _assert_same_run("pagerank", jax_ex.run(max_iters=30),
                     torch_ex.run(max_iters=30))


def test_compile_pregel_without_device_needs_a_card():
    (_, torch_prog), _, tg = _case("sssp")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_pregel(torch_prog, tg)


def test_unported_options_raise():
    (_, torch_prog), _, tg = _case("sssp")
    with pytest.raises(NotImplementedError, match="A10"):
        compile_pregel(torch_prog, tg, mesh=object(), device="cpu")
    ex = compile_pregel(torch_prog, tg, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        ex.run(max_iters=3, checkpoint_dir="ckpt")
    with pytest.raises(NotImplementedError, match="A11"):
        ex.remesh(None)


def _argmin_sssp():
    """SSSP with parent pointers: state (distance, own id, parent), messages
    (distance + 1, sender id) combined by lexicographic argmin."""

    jax_prog = JaxVertexProgram(
        init_vertex=lambda ids, vd: jnp.stack(
            [jnp.where(ids == 0, 0.0, jnp.float32(INF)),
             ids.astype(jnp.float32), -jnp.ones(ids.shape, jnp.float32)],
            axis=1),
        message=lambda j, s, ed: jnp.stack([s[:, 0] + 1.0, s[:, 1]], axis=1),
        apply=lambda j, s, inbox, got: (
            jnp.where((inbox[:, 0] < s[:, 0])[:, None],
                      jnp.stack([inbox[:, 0], s[:, 1], inbox[:, 1]], axis=1),
                      s),
            inbox[:, 0] < s[:, 0]),
        combine="argmin",
    )
    torch_prog = VertexProgram(
        init_vertex=lambda ids, vd: torch.stack(
            [torch.where(ids == 0, 0.0, INF), ids.to(torch.float32),
             -torch.ones(ids.shape, device=ids.device)], dim=1),
        message=lambda j, s, ed: torch.stack([s[:, 0] + 1.0, s[:, 1]],
                                             dim=1),
        apply=lambda j, s, inbox, got: (
            torch.where((inbox[:, 0] < s[:, 0])[:, None],
                        torch.stack([inbox[:, 0], s[:, 1], inbox[:, 1]],
                                    dim=1),
                        s),
            inbox[:, 0] < s[:, 0]),
        combine="argmin",
    )
    return jax_prog, torch_prog


@pytest.mark.parametrize("semi_naive", [False, True])
def test_structured_monoid_probe_and_run_match_jax(semi_naive):
    # The payload probe (meta tensors here, jax.eval_shape there) prices
    # 8 B/msg, so the monoid note comes out byte-equal.
    _, jg, tg = _case("sssp")
    jax_prog, torch_prog = _argmin_sssp()
    jax_ex = jax_compile_pregel(jax_prog, jg, semi_naive=semi_naive)
    torch_ex = compile_pregel(torch_prog, tg, semi_naive=semi_naive,
                              device="cpu")
    assert "combine-monoid(argmin, 8B/msg, xla-generic)" in \
        torch_ex.plan.notes
    assert torch_ex.plan.notes == jax_ex.plan.notes
    want, got = jax_ex.run(max_iters=60), torch_ex.run(max_iters=60)
    assert got.converged
    _assert_same_run("argmin_sssp", want, got)
