"""The port's census (``repro_torch.launch.census``) against the JAX
package's HLO census (``repro.launch.hlo_analysis``).

The JAX package's ``tests/test_hlo_analysis.py`` cases, ported: a Python
loop counts what a scanned or unrolled JAX program counts, every trip.
Then what only the eager census has: checkpoint recompute counted where it
runs, bytes of single ops equal to their closed forms, the region bytes,
the peak estimate, a hand-written kernel refused, and the same census on
the CPU as on the ``meta`` device.  ``roofline_terms`` equals the JAX
package's on the same census numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.utils.checkpoint import checkpoint

from repro.core import hardware as jax_hw
from repro.launch import hlo_analysis as jax_census
from repro_torch.core.hardware import H100_SXM, TPU_V5E, MeshSpec
from repro_torch.core.lm_planner import plan_lm
from repro_torch.launch import census as C
from repro_torch.launch.serve import build_prefill_step
from repro_torch.launch.train import build_train_step, make_optimizer
from repro_torch.models import lm
from repro_torch.models.registry import get_config, reduced_config

F32 = 4


def _jax_flops(fn, *shapes):
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    hlo = jax.jit(fn).lower(*structs).compile().as_text()
    return jax_census.analyze_hlo(hlo, 1, 0).dot_flops


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_flops_match_scanned_and_unrolled(device):
    def loop(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def unrolled(x, w):
        for _ in range(8):
            x = jnp.tanh(x @ w)
        return x

    def scanned(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return lax.scan(body, x, None, length=8)[0]

    x = torch.ones((128, 256), device=device)
    w = torch.ones((256, 256), device=device)
    _, census = C.census_of(loop, x, w)
    expected = 2 * 128 * 256 * 256 * 8
    assert census.dot_flops == expected
    assert census.op_counts["mm"] == 8
    assert census.while_trips == {}
    for fn in (unrolled, scanned):
        assert _jax_flops(fn, (128, 256), (256, 256)) == expected


def test_nested_loops_multiply():
    def nested(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    def jax_nested(x, w):
        def outer(c, _):
            return lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                            length=3)[0], None
        return lax.scan(outer, x, None, length=5)[0]

    x = torch.ones((64, 64), device="meta")
    _, census = C.census_of(nested, x, x)
    assert census.dot_flops == 2 * 64 ** 3 * 15
    assert _jax_flops(jax_nested, (64, 64), (64, 64)) == 2 * 64 ** 3 * 15


def test_checkpoint_recompute_is_counted():
    """Forward x @ w once, its recompute in the backward once more, and the
    backward's dx and dw products."""

    M, K, N = 32, 48, 16
    x = torch.randn(M, K, requires_grad=True)
    w = torch.randn(K, N, requires_grad=True)
    product = 2 * M * K * N

    def plain():
        torch.tanh(x @ w).sum().backward()

    def remat():
        checkpoint(lambda a, b: torch.tanh(a @ b), x, w,
                   use_reentrant=False).sum().backward()

    _, p = C.census_of(plain)
    _, r = C.census_of(remat)
    assert p.dot_flops == 3 * product
    assert r.dot_flops == 4 * product


def _bytes(fn, *args):
    return C.census_of(fn, *args)[1].bytes_accessed


def test_bytes_closed_forms():
    M, K, N = 24, 40, 8
    a = torch.randn(M, K)
    b = torch.randn(K, N)
    # a product reads its operands and writes its output
    assert _bytes(torch.mm, a, b) == F32 * (M * K + K * N + M * N)
    # views and reshapes of contiguous tensors move nothing
    assert _bytes(lambda t: t.view(K, M).t()[1:3], a) == 0
    # a slice made contiguous: the slice read and written
    assert _bytes(lambda t: t[:, 5:17].contiguous(), a) == 2 * F32 * M * 12
    # an index (a gather): the gathered rows read and written
    idx = torch.tensor([3, 1, 7, 7, 0])
    assert _bytes(lambda t, i: t[i], a, idx) == 2 * F32 * 5 * K
    assert _bytes(lambda t, i: torch.index_select(t, 0, i), a, idx) == \
        2 * F32 * 5 * K
    # an in-place slice write: the update read and written
    upd = torch.randn(3, K)

    def write(t, u):
        t[4:7] = u
        return t

    assert _bytes(write, a.clone(), upd) == 2 * F32 * 3 * K
    # an index write (a scatter): the update read and written
    assert _bytes(lambda t, u: t.index_put_((torch.tensor([0, 2, 9]),), u),
                  a.clone(), upd) == 2 * F32 * 3 * K
    # an elementwise op: operands and output; a fill: the output
    assert _bytes(torch.add, a, a) == 3 * F32 * M * K
    assert _bytes(lambda t: torch.zeros_like(t), a) == F32 * M * K


def test_region_bytes_and_no_census():
    x = torch.ones(100)

    def fn(t):
        y = t * 2.0
        with C.vmem_region("flash"):
            z = y + 1.0
        return z

    _, census = C.census_of(fn, x)
    assert census.bytes_accessed == 2 * 2 * F32 * 100
    assert census.vmem_region_bytes == 2 * F32 * 100
    # with no census running the region is a null context and a kernel
    # launch is let through
    with C.vmem_region("flash"):
        pass
    C.refuse_kernel("flash_fwd (B2)")


def test_kernel_launch_under_census_raises():
    with pytest.raises(RuntimeError, match="flash_fwd"):
        C.census_of(C.refuse_kernel, "flash_fwd (B2)")


def test_peak_and_memory_sizes():
    n = 1000

    def fn(x):
        y = x * 2.0
        z = y + 1.0
        del y
        w = z * 3.0
        return w

    _, census = C.census_of(fn, torch.ones(n))
    # x, y and z live together; then y goes and w comes
    assert census.peak_bytes == 3 * F32 * n
    assert census.argument_bytes == F32 * n
    assert census.output_bytes == F32 * n
    assert census.alias_bytes == 0

    _, inplace = C.census_of(lambda x: x.add_(1.0), torch.ones(n))
    assert inplace.peak_bytes == F32 * n
    assert inplace.alias_bytes == inplace.output_bytes == F32 * n


def _prefill_census(device):
    cfg = reduced_config(get_config("phi4_mini_3_8b"))
    plan = plan_lm(cfg, "prefill_32k", MeshSpec((("data", 1),)))
    step, _ = build_prefill_step(plan, None, 64, device)
    params = lm.abstract_params(plan.cfg)
    if device != "meta":
        params = lm.init_params(plan.cfg, torch.Generator().manual_seed(0),
                                device=device)
    tokens = torch.zeros((2, 64), dtype=torch.int32, device=device)
    return C.census_of(step, params, {"tokens": tokens})[1]


def _train_census(device):
    """A train step in 2 microbatches: AdamW makes its learning rate with
    ``torch.as_tensor``, which lifts a host scalar on the CPU or the card
    and not on meta (a metadata op the census leaves out)."""

    cfg = reduced_config(get_config("phi4_mini_3_8b"))
    plan = dataclasses.replace(
        plan_lm(cfg, "train_4k", MeshSpec((("data", 1),))), microbatches=2)
    params = lm.abstract_params(plan.cfg) if device == "meta" else \
        lm.init_params(plan.cfg, torch.Generator().manual_seed(0),
                       device=device)
    state = {"params": params, "opt": make_optimizer(plan).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    batch = {"tokens": torch.zeros((4, 60), dtype=torch.int32,
                                   device=device)}
    step = build_train_step(plan, None, device=device)[0]
    return C.census_of(step, state, batch)[1]


@pytest.mark.parametrize("census", [_prefill_census, _train_census],
                         ids=["prefill", "train"])
def test_census_is_the_same_on_cpu_and_meta(census):
    cpu, meta = census("cpu"), census("meta")
    assert cpu.dot_flops == meta.dot_flops > 0
    assert cpu.bytes_accessed == meta.bytes_accessed
    assert cpu.vmem_region_bytes == meta.vmem_region_bytes > 0
    assert cpu.op_counts == meta.op_counts
    assert cpu.peak_bytes == meta.peak_bytes


def _jax_hw(hw):
    return jax_hw.HardwareSpec(**dataclasses.asdict(hw))


@pytest.mark.parametrize("hw", [TPU_V5E, H100_SXM], ids=lambda h: h.name)
def test_roofline_terms_match_the_jax_package(hw):
    rng = np.random.default_rng(0)
    for _ in range(5):
        flops, nbytes, region, ici, dcn, operand = rng.uniform(
            1e9, 1e15, 6)
        ours = C.Census(dot_flops=flops, bytes_accessed=nbytes,
                        vmem_region_bytes=region / 10,
                        ici_link_bytes=ici, dcn_link_bytes=dcn,
                        total_operand_bytes=operand)
        theirs = jax_census.HLOCensus(
            dot_flops=flops, bytes_accessed=nbytes,
            vmem_region_bytes=region / 10, ici_link_bytes=ici,
            dcn_link_bytes=dcn, total_operand_bytes=operand)
        got = C.roofline_terms(ours, 1, hw=hw)
        want = jax_census.roofline_terms(theirs, 1, hw=_jax_hw(hw))
        assert got.keys() == want.keys()
        assert got["dominant"] == want["dominant"]
        for k, v in want.items():
            if k != "dominant":
                assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
    # the default is the JAX package's TPU_V5E
    assert C.roofline_terms(ours, 1) == C.roofline_terms(ours, 1,
                                                         hw=TPU_V5E)
