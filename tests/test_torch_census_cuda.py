"""The census (``repro_torch.launch.census``) on the card: the same count
on CUDA tensors as on the ``meta`` device, and the hand-written kernels
refused.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_census_cuda.py

A program the dispatcher sees whole (the LM's prefill with the plain
attention, and its train step) counts the same FLOPs, bytes and ops on
the card as on ``meta``.  The kernels B1-B4 launch through ``ctypes``,
which no dispatch mode sees: under a census each raises, naming itself,
before it launches.
"""

import dataclasses

import pytest
import torch

from repro_torch.core.hardware import H100_SXM, MeshSpec
from repro_torch.core.lm_planner import plan_lm
from repro_torch.core.tree import tree_map
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.segment_combine.kernel import segment_combine_cuda
from repro_torch.launch.census import census_of
from repro_torch.launch.serve import build_prefill_step
from repro_torch.launch.train import build_train_step, make_optimizer
from repro_torch.models import lm
from repro_torch.models.registry import get_config, reduced_config


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census's card path and the "
                    "Hopper kernels have no CPU mode")
    return torch.device("cuda")


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def _same(a, b):
    assert a.dot_flops == b.dot_flops > 0
    assert a.bytes_accessed == b.bytes_accessed
    assert a.vmem_region_bytes == b.vmem_region_bytes
    assert a.op_counts == b.op_counts


def _cfg(kind):
    cfg = dataclasses.replace(reduced_config(get_config("phi4_mini_3_8b")),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    shape = {"prefill": "prefill_32k", "train": "train_4k"}[kind]
    plan = plan_lm(cfg, shape, MeshSpec((("data", 1),)), hw=H100_SXM)
    return dataclasses.replace(plan, microbatches=2)


def test_prefill_census_is_the_same_on_the_card_and_meta():
    dev = _card()
    plan = _cfg("prefill")
    params = lm.init_params(plan.cfg, torch.Generator(device=dev)
                            .manual_seed(0), device=dev)
    batch = {"tokens": torch.randint(0, plan.cfg.vocab, (2, 700),
                                     dtype=torch.int32, device=dev)}
    _, card = census_of(build_prefill_step(plan, None, 700, dev,
                                           attention="ref")[0],
                        params, batch)
    _, meta = census_of(build_prefill_step(plan, None, 700, "meta",
                                           attention="ref")[0],
                        _meta(params), _meta(batch))
    _same(card, meta)


def test_train_census_is_the_same_on_the_card_and_meta():
    dev = _card()
    plan = _cfg("train")

    def state_on(device):
        params = lm.abstract_params(plan.cfg) if device == "meta" else \
            lm.init_params(plan.cfg, torch.Generator(device=device)
                           .manual_seed(0), device=device)
        return {"params": params, "opt": make_optimizer(plan).init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    batch = {"tokens": torch.randint(0, plan.cfg.vocab, (4, 600),
                                     dtype=torch.int32, device=dev)}
    counts = []
    for device, b in ((dev, batch), ("meta", _meta(batch))):
        step = build_train_step(plan, None, device=device, attention="ref")[0]
        counts.append(census_of(step, state_on(device), b)[1])
    _same(*counts)


def test_kernels_under_a_census_raise():
    dev = _card()
    plan = _cfg("prefill")
    params = lm.init_params(plan.cfg, torch.Generator(device=dev)
                            .manual_seed(0), device=dev)
    batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32, device=dev)}
    with pytest.raises(RuntimeError, match=r"flash_fwd \(B2\)"):
        census_of(build_prefill_step(plan, None, 64, dev)[0], params, batch)

    q = torch.randn((1, 2, 64, 64), device=dev, dtype=torch.bfloat16)
    m = torch.zeros((1, 2, 64), device=dev)
    for fn, name in ((K.flash_bwd_dq, "flash_bwd_dq (B3)"),
                     (K.flash_bwd_dkv, "flash_bwd_dkv (B4)")):
        before = (K.dq_launch_count, K.dkv_launch_count)
        with pytest.raises(RuntimeError, match=name.replace("(", r"\(")
                           .replace(")", r"\)")):
            census_of(fn, q, q, q, q, m, m, m, causal=True, window=None,
                      sm_scale=0.125)
        assert (K.dq_launch_count, K.dkv_launch_count) == before

    values = torch.ones((128, 4), device=dev)
    ids = torch.zeros(128, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match=r"segment_combine \(B1\)"):
        census_of(segment_combine_cuda, values, ids, 1, "sum")
