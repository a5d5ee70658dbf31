"""The LM train step on a mesh on the card: 4 ranks on one GPU over staged
``gloo``, a ``(data 2, model 2)`` mesh.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_spmd_train_cuda.py

The cell is reduced phi4-mini at head dim 128 with bf16 compute (4 q / 2
kv heads, d_model 256, 2 layers; 4 x 256 tokens in 2 microbatches, 2
AdamW steps), so that on each rank the flash kernels run at the local
head counts (2 q / 1 kv heads) on the ``wgmma`` route, under the
planner's ZeRO-1 plan and under ZeRO-3.  Bars: each step's loss and grad
norm within twice the bf16 bound measured in the same test (the
one-device step in bf16 against the same step in f32) of the one-device
step; every rank's losses equal; every rank launched the forward, dQ and
dK/dV kernels, each launch on the ``wgmma`` route; and on every rank the
three kernels at the local shape agree with their plain version (in f32
on the same bf16 inputs) within the kernels' per-element bf16 bounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

SEQ = 256
BATCH = 4
MICROBATCHES = 2
STEPS = 2
LR = 1e-3
SEED = 0
NOISE_FACTOR = 2.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _plan(fsdp, compute_dtype="bfloat16"):
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.models.registry import get_config, reduced_config

    cfg = dataclasses.replace(
        reduced_config(get_config("phi4_mini_3_8b")), d_model=256,
        head_dim=128, compute_dtype=compute_dtype)
    plan = plan_lm(cfg, "train_4k", MeshSpec((("data", 2), ("model", 2))))
    plan = dataclasses.replace(plan, cfg=cfg, microbatches=MICROBATCHES)
    if fsdp:
        plan = dataclasses.replace(
            plan, zero="zero3",
            rules=dataclasses.replace(plan.rules, fsdp=True))
    return plan


def _state(plan, device):
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init_params(plan.cfg, gen, device=device)
    opt = adamw(lr=LR)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}, opt


def _batch():
    rng = np.random.default_rng(SEED)
    return {"tokens": rng.integers(0, 128, (BATCH, SEQ)).astype(np.int32)}


def _counts(K):
    return (K.launch_count, K.dq_launch_count, K.dkv_launch_count,
            K.fwd_wgmma_launch_count, K.dq_wgmma_launch_count,
            K.dkv_wgmma_launch_count)


def _kernels_at(B, H, KH, S, D, device):
    """The forward, dQ and dK/dV kernels at one bf16 shape (the LM's
    layout, causal) against their plain versions in f32 on the same
    inputs: each output's largest error over its per-element bound
    (``kernel.bf16_error_bound``, ``kernel.bf16_bwd_error_bound``)."""

    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward,
        attention_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    q, k, v, do = (torch.randn(s, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D),
                             (B, S, H, D)))
    scale = 1.0 / D ** 0.5
    kw = dict(causal=True, window=None, sm_scale=scale)
    out, m, l = K.flash_fwd(q, k, v, layout="bshd", **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = K.flash_bwd_dq(q, k, v, do, m, l, delta, layout="bshd", **kw)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, m, l, delta, layout="bshd", **kw)
    bq, bk, bv, bdo = (t.transpose(1, 2) for t in (q, k, v, do))
    f = [t.float() for t in (bq, bk, bv)]
    ref = attention_reference(*f, **kw)
    bound = K.bf16_error_bound(
        ref, attention_reference(f[0], f[1], f[2].abs(), **kw), S, D)
    ratios = [float(((out.transpose(1, 2).float() - ref).abs()
                     / bound).max())]
    refs = attention_backward(*f, bdo.float(), m, l, delta, **kw)
    bounds = K.bf16_bwd_error_bound(bq, bk, bv, bdo, m, l, delta, refs,
                                    **kw)
    for g, r, b in zip((dq, dk, dv), refs, bounds):
        ratios.append(float(((g.transpose(1, 2).float() - r).abs()
                             / b).max()))
    return ratios


def _rank(rank, world, fsdp):
    from repro_torch.carry import gather_state, shard_state
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cuda",
                     backend="gloo")
    plan = _plan(fsdp)
    state, opt = _state(plan, mesh.device)
    step, specs, batch_fn = train.build_train_step(plan, mesh, optimizer=opt)
    state = shard_state(state, specs, mesh)
    rows = batch_fn(_batch())
    K.reset_launch_count()
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, rows)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts = _counts(K)
    full = gather_state(state, specs, mesh)
    cfg = plan.cfg
    local = (BATCH // MICROBATCHES // 2, cfg.n_heads // 2,
             cfg.n_kv_heads // 2, SEQ, cfg.hd)
    return {"losses": losses, "grad_norms": norms, "counts": counts,
            "device": str(mesh.device), "staged": mesh.stats.staged_bytes,
            "finite": all(bool(torch.isfinite(t).all())
                          for t in tree_leaves(full["params"])),
            "kernels": _kernels_at(*local, mesh.device),
            "routes": [K.route(n, torch.bfloat16, cfg.hd)
                       for n in ("fwd", "dq", "dkv")]}


def _single(plan, device):
    from repro_torch.launch import train

    state, opt = _state(plan, device)
    step, _, _ = train.build_train_step(plan, None, optimizer=opt,
                                        device=device)
    out = []
    for _ in range(STEPS):
        state, metrics = step(state, _batch())
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return np.array(out)


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "zero3"])
def test_mesh_train_step_on_the_card(tmp_path, fsdp):
    device = _card()
    one = _single(_plan(fsdp), device)
    f32 = _single(_plan(fsdp, "float32"), device)
    bound = float((np.abs(one - f32) / np.abs(f32)).max())
    bar = NOISE_FACTOR * bound
    ranks = launch_ranks(_rank, 4, fsdp, store_dir=str(tmp_path),
                         timeout=600)
    per_step = 2 * MICROBATCHES * _plan(fsdp).cfg.n_layers
    for r in ranks:
        assert r["device"].startswith("cuda") and r["staged"] > 0
        assert r["finite"]
        got = np.array(list(zip(r["losses"], r["grad_norms"])))
        assert float((np.abs(got - one) / np.abs(one)).max()) <= bar, \
            (got, one, bar)
        assert r["losses"] == ranks[0]["losses"]
        assert r["routes"] == ["wgmma"] * 3
        fwd, dq, dkv, fwd_w, dq_w, dkv_w = r["counts"]
        # Full remat: a layer's forward twice a microbatch, its backward
        # once.
        assert fwd == fwd_w == STEPS * per_step
        assert dq == dq_w == dkv == dkv_w == STEPS * per_step // 2
        # out, dq, dk, dv: each within its per-element bound
        assert max(r["kernels"]) <= 1.0, r["kernels"]
