"""LM prefill and decode on a mesh on the card: 4 ranks on one GPU over
staged ``gloo``, a ``(data 2, model 2)`` mesh.

These tests need the card and skip without one; they import nothing of
JAX, so they run on the machine with the card as they are:

    python -m pytest -q tests/test_torch_spmd_serve_lm_cuda.py

The cell is reduced phi4-mini at head dim 128 with bf16 compute (4 q / 2
kv heads, d_model 256, 2 layers): 4 x 256-token prompts into a cache of
264 slots cut over ``model``, then 8 decode steps fed the one-device
run's greedy tokens, so that each rank's prefill runs the flash kernel at
its local head counts (2 q / 1 kv heads) on the ``wgmma`` route.  Bars:
prefill's and every step's logits within twice the bf16 bound measured in
the same test (the one-device plain path in bf16 against it in f32) of
the one-device run; every rank's joined logits equal; each rank launched
the forward kernel once a layer in prefill, on the ``wgmma`` route, and
never in decode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import launch_ranks

PROMPT = (4, 256)
STEPS = 8
CACHE = PROMPT[1] + STEPS
SEED = 0
NOISE_FACTOR = 2.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _plans(compute_dtype="bfloat16"):
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.models.registry import get_config, reduced_config

    cfg = dataclasses.replace(
        reduced_config(get_config("phi4_mini_3_8b")), d_model=256,
        head_dim=128, compute_dtype=compute_dtype)
    mesh = MeshSpec((("data", 2), ("model", 2)))
    return [dataclasses.replace(plan_lm(cfg, kind, mesh), cfg=cfg)
            for kind in ("prefill_32k", "decode_32k")]


def _params(cfg, device):
    from repro_torch.models import lm

    gen = torch.Generator(device=device).manual_seed(SEED)
    return lm.init_params(cfg, gen, device=device)


def _prompts():
    rng = np.random.default_rng(SEED)
    return rng.integers(0, 128, PROMPT).astype(np.int32)


def _single(device, compute_dtype="bfloat16", attention="auto", feed=None):
    """The one-device run: logits [STEPS + 1, B, V] and greedy tokens."""

    from repro_torch.launch import serve

    pplan, dplan = _plans(compute_dtype)
    params = _params(pplan.cfg, device)
    prefill, _ = serve.build_prefill_step(pplan, None, CACHE, device,
                                          attention=attention)
    decode, _, _ = serve.build_decode_step(dplan, None, device)
    logits, cache, pos = prefill(params, {"tokens": _prompts()})
    out, toks = [logits[:, -1].float()], [serve.greedy_sample(logits)]
    for i in range(STEPS):
        token = toks[-1] if feed is None else feed[:, i:i + 1]
        logits, cache = decode(params, cache, token, pos + i)
        out.append(logits[:, -1].float())
        toks.append(serve.greedy_sample(logits))
    return torch.stack(out).cpu(), torch.cat(toks, dim=1).cpu()


def _rank(rank, world, feed):
    from repro_torch.carry import shard_state
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm

    mesh = make_mesh((2, 2), ("data", "model"), device="cuda",
                     backend="gloo")
    pplan, dplan = _plans()
    cfg, rules = pplan.cfg, pplan.rules
    prefill, p_specs = serve.build_prefill_step(pplan, mesh, CACHE)
    decode, d_specs, _ = serve.build_decode_step(dplan, mesh,
                                                 cache_len=CACHE)
    params = shard_state(_params(cfg, mesh.device), p_specs, mesh)
    rows = serve.batch_rows({"tokens": _prompts(), "feed": feed}, mesh,
                            rules)
    K.reset_launch_count()
    logits, cache, pos = prefill(params, rows)
    counts = [K.launch_count, K.fwd_wgmma_launch_count]
    out = [lm.gather_logits(logits, cfg, mesh, rules, PROMPT[0])]
    for i in range(STEPS):
        logits, cache = decode(params, cache, rows["feed"][:, i:i + 1],
                               pos + i)
        out.append(lm.gather_logits(logits, cfg, mesh, rules, PROMPT[0]))
    counts.append(K.launch_count - counts[0])
    # numpy, not tensors: a tensor crosses the result queue by shared
    # memory, which dies with the rank
    return {"logits": torch.stack([x[:, -1].float() for x in out]).cpu()
            .numpy(),
            "counts": counts, "staged": mesh.stats.staged_bytes,
            "route": K.route("fwd", torch.bfloat16, cfg.hd)}


def _rel_l2(a, b, vocab):
    a, b = a[..., :vocab].double(), b[..., :vocab].double()
    return float((a - b).norm() / b.norm())


def test_mesh_prefill_and_decode_on_the_card(tmp_path):
    device = _card()
    one, tokens = _single(device)
    plain, _ = _single(device, attention="ref", feed=tokens)
    f32, _ = _single(device, "float32", attention="ref", feed=tokens)
    cfg = _plans()[0].cfg
    bar = NOISE_FACTOR * max(_rel_l2(plain[i], f32[i], cfg.vocab)
                             for i in range(STEPS + 1))
    ranks = launch_ranks(_rank, 4, tokens.numpy(), store_dir=str(tmp_path),
                         timeout=600)
    for r in ranks:
        assert r["staged"] > 0 and r["route"] == "wgmma"
        assert r["counts"] == [cfg.n_layers, cfg.n_layers, 0], r["counts"]
        assert np.array_equal(r["logits"], ranks[0]["logits"])
        got = torch.from_numpy(r["logits"])
        rel = [_rel_l2(got[i], one[i], cfg.vocab)
               for i in range(STEPS + 1)]
        assert max(rel) <= bar, (rel, bar)
