"""The port's dense-LM serving path against the JAX package's, on the CPU.

For each dense config under ``reduced_config`` (and two sliding-window
variants: one whose cache is a ring shorter than the prompt, one whose
cache is longer than the window), JAX parameters from
``lm.init_params(PRNGKey(0))`` are carried into the port by
``lm_params_from_numpy``, and the same numpy tokens go through both:

* ``forward`` logits, ``prefill`` (last-token logits, cache k/v, pos) and 4
  ``decode_step``s (logits and caches) agree within 1e-5 max abs in f32
  (f32 sums taken in another order; logits of these configs are O(1));
* with bf16 compute, ``forward`` logits agree within 2e-2 relative L2 (the
  two frameworks round bf16 at different places);
* greedy serving through ``launch/serve.py`` with the configuration of
  ``examples/serve_lm.py`` gives the same tokens as the JAX package's
  ``build_prefill_step`` / ``build_decode_step``;
* ``plan_lm``'s notes and ``LMPlan`` fields are byte-equal to the JAX
  package's for every config x shape cell, on one device and on a (data
  16, model 16) mesh, and every config's parameter count equals the JAX
  package's.

The other families are held against the JAX package in
``tests/test_torch_families.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hardware import MeshSpec as JMeshSpec
from repro.core.lm_planner import plan_lm as jax_plan_lm
from repro.launch import serve as jax_serve
from repro.models import lm as jlm
from repro.models.common import ArchConfig as JArchConfig
from repro.models.common import cross_entropy_loss as jax_cross_entropy
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced
from repro_torch.carry import lm_params_from_numpy
from repro_torch.core.hardware import MeshSpec
from repro_torch.core.lm_planner import plan_lm
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.common import SHAPES, ArchConfig, cross_entropy_loss
from repro_torch.models.registry import (
    ARCH_IDS,
    build_model,
    get_config,
    reduced_config,
)

F32_TOL = 1e-5
BF16_REL_L2 = 2e-2
DENSE_IDS = ("minitron_8b", "phi4_mini_3_8b", "stablelm_12b",
             "chameleon_34b")
CASES = list(DENSE_IDS) + ["phi4_mini_3_8b+window",
                           "phi4_mini_3_8b+narrow_window"]


def _configs(case, **changes):
    arch, _, variant = case.partition("+")
    jc = jax_reduced(jax_get_config(arch))
    tc = reduced_config(get_config(arch))
    if variant:
        changes["window"] = {"window": 16, "narrow_window": 8}[variant]
    return (dataclasses.replace(jc, **changes),
            dataclasses.replace(tc, **changes))


def _params(jc, tc, seed=0):
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, lm_params_from_numpy(tc, tree, device="cpu")


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    jc, tc = _configs(case)
    jp, tp = _params(jc, tc)
    toks = _tokens(jc)
    want = jlm.forward(jp, jnp.asarray(toks), jc, remat_policy="none")
    got = lm.forward(tp, torch.from_numpy(toks), tc)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(case):
    jc, tc = _configs(case)
    jp, tp = _params(jc, tc)
    toks = _tokens(jc)
    # a ring shorter than the prompt under "+window"; else 32 slots
    P, cache_len = 28, (16 if case.endswith("+window") else 32)
    jlg, jcache, jpos = jlm.prefill(jp, jnp.asarray(toks[:, :P]), jc,
                                    cache_len)
    lg, cache, pos = lm.prefill(tp, torch.from_numpy(toks[:, :P]), tc,
                                cache_len)
    assert pos == int(jpos) == P
    _close(lg, jlg)
    for name in ("k", "v"):
        _close(cache["layers"][name], jcache["layers"][name])
    for i in range(4):
        tok = toks[:, P + i:P + i + 1]
        jlg, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.int32(P + i), jc)
        lg, new_cache = lm.decode_step(tp, cache, torch.from_numpy(tok),
                                       P + i, tc)
        assert new_cache is cache  # updated in place
        _close(lg, jlg)
        for name in ("k", "v"):
            _close(cache["layers"][name], jcache["layers"][name])


@pytest.mark.parametrize("case", ["phi4_mini_3_8b", "chameleon_34b"])
def test_bf16_compute_forward_matches_jax(case):
    jc, tc = _configs(case, compute_dtype="bfloat16")
    jp, tp = _params(jc, tc)
    toks = _tokens(jc)
    want = np.asarray(jlm.forward(jp, jnp.asarray(toks), jc,
                                  remat_policy="none"), np.float32)
    got = lm.forward(tp, torch.from_numpy(toks), tc)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()[..., :jc.vocab]
    want = want[..., :jc.vocab]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel


# examples/serve_lm.py:23-27
SERVE_CFG = dict(
    name="repro-serve-25m", family="dense", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=2, d_ff=1024, vocab=4096, head_dim=64,
    window=None, param_dtype="float32", compute_dtype="float32",
)


def test_greedy_serving_matches_jax():
    """examples/serve_lm.py's loop: 8 requests, 64-token prompts, 8 new
    tokens, greedy."""

    jc, tc = JArchConfig(**SERVE_CFG), ArchConfig(**SERVE_CFG)
    B, prompt_len, gen = 8, 64, 8
    cache_len = prompt_len + gen
    jp, tp = _params(jc, tc)
    prompts = np.random.default_rng(0).integers(
        0, jc.vocab, (B, prompt_len)).astype(np.int32)

    def run(serve_mod, plan, params, tokens, as_pos):
        prefill_fn, _ = serve_mod.build_prefill_step(plan, None, cache_len,
                                                     **device)
        decode_fn, _, _ = serve_mod.build_decode_step(plan, None, **device)
        logits, cache, _ = prefill_fn(params, {"tokens": tokens})
        token = serve_mod.greedy_sample(logits)
        out = [np.asarray(token)]
        for i in range(gen - 1):
            logits, cache = decode_fn(params, cache, token,
                                      as_pos(prompt_len + i))
            token = serve_mod.greedy_sample(logits)
            out.append(np.asarray(token))
        return np.concatenate(out, axis=1)

    jplan = dataclasses.replace(
        jax_plan_lm(jc, "decode_32k", JMeshSpec((("data", 1),))), cfg=jc)
    tplan = dataclasses.replace(
        plan_lm(tc, "decode_32k", MeshSpec((("data", 1),))), cfg=tc)
    device = {}
    want = run(jax_serve, jplan, jp, jnp.asarray(prompts), jnp.int32)
    device = {"device": "cpu"}
    got = run(serve, tplan, tp, torch.from_numpy(prompts), int)
    assert got.dtype == np.int32 and got.shape == (B, gen)
    np.testing.assert_array_equal(got, want)


MESHES = {"one": (("data", 1),), "pod": (("data", 16), ("model", 16))}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_plan_lm_is_byte_equal(arch, shape, mesh):
    want = jax_plan_lm(jax_get_config(arch), shape, JMeshSpec(MESHES[mesh]))
    got = plan_lm(get_config(arch), shape, MeshSpec(MESHES[mesh]))
    assert got.notes == want.notes
    assert got.explain() == want.explain()
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.mesh.axes == want.mesh.axes
    assert got.rules.rules == want.rules.rules
    for f in ("shape_name", "kind", "remat", "microbatches", "zero",
              "m_dtype", "v_dtype", "grad_codec"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.rules.fsdp, got.rules.expert_parallel) == \
        (want.rules.fsdp, want.rules.expert_parallel)


def test_param_count_matches_jax():
    for arch in ARCH_IDS:
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count()
    assert get_config("phi4_mini_3_8b").param_count() == 4_451_404_800


def test_unported_families_and_meshes_raise():
    """On a ``(data 1, model 4)`` mesh every family builds both serve
    steps: reduced minicpm3-4b (MLA, 4 heads), mamba2-130m and hymba-1.5b
    (A10h-2), and reduced whisper-medium and minitron-8b, whose 2 kv heads
    4 does not divide (A10h-3, repeated to the rank's q head).  q heads
    cut mid-head over a ``model`` that does not divide them (the same
    minicpm3, hymba and whisper with 5 heads, the ``qkv`` rule kept on
    ``model`` where the planner would replicate them) refuse both, naming
    ROADMAP A10h-4, before any collective (a stand-in mesh has no process
    group to call)."""

    import types

    mesh = types.SimpleNamespace(shape={"data": 1, "model": 4},
                                 device=torch.device("cpu"))
    axes = (("data", 1), ("model", 4))
    five = {"mla": {"n_heads": 5}, "encdec": {"n_heads": 5, "n_kv_heads": 1},
            "hybrid": {"n_heads": 5, "n_kv_heads": 1}}
    built = refused = 0
    for arch in ("minicpm3_4b", "mamba2_130m", "hymba_1_5b",
                 "whisper_medium", "minitron_8b"):
        cfg = reduced_config(get_config(arch))
        cases = [(cfg, True)]
        if cfg.family in five:
            cases.append((dataclasses.replace(cfg, **five[cfg.family]),
                          False))
        for c, ported in cases:
            for shape in ("prefill_32k", "decode_32k"):
                plan = dataclasses.replace(
                    plan_lm(c, shape, MeshSpec(axes)), cfg=c)
                if not ported:
                    # the planner replicates heads model does not divide
                    plan = dataclasses.replace(
                        plan, rules=plan.rules.with_rule("qkv", "model"))

                def build():
                    if shape == "prefill_32k":
                        return serve.build_prefill_step(plan, mesh, 32)
                    return serve.build_decode_step(plan, mesh, cache_len=32)

                if ported:
                    assert callable(build()[0])
                    built += 1
                    continue
                with pytest.raises(NotImplementedError, match="A10h-4"):
                    build()
                refused += 1
    assert (built, refused) == (10, 6)


def test_lm_params_from_numpy_keeps_bf16_and_checks_shapes():
    jc, tc = _configs("phi4_mini_3_8b", param_dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = lm_params_from_numpy(tc, tree, device="cpu")
    wq = tp["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 64)
    assert tp["layers"]["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(jp["layers"]["attn"]["wq"], np.float32))
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_numpy(tc, tree, device="cpu")


def test_serving_params_give_the_same_bits():
    """A bf16 copy of the weights made once gives the bits of the cast per
    call."""

    _, tc = _configs("chameleon_34b", compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = build_model(tc)["init_params"](gen, device="cpu")
    toks = torch.from_numpy(_tokens(tc))
    sp = lm.serving_params(tc, params)
    assert sp["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert sp["layers"]["attn"]["q_norm"].dtype == torch.float32
    assert torch.equal(lm.forward(sp, toks, tc), lm.forward(params, toks, tc))
    lg, cache, pos = lm.prefill(sp, toks[:, :20], tc, 24)
    lg2, cache2, _ = lm.prefill(params, toks[:, :20], tc, 24)
    assert torch.equal(lg, lg2)
    assert torch.equal(lm.decode_step(sp, cache, toks[:, 20:21], pos, tc)[0],
                       lm.decode_step(params, cache2, toks[:, 20:21], pos,
                                      tc)[0])


def test_init_params_distribution():
    cfg = get_config("phi4_mini_3_8b")
    cfg = dataclasses.replace(reduced_config(cfg), d_model=256, d_ff=512)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert abs(params["embed"]["tok"].std().item() - 0.02) < 1e-3
    small = 0.02 / (2.0 * cfg.n_layers) ** 0.5
    assert abs(params["layers"]["mlp"]["w_down"].std().item() - small) \
        < 0.05 * small
    assert torch.equal(params["layers"]["ln1"], torch.ones(2, 256))
    assert lm.param_count(cfg) == sum(
        t.numel() for t in [params["embed"]["tok"], params["embed"]["head"],
                            params["embed"]["out_norm"]]
        + [t for d in params["layers"].values()
           for t in (d.values() if isinstance(d, dict) else [d])])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 8, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.6).astype(np.float32) if masked else None
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
