"""The port's mla, moe, ssm, hybrid and encdec families against the JAX
package's, on the CPU.

For each of the six configurations under ``reduced_config`` (minicpm3-4b,
whisper-medium, mixtral-8x22b, arctic-480b, mamba2-130m, hymba-1.5b), JAX
parameters from ``lm.init_params(PRNGKey(0))`` are carried into the port by
``lm_params_from_numpy``, and the same numpy tokens (and, for whisper, the
same numpy frame embeddings) go through both.  In f32 every comparison
holds within ``F32_REL`` = 1e-5 of ``max |reference|`` (f32 sums taken in
another order):

* teacher-forced ``forward`` logits, and ``loss_fn``;
* ``prefill``: the last-token logits and every cache leaf (the KV ring of
  the windowed configs, whose cache is shorter than the prompt; the MLA
  latent ``c`` and rope key ``kr``; the conv window and SSM state; whisper's
  ``cache["cross"]``), then 4 ``decode_step``s with the cache updated in
  place;
* greedy serving through ``launch/serve.py`` gives the JAX package's tokens.

Unit cases: ``ssd_chunked`` at a length that is not a chunk multiple (the
final state too), ``_causal_conv``, ``moe_apply`` with drop-free capacity;
and ROADMAP C11: with overflowing capacity, ``moe_apply`` equals a float64
oracle that keeps the first ``cap`` arrivals of each expert, while the JAX
package's differs from it exactly on the tokens holding rank ``cap - 1``
of an overflowing expert (its clamp writes the dropped pairs' zeros onto
that slot).
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
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced
from repro_torch.carry import lm_params_from_numpy
from repro_torch.core.hardware import MeshSpec
from repro_torch.core.lm_planner import plan_lm
from repro_torch.launch import serve
from repro_torch.models import blocks, lm
from repro_torch.models.registry import get_config, reduced_config

F32_REL = 1e-5
# |logit| of the padded vocab's columns (masked to -1e30 in the head)
PADDED_LOGIT = 1e29
BF16_REL_L2 = 2e-2
FAMILIES = ("minicpm3_4b", "whisper_medium", "mixtral_8x22b", "arctic_480b",
            "mamba2_130m", "hymba_1_5b")
# Prompt length, and a cache shorter than it for the windowed configs (a
# ring), else room for the prompt and the 4 decode steps.
P = 28


def _cache_len(cfg):
    return 16 if cfg.window is not None else 32


def _configs(arch, **changes):
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
    tc = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    return jc, tc


def _params(jc, tc, seed=0):
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, lm_params_from_numpy(tc, tree, device="cpu")


def _inputs(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return toks, frames


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=F32_REL, what=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    # the scale of the values, not of the padded vocab's -1e30 columns
    real = np.abs(want)[np.abs(want) < PADDED_LOGIT]
    bar = tol * (float(np.max(real)) if real.size else 0.0)
    assert err <= bar, f"{what}: max abs err {err} > {bar}"


def _close_tree(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], f"{what}/{k}")
    else:
        _close(got, want, what=what)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks, frames = _inputs(jc)
    want = jlm.forward(jp, jnp.asarray(toks), jc, enc_input=_j(frames),
                       remat_policy="none")
    got = lm.forward(tp, torch.from_numpy(toks), tc, enc_input=_t(frames))
    _close(got, want, what="logits")


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_jax(arch):
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks, frames = _inputs(jc)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        jbatch["enc_input"] = jnp.asarray(frames)
        tbatch["enc_input"] = torch.from_numpy(frames)
    want, _ = jlm.loss_fn(jp, jbatch, jc, remat_policy="none")
    got, _ = lm.loss_fn(tp, tbatch, tc, remat_policy="none")
    _close(got, want, what="loss")


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch):
    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks, frames = _inputs(jc)
    cache_len = _cache_len(jc)
    jlg, jcache, jpos = jlm.prefill(jp, jnp.asarray(toks[:, :P]), jc,
                                    cache_len, enc_input=_j(frames))
    lg, cache, pos = lm.prefill(tp, torch.from_numpy(toks[:, :P]), tc,
                                cache_len, enc_input=_t(frames))
    assert pos == int(jpos) == P
    assert set(cache) == set(jcache) == (
        {"layers", "cross"} if arch == "whisper_medium" else {"layers"})
    _close(lg, jlg, what="prefill logits")
    _close_tree(cache, jcache, "prefill cache")
    for i in range(4):
        tok = toks[:, P + i:P + i + 1]
        jlg, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.int32(P + i), jc)
        lg, new_cache = lm.decode_step(tp, cache, torch.from_numpy(tok),
                                       P + i, tc)
        assert new_cache is cache  # updated in place
        _close(lg, jlg, what=f"decode step {i} logits")
        _close_tree(cache, jcache, f"decode step {i} cache")


@pytest.mark.parametrize("arch", ["minicpm3_4b", "whisper_medium",
                                  "mamba2_130m", "hymba_1_5b"])
def test_bf16_compute_forward_matches_jax(arch):
    """bf16 compute: the two frameworks round at different places.  (The
    MoE configs are left out: a rounding can flip a top-k choice, and
    then a token's whole expert output differs.)"""

    jc, tc = _configs(arch, compute_dtype="bfloat16")
    jp, tp = _params(jc, tc)
    toks, frames = _inputs(jc)
    want = np.asarray(jlm.forward(jp, jnp.asarray(toks), jc,
                                  enc_input=_j(frames), remat_policy="none"),
                      np.float32)[..., :jc.vocab]
    got = lm.forward(tp, torch.from_numpy(toks), tc, enc_input=_t(frames))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()[..., :jc.vocab]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_serving_matches_jax(arch):
    """Prefill and 6 greedy decode steps through each package's
    ``launch/serve.py`` give the same tokens."""

    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks, frames = _inputs(jc, B=3, S=20, seed=1)
    gen, cache_len = 6, 26

    def run(serve_mod, plan, params, to_array, as_pos, **device):
        prefill_fn, _ = serve_mod.build_prefill_step(plan, None, cache_len,
                                                     **device)
        decode_fn, _, _ = serve_mod.build_decode_step(plan, None, **device)
        batch = {"tokens": to_array(toks)}
        if frames is not None:
            batch["enc_input"] = to_array(frames)
        logits, cache, _ = prefill_fn(params, batch)
        token = serve_mod.greedy_sample(logits)
        out = [np.asarray(token)]
        for i in range(gen - 1):
            logits, cache = decode_fn(params, cache, token,
                                      as_pos(toks.shape[1] + i))
            token = serve_mod.greedy_sample(logits)
            out.append(np.asarray(token))
        return np.concatenate(out, axis=1)

    jplan = dataclasses.replace(
        jax_plan_lm(jc, "decode_32k", JMeshSpec((("data", 1),))), cfg=jc)
    tplan = dataclasses.replace(
        plan_lm(tc, "decode_32k", MeshSpec((("data", 1),))), cfg=tc)
    want = run(jax_serve, jplan, jp, jnp.asarray, jnp.int32)
    got = run(serve, tplan, tp, torch.from_numpy, int, device="cpu")
    assert got.dtype == np.int32 and got.shape == (3, gen)
    np.testing.assert_array_equal(got, want)


def test_plain_attention_path_matches_the_default():
    """``attention="ref"`` (the plain path the card's bars read) gives the
    default path's prefill and decode logits, whisper's cross-attention in
    decode included."""

    _, tc = _configs("whisper_medium")
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(tc, gen, device="cpu")
    toks, frames = (_t(a) for a in _inputs(tc))
    out = {}
    for impl in ("auto", "ref"):
        lg, cache, pos = lm.prefill(params, toks[:, :P], tc, 32,
                                    enc_input=frames, attention=impl)
        steps = [lg]
        for i in range(3):
            tok = toks[:, P + i:P + i + 1]
            steps.append(lm.decode_step(params, cache, tok, pos + i, tc,
                                        attention=impl)[0])
        out[impl] = torch.stack(steps)
    _close(out["ref"], out["auto"])


def test_encdec_needs_frames():
    _, tc = _configs("whisper_medium")
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(tc, gen, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_input"):
        lm.prefill(params, toks, tc, 8)


# ---------------------------------------------------------------------------
# Units: the SSD scan, the causal conv, the MoE dispatch
# ---------------------------------------------------------------------------


def _ssd_inputs(b=2, s=21, h=4, p=8, g=2, n=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A_log = rng.standard_normal(h).astype(np.float32) * 0.5
    Bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A_log, Bm, Cm, D


@pytest.mark.parametrize("s,chunk", [(21, 8), (16, 8), (5, 8), (33, 16)])
def test_ssd_chunked_matches_jax(s, chunk):
    args = _ssd_inputs(s=s)
    want_y, want_st = jblocks.ssd_chunked(*map(jnp.asarray, args), chunk)
    got_y, got_st = blocks.ssd_chunked(*map(torch.from_numpy, args), chunk)
    _close(got_y, want_y, what="y")
    _close(got_st, want_st, what="final state")


def test_ssd_chunked_final_state_is_the_recurrence():
    """The chunked scan's output and final state equal the step-by-step
    recurrence (the decode path's) in float64."""

    x, dt, A_log, Bm, Cm, D = (a.astype(np.float64)
                               for a in _ssd_inputs(s=13))
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    A = -np.exp(A_log)
    st = np.zeros((b, h, p, Bm.shape[3]))
    ys = []
    for t in range(s):
        Bt = np.repeat(Bm[:, t], rep, axis=1)
        Ct = np.repeat(Cm[:, t], rep, axis=1)
        st = st * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bt, x[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", Ct, st) + x[:, t] * D[:, None])
    y, final = blocks.ssd_chunked(*(torch.from_numpy(a) for a in
                                    (x, dt, A_log, Bm, Cm, D)), 4)
    _close(y, np.stack(ys, axis=1), what="y")
    _close(final, st, what="final state")


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(7)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jblocks._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(b))
    got = blocks._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                              torch.from_numpy(b))
    _close(got, want)


def _moe_case(arch, capacity_factor=None, T=16, seed=0):
    changes = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    jc, tc = _configs(arch, **changes)
    jp, tp = _params(jc, tc, seed)
    x = np.random.default_rng(seed + 11).standard_normal(
        (1, T, jc.d_model)).astype(np.float32)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tmoe = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    return jc, tc, jmoe, tmoe, x


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
@pytest.mark.parametrize("T", [16, 37])
def test_moe_apply_drop_free_matches_jax(arch, T):
    jc, tc, jmoe, tmoe, x = _moe_case(arch, T=T)
    assert tc.capacity_factor == tc.n_experts
    want = jblocks.moe_apply(jmoe, jnp.asarray(x), jc)
    got = blocks.moe_apply(tmoe, torch.from_numpy(x), tc)
    _close(got, want)


def _moe_oracle(p, x, cfg):
    """float64 top-k MoE that keeps each expert's first ``cap`` arrivals
    (pairs in token order), in torch, so that autograd can differentiate it
    (the routing is chosen without gradients, as the layer's; the gates,
    the experts and the dense residual carry them).  ``p`` and ``x`` are
    arrays or tensors of any float dtype; returns the output [T, E] (f64)
    and the tokens that hold rank ``cap - 1`` in an expert that
    overflows."""

    def f64(a):
        return a.to(torch.float64) if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.asarray(a, np.float64))

    p = {k: f64(v) for k, v in p.items()}
    x = f64(x).reshape(-1, cfg.d_model)
    T, X, k = x.shape[0], cfg.n_experts, cfg.top_k
    cap = blocks.moe_capacity(cfg, T)
    probs = torch.softmax(x @ p["router"], dim=-1)
    choice = np.argsort(-probs.detach().numpy(), axis=-1,
                        kind="stable")[:, :k]
    gates = torch.gather(probs, -1, torch.from_numpy(choice))
    gates = gates / gates.sum(-1, keepdim=True)
    arrivals = {e: [] for e in range(X)}
    for t in range(T):
        for i in range(k):
            arrivals[int(choice[t, i])].append((t, i))
    at_last_slot = set()
    rows = []
    for e, pairs in arrivals.items():
        if len(pairs) > cap:
            at_last_slot.add(pairs[cap - 1][0])
        for t, i in pairs[:cap]:
            h = x[t] @ p["w_gate"][e]
            u = x[t] @ p["w_up"][e]
            y = (torch.nn.functional.silu(h) * u) @ p["w_down"][e]
            rows.append((t, gates[t, i] * y))
    out = x.new_zeros(x.shape)
    for t, y in rows:
        out = out.index_add(0, torch.tensor([t]), y[None])
    if cfg.dense_residual:
        h = x @ p["res_w_gate"]
        out = out + (torch.nn.functional.silu(h) * (x @ p["res_w_up"])) \
            @ p["res_w_down"]
    return out, at_last_slot


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_overflow_drops_at_capacity(arch, seed):
    """ROADMAP C11: pairs past an expert's capacity are dropped and the
    kept pairs keep their expert outputs."""

    jc, tc, jmoe, tmoe, x = _moe_case(arch, capacity_factor=0.5, seed=seed)
    want, clobbered = _moe_oracle(tmoe, x, tc)
    assert clobbered, "the case must overflow an expert"
    got = blocks.moe_apply(tmoe, torch.from_numpy(x), tc)
    _close(got.reshape(want.shape), want.numpy())


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_moe_clobbers_rank_cap_minus_1(arch, seed):
    """The JAX package's ``moe_apply`` clamps a dropped pair onto slot
    ``e * cap + cap - 1`` and writes zeros there, over the kept pair of
    rank ``cap - 1``: exactly those tokens lose their expert's output."""

    jc, tc, jmoe, tmoe, x = _moe_case(arch, capacity_factor=0.5, seed=seed)
    want, clobbered = _moe_oracle(tmoe, x, tc)
    want = want.numpy()
    ref = np.asarray(jblocks.moe_apply(jmoe, jnp.asarray(x), jc),
                     np.float64).reshape(want.shape)
    err = np.abs(ref - want).max(-1)
    bar = F32_REL * float(np.abs(want).max())
    assert set(np.flatnonzero(err > bar)) == clobbered


def test_moe_route_is_stable_and_ranks_arrivals():
    """Pairs sorted by expert keep arrival order (ROADMAP C2) and a pair's
    rank counts the earlier pairs of its expert."""

    _, tc, _, tmoe, x = _moe_case("arctic_480b", T=40)
    xf = torch.from_numpy(x).reshape(40, -1)
    order, e_s, _, rank, keep = blocks._route(xf, tmoe["router"], tc, 3)
    assert torch.equal(e_s, torch.sort(e_s).values)
    for e in torch.unique(e_s):
        members = order[e_s == e]
        assert torch.equal(members, torch.sort(members).values)
        assert torch.equal(rank[e_s == e], torch.arange(len(members)))
    assert torch.equal(keep, rank < 3)


# ---------------------------------------------------------------------------
# Repairs: a prompt shorter than the conv window (ROADMAP C12), caches that
# do not hold the prompt or the position (ROADMAP C13)
# ---------------------------------------------------------------------------


def _decode_against_teacher_forcing(params, cfg, toks, prompt, steps,
                                    cache_len):
    """Each of ``steps`` decode steps' logits after a ``prompt``-token
    prefill, against the teacher-forced forward's at the same position."""

    t = torch.from_numpy(toks)
    _, cache, pos = lm.prefill(params, t[:, :prompt], cfg, cache_len)
    assert pos == prompt
    for i in range(steps):
        got, _ = lm.decode_step(params, cache, t[:, pos + i:pos + i + 1],
                                pos + i, cfg)
        want = lm.forward(params, t[:, :pos + i + 1], cfg)[:, -1:]
        _close(got, want.numpy(), what=f"prompt {prompt} step {i}")


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b"])
@pytest.mark.parametrize("prompt", [1, 2, 3])
def test_decode_after_a_prompt_shorter_than_the_conv_window(arch, prompt):
    """ROADMAP C12: prefill keeps the last d_conv - 1 conv inputs, left-
    padded with the causal conv's zeros when the prompt is shorter, so
    decode after 1, 2 or 3 prompt tokens (d_conv 4) matches teacher
    forcing."""

    jc, tc = _configs(arch)
    assert tc.d_conv == 4
    _, tp = _params(jc, tc)
    toks, _ = _inputs(jc, S=prompt + 5)
    _, cache, _ = lm.prefill(tp, torch.from_numpy(toks[:, :prompt]), tc, 16)
    conv = cache["layers"]["ssm"]["conv"] if arch == "hymba_1_5b" else \
        cache["layers"]["conv"]
    assert conv.shape[2] == tc.d_conv - 1
    assert not conv[:, :, :tc.d_conv - 1 - prompt].any()
    _decode_against_teacher_forcing(tp, tc, toks, prompt, 5, 16)


@pytest.mark.parametrize("arch", ["mamba2_130m", "hymba_1_5b"])
@pytest.mark.parametrize("prompt", [1, 2])
def test_reference_decode_crashes_after_a_prompt_shorter_than_the_window(
        arch, prompt):
    """The JAX package keeps a conv window of ``prompt`` rows, and its
    first decode step's einsum against the 4-row kernel raises (ROADMAP
    C12): the port does not copy the crash."""

    jc, _ = _configs(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    toks, _ = _inputs(jc, S=prompt + 1)
    _, jcache, _ = jlm.prefill(jp, jnp.asarray(toks[:, :prompt]), jc, 16)
    with pytest.raises((ValueError, TypeError)):
        jlm.decode_step(jp, jcache, jnp.asarray(toks[:, prompt:]),
                        jnp.int32(prompt), jc)


C13_ARCHS = ["phi4_mini_3_8b", "minicpm3_4b"]


@pytest.mark.parametrize("arch", C13_ARCHS)
def test_prefill_into_a_cache_shorter_than_the_prompt_raises(arch):
    """ROADMAP C13: a cache without a ring must hold the prompt.  The port
    raises where a negative pad would crop it to its first slots; the JAX
    package refuses too (``jnp.pad`` with a negative width)."""

    jc, tc = _configs(arch)
    assert tc.window is None
    jp, tp = _params(jc, tc)
    toks, _ = _inputs(jc, S=12)
    with pytest.raises(ValueError, match=r"S = 12 .*cache_len = 8"):
        lm.prefill(tp, torch.from_numpy(toks), tc, 8)
    with pytest.raises(ValueError):
        jlm.prefill(jp, jnp.asarray(toks), jc, 8)
    lg, cache, _ = lm.prefill(tp, torch.from_numpy(toks), tc, 12)
    assert all(leaf.shape[2] == 12 for leaf in cache["layers"].values())


def test_ring_prefill_is_unchanged_by_the_cache_check():
    """The windowed configs keep their ring when the cache is shorter than
    the prompt (no C13 error), and it matches the JAX package's."""

    jc, tc = _configs("mixtral_8x22b")
    jp, tp = _params(jc, tc)
    toks, _ = _inputs(jc, S=28)
    assert tc.window == 16
    _, jcache, _ = jlm.prefill(jp, jnp.asarray(toks), jc, 12)
    _, cache, _ = lm.prefill(tp, torch.from_numpy(toks), tc, 12)
    _close_tree(cache, jcache, "ring cache")


@pytest.mark.parametrize("arch", C13_ARCHS)
def test_decode_past_the_cache_raises_where_the_reference_answers_wrong(
        arch):
    """ROADMAP C13, the deliberate departure: decode at a position at or
    past the cache's length raises ``IndexError`` in the port, where the
    JAX package's ``dynamic_update_slice`` clamps the write onto the last
    slot and answers, off from teacher forcing."""

    jc, tc = _configs(arch)
    jp, tp = _params(jc, tc)
    toks, _ = _inputs(jc, S=12)
    prompt, cache_len = 6, 8
    _, cache, _ = lm.prefill(tp, torch.from_numpy(toks[:, :prompt]), tc,
                             cache_len)
    _, jcache, _ = jlm.prefill(jp, jnp.asarray(toks[:, :prompt]), jc,
                               cache_len)
    for pos in range(prompt, cache_len):
        tok = toks[:, pos:pos + 1]
        lm.decode_step(tp, cache, torch.from_numpy(tok), pos, tc)
        _, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok),
                                    jnp.int32(pos), jc)
    off = []
    for pos in range(cache_len, 12):
        tok = toks[:, pos:pos + 1]
        with pytest.raises(IndexError, match="past the cache"):
            lm.decode_step(tp, cache, torch.from_numpy(tok), pos, tc)
        jlg, jcache = jlm.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.int32(pos), jc)
        want = np.asarray(jlm.forward(jp, jnp.asarray(toks[:, :pos + 1]), jc,
                                      remat_policy="none"))[:, -1:,
                                                              :jc.vocab]
        jlg = np.asarray(jlg)[..., :jc.vocab]
        assert np.isfinite(jlg).all()
        off.append(float(np.abs(jlg - want).max())
                   / float(np.abs(want).max()))
    assert min(off) > 10 * F32_REL, off
