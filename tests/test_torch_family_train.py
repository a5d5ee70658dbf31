"""Training of the mla, moe, ssm, hybrid and encdec families: the port
against the JAX package, on the CPU.

For each of the six configurations under ``reduced_config`` (minicpm3-4b,
mixtral-8x22b, arctic-480b with its dense residual, mamba2-130m,
hymba-1.5b, whisper-medium with frame embeddings from the seed), JAX
parameters and train states are carried into the port by
``lm_params_from_numpy`` / ``train_state_from_numpy`` and the same numpy
tokens go through both:

* ``loss_fn``'s value and gradients against ``jax.value_and_grad`` of the
  reference's under the remat policies "none", "full", "dots" and
  "group:2", with a token mask that has zeros in it: the loss within 1e-5
  absolute, every gradient leaf within 1e-5 of its largest magnitude (f32
  sums in another order);
* three steps of ``build_train_step`` against the reference's at 1 and 2
  microbatches: after each step the loss and grad_norm within rtol 1e-5,
  the params within 1e-5 absolute (as ``tests/test_torch_train.py``),
  AdamW's m and v within 1e-5 of each leaf's largest magnitude after the
  first step and within 1e-4 after the later ones (``MOMENT_REL``).

The reduced MoE configs route drop-free (capacity factor = the number of
experts), so the above holds the MoE at a capacity where no pair drops;
``moe_apply``'s own gradient is held there against the reference's too.
Where experts overflow, the reference clobbers a kept pair (ROADMAP C11),
so the port's gradient is held against a float64 autograd oracle that
drops each expert's arrivals past its capacity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hardware import MeshSpec as JMeshSpec
from repro.core.lm_planner import plan_lm as jax_plan_lm
from repro.launch import train as jax_train
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced
from repro_torch.carry import lm_params_from_numpy, train_state_from_numpy
from repro_torch.core.hardware import MeshSpec
from repro_torch.core.lm_planner import plan_lm
from repro_torch.launch import train
from repro_torch.models import blocks, lm
from repro_torch.models.registry import get_config, reduced_config
from test_torch_families import _moe_case, _moe_oracle

TOL = 1e-5
# AdamW's moments after the first step: the two packages' gradients are
# then taken at parameters already up to TOL apart, and AdamW's first
# update moved every element by about lr on its gradient's sign (a near-
# zero gradient's sign may differ), so the moments drift further apart
# than one gradient's rounding.  At step 0 they are held at TOL.
MOMENT_REL = 1e-4
FAMILIES = ("minicpm3_4b", "mixtral_8x22b", "arctic_480b", "mamba2_130m",
            "hymba_1_5b", "whisper_medium")


def _configs(arch, **changes):
    jc = dataclasses.replace(jax_reduced(jax_get_config(arch)), **changes)
    tc = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    return jc, tc


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (the two packages order leaves
    differently)."""

    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float64)


def _assert_leaves_close(got, want, rel=TOL, atol=0.0, what=""):
    """Every leaf of ``got`` within ``atol`` + ``rel`` x max |leaf of
    want|."""

    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
    for key in w:
        a, b = _as_np(g[key]), _as_np(w[key])
        assert a.shape == b.shape, (what, key, a.shape, b.shape)
        err = float(np.abs(a - b).max()) if b.size else 0.0
        bar = atol + rel * (float(np.abs(b).max()) if b.size else 0.0)
        assert err <= bar, f"{what}{key}: max abs err {err} > {bar}"


def _batch(cfg, B, S, seed, mask=False):
    """Numpy tokens (and, for the encoder-decoder, frame embeddings; with
    ``mask``, a token mask with zeros in it) from ``seed``."""

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if mask:
        m = (rng.random((B, S)) < 0.75).astype(np.int32)
        m[:, 1] = 0
        batch["mask"] = m
    if cfg.family == "encdec":
        batch["enc_input"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("policy", ["none", "full", "dots", "group:2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_and_gradients_match_jax(arch, policy):
    jc, tc = _configs(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    batch = _batch(jc, 2, 20, seed=1, mask=True)
    assert (batch["mask"] == 0).any()
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jc, remat_policy=policy),
        has_aux=True)(jp)
    tp = lm_params_from_numpy(tc, _np_tree(jp), device="cpu")
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_()
    loss, aux = lm.loss_fn(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, tc,
                           remat_policy=policy)
    loss.backward()
    assert aux["loss"] is loss
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    grads = {k: t.grad for k, t in leaves.items()}
    assert all(g is not None for g in grads.values())
    _assert_leaves_close(grads, _flat(_np_tree(jg)), what="grad ")


def _train_pair(arch, microbatches):
    jc, tc = _configs(arch)
    jplan, tplan = (dataclasses.replace(
        plan(c, "train_4k", mesh((("data", 1),))), cfg=c,
        microbatches=microbatches)
        for plan, mesh, c in ((jax_plan_lm, JMeshSpec, jc),
                              (plan_lm, MeshSpec, tc)))
    return jc, tc, jplan, tplan


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax_over_three_steps(arch, microbatches):
    jc, tc, jplan, tplan = _train_pair(arch, microbatches)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jax_train.make_optimizer(jplan).init(jp),
              "step": jnp.int32(0)}
    tstate = train_state_from_numpy(tc, _np_tree(jstate), device="cpu")
    jstep, _, _ = jax_train.build_train_step(jplan, mesh=None)
    tstep, _, _ = train.build_train_step(tplan, device="cpu")
    for i in range(3):
        batch = _batch(jc, 4, 16, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        _assert_leaves_close(tstate["params"], _np_tree(jstate["params"]),
                             rel=0.0, atol=TOL, what=f"step {i} params ")
        for name in ("m", "v"):
            _assert_leaves_close(
                getattr(tstate["opt"], name),
                _np_tree(getattr(jstate["opt"], name)),
                rel=TOL if i == 0 else MOMENT_REL, what=f"step {i} {name} ")


def _moe_grads_torch(p, x, cfg, weights):
    """Gradients of sum(moe_apply(p, x) * weights) by every parameter leaf
    and by x (f32 port)."""

    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = blocks.moe_apply(leaves, xt, cfg)
    (out.reshape(weights.shape) * weights).sum().backward()
    return out.detach(), {**{k: v.grad for k, v in leaves.items()},
                          "x": xt.grad}


@pytest.mark.parametrize("T", [16, 37])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_moe_gradients_drop_free_match_jax(arch, T):
    """At a capacity where no pair drops, ``moe_apply``'s gradients by
    its parameters and its input equal ``jax.grad`` of the reference's."""

    jc, tc, jmoe, tmoe, x = _moe_case(arch, T=T)
    assert blocks.moe_capacity(tc, T) >= T * tc.top_k
    weights = np.random.default_rng(T).standard_normal(
        (T, jc.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jblocks.moe_apply(p, xx, jc).reshape(T, -1)
                       * jnp.asarray(weights))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jmoe, jnp.asarray(x))
    _, got = _moe_grads_torch(tmoe, x, tc, torch.from_numpy(weights))
    _assert_leaves_close(got, {**_np_tree(jgp), "x": np.asarray(jgx)},
                         what="moe grad ")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "arctic_480b"])
def test_moe_gradients_at_overflow_match_the_float64_oracle(arch, seed):
    """Experts overflow (capacity factor 0.5): ``moe_apply``'s output and
    its gradients by every parameter and by the input equal those of the
    float64 oracle that drops each expert's arrivals past its capacity,
    within 1e-5 of each leaf's largest magnitude.  (The reference is not
    the yardstick here: its clamp clobbers a kept pair, ROADMAP C11.)"""

    jc, tc, jmoe, tmoe, x = _moe_case(arch, capacity_factor=0.5, seed=seed)
    T = x.shape[1]
    weights = torch.from_numpy(np.random.default_rng(seed + 5)
                               .standard_normal((T, jc.d_model)))
    out, got = _moe_grads_torch(tmoe, x, tc, weights.float())
    p64 = {k: v.detach().double().requires_grad_() for k, v in tmoe.items()}
    x64 = torch.from_numpy(x).double().requires_grad_()
    want, clobbered = _moe_oracle(p64, x64, tc)
    assert clobbered, "the case must overflow an expert"
    (want * weights).sum().backward()
    _assert_leaves_close({"out": out.reshape(T, -1)},
                         {"out": want.detach()}, what="moe ")
    _assert_leaves_close(got, {**{k: v.grad for k, v in p64.items()},
                               "x": x64.grad}, what="moe grad ")
    # the router learns only through the kept pairs' gates
    assert float(got["router"].abs().max()) > 0


def _ssd_recurrence(x, dt, A_log, Bm, Cm, D):
    """The SSM as its step recurrence (the decode's math), differentiable:
    y [b, s, h, p] and the final state [b, h, p, n]."""

    A = -torch.exp(A_log)
    rep = x.shape[2] // Bm.shape[2]
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    st = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[3]))
    ys = []
    for t in range(x.shape[1]):
        st = st * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], st))
    return torch.stack(ys, dim=1) + x * D[None, None, :, None], st


def test_ssd_gradients_are_finite_at_the_published_chunk():
    """ROADMAP C14: at the configs' chunk of 128 and their initial decay
    (A_log = 1, dt = softplus(0): each step decays by e^-1.88), the
    masked upper triangle of the chunk's decay matrix holds sums up to
    +240, whose exp overflows f32; masked after the exp, its gradient is
    0 * inf = NaN, as the JAX package's gradient by dt is here.

    The port's ``ssd_chunked`` gradients by every input: in float64 equal
    to the step recurrence's within 1e-10 of each one's largest magnitude
    (the same math); in f32 finite and within 1e-3 (the gradient by A_log
    sums terms L_ij (cs_i - cs_j) of size up to 240 that cancel to a
    largest of about 4, and each cumulative log-decay cs carries an f32
    rounding of 240 x 2^-24; the step recurrence in f32 lands 8e-7 off,
    the chunked scan 3e-4)."""

    rng = np.random.default_rng(0)
    b, s, h, p, g, n, chunk = 1, 300, 2, 4, 1, 8, 128
    x, Bm, Cm = (rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, h, p), (b, s, g, n), (b, s, g, n)))
    dt = np.full((b, s, h), np.log(2.0), np.float32)
    A_log, D = np.ones(h, np.float32), np.ones(h, np.float32)
    weights = [rng.standard_normal((b, s, h, p)),
               rng.standard_normal((b, h, p, n))]
    args = (x, dt, A_log, Bm, Cm, D)
    names = ("x", "dt", "A_log", "Bm", "Cm", "D")

    def loss(fn, arrays, ws):
        y, st = fn(*arrays)
        return (y * ws[0]).sum() + (st * ws[1]).sum()

    def grads(fn, dtype):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in args]
        loss(fn, leaves, [torch.from_numpy(w).to(dtype)
                          for w in weights]).backward()
        return {k: t.grad for k, t in zip(names, leaves)}

    want = grads(_ssd_recurrence, torch.float64)
    for dtype, rel in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        got = grads(lambda *a: blocks.ssd_chunked(*a, chunk), dtype)
        assert all(bool(torch.isfinite(t).all()) for t in got.values())
        _assert_leaves_close({k: t.double() for k, t in got.items()},
                             {k: t.double() for k, t in want.items()},
                             rel=rel, what=f"ssd grad {dtype} ")

    jgrads = jax.grad(lambda *a: loss(
        lambda *c: jblocks.ssd_chunked(*c, chunk), a,
        [jnp.asarray(w, jnp.float32) for w in weights]),
        argnums=tuple(range(6)))(*map(jnp.asarray, args))
    assert bool(jnp.isnan(jgrads[1]).any())
