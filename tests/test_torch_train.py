"""The port's LM training path against the JAX package's, on the CPU.

Reduced dense configs (``reduced_config``: 2 layers, d_model 64, f32
compute), JAX parameters carried into the port by ``lm_params_from_numpy``
/ ``train_state_from_numpy``, and the same numpy tokens into both:

* ``loss_fn`` value and gradients under the remat policies "none", "full",
  "dots" and "group:2", and ``chunked_xent`` with chunks of 7 (ragged
  last chunk, ignored labels): within 1e-5 (f32 sums in another order);
* ``sgd`` (with and without momentum), ``adamw`` (f32 and bf16 first
  moment), ``clip_by_global_norm`` and ``warmup_cosine`` over 3 updates:
  within 1e-6 relative, bf16 moments within one bf16 ulp;
* ``build_train_step`` for 3 steps at 1 and 2 microbatches: loss and
  grad_norm per step within rtol 1e-5, parameters within atol 1e-5;
* the loss falls on the port's own ``zipf`` stream (as
  ``tests/test_models.py`` checks the JAX package's), and the stream is a
  pure function of (seed, step) that resumes from its ``state_dict``.
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
from repro.models import lm as jlm
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced
from repro.optim import optimizers as jopt
from repro_torch.carry import lm_params_from_numpy, train_state_from_numpy
from repro_torch.core.hardware import MeshSpec
from repro_torch.core.lm_planner import plan_lm
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticLMStream, batch_for_step
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.models.registry import get_config, reduced_config
from repro_torch.optim import optimizers as topt

TOL = 1e-5
ARCH = "phi4_mini_3_8b"


def _configs(arch=ARCH, **changes):
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


def _assert_trees_close(got, want, atol=TOL, rtol=0.0):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for key in w:
        a = g[key]
        a = (a.grad if a.grad is not None else a) if isinstance(
            a, torch.Tensor) else a
        np.testing.assert_allclose(
            np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                       else a, np.float32),
            np.asarray(w[key], np.float32), atol=atol, rtol=rtol,
            err_msg=key)


def _tokens(cfg, B=2, S=20, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("policy", ["none", "full", "dots", "group:2"])
def test_loss_fn_and_gradients_match_jax(policy):
    jc, tc = _configs()
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    toks = _tokens(jc)
    mask = (np.random.default_rng(1).random(toks.shape) < 0.8).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jbatch, jc, remat_policy=policy),
        has_aux=True)(jp)
    tp = lm_params_from_numpy(tc, _np_tree(jp), device="cpu")
    for t in tree_leaves(tp):
        t.requires_grad_()
    loss, aux = lm.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                "mask": torch.from_numpy(mask)}, tc,
                           remat_policy=policy)
    loss.backward()
    assert aux["loss"] is loss
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    _assert_trees_close(tp, jg)


def test_chunked_xent_with_ragged_chunks_matches_jax():
    jc, tc = _configs()
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, 19, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (2, 19)).astype(np.int32)
    labels[0, 3] = labels[1, 17] = -1
    want, jgrad = jax.value_and_grad(
        lambda h: jlm.chunked_xent(jp, h, jnp.asarray(labels), jc, chunk=7)
    )(jnp.asarray(hidden))
    tp = lm_params_from_numpy(tc, _np_tree(jp), device="cpu")
    h = torch.from_numpy(hidden).requires_grad_()
    got = lm.chunked_xent(tp, h, torch.from_numpy(labels), tc, chunk=7)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgrad), atol=TOL)


def _grads(rng, shapes, dtype=np.float32):
    return {"a": rng.normal(size=shapes[0]).astype(dtype),
            "b": {"c": rng.normal(size=shapes[1]).astype(dtype)}}


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


OPTIMIZERS = {
    "sgd": (lambda: jopt.sgd(1e-2), lambda: topt.sgd(1e-2)),
    "sgd_momentum": (lambda: jopt.sgd(1e-2, momentum=0.9),
                     lambda: topt.sgd(1e-2, momentum=0.9)),
    "adamw": (lambda: jopt.adamw(1e-2), lambda: topt.adamw(1e-2)),
    "adamw_bf16_m": (lambda: jopt.adamw(1e-2, state_dtype=jnp.bfloat16),
                     lambda: topt.adamw(1e-2, state_dtype=torch.bfloat16)),
    "adamw_warmup_cosine": (
        lambda: jopt.adamw(jopt.warmup_cosine(1e-2, 2, 5)),
        lambda: topt.adamw(topt.warmup_cosine(1e-2, 2, 5))),
}


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (float32 numpy)."""

    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _assert_within_ulp(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for key in w:
        a = g[key].detach().float().numpy()
        b = np.asarray(w[key], np.float32)
        off = np.abs(a - b) > _bf16_ulp(b)
        assert not off.any(), (key, a[off][:5], b[off][:5])


@pytest.mark.parametrize("name", list(OPTIMIZERS))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_optimizers_match_jax_over_three_updates(name, param_dtype):
    """``clip_by_global_norm`` and ``update`` (both in place) against the
    JAX package's.  f32 params within 1e-6 relative; bf16 params, and a
    bf16 first moment, within one bf16 ulp: the f32 values before the
    cast differ in their last bits, which can move a rounding by one."""

    make_j, make_t = OPTIMIZERS[name]
    jo, to = make_j(), make_t()
    rng = np.random.default_rng(3)
    shapes = ((5, 3), (7,))
    jdt, tdt = ((jnp.float32, torch.float32) if param_dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    params = _grads(rng, shapes)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
    tp = _to_torch(params, tdt)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _grads(rng, shapes)
        jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), g)
        jg, jn = jopt.clip_by_global_norm(jg, 2.0)
        jp, js = jo.update(jg, js, jp, jnp.int32(i))
        tg = _to_torch(g, tdt)
        leaf = tp["a"]
        tg, tn = topt.clip_by_global_norm(tg, 2.0)
        tp, ts = to.update(tg, ts, tp, torch.tensor(i, dtype=torch.int32))
        assert tp["a"] is leaf and tp["a"].dtype == tdt
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        if param_dtype == "float32":
            _assert_trees_close(tp, jp, atol=0, rtol=1e-6)
        else:
            _assert_within_ulp(tp, _np_tree(jp))
    if name.startswith("adamw"):
        m = ts.m["a"]
        assert m.dtype == (torch.bfloat16 if name == "adamw_bf16_m"
                           else torch.float32)
        assert ts.v["a"].dtype == torch.float32
        if m.dtype == torch.bfloat16:
            _assert_within_ulp(ts.m, _np_tree(js.m))
        else:
            _assert_trees_close(ts.m, js.m, atol=0, rtol=1e-6)
        _assert_trees_close(ts.v, js.v, atol=0, rtol=1e-6)


def test_warmup_cosine_matches_jax():
    jf, tf = jopt.warmup_cosine(3e-4, 10, 100), topt.warmup_cosine(
        3e-4, 10, 100)
    for s in (0, 5, 9, 10, 50, 99, 150):
        np.testing.assert_allclose(float(tf(torch.tensor(s))),
                                   float(jf(jnp.int32(s))), rtol=1e-6)


def _train_pair(microbatches):
    jc, tc = _configs()
    jplan = dataclasses.replace(
        jax_plan_lm(jc, "train_4k", JMeshSpec((("data", 1),))), cfg=jc,
        microbatches=microbatches)
    tplan = dataclasses.replace(
        plan_lm(tc, "train_4k", MeshSpec((("data", 1),))), cfg=tc,
        microbatches=microbatches)
    return jc, tc, jplan, tplan


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_over_three_steps(microbatches):
    jc, tc, jplan, tplan = _train_pair(microbatches)
    jopt_ = jax_train.make_optimizer(jplan)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jopt_.init(jp), "step": jnp.int32(0)}
    tstate = train_state_from_numpy(tc, _np_tree(jstate), device="cpu")
    assert tstate["step"].dtype == torch.int32
    jstep, jsh, jbsh = jax_train.build_train_step(jplan, mesh=None)
    tstep, tsh, tbsh = train.build_train_step(tplan, device="cpu")
    assert (tsh, tbsh) == (jsh, jbsh) == (None, None)
    rng = np.random.default_rng(4)
    for i in range(3):
        toks = rng.integers(0, jc.vocab, (4, 16)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": toks})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
    _assert_trees_close(tstate["params"], _np_tree(jstate["params"]))


def test_train_step_with_bf16_params_and_moments_matches_jax():
    """The full-size run's dtype policy at reduced size: bf16 params, bf16
    AdamW m, f32 v, an f32 accumulator over 2 microbatches and the in-place
    bf16 update, for 3 steps against the JAX package's step.  Each
    microbatch's gradient is rounded to bf16 in both packages, so f32 sums
    that differ in their last bits can land one bf16 ulp apart there; each
    update rounds the params to bf16 once more (the norm scales stay f32,
    as in the JAX package).  Bars: loss and grad_norm rtol 1e-5; params
    within one bf16 ulp per update, element by element;
    m and v within one bf16 ulp of the leaf's largest magnitude."""

    steps = 3
    jc, tc = _configs(param_dtype="bfloat16")
    jplan, tplan = (dataclasses.replace(
        plan(c, "train_4k", mesh((("data", 1),))), cfg=c, microbatches=2,
        m_dtype="bfloat16") for plan, mesh, c in (
            (jax_plan_lm, JMeshSpec, jc), (plan_lm, MeshSpec, tc)))
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jax_train.make_optimizer(jplan).init(jp),
              "step": jnp.int32(0)}
    tstate = train_state_from_numpy(tc, _np_tree(jstate), device="cpu")
    assert tstate["opt"].m["layers"]["attn"]["wq"].dtype == torch.bfloat16
    jstep, _, _ = jax_train.build_train_step(jplan, mesh=None)
    tstep, _, _ = train.build_train_step(tplan, device="cpu")
    rng = np.random.default_rng(4)
    for i in range(steps):
        toks = rng.integers(0, jc.vocab, (4, 16)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": toks})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
    got, want = _flat(tstate["params"]), _flat(_np_tree(jstate["params"]))
    for key in want:
        a = got[key]
        assert str(a.dtype)[6:] == str(want[key].dtype), key
        b = np.asarray(want[key], np.float32)
        np.testing.assert_array_less(np.abs(a.float().numpy() - b),
                                     steps * _bf16_ulp(b) + 1e-30,
                                     err_msg=key)
    for name in ("m", "v"):
        got = _flat(getattr(tstate["opt"], name))
        want = _flat(_np_tree(getattr(jstate["opt"], name)))
        for key in want:
            b = np.asarray(want[key], np.float32)
            np.testing.assert_allclose(
                got[key].float().numpy(), b, rtol=0,
                atol=float(_bf16_ulp(np.abs(b).max())), err_msg=name + key)


def test_train_step_updates_the_state_in_place():
    _, tc, _, tplan = _train_pair(2)
    params = lm.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = train.make_optimizer(tplan)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.tensor(0, dtype=torch.int32)}
    wq = params["layers"]["attn"]["wq"]
    before = wq.clone()
    step, _, _ = train.build_train_step(tplan, device="cpu")
    new, metrics = step(state, batch_for_step(
        DataConfig(tc.vocab, 16, 4, task="zipf"), 0, device="cpu"))
    assert new["params"]["layers"]["attn"]["wq"] is wq
    assert not torch.equal(wq, before)
    assert all(t.grad is None for t in tree_leaves(params))
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0


def test_train_loss_decreases_on_zipf_stream():
    """tests/test_models.py's smoke check on the port's own stream."""

    tc = reduced_config(get_config("minitron_8b"))
    params = lm.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
    dc = DataConfig(vocab=tc.vocab, seq_len=32, global_batch=8, task="zipf")
    opt = topt.adamw(lr=1e-2)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.tensor(0, dtype=torch.int32)}
    plan = dataclasses.replace(
        plan_lm(tc, "train_4k", MeshSpec((("data", 1),))), cfg=tc,
        microbatches=1)
    step, _, _ = train.build_train_step(plan, None, optimizer=opt,
                                        device="cpu")
    losses = []
    stream = SyntheticLMStream(dc, device="cpu")
    for _ in range(60):
        state, metrics = step(state, next(stream))
        losses.append(float(metrics["loss"]))
    assert min(losses[-10:]) < losses[0] - 0.25, losses[:5] + losses[-5:]


@pytest.mark.parametrize("task", ["zipf", "copy"])
def test_data_stream_is_pure_and_resumes(task):
    dc = DataConfig(vocab=50, seq_len=12, global_batch=3, seed=7, task=task)
    a = SyntheticLMStream(dc, device="cpu")
    first = [next(a)["tokens"] for _ in range(3)]
    saved = a.state_dict()
    rest = [next(a)["tokens"] for _ in range(2)]
    b = SyntheticLMStream(dc, device="cpu")
    b.load_state_dict(saved)
    assert all(torch.equal(x, next(b)["tokens"]) for x in rest)
    for i, x in enumerate(first + rest):
        assert torch.equal(x, batch_for_step(dc, i, device="cpu")["tokens"])
        assert x.dtype == torch.int32 and x.shape == (3, 12)
        assert int(x.min()) >= 0 and int(x.max()) < 50
    assert not torch.equal(first[0], first[1])
    other = batch_for_step(dataclasses.replace(dc, seed=8), 0, device="cpu")
    assert not torch.equal(first[0], other["tokens"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticLMStream(dataclasses.replace(dc, seed=8),
                          device="cpu").load_state_dict(saved)


def test_mesh_raises(tmp_path):
    """On a one-rank mesh the step is the unmeshed step bit for bit; the
    mla and encdec families (A10h-1) and the ssm and hybrid families
    (A10h-2) build it, with no collective."""

    import torch.distributed as dist

    from repro_torch.carry import gather_state, shard_state
    from repro_torch.launch.mesh import make_mesh

    _, tc, _, tplan = _train_pair(2)
    params = lm.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = train.make_optimizer(tplan)
    one = {"params": params, "opt": opt.init(params),
           "step": torch.tensor(0, dtype=torch.int32)}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device="cpu")
        mstep, specs, batch_fn = train.build_train_step(tplan, mesh,
                                                        optimizer=opt)
        meshed = shard_state(one, specs, mesh)
        tstep, _, _ = train.build_train_step(tplan, optimizer=opt,
                                             device="cpu")
        rng = np.random.default_rng(4)
        for _ in range(2):
            batch = {"tokens": rng.integers(0, tc.vocab, (4, 16)).astype(
                np.int32)}
            one, want = tstep(one, batch)
            meshed, got = mstep(meshed, batch_fn(batch))
            for k in ("loss", "grad_norm"):
                assert torch.equal(got[k], want[k])
        full = gather_state(meshed, specs, mesh)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full), tree_leaves(one)))
        for arch in ("minicpm3_4b", "mamba2_130m", "hymba_1_5b",
                     "whisper_medium"):
            cfg = reduced_config(get_config(arch))
            plan = dataclasses.replace(
                plan_lm(cfg, "train_4k", MeshSpec((("data", 1),))), cfg=cfg)
            calls = dict(mesh.stats.calls)
            step, specs, batch_fn = train.build_train_step(
                plan, mesh, device="cpu")
            assert callable(step) and callable(batch_fn)
            assert set(specs) == {"params", "opt", "step"}
            assert dict(mesh.stats.calls) == calls
    finally:
        dist.destroy_process_group()


def test_train_state_from_numpy_keeps_bf16_moments():
    jc, tc = _configs(param_dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    jo = jopt.adamw(state_dtype=jnp.bfloat16)
    js = jo.init(jp)
    js = jopt.AdamState(
        m=jax.tree_util.tree_map(lambda x: x + 0.5, js.m), v=js.v)
    state = train_state_from_numpy(
        tc, _np_tree({"params": jp, "opt": js, "step": jnp.int32(5)}),
        device="cpu")
    assert state["opt"].m["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert state["opt"].v["layers"]["attn"]["wq"].dtype == torch.float32
    assert state["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert int(state["step"]) == 5
    assert torch.equal(state["opt"].m["embed"]["tok"].float(),
                       torch.full(state["opt"].m["embed"]["tok"].shape, 0.5))
