"""LM assembly: embeddings + the layer stack + head; train/prefill/decode.

The JAX package's ``models/lm.py``, every family, on one device:

* layer parameters are stacked on a leading ``[L, ...]`` axis, as in the
  JAX package, and the depth loop is a Python loop over that axis (the JAX
  package's ``lax.scan``);
* the decode cache is a tree stacked on the same axis; ``decode_step``
  updates it in place, where the JAX package donates it to the jitted step
  (``launch/serve.py``) and so updates it in place too;
* ``attention="ref"`` on ``prefill`` and on the training functions runs the
  attention's plain version (``attention_reference``) instead of the flash
  kernels: the whole path against its plain version on the card;
* training (``hidden_forward``, ``chunked_xent``, ``loss_fn``) runs under
  autograd with the JAX package's remat policies (``_remat``,
  ``_scan_layers``) over ``torch.utils.checkpoint``, and ``chunked_xent``
  recomputes each sequence chunk's logits in the backward, so no
  ``(B, S, V)`` slab stays alive;
* ``params["layers"]`` is either the stacked tree or a list of per-layer
  trees (``launch/train.py`` hands the model per-layer views of the stacked
  leaves, so each layer's gradient is a tensor of its own);
* whisper (``encdec``) runs the encoder stack (bidirectional) over the
  frame embeddings ``enc_input`` and wires its output into each decoder
  layer's cross-attention; at serve time the cross K/V is computed once at
  prefill and carried in ``cache["cross"]``;
* inside a :func:`~repro_torch.parallel.sharding.placement` (the train
  step on a mesh, ROADMAP A10e-1, and prefill and decode on a mesh,
  A10e-2) the parameters are this rank's blocks: the embedding, the head
  and the loss are vocab-parallel over ``model`` (each rank looks up and
  scores its own vocab range, ``psum``/``pmax`` join them; the head's
  logits stay cut, :func:`gather_logits` joins them), the loss is the
  mean over the global microbatch (its sums ``psum``'d over the batch
  axes), and under ZeRO-3 each layer's parameters and the head are
  gathered over ``data`` at use (``sharding.at_use``).  The decode cache
  is this rank's rows and, where ``model`` divides them, its block of the
  slots (``init_cache(mesh=...)``, the reference's ``cache_shardings``);
* whisper on a mesh (ROADMAP A10h-1): the encoder's layers are the dense
  tensor-parallel layers (bidirectional), each decoder layer's
  cross-attention is column-parallel over heads with ``wo`` row-parallel,
  and the cross K/V cache holds every head on every ``model`` rank (cut
  over ``batch`` only, as the reference lays it out): prefill all-gathers
  each layer's K/V heads once, decode narrows to the rank's own;
* a tied table (mamba2-130m, ROADMAP A10h-2) is the vocab-parallel
  lookup and the vocab-parallel head at once: autograd sums both parts of
  its gradient into the one leaf, and under ZeRO-3 it is gathered once
  for each use (the lookup, then the head or the loss).
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
from math import prod
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.blocks import LayerCtx, ParamSpec
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.models.common import (
    ArchConfig,
    chunked_attention,
    dtype_of,
    rms_norm,
    rope,
)

__all__ = [
    "model_specs",
    "n_stack",
    "param_count",
    "init_params",
    "abstract_params",
    "param_axes",
    "serving_params",
    "forward",
    "hidden_forward",
    "chunked_xent",
    "loss_fn",
    "REMAT_POLICIES",
    "prefill",
    "decode_step",
    "cache_specs",
    "cache_axes",
    "init_cache",
    "abstract_cache",
    "gather_logits",
]

_STACKED_KEYS = ("layers", "enc_layers")
Device = Optional[Union[str, torch.device]]


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _spec_map(fn, tree):
    """``fn`` over the ParamSpec leaves of a nested dict."""

    if _is_spec(tree):
        return fn(tree)
    return {k: _spec_map(fn, v) for k, v in tree.items()}


def _spec_leaves(tree):
    if _is_spec(tree):
        return [tree]
    return [s for v in tree.values() for s in _spec_leaves(v)]


# ---------------------------------------------------------------------------
# Param specs / init
# ---------------------------------------------------------------------------


def _embed_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    E, V = cfg.d_model, cfg.padded_vocab
    specs = {
        "tok": ParamSpec((V, E), ("vocab", "embed")),
        "out_norm": ParamSpec((E,), ("embed",), init="ones", dtype="float32"),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((E, V), ("embed", "vocab"))
    return specs


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, family="dense", window=None)


def model_specs(cfg: ArchConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": _embed_specs(cfg),
        "layers": blocks.layer_specs(cfg),      # stacked x n_layers
    }
    if cfg.family == "encdec":
        specs["enc_layers"] = blocks.layer_specs(_encoder_cfg(cfg))
        specs["enc_norm"] = ParamSpec((cfg.d_model,), ("embed",),
                                      init="ones", dtype="float32")
        specs["layers"]["lnx"] = ParamSpec(
            (cfg.d_model,), ("embed",), init="ones", dtype="float32")
        specs["layers"]["xattn"] = blocks.attention_specs(cfg)
    return specs


def n_stack(cfg: ArchConfig, key: str) -> int:
    """Layers stacked on the leading axis of ``params[key]`` (0: not a
    stacked key)."""

    if key not in _STACKED_KEYS:
        return 0
    return cfg.enc_layers if key == "enc_layers" else cfg.n_layers


def param_count(cfg: ArchConfig) -> int:
    total = 0
    for key, sub in model_specs(cfg).items():
        n = n_stack(cfg, key) or 1
        total += sum(n * prod(s.shape) for s in _spec_leaves(sub))
    return total


def _init_leaf(spec: ParamSpec, cfg: ArchConfig, stacked: int,
               gen: torch.Generator, device: torch.device) -> torch.Tensor:
    dt = dtype_of(spec.dtype or cfg.param_dtype)
    shape = ((stacked,) + spec.shape) if stacked else spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    scale = 0.02
    if spec.init == "small_normal":
        scale = 0.02 / max(1.0, (2.0 * cfg.n_layers) ** 0.5)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dt)


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device: Device = None) -> Dict[str, Any]:
    """Random parameters with the JAX package's distribution (normal
    0.02, ``small_normal`` scaled by 1/sqrt(2 L), ones and zeros), drawn
    from ``gen`` (a generator on ``device``): not the JAX package's bits."""

    device = resolve_device(device)
    params: Dict[str, Any] = {}
    for k, sub in model_specs(cfg).items():
        stacked = n_stack(cfg, k)
        params[k] = _spec_map(
            lambda s: _init_leaf(s, cfg, stacked, gen, device), sub)
    return params


def abstract_params(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameters' shapes and dtypes as tensors on the ``meta``
    device (no storage, no generator): the JAX package's
    ``abstract_params``, for the dry run."""

    meta = torch.device("meta")
    params: Dict[str, Any] = {}
    for k, sub in model_specs(cfg).items():
        stacked = n_stack(cfg, k)
        params[k] = _spec_map(lambda s: torch.empty(
            ((stacked,) + s.shape) if stacked else s.shape,
            dtype=dtype_of(s.dtype or cfg.param_dtype), device=meta), sub)
    return params


def param_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The logical-axes tree parallel to the params tree, a tuple a leaf
    ("stack" prepended for layer-stacked leaves)."""

    out: Dict[str, Any] = {}
    for k, sub in model_specs(cfg).items():
        pre = ("stack",) if n_stack(cfg, k) else ()
        out[k] = _spec_map(lambda s: pre + tuple(s.axes), sub)
    return out


def serving_params(cfg: ArchConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``params`` with every leaf that the model only reads cast
    to the compute dtype (``x.to(dt) @ w.to(dt)``, ``take(tok).to(dt)``)
    made in that dtype once, at load: the matmul weights, the embedding
    table and the head.  Norm scales (f32 by their spec) stay as they are.
    Gives the same bits as the cast per call, without the per-call cast
    (for bf16 compute, half the weight bytes read per decode step)."""

    dt = dtype_of(cfg.compute_dtype)
    specs = model_specs(cfg)

    def cast(spec_tree, leaf_tree):
        if _is_spec(spec_tree):
            return leaf_tree if spec_tree.dtype else leaf_tree.to(dt)
        return {k: cast(spec_tree[k], leaf_tree[k]) for k in spec_tree}

    return cast(specs, params)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    if cfg.family == "ssm":
        return None, None
    dim = cfg.rope_head_dim if cfg.family == "mla" else cfg.hd
    return rope(positions, dim, cfg.rope_theta)


def _layer(params: Dict[str, Any], i: int,
           key: str = "layers") -> Dict[str, Any]:
    layers = params[key]
    if isinstance(layers, (list, tuple)):
        layer = layers[i]
    else:
        layer = tree_map(lambda a: a[i], layers)
    return sharding.at_use(layer, key, stacked=True)


def _vocab_local(ids: torch.Tensor, n: int):
    """``ids`` in this ``model`` rank's vocab block of ``n`` rows: the
    local row (clamped into ``[0, n)``, ROADMAP C1) and whether the id
    lies in the block."""

    local = ids.long() - C.axis_index("model") * n
    inside = (local >= 0) & (local < n)
    return torch.clamp(local, 0, n - 1), inside


def _embed_tokens(params, tokens, cfg):
    dt = dtype_of(cfg.compute_dtype)
    emb = sharding.at_use(params["embed"]["tok"], "embed", "tok")
    tp = sharding.tp_axes()
    if not tp or emb.shape[0] == cfg.padded_vocab:
        return emb[tokens.long()].to(dt)
    # Vocab-parallel: each rank's rows for the ids in its block, zeros for
    # the rest, summed over the ranks.
    local, inside = _vocab_local(tokens, emb.shape[0])
    x = torch.where(inside[..., None], emb[local], 0.0)
    return C.reduce_from(x, tp).to(dt)


def _lm_head(params, x, cfg):
    """Logits of the hidden states ``x``.  In a placement, this ``model``
    rank's block of the vocab columns (the padded ones lie in the last
    rank's block: masked by their global index)."""

    dt = dtype_of(cfg.compute_dtype)
    x = rms_norm(x, sharding.at_use(params["embed"]["out_norm"], "embed",
                                    "out_norm"))
    head = (
        sharding.at_use(params["embed"]["tok"], "embed", "tok").T
        if cfg.tie_embeddings
        else sharding.at_use(params["embed"]["head"], "embed", "head")
    )
    tp = sharding.tp_axes()
    split = bool(tp) and head.shape[-1] < cfg.padded_vocab
    logits = C.copy_to(x.to(dt), tp if split else ()) @ head.to(dt)
    if cfg.padded_vocab != cfg.vocab:
        # padded columns never win an argmax or enter a softmax
        col = torch.arange(logits.shape[-1], device=logits.device)
        if split:
            col = col + C.axis_index("model") * logits.shape[-1]
        logits = logits.masked_fill(col >= cfg.vocab, -1e30)
    return logits


def _encoder(params, enc_input, cfg, remat_policy="none", attention="auto"):
    """Whisper encoder: bidirectional dense stack over frame embeddings."""

    if enc_input is None:
        raise ValueError(f"{cfg.name}: the encoder-decoder needs encoder "
                         f"frames (enc_input)")
    S = enc_input.shape[1]
    x = enc_input.to(dtype_of(cfg.compute_dtype))
    sin, cos = _rope_tables(cfg, torch.arange(S, device=x.device)[None, :])
    ctx = LayerCtx(cfg=_encoder_cfg(cfg), mode="train", sin=sin, cos=cos,
                   causal=False, attention=attention)

    def body(h, layer_params):
        return blocks.layer_apply(layer_params, h, ctx)[0]

    x = _scan_layers(body, x, params, cfg.enc_layers, remat_policy,
                     key="enc_layers")
    return rms_norm(x, params["enc_norm"])


def _xattn_tp(params, cfg) -> Tuple[str, ...]:
    """The ``model`` axes the decoder's cross-attention heads are cut over
    (``()`` where they are whole), read from layer 0's ``wq`` width."""

    layers = params["layers"]
    wq = (layers[0] if isinstance(layers, (list, tuple)) else
          layers)["xattn"]["wq"]
    return blocks._tp_cut(wq.shape[-1] // cfg.hd, cfg.n_heads)


def _cross_kv(p, enc_out, cfg):
    """The encoder output's K/V at the rank's kv heads (the local width of
    ``wk``/``wv``), or every kv head where ``model`` does not divide them
    (ROADMAP A10h-3, case (i): the projections' columns all-gathered)."""

    dt = dtype_of(cfg.compute_dtype)
    B, S, _ = enc_out.shape
    D = cfg.hd
    k = enc_out.to(dt) @ p["wk"].to(dt)
    v = enc_out.to(dt) @ p["wv"].to(dt)
    tp = blocks._tp_cut(k.shape[-1], cfg.n_kv_heads * D)
    if tp and cfg.n_kv_heads % sharding.ambient_axis_size(tp[0]):
        k, v = blocks._gather_columns([k, v], tp)
    return k.reshape(B, S, -1, D), v.reshape(B, S, -1, D)


def _cross_attention(p, x, enc_kv, cfg, attention="auto"):
    """Decoder cross-attention: q from the decoder, K/V from the encoder.

    On a mesh (ROADMAP A10h-1) q, K and V are column-parallel over the
    rank's heads and ``wo`` row-parallel; a K/V holding every head (the
    decode's cross cache, whole over ``model``, or kv heads that ``model``
    does not divide) is narrowed to the rank's heads, or repeated to its
    q heads (A10h-3, case (i)), with no collective.  The q heads must
    divide ``model`` (A10h-4; the mesh steps refuse the rest)."""

    dt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    D = cfg.hd
    H = p["wq"].shape[-1] // D
    tp = blocks._tp_cut(H, cfg.n_heads)
    x = C.copy_to(x, tp)
    q = (x.to(dt) @ p["wq"].to(dt)).reshape(B, S, H, D)
    k, v = enc_kv
    KH = cfg.n_kv_heads
    if tp and k.shape[2] == KH:
        if KH % C.axis_size(tp[0]):
            k, v = (blocks._repeat_kv(t, cfg, tp) for t in (k, v))
        else:
            n = KH // C.axis_size(tp[0])
            k = k.narrow(2, C.axis_index(tp) * n, n)
            v = v.narrow(2, C.axis_index(tp) * n, n)
    out = chunked_attention(q, k, v, causal=False, window=None,
                            impl=attention)
    return C.reduce_from(out.reshape(B, S, H * D).to(dt) @ p["wo"].to(dt),
                         tp)


_CORE = ("ln1", "attn", "ln2", "mlp")


def _apply(layer_params, h, ctx: LayerCtx, cache=None, cross=None):
    """One decoder layer; with ``cross`` (encdec) its self-attention core,
    then cross-attention over the encoder's ``cross = (k, v)``."""

    if cross is None:
        return blocks.layer_apply(layer_params, h, ctx, cache)
    core = {k: layer_params[k] for k in _CORE}
    h, c = blocks.layer_apply(core, h, ctx, cache)
    h = h + _cross_attention(layer_params["xattn"],
                             rms_norm(h, layer_params["lnx"]), cross,
                             ctx.cfg, ctx.attention)
    return h, c


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: ArchConfig,
    *,
    enc_input: Optional[torch.Tensor] = None,
    attention: str = "auto",
) -> torch.Tensor:
    """Teacher-forced forward -> logits (B, S, V)."""

    return _lm_head(params, hidden_forward(
        params, tokens, cfg, enc_input=enc_input, remat_policy="none",
        attention=attention), cfg)


# ---------------------------------------------------------------------------
# Training: remat, hidden states, chunked cross entropy, loss
# ---------------------------------------------------------------------------

# Remat policies of the JAX package (``lm._remat`` / ``_scan_layers``):
# "none" keeps every activation, "full" recomputes each layer in the
# backward, "dots" keeps the matmul outputs (``checkpoint_dots``) and
# recomputes the rest, "group:G" keeps only every G-th layer boundary.
REMAT_POLICIES = ("none", "full", "dots", "group:G")

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint`` of ``fn``, which runs, in the forward and
    when the backward recomputes it, in a copy of the caller's context
    variables: on the card autograd recomputes in its device thread, where
    the mesh a step binds (``collectives.bind``, ``sharding.placement``)
    would be unset."""

    ctx = contextvars.copy_context()
    return checkpoint(lambda *a: ctx.run(fn, *a), *args,
                      use_reentrant=False, **kwargs)


def _remat(fn, policy: str):
    """``fn`` under the remat ``policy`` ("none", "full" or "dots")."""

    if policy == "none":
        return fn
    if policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
        return lambda *a: _checkpoint(fn, *a, context_fn=context)
    if policy == "full":
        return lambda *a: _checkpoint(fn, *a)
    raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got "
                     f"{policy!r}")


def _scan_layers(body, x, params, n_layers: int, policy: str,
                 key: str = "layers"):
    """The depth loop ``x = body(x, layer i of params[key])`` under the
    remat ``policy``.

    ``group:G`` is sqrt-style checkpointing: only every G-th layer boundary
    is saved for the backward, and a group's G layers are recomputed
    together (their internals kept while its backward runs); when G does
    not divide the depth, or G <= 1, it is "full", as in the JAX
    package."""

    if policy.startswith("group:"):
        G = int(policy.split(":")[1])
        if n_layers % G == 0 and G > 1:
            def group_body(h, start):
                for i in range(start, start + G):
                    h = body(h, _layer(params, i, key))
                return h

            for start in range(0, n_layers, G):
                x = _checkpoint(group_body, x, start)
            return x
        policy = "full"
    step = _remat(lambda h, i: body(h, _layer(params, i, key)), policy)
    for i in range(n_layers):
        x = step(x, i)
    return x


def hidden_forward(
    params, tokens: torch.Tensor, cfg: ArchConfig, *,
    enc_input: Optional[torch.Tensor] = None, remat_policy: str = "full",
    attention: str = "auto",
) -> torch.Tensor:
    """Forward up to (but excluding) the LM head: final hidden states."""

    B, S = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    sin, cos = _rope_tables(cfg, torch.arange(S, device=x.device)[None, :])
    ctx = LayerCtx(cfg=cfg, mode="train", sin=sin, cos=cos,
                   attention=attention)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encoder(params, enc_input, cfg, remat_policy, attention)
        # Every layer's cross K/V reads its heads of the whole encoder
        # output: one copy_to sums the layers' partial gradients over
        # ``model`` once.
        enc_out = C.copy_to(enc_out, _xattn_tp(params, cfg))

    def body(h, layer_params):
        cross = None if enc_out is None else _cross_kv(
            layer_params["xattn"], enc_out, cfg)
        return _apply(layer_params, h, ctx, cross=cross)[0]

    return _scan_layers(body, x, params, cfg.n_layers, remat_policy)


def chunked_xent(params, hidden: torch.Tensor, labels: torch.Tensor,
                 cfg: ArchConfig, chunk: int = 512) -> torch.Tensor:
    """Cross entropy with sequence-chunked logits: each chunk's logits are
    computed, reduced to (lse, picked) and recomputed in the backward (a
    checkpointed body), so the (B, S, V) logits slab never materialises.
    Labels < 0 are ignored.

    In a placement the head's vocab columns are this ``model`` rank's
    block (the padded columns lie in the last rank's): the row max is
    ``pmax``'d, the sum of exponentials and the label's logit ``psum``'d
    over ``model``; the loss and the label count are summed over the
    batch axes before the division, the mean over the global microbatch.
    Under ZeRO-3 the head is gathered once here, not once a chunk."""

    dt = dtype_of(cfg.compute_dtype)
    B, S, E = hidden.shape
    head = (
        sharding.at_use(params["embed"]["tok"], "embed", "tok").T
        if cfg.tie_embeddings
        else sharding.at_use(params["embed"]["head"], "embed", "head")
    ).to(dt)
    out_norm = sharding.at_use(params["embed"]["out_norm"], "embed",
                               "out_norm")
    chunk = min(chunk, S)
    tp = sharding.tp_axes()
    n_cols = head.shape[-1]
    split = bool(tp) and n_cols < cfg.padded_vocab
    col = torch.arange(n_cols, device=hidden.device)
    if split:
        col = col + C.axis_index("model") * n_cols
    padded = col >= cfg.vocab

    def body(xc, lc):
        xn = rms_norm(xc, out_norm).to(dt)
        if split:
            xn = C.copy_to(xn, tp)
        logits = (xn @ head).to(torch.float32)
        logits = logits.masked_fill(padded, -1e30)
        valid = lc >= 0
        if split:
            # The row max cancels in the loss's gradient: it carries none.
            m = C.pmax(torch.amax(logits.detach(), dim=-1), tp)
            local, inside = _vocab_local(lc, n_cols)
            picked = torch.where(
                inside, torch.gather(logits, -1, local[..., None])[..., 0],
                0.0)
            sums = C.reduce_from(torch.stack([
                torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                picked]), tp)
            lse = torch.log(sums[0]) + m
            picked = sums[1]
        else:
            m = torch.amax(logits, dim=-1)
            lse = torch.log(torch.sum(torch.exp(logits - m[..., None]),
                                      dim=-1)) + m
            # the label's logit (a select, as the JAX package's sum over
            # where(col == label)); ignored labels read column 0, masked
            # below
            picked = torch.gather(
                logits, -1, torch.clamp(lc, min=0)[..., None].long())[..., 0]
        nll = torch.where(valid, lse - picked, 0.0)
        return torch.sum(nll), torch.sum(valid.to(torch.float32))

    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        xc, lc = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part, n = _checkpoint(body, xc, lc)
        else:
            part, n = body(xc, lc)
        loss_sum = loss_sum + part
        count = count + n
    dp = sharding.batch_axes()
    if dp:
        loss_sum, count = C.reduce_from(torch.stack([loss_sum, count]), dp)
    return loss_sum / torch.clamp(count, min=1.0)


def loss_fn(
    params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
    remat_policy: str = "full", *, attention: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of ``batch["tokens"]`` (positions where
    ``batch["mask"]`` is 0 are ignored; ``batch["enc_input"]`` holds an
    encoder-decoder's frames); returns ``(loss, {"loss": loss})``."""

    tokens = batch["tokens"]
    hidden = hidden_forward(params, tokens, cfg,
                            enc_input=batch.get("enc_input"),
                            remat_policy=remat_policy, attention=attention)
    labels = tokens[:, 1:]
    if "mask" in batch:
        labels = torch.where(batch["mask"][:, 1:] > 0, labels, -1)
    loss = chunked_xent(params, hidden[:, :-1], labels, cfg)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    specs = {"layers": blocks.layer_cache_specs(cfg, batch, seq)}
    if cfg.family == "encdec":
        kv = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
        specs["cross"] = {
            "k": ParamSpec(kv, ("batch", None, None, None), init="zeros",
                           dtype=cfg.compute_dtype),
            "v": ParamSpec(kv, ("batch", None, None, None), init="zeros",
                           dtype=cfg.compute_dtype),
        }
    return specs


def cache_axes(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """The cache tree's logical axes, a tuple a leaf with ``"stack"``
    (the layers) in front (the JAX package's ``cache_axes``)."""

    return {k: _spec_map(lambda s: ("stack",) + tuple(s.axes), v)
            for k, v in cache_specs(cfg, batch, seq).items()}


def init_cache(cfg: ArchConfig, batch: int, seq: int, *,
               device: Device = None, mesh=None,
               rules=None) -> Dict[str, Any]:
    """A zero cache for ``batch`` rows of ``seq`` positions; on ``mesh``
    (with the plan's ``rules``) this rank's blocks of it, on the mesh's
    device, cut as ``launch.serve.cache_specs_on`` cuts it."""

    if mesh is not None:
        from repro_torch.carry import sharded_zeros
        from repro_torch.launch.serve import cache_specs_on

        return sharded_zeros(abstract_cache(cfg, batch, seq),
                             cache_specs_on(cfg, mesh, rules, batch, seq),
                             mesh)
    device = resolve_device(device)
    return {
        k: _spec_map(lambda s: torch.zeros(
            (cfg.n_layers,) + s.shape, dtype=dtype_of(s.dtype or "float32"),
            device=device), v)
        for k, v in cache_specs(cfg, batch, seq).items()
    }


def abstract_cache(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """:func:`init_cache`'s tree on the ``meta`` device (the JAX
    package's ``abstract_cache``)."""

    return init_cache(cfg, batch, seq, device="meta")


def gather_logits(logits: torch.Tensor, cfg: ArchConfig, mesh, rules,
                  batch: int) -> torch.Tensor:
    """The global ``(batch, S, V)`` logits from every rank's block (its
    rows, and its vocab columns where ``model`` cuts them: the reference's
    ``("batch", "seq", "vocab")`` layout under ``rules``); every rank of
    ``mesh`` calls it and gets the whole."""

    spec = sharding.logical_to_spec(
        rules, ("batch", "seq", "vocab"),
        shape=(batch, logits.shape[1], cfg.padded_vocab), mesh=mesh)
    return sharding.join_blocks(logits, spec, mesh)


def _stack_into(stack, i: int, tree, n: int):
    """``tree`` copied into layer ``i`` of ``stack`` (made ``[n, ...]`` on
    first use)."""

    if stack is None:
        stack = tree_map(lambda t: t.new_empty((n,) + t.shape), tree)
    tree_map(lambda dst, src: dst[i].copy_(src), stack, tree)
    return stack


def _whole_heads(kv, cfg):
    """The cross cache's ``{"k", "v"}`` from the rank's heads of the
    encoder's K/V: where ``model`` cuts them, every head (one all-gather
    of K and V stacked), as the reference's cache layout ``("batch", None,
    None, None)`` keeps them on every rank."""

    k, v = kv
    if k.shape[2] < cfg.n_kv_heads:
        both = C.all_gather_dim(torch.stack([k, v]), sharding.tp_axes(), 3)
        k, v = both[0], both[1]
    return {"k": k, "v": v}


def prefill(
    params, tokens: torch.Tensor, cfg: ArchConfig, cache_len: int,
    *, enc_input: Optional[torch.Tensor] = None, attention: str = "auto",
):
    """Run the prompt, return (last-token logits, filled cache, pos)."""

    S = tokens.shape[1]
    x = _embed_tokens(params, tokens, cfg)
    sin, cos = _rope_tables(cfg, torch.arange(S, device=x.device)[None, :])
    ctx = LayerCtx(cfg=cfg, mode="prefill", sin=sin, cos=cos,
                   cache_len=cache_len, attention=attention,
                   kv_axes=sharding.cut_axes("kv_seq", cache_len))
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encoder(params, enc_input, cfg, attention=attention)
    # Stacked from the layers' own caches, as the JAX package's scan stacks
    # them: cache_len slots, whatever the window (init_cache would hold
    # min(cache_len, window)).
    layers = cross_kv = None
    for i in range(cfg.n_layers):
        layer_params = _layer(params, i)
        cross = None
        if enc_out is not None:
            cross = _cross_kv(layer_params["xattn"], enc_out, cfg)
            cross_kv = _stack_into(cross_kv, i, _whole_heads(cross, cfg),
                                   cfg.n_layers)
        x, c = _apply(layer_params, x, ctx, cross=cross)
        layers = _stack_into(layers, i, c, cfg.n_layers)
    logits = _lm_head(params, x[:, -1:, :], cfg)
    cache = {"layers": layers}
    if cross_kv is not None:
        cache["cross"] = cross_kv
    return logits, cache, S


def decode_step(
    params, cache: Dict[str, Any], token: torch.Tensor, pos: int,
    cfg: ArchConfig, *, attention: str = "auto",
    cache_len: Optional[int] = None,
):
    """One decode step: token (B, 1) + cache -> (logits, cache).

    ``pos`` is the absolute position of ``token``.  The cache is updated in
    place and returned (the JAX package donates it to the jitted step).
    ``attention`` is the cross-attention's implementation (encdec); the
    self-attention over the cache is plain PyTorch.  In a placement the
    cache is this rank's blocks and ``cache_len`` the whole cache's slots
    (a block does not tell whether the slots were cut)."""

    B = token.shape[0]
    pos = int(pos)
    kv_axes = ()
    if sharding.tp_axes():
        if cache_len is None:
            raise ValueError("decode on a mesh needs the cache's global "
                             "slot count (cache_len=)")
        kv_axes = sharding.cut_axes("kv_seq", cache_len)
    x = _embed_tokens(params, token, cfg)
    sin, cos = _rope_tables(
        cfg, torch.full((1, 1), pos, dtype=torch.int32, device=x.device))
    if sin is not None:
        sin = sin.expand((B,) + sin.shape[1:])
        cos = cos.expand((B,) + cos.shape[1:])
    ctx = LayerCtx(cfg=cfg, mode="decode", sin=sin, cos=cos, pos=pos,
                   attention=attention, cache_len=cache_len or 0,
                   kv_axes=kv_axes)
    for i in range(cfg.n_layers):
        layer_cache = tree_map(lambda a: a[i], cache["layers"])
        cross = None
        if cfg.family == "encdec":
            cross = (cache["cross"]["k"][i], cache["cross"]["v"][i])
        x, _ = _apply(_layer(params, i), x, ctx, layer_cache, cross)
    logits = _lm_head(params, x, cfg)
    return logits, cache
