"""LM assembly: embeddings + the layer stack + head; train/prefill/decode.

The JAX package's ``models/lm.py`` for the dense family, on one device:

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
  leaves, so each layer's gradient is a tensor of its own).

The other families (encoder-decoder included) raise (ROADMAP A14(c)).
"""

from __future__ import annotations

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
from repro_torch.models.common import ArchConfig, dtype_of, rms_norm, rope

__all__ = [
    "model_specs",
    "param_count",
    "init_params",
    "serving_params",
    "forward",
    "hidden_forward",
    "chunked_xent",
    "loss_fn",
    "REMAT_POLICIES",
    "prefill",
    "decode_step",
    "cache_specs",
    "init_cache",
]

_STACKED_KEYS = ("layers",)
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


def model_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "embed": _embed_specs(cfg),
        "layers": blocks.layer_specs(cfg),      # stacked x n_layers
    }


def param_count(cfg: ArchConfig) -> int:
    total = 0
    for key, sub in model_specs(cfg).items():
        n = cfg.n_layers if key in _STACKED_KEYS else 1
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
        stacked = cfg.n_layers if k in _STACKED_KEYS else 0
        params[k] = _spec_map(
            lambda s: _init_leaf(s, cfg, stacked, gen, device), sub)
    return params


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
    return rope(positions, cfg.hd, cfg.rope_theta)


def _layer(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return tree_map(lambda a: a[i], layers)


def _embed_tokens(params, tokens, cfg):
    dt = dtype_of(cfg.compute_dtype)
    emb = params["embed"]["tok"]
    return emb[tokens.long()].to(dt)


def _lm_head(params, x, cfg):
    dt = dtype_of(cfg.compute_dtype)
    x = rms_norm(x, params["embed"]["out_norm"])
    head = (
        params["embed"]["tok"].T if cfg.tie_embeddings
        else params["embed"]["head"]
    )
    logits = x.to(dt) @ head.to(dt)
    if cfg.padded_vocab != cfg.vocab:
        # padded columns never win an argmax or enter a softmax
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab, -1e30)
    return logits


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise blocks.unported_family(cfg)


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: ArchConfig,
) -> torch.Tensor:
    """Teacher-forced forward -> logits (B, S, V)."""

    _check_family(cfg)
    B, S = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    sin, cos = _rope_tables(cfg, torch.arange(S, device=x.device)[None, :])
    ctx = LayerCtx(cfg=cfg, mode="train", sin=sin, cos=cos)
    for i in range(cfg.n_layers):
        x, _ = blocks.layer_apply(_layer(params, i), x, ctx)
    return _lm_head(params, x, cfg)


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


def _remat(fn, policy: str):
    """``fn`` under the remat ``policy`` ("none", "full" or "dots")."""

    if policy == "none":
        return fn
    if policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context)
    if policy == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got "
                     f"{policy!r}")


def _scan_layers(body, x, params, n_layers: int, policy: str):
    """The depth loop ``x = body(x, layer i)`` under the remat ``policy``.

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
                    h = body(h, _layer(params, i))
                return h

            for start in range(0, n_layers, G):
                x = checkpoint(group_body, x, start, use_reentrant=False)
            return x
        policy = "full"
    step = _remat(lambda h, i: body(h, _layer(params, i)), policy)
    for i in range(n_layers):
        x = step(x, i)
    return x


def hidden_forward(
    params, tokens: torch.Tensor, cfg: ArchConfig, *,
    remat_policy: str = "full", attention: str = "auto",
) -> torch.Tensor:
    """Forward up to (but excluding) the LM head: final hidden states."""

    _check_family(cfg)
    B, S = tokens.shape
    x = _embed_tokens(params, tokens, cfg)
    sin, cos = _rope_tables(cfg, torch.arange(S, device=x.device)[None, :])
    ctx = LayerCtx(cfg=cfg, mode="train", sin=sin, cos=cos,
                   attention=attention)

    def body(h, layer_params):
        return blocks.layer_apply(layer_params, h, ctx)[0]

    return _scan_layers(body, x, params, cfg.n_layers, remat_policy)


def chunked_xent(params, hidden: torch.Tensor, labels: torch.Tensor,
                 cfg: ArchConfig, chunk: int = 512) -> torch.Tensor:
    """Cross entropy with sequence-chunked logits: each chunk's logits are
    computed, reduced to (lse, picked) and recomputed in the backward (a
    checkpointed body), so the (B, S, V) logits slab never materialises.
    Labels < 0 are ignored."""

    dt = dtype_of(cfg.compute_dtype)
    B, S, E = hidden.shape
    head = (
        params["embed"]["tok"].T if cfg.tie_embeddings
        else params["embed"]["head"]
    ).to(dt)
    out_norm = params["embed"]["out_norm"]
    chunk = min(chunk, S)
    col = torch.arange(cfg.padded_vocab, device=hidden.device)
    padded = col >= cfg.vocab

    def body(xc, lc):
        logits = (rms_norm(xc, out_norm).to(dt) @ head).to(torch.float32)
        logits = logits.masked_fill(padded, -1e30)
        m = torch.amax(logits, dim=-1)
        lse = torch.log(torch.sum(torch.exp(logits - m[..., None]),
                                  dim=-1)) + m
        valid = lc >= 0
        # the label's logit (a select, as the JAX package's sum over
        # where(col == label)); ignored labels read column 0, masked below
        picked = torch.gather(logits, -1,
                              torch.clamp(lc, min=0)[..., None].long())[..., 0]
        nll = torch.where(valid, lse - picked, 0.0)
        return torch.sum(nll), torch.sum(valid.to(torch.float32))

    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        xc, lc = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part, n = checkpoint(body, xc, lc, use_reentrant=False)
        else:
            part, n = body(xc, lc)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum / torch.clamp(count, min=1.0)


def loss_fn(
    params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
    remat_policy: str = "full", *, attention: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of ``batch["tokens"]`` (positions where
    ``batch["mask"]`` is 0 are ignored); returns ``(loss, {"loss": loss})``."""

    tokens = batch["tokens"]
    hidden = hidden_forward(params, tokens, cfg, remat_policy=remat_policy,
                            attention=attention)
    labels = tokens[:, 1:]
    if "mask" in batch:
        labels = torch.where(batch["mask"][:, 1:] > 0, labels, -1)
    loss = chunked_xent(params, hidden[:, :-1], labels, cfg)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    return {"layers": blocks.layer_cache_specs(cfg, batch, seq)}


def init_cache(cfg: ArchConfig, batch: int, seq: int, *,
               device: Device = None) -> Dict[str, Any]:
    device = resolve_device(device)
    return {
        k: _spec_map(lambda s: torch.zeros(
            (cfg.n_layers,) + s.shape, dtype=dtype_of(s.dtype or "float32"),
            device=device), v)
        for k, v in cache_specs(cfg, batch, seq).items()
    }


def prefill(
    params, tokens: torch.Tensor, cfg: ArchConfig, cache_len: int,
    *, attention: str = "auto",
):
    """Run the prompt, return (last-token logits, filled cache, pos)."""

    _check_family(cfg)
    S = tokens.shape[1]
    x = _embed_tokens(params, tokens, cfg)
    sin, cos = _rope_tables(cfg, torch.arange(S, device=x.device)[None, :])
    ctx = LayerCtx(cfg=cfg, mode="prefill", sin=sin, cos=cos,
                   cache_len=cache_len, attention=attention)
    # Stacked from the layers' own caches, as the JAX package's scan stacks
    # them: cache_len slots, whatever the window (init_cache would hold
    # min(cache_len, window)).
    layers = None
    for i in range(cfg.n_layers):
        x, c = blocks.layer_apply(_layer(params, i), x, ctx)
        if layers is None:
            layers = tree_map(
                lambda t: t.new_empty((cfg.n_layers,) + t.shape), c)
        tree_map(lambda dst, src: dst[i].copy_(src), layers, c)
    logits = _lm_head(params, x[:, -1:, :], cfg)
    return logits, {"layers": layers}, S


def decode_step(
    params, cache: Dict[str, Any], token: torch.Tensor, pos: int,
    cfg: ArchConfig,
):
    """One decode step: token (B, 1) + cache -> (logits, cache).

    ``pos`` is the absolute position of ``token``.  The cache is updated in
    place and returned (the JAX package donates it to the jitted step)."""

    _check_family(cfg)
    B = token.shape[0]
    pos = int(pos)
    x = _embed_tokens(params, token, cfg)
    sin, cos = _rope_tables(
        cfg, torch.full((1, 1), pos, dtype=torch.int32, device=x.device))
    sin = sin.expand((B,) + sin.shape[1:])
    cos = cos.expand((B,) + cos.shape[1:])
    ctx = LayerCtx(cfg=cfg, mode="decode", sin=sin, cos=cos, pos=pos)
    for i in range(cfg.n_layers):
        layer_cache = tree_map(lambda a: a[i], cache["layers"])
        x, _ = blocks.layer_apply(_layer(params, i), x, ctx, layer_cache)
    logits = _lm_head(params, x, cfg)
    return logits, cache

