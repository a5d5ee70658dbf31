"""The port's dry-run train steps against the JAX package's, on the CPU.

For the reduced config of each of the ten architectures, under full and
no remat, the census's dot FLOPs of the port's train step (the loss, its
gradient, the clip and AdamW, built by ``launch.train.build_train_step``
on the ``meta`` device) equal ``analyze_hlo``'s of the JAX package's
``mesh=None`` step (``jax.value_and_grad`` inside, as its dry run lowers
it) exactly, but for two differences pinned here with their cause:

* **The SSD body** (mamba2, hymba).  The JAX package runs ``ssd_chunked``
  as a scan whose chunk body is ``jax.checkpoint``-ed, so its backward
  recomputes the body's ``C·Bᵀ`` scores (``2·b·h·Q·Q·n`` a chunk) and the
  ``C·state`` product (``2·b·Q·h·p·n``) that the port's chunk-batched SSD
  (ROADMAP D9) keeps from its forward; and XLA writes the gradients of the
  two decay factors, sums over the head dim ``p``, as dots
  (``2·b·h·Q·p`` each) where the port's autograd multiplies and sums.
  The same gradient by other operations: no work is skipped.
  ``test_ssd_gap_op_by_op`` holds it by contraction length with distinct
  n, p and Q.
* **One-trip scans under full remat** (whisper's encoder and cross
  attention, whose 24 frames are one KV chunk).  When the attention's
  scan has one trip, XLA unrolls it and merges the rematerialised
  forward's ``q·kᵀ`` with the backward's identical product; the port
  computes both.  At 513 tokens the decoder's self-attention has two
  chunks, and the gap is the encoder's and the cross attention's
  ``2·B·H·Sq·Skv·D`` a layer.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import hlo_analysis as H
from repro.models.blocks import ssd_chunked as jax_ssd_chunked
from repro_torch.models import registry
from repro_torch.models.blocks import ssd_chunked

from _dryrun_cells import BATCH, TINY, jax_dot_flops, port_cell, \
    use_tiny_cells

S = TINY["tiny_train"]["seq"]


def _ssd_chunk_gap(b, h, p, n, Q):
    """JAX minus port dot FLOPs of one SSD chunk's forward and backward."""

    return 2 * b * h * Q * Q * n + 2 * b * Q * h * p * n + 2 * (
        2 * b * h * Q * p)


def _pinned_gap(cfg, remat):
    gap = 0
    if cfg.ssm_state:
        nc = -(-S // cfg.ssm_chunk)
        gap += cfg.n_layers * nc * _ssd_chunk_gap(
            BATCH, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk)
    if cfg.family == "encdec" and remat == "full":
        # the port computes these and XLA merges them away
        H_, D, F = cfg.n_heads, cfg.hd, cfg.enc_seq
        gap -= cfg.enc_layers * 2 * BATCH * H_ * F * F * D
        gap -= cfg.n_layers * 2 * BATCH * H_ * S * F * D
    return gap


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_train_flops_equal_the_jax_census(arch, remat, monkeypatch):
    use_tiny_cells(monkeypatch)
    art = port_cell(arch, "tiny_train", remat=remat)
    assert art["plan"]["remat"] == remat
    cfg = registry.get_config(arch)
    want = jax_dot_flops(arch, "tiny_train", remat=remat)
    assert want - art["cost"]["flops_per_device"] == _pinned_gap(cfg, remat)


def _jax_dot_flops_by_k(hlo):
    """``analyze_hlo``'s dot FLOPs (with its loop multipliers), grouped by
    the contracted extent K."""

    comps = H._split_computations(hlo)
    parents = {}
    for cname, lines in comps.items():
        for line in lines:
            wm = H._WHILE_RE.search(line)
            if wm:
                trip = 1
                for cl in comps.get(wm.group(1), ()):
                    cm = H._CONST_RE.search(cl)
                    if cm:
                        trip = int(cm.group(1))
                parents[wm.group(1)] = parents[wm.group(2)] = (cname, trip)
                continue
            cm = H._CALL_RE.search(line)
            if cm and cm.group(1) in comps:
                parents.setdefault(cm.group(1), (cname, 1))

    def mult(c):
        return parents[c][1] * mult(parents[c][0]) if c in parents else 1

    by_k = collections.Counter()
    for cname, lines in comps.items():
        types = {}
        for line in lines:
            m = H._INSTR_RE.match(line)
            if not m:
                continue
            types[m.group(1)] = m.group(2)
            if m.group(3) != "dot":
                continue
            out = int(np.prod(H._shape_dims(m.group(2))[0][1]))
            lhs = H._shape_dims(types[H._operands(line, "dot")[0]])[0][1]
            k = int(np.prod([lhs[int(i)] for i in H._CONTRACT_RE.search(
                line).group(1).split(",") if i]))
            by_k[k] += 2 * out * k * mult(cname)
    return by_k


class _DotsByK(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_k = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
            k = args[0].shape[-1]
            self.by_k[k] += 2 * out.numel() * k
        return out


def test_ssd_gap_op_by_op():
    b, s, h, p, n, Q = 2, 32, 4, 12, 20, 8
    shapes = [(b, s, h, p), (b, s, h), (h,), (b, s, 1, n), (b, s, 1, n),
              (h,)]

    def jax_loss(*a):
        y, st = jax_ssd_chunked(*a, Q)
        return jnp.sum(y) + jnp.sum(st)

    structs = [jax.ShapeDtypeStruct(sh, jnp.float32) for sh in shapes]
    hlo = jax.jit(jax.value_and_grad(jax_loss, argnums=range(6))).lower(
        *structs).compile().as_text()
    theirs = _jax_dot_flops_by_k(hlo)
    assert sum(theirs.values()) == H.analyze_hlo(hlo, 1, 0).dot_flops

    args = [torch.randn(sh, requires_grad=True) for sh in shapes]
    with _DotsByK() as ours:
        y, st = ssd_chunked(*args, Q)
        (y.sum() + st.sum()).backward()
    nc = s // Q
    # the recomputed C·Bᵀ and C·state contract over n, the decay factors'
    # gradients over p; every product over Q is the same in both
    assert theirs[n] - ours.by_k[n] == nc * (2 * b * h * Q * Q * n
                                             + 2 * b * Q * h * p * n)
    assert theirs[p] - ours.by_k[p] == nc * 2 * (2 * b * h * Q * p)
    assert theirs[Q] == ours.by_k[Q]
    assert sum(theirs.values()) - sum(ours.by_k.values()) == \
        nc * _ssd_chunk_gap(b, h, p, n, Q)
