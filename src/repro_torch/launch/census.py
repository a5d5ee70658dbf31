"""Per-op census of a PyTorch program: dot FLOPs, bytes, peak memory and
the roofline terms (the JAX package's ``launch/hlo_analysis.py``).

The JAX package derives its census from the compiled HLO text.  The port
has no HLO: it runs eagerly, op by op, so this module (named for what it
does, not for a text it parses) derives the same quantities from the aten
op stream, under a ``TorchDispatchMode`` that sees every op the program
dispatches, on any device.  On the ``meta`` device the ops compute shapes
only, so a full-width step is counted on a host with no card.

* **FLOPs**: ``2 * M * N * K`` for every mm, bmm, addmm, baddbmm and
  convolution (PyTorch's ``torch.utils.flop_counter`` formulas), the
  ``dot`` / ``convolution`` instructions ``analyze_hlo`` counts.
  Elementwise FLOPs are ignored, as there.
* **Loop multipliers are gone**: a Python loop runs every trip, and the
  forward that ``torch.utils.checkpoint`` recomputes in the backward is
  counted where it runs, so every count is already the whole program's
  (``while_trips`` stays empty).
* **Bytes**: an op's output bytes plus its operand bytes.  Views and
  metadata ops are free (``analyze_hlo``'s ``_FREE_OPS``); gathers (index,
  gather, embedding) count the gathered slice twice, and in-place slice
  writes (``copy_``, ``index_put_``, scatters) the written slice twice,
  as ``analyze_hlo`` counts dynamic-slice, gather, dynamic-update-slice
  and scatter; fills count the written bytes.  Eager PyTorch runs unfused,
  so this is the port's own traffic and is not expected to equal XLA's
  fused count.
* **Regions**: ops run inside a :func:`vmem_region` (the attention's plain
  forward and backward, the SSD body: what the kernels keep on chip) add
  their bytes to ``vmem_region_bytes`` as well, which the memory term
  leaves out, as the JAX package's ``*_vmem_region`` scopes.
* **Peak memory**: the live bytes of the distinct storages the program
  holds, the arguments included, tracked from each op's outputs until
  their storage is freed.
* **Hand-written kernels** launch through ``ctypes``, which the dispatcher
  never sees: a launch under a census raises (:func:`refuse_kernel`)
  rather than count zero.
* **Collectives**: the LM has no mesh in the port yet (ROADMAP A10e), so the
  collective fields (``by_type_*``, ``ici_link_bytes``,
  ``dcn_link_bytes``, ``total_operand_bytes``) stay zero; the collective
  census waits for collectives to count.

The roofline terms (:func:`roofline_terms`) are the JAX package's, with
its keys and arithmetic; pass ``hw=H100_SXM`` for the card.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hardware import HardwareSpec, TPU_V5E

__all__ = ["Census", "census_of", "roofline_terms", "vmem_region",
           "refuse_kernel"]

aten = torch.ops.aten

# The products analyze_hlo counts (HLO dot and convolution).
_DOT_OPS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
            aten._convolution, aten.convolution_backward}
# No data moved: metadata, allocation without a write, host reads.
_FREE_OPS = {aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view,
             aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten._local_scalar_dense,
             aten.set_, aten.resize_, aten.sym_size, aten.sym_stride,
             aten.sym_numel, aten.sym_storage_offset, aten.is_same_size}
# Gathers: the gathered slice is read and written.
_GATHER_OPS = {aten.index, aten.gather, aten.index_select, aten.embedding,
               aten.take}
# Writes of a slice into a tensor: the update is read and written.
_SCATTER_OPS = {aten.index_put: 2, aten.index_put_: 2,
                aten._index_put_impl_: 2, aten.scatter: 3, aten.scatter_: 3,
                aten.scatter_add: 3, aten.scatter_add_: 3,
                aten.index_add: 3, aten.index_add_: 3,
                aten.index_copy: 3, aten.index_copy_: 3}
# Ops that write their output and read no operand's data.
_WRITE_ONLY_OPS = {aten.fill_, aten.zero_, aten.new_zeros, aten.new_ones,
                   aten.new_full, aten.zeros_like, aten.ones_like,
                   aten.full_like}


@dataclass
class Census:
    """``HLOCensus``'s fields, counted from the op stream, and what only
    an eager run has: ``op_counts`` (calls by aten op, of the ops that
    move data: views and metadata ops, which a device may issue or skip
    as it builds tensors, are left out), ``peak_bytes``
    (the live storages' peak, the arguments included) and the bytes of
    the arguments', the result's and the result's storages that are
    arguments' (``memory_analysis``'s argument, output and alias
    sizes)."""

    dot_flops: float = 0.0
    bytes_accessed: float = 0.0
    vmem_region_bytes: float = 0.0
    by_type_bytes: Dict[str, float] = field(default_factory=dict)
    by_type_count: Dict[str, int] = field(default_factory=dict)
    ici_link_bytes: float = 0.0
    dcn_link_bytes: float = 0.0
    total_operand_bytes: float = 0.0
    while_trips: Dict[str, int] = field(default_factory=dict)
    details: List[Dict] = field(default_factory=list)
    op_counts: Dict[str, int] = field(default_factory=dict)
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts (ops' arguments and
    results, the steps' state trees)."""

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _op_bytes(packet, args, kwargs, out) -> int:
    outs = _tensors(out)
    if packet in _GATHER_OPS:
        return 2 * sum(map(_nbytes, outs))
    if packet is aten.copy_:
        return 2 * _nbytes(args[0])
    if packet in _SCATTER_OPS:
        pos = _SCATTER_OPS[packet]
        update = args[pos] if len(args) > pos else kwargs.get(
            "values", kwargs.get("src", kwargs.get("source")))
        return 2 * _nbytes(update)
    written = sum(map(_nbytes, outs))
    if packet in _WRITE_ONLY_OPS:
        return written
    return written + sum(map(_nbytes, _tensors((args, kwargs))))


class _Storages:
    """The live bytes of the distinct storages seen, and their peak.  A
    storage is freed when its Python object dies, which PyTorch keeps
    alive while any tensor (an autograd-saved one too) holds it."""

    def __init__(self) -> None:
        self._live: Dict[int, Tuple[int, weakref.ref]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, weakref.ref(st, lambda _: self._free(key)))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)[0]


def _storage_bytes(tensors, keep=lambda key: True) -> int:
    """The bytes of the distinct storages of ``tensors`` whose key
    ``keep`` accepts."""

    sizes = {}
    for t in tensors:
        st = t.untyped_storage()
        if keep(st._cdata):
            sizes[st._cdata] = st.nbytes()
    return sum(sizes.values())


class _CensusMode(TorchDispatchMode):
    def __init__(self, census: Census, storages: _Storages) -> None:
        super().__init__()
        self.census = census
        self.storages = storages
        self.regions: List[str] = []

    @contextlib.contextmanager
    def region(self, name: str):
        self.regions.append(name)
        try:
            yield
        finally:
            self.regions.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in _DOT_OPS:
            # a composite op reaching the mode: count what it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.storages.add(t)
        if func.is_view or packet in _FREE_OPS:
            return out
        c = self.census
        name = str(packet).split(".")[-1]
        c.op_counts[name] = c.op_counts.get(name, 0) + 1
        if packet in _DOT_OPS:
            c.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        nbytes = _op_bytes(packet, args, kwargs, out)
        c.bytes_accessed += nbytes
        if self.regions:
            c.vmem_region_bytes += nbytes
        return out


def _active() -> Optional[_CensusMode]:
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _CensusMode):
            return mode
    return None


def vmem_region(name: str):
    """A context marking the ops a kernel keeps on chip (the JAX package's
    ``jax.named_scope("<name>_vmem_region")``): under a census their bytes
    count in ``vmem_region_bytes`` too; with no census running it does
    nothing."""

    mode = _active()
    return contextlib.nullcontext() if mode is None else mode.region(name)


def refuse_kernel(name: str) -> None:
    """Raises when a census is running: the hand-written kernel ``name``
    launches through ``ctypes``, where no dispatch mode sees its work."""

    if _active() is not None:
        raise RuntimeError(
            f"census: the hand-written kernel {name} launches outside the "
            f"PyTorch dispatcher, so a census cannot count it; take the "
            f"census on the meta device or with attention='ref'")


def census_of(fn, *args, **kwargs) -> Tuple[Any, Census]:
    """``(fn(*args, **kwargs), its Census)``; ``census.peak_bytes`` is the
    peak estimate: the arguments' storages plus every storage the run
    allocated, at the largest moment of their sum."""

    census = Census()
    storages = _Storages()
    arg_tensors = _tensors((args, kwargs))
    for t in arg_tensors:
        storages.add(t)
    arg_keys = {t.untyped_storage()._cdata for t in arg_tensors}
    with _CensusMode(census, storages):
        result = fn(*args, **kwargs)
    outs = _tensors(result)
    census.peak_bytes = storages.peak_bytes
    census.argument_bytes = _storage_bytes(arg_tensors)
    census.output_bytes = _storage_bytes(outs)
    census.alias_bytes = _storage_bytes(outs, arg_keys.__contains__)
    return result, census


def roofline_terms(
    census: Census,
    n_devices: int,
    hw: HardwareSpec = TPU_V5E,
    raw_cost: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """The JAX package's ``roofline_terms``: the same keys and arithmetic.
    ``raw_cost`` (XLA's uncorrected cost) has no counterpart here and is
    only echoed when given."""

    compute_s = census.dot_flops / hw.peak_flops_bf16
    # The memory term leaves out the regions' traffic: the kernels keep it
    # on chip; the whole count is reported beside it.
    hbm_bytes = census.bytes_accessed - census.vmem_region_bytes
    memory_s = hbm_bytes / hw.hbm_bw
    collective_s = (
        census.ici_link_bytes / hw.ici_bw
        + census.dcn_link_bytes / hw.dcn_bw
    )
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "memory_s_xla_fallback": census.bytes_accessed / hw.hbm_bw,
        "vmem_region_bytes": census.vmem_region_bytes,
    }
    three = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    dominant = max(three, key=three.get)
    terms.update({
        "dominant": dominant,
        "step_lower_bound_s": max(three.values()),
        "hlo_flops_per_device": census.dot_flops,
        "hlo_bytes_per_device": census.bytes_accessed,
        "ici_link_bytes": census.ici_link_bytes,
        "dcn_link_bytes": census.dcn_link_bytes,
        "collective_operand_bytes": census.total_operand_bytes,
    })
    if raw_cost:
        terms["xla_cost_flops_uncorrected"] = raw_cost.get("flops", 0.0)
        terms["xla_cost_bytes_uncorrected"] = raw_cost.get(
            "bytes accessed", 0.0)
    return terms
