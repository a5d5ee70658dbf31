"""Hardware model: the roofline terms shared by the planner and §Roofline.

The paper's optimizer chooses physical plans from data statistics and the
hardware configuration (Section 1: "optimized — based on hardware
configurations and data statistics").  Here the hardware model is the TPU
v5e-class chip specified by the assignment:

* 197 TFLOP/s bf16 peak per chip,
* 819 GB/s HBM bandwidth per chip,
* ~50 GB/s per ICI link (per direction), 2D/3D torus intra-pod,
  slower DCN across pods.

Every cost the planner reasons about is expressed through the same three
roofline terms the experiment harness reports:

    compute    = flops / (chips * peak_flops)
    memory     = hbm_bytes / (chips * hbm_bw)
    collective = collective_bytes_on_busiest_link / link_bw

so planning decisions and the §Roofline analysis share one source of truth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["HardwareSpec", "MeshSpec", "CollectiveCost", "TPU_V5E", "H100_SXM"]


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peaks + interconnect parameters."""

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per ICI link per direction
    dcn_bw: float = 6.25e9           # bytes/s per host across pods (~50 Gbit)
    ici_latency: float = 1e-6        # seconds per hop (alpha term)
    dcn_latency: float = 10e-6
    vmem_bytes: int = 128 * 1024 * 1024  # v5e VMEM per core (for BlockSpecs)
    hbm_bytes: int = 16 * 1024 ** 3

    def axis_bw(self, axis: str) -> float:
        """Bandwidth of the link class used by a mesh axis."""

        return self.dcn_bw if axis == "pod" else self.ici_bw

    def axis_latency(self, axis: str) -> float:
        return self.dcn_latency if axis == "pod" else self.ici_latency


TPU_V5E = HardwareSpec()

# NVIDIA H100 SXM datasheet values: NVLink (450 GB/s each way) stands in for
# ICI, and ``vmem_bytes`` reads as the shared memory one SM offers (228 KiB).
# Nothing selects it by default: plans keep the TPU_V5E notes unless a caller
# passes ``hw=H100_SXM``.
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    dcn_bw=50e9,
    ici_latency=2e-6,
    dcn_latency=10e-6,
    vmem_bytes=228 * 1024,
    hbm_bytes=80 * 1000 ** 3,
)


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes, e.g. ``(("pod", 2), ("data", 16), ("model", 16))``.

    This mirrors ``launch.mesh.make_production_mesh`` but is a pure-python
    description so the planner can run without touching device state.
    """

    axes: Tuple[Tuple[str, int], ...]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    def size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        return 1

    @property
    def n_devices(self) -> int:
        out = 1
        for _, s in self.axes:
            out *= s
        return out

    @property
    def data_parallel_size(self) -> int:
        return self.size("pod") * self.size("data")

    def __str__(self) -> str:  # pragma: no cover
        return "x".join(f"{n}={s}" for n, s in self.axes)


SINGLE_POD = MeshSpec((("data", 16), ("model", 16)))
MULTI_POD = MeshSpec((("pod", 2), ("data", 16), ("model", 16)))


@dataclass(frozen=True)
class CollectiveCost:
    """Alpha-beta cost of one collective: ``seconds = alpha + bytes/bw``."""

    seconds: float
    bytes_on_link: float
    hops: int

    def __add__(self, other: "CollectiveCost") -> "CollectiveCost":
        return CollectiveCost(
            self.seconds + other.seconds,
            self.bytes_on_link + other.bytes_on_link,
            self.hops + other.hops,
        )


def ring_all_reduce(nbytes: float, n: int, bw: float, alpha: float) -> CollectiveCost:
    """Bandwidth-optimal ring all-reduce: 2(n-1)/n of the payload per link."""

    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    link_bytes = 2.0 * nbytes * (n - 1) / n
    return CollectiveCost(2 * (n - 1) * alpha + link_bytes / bw, link_bytes, 2 * (n - 1))


def ring_reduce_scatter(nbytes: float, n: int, bw: float, alpha: float) -> CollectiveCost:
    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    link_bytes = nbytes * (n - 1) / n
    return CollectiveCost((n - 1) * alpha + link_bytes / bw, link_bytes, n - 1)


def ring_all_gather(nbytes: float, n: int, bw: float, alpha: float) -> CollectiveCost:
    return ring_reduce_scatter(nbytes, n, bw, alpha)


def kary_tree_reduce(
    nbytes: float, n: int, k: int, bw: float, alpha: float
) -> CollectiveCost:
    """The paper's k-ary aggregation tree (§4.3 "model volume property").

    Each level: every aggregator receives at most ``k`` inputs of the full
    payload (non-pipelined), so time per level ≈ alpha + k*bytes/bw and the
    depth is ``ceil(log_k n)``.  Good when the flat ring's 2(n-1) latency
    hops dominate (small payloads, huge n); bad for bandwidth-bound payloads.
    """

    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    k = max(2, k)
    depth = max(1, math.ceil(math.log(n, k)))
    link_bytes = float(k * nbytes * depth)
    return CollectiveCost(depth * (alpha + k * nbytes / bw), link_bytes, depth)


def all_to_all(nbytes: float, n: int, bw: float, alpha: float) -> CollectiveCost:
    """All-to-all of ``nbytes`` total per device: (n-1)/n crosses links."""

    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    link_bytes = nbytes * (n - 1) / n
    return CollectiveCost(alpha * (n - 1) + link_bytes / bw, link_bytes, n - 1)
