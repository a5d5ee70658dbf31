"""Device meshes over ``torch.distributed`` and the rank launcher.

The port's counterpart of the JAX package's ``launch/mesh.py``.  JAX's
``shard_map`` runs one controller over a mesh of devices; here every rank
is a process that holds its own shard, and a :class:`Mesh` names the
axes of a ``torch.distributed`` :class:`DeviceMesh` so that the named-axis
collectives (:mod:`repro_torch.parallel.collectives`) find the process
group of each axis.

* :func:`make_mesh` / :func:`make_data_mesh` build the mesh over the
  default process group (``init_device_mesh``), or over a listed subset
  of its ranks (``ranks=``: the survivors an elastic ``remesh`` moves
  onto; a rank outside gets ``None`` and has left); :func:`mesh_spec_of`
  describes it to the planner.
* :func:`launch_ranks` runs ``fn(rank, world, *args)`` on ``world``
  spawned processes that meet through a ``FileStore`` in a directory the
  caller gives, so that test workers never share a port.

Transports: on the CPU ``gloo``; on the card ``nccl`` with one GPU a rank
(the default, refused when the world exceeds the GPUs), or ``gloo`` when
the caller names it, which stages every collective through pinned host
buffers (counted in ``Mesh.stats.staged_bytes``).  The production meshes
(256 and 512 devices) are ROADMAP A10e.
"""

from __future__ import annotations

import itertools
import math
import os
import queue
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from datetime import timedelta
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.hardware import MeshSpec
from repro_torch.device import resolve_device

__all__ = ["Mesh", "CollectiveStats", "make_mesh", "make_data_mesh",
           "mesh_spec_of", "remesh_note", "launch_ranks", "BATCH_AXES"]

# The axes records and vertices are sharded over; ``model`` replicates.
BATCH_AXES = ("pod", "data")


@dataclass
class CollectiveStats:
    """The calls this rank made of each collective, the bytes it handed to
    each (its payload, once a call) and, with staged ``gloo`` on the card,
    the bytes copied between the card and the pinned host buffers, both
    ways.  A batched call (k queries under vmap) counts once."""

    sent: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    staged_bytes: int = 0
    calls: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def reset(self) -> None:
        self.sent.clear()
        self.calls.clear()
        self.staged_bytes = 0


@dataclass(eq=False)
class Mesh:
    """A named device mesh of ``torch.distributed`` ranks.

    ``shape`` maps each axis name to its size, in mesh order (as JAX's
    ``Mesh.shape``); ``device`` is the device this rank's shards live on.
    """

    device_mesh: Any
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    backend: str
    staged: bool
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    _groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict,
                                                repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def transport(self) -> str:
        if self.staged:
            return "gloo, staged through pinned host buffers"
        return self.backend

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The sharding axes of more than one rank, in mesh order."""

        return tuple(a for a in BATCH_AXES if self.shape.get(a, 1) > 1)

    @property
    def wide_axes(self) -> Tuple[str, ...]:
        """Every axis of more than one rank, in mesh order: a decision
        agreed over them reaches every rank of the mesh."""

        return tuple(a for a, s in zip(self.axis_names, self.sizes) if s > 1)

    @property
    def n_ranks(self) -> int:
        return math.prod(self.sizes)

    def coordinate(self, axis: str) -> int:
        return int(self.device_mesh.get_coordinate()[
            self.axis_names.index(axis)])

    def linear_index(self, axes: Tuple[str, ...]) -> int:
        """This rank's index over ``axes`` taken together (row-major)."""

        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coordinate(a)
        return idx

    def group(self, axes: Tuple[str, ...]):
        """The process group of ``axes`` taken together, its ranks in the
        order of :meth:`linear_index`.  A group over several axes is made
        the first time it is asked for, by every rank at once (each rank
        asks at the same point of the same program, as SPMD code does)."""

        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            self._make_group(axes)
        return self._groups[axes]

    def _make_group(self, axes: Tuple[str, ...]) -> None:
        """Make the groups of ``axes`` taken together: every rank of the
        default group calls ``new_group`` for each of them (a mesh over a
        subset of the world makes them all in :func:`make_mesh`, while
        every rank is still there)."""

        order = [self.axis_names.index(a) for a in axes]
        ranks = self.device_mesh.mesh
        rest = [d for d in range(len(self.sizes)) if d not in order]
        rows = ranks.permute(rest + order).reshape(
            -1, math.prod(self.sizes[d] for d in order))
        me = dist.get_rank()
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                self._groups[axes] = g


def make_mesh(
    shape: Tuple[int, ...],
    axes: Tuple[str, ...],
    *,
    ranks: Optional[Sequence[int]] = None,
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
) -> Optional[Mesh]:
    """The mesh of ``shape`` named ``axes`` over the default process group
    (started by :func:`launch_ranks` or ``init_process_group``), the
    counterpart of ``make_compat_mesh``.

    ``ranks`` (default: the whole world) lists the default group's ranks
    the mesh spans, ascending, row-major over ``shape``: the surviving
    ranks an elastic ``remesh`` moves onto.  Every rank of the world calls
    this, because making a process group is collective; a rank outside
    ``ranks`` gets ``None`` and has left the mesh.  Nothing takes a subset
    of the world unless ``ranks`` names it.

    ``device`` (default: the card) is where this rank's shards live.  On
    the card ``backend`` defaults to ``nccl``, one GPU a rank of the mesh;
    ``gloo`` there must be named and stages each collective through pinned
    host buffers.  The backend must be the default process group's.
    """

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: start the ranks "
            "with launch_ranks or torch.distributed.init_process_group")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size()
    if ranks is None:
        if math.prod(shape) != world:
            raise ValueError(
                f"a mesh of shape {shape} needs {math.prod(shape)} ranks, "
                f"the process group has {world}: name the ranks it spans "
                "(ranks=)")
        members = list(range(world))
    else:
        members = [int(r) for r in ranks]
        # Ascending: torch orders a group's members by their global rank,
        # and a collective's blocks must come in the mesh's order.
        if len(members) != math.prod(shape) or members != sorted(set(
                members)) or not all(0 <= r < world for r in members):
            raise ValueError(
                f"ranks {members} are not {math.prod(shape)} distinct ranks "
                f"of the world of {world} in ascending order, for a mesh of "
                f"shape {shape}")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type != "cuda" and backend != "gloo":
        raise ValueError(f"backend {backend!r} on {device}: the CPU takes "
                         "gloo")
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()!r}, the mesh asks for "
                         f"{backend!r}")
    staged = False
    if device.type == "cuda":
        n_gpus = torch.cuda.device_count()
        if backend == "nccl" and len({r % n_gpus for r in members}) \
                < len(members):
            raise ValueError(
                f"nccl needs one GPU a rank: {len(members)} ranks, "
                f"{n_gpus} GPU(s) (NCCL refuses two ranks on one GPU); name "
                "backend='gloo' to stage the collectives through host "
                "memory")
        device = torch.device("cuda", dist.get_rank() % n_gpus)
        torch.cuda.set_device(device)
        staged = backend == "gloo"
    kind = "cuda" if backend == "nccl" else "cpu"
    if ranks is None:
        dm = init_device_mesh(kind, shape, mesh_dim_names=axes)
    else:
        dm = DeviceMesh(kind, torch.tensor(members).reshape(shape),
                        mesh_dim_names=axes)
    mesh = Mesh(dm, axes, shape, device, backend, staged)
    if ranks is not None:
        # The groups of several axes, made now while every rank is here.
        for k in range(2, len(axes) + 1):
            for combo in itertools.combinations(axes, k):
                mesh._make_group(combo)
    if dist.get_rank() not in members:
        return None
    return mesh


def make_data_mesh(n_data: int = 0, ranks: Optional[Sequence[int]] = None,
                   **kwargs) -> Optional[Mesh]:
    """A pure data-parallel mesh ``(("data", n),)``; ``n_data=0`` takes
    every rank of the world, or of ``ranks``."""

    if n_data <= 0:
        n_data = dist.get_world_size() if ranks is None else len(ranks)
    return make_mesh((n_data,), ("data",), ranks=ranks, **kwargs)


def mesh_spec_of(mesh: Mesh) -> MeshSpec:
    return MeshSpec(tuple(zip(mesh.axis_names, mesh.sizes)))


def remesh_note(old: Optional[Mesh], new: Optional[Mesh]) -> str:
    """The plan note of an elastic remesh from ``old`` to ``new`` (None:
    one device), in the reference's words: ``remesh(8->4: data=4)``,
    ``remesh(4->1: 1 device)``."""

    old_n = 1 if old is None else old.n_ranks
    if new is None:
        return f"remesh({old_n}->1: 1 device)"
    shape = "x".join(f"{a}={s}" for a, s in zip(new.axis_names, new.sizes))
    return f"remesh({old_n}->{new.n_ranks}: {shape})"


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------


def _rank_entry(fn, rank, world, backend, store, timeout, args, results):
    try:
        # Each rank gets its share of the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch_ranks(
    fn: Callable[..., Any],
    world: int,
    *args: Any,
    store_dir: str,
    backend: str = "gloo",
    timeout: float = 600.0,
) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned processes joined
    in one process group, and return their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  The ranks
    meet through a ``FileStore`` at ``store_dir/store`` (a fresh directory:
    no port is opened); collectives time out after ``timeout`` seconds,
    so a rank that leaves the lockstep raises instead of hanging.  The
    whole launch has a wall clock of ``timeout`` too.  If a rank fails, the
    others are killed and its traceback is raised.
    """

    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, backend, store, timeout, args,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = (f"ranks {sorted(set(range(world)) - set(out))}"
                               f" gave no result in {timeout} s")
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
