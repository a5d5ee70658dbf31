"""Checkpoint store: a manifest and one ``.npy`` per leaf, async writer.

The paper's runtime materializes superstep output "for fault tolerance
before executing the subsequent superstep" (§2.1); this store is that
feature for the fixpoint drivers.  Layout, the JAX package's own
(:mod:`repro.checkpoint.store`), so a checkpoint written by either
package restores in the other:

    <dir>/step_000042/
        MANIFEST.json      # step, leaf paths, shapes/dtypes, extra metadata
        leaf_<i>.npy       # one numpy file per leaf
    <dir>/LATEST           # last durably committed step (written last)

Leaves are numbered in the reference's flatten order: dict entries by
sorted key, tuples and lists by position, named tuples by field, ``None``
an empty subtree; their paths are written as JAX's ``keystr`` writes them
(``['state']['rank']['values'][1]``).  bfloat16 and the float8 types,
which numpy cannot hold, are stored as a same-width integer view under the
dtype's name.

Commit protocol: leaves are written to a temp dir, fsync'd, atomically
renamed, and only then is LATEST updated, so a crash mid-write never
corrupts the restore point.  :class:`CheckpointStore` copies the tree to
host memory on the caller's thread (a consistent snapshot; for card
tensors the synchronous device-to-host copy, into pinned memory) and does
the file I/O on a writer thread.  :class:`MeshCheckpointStore` is the
store every rank of a mesh drives in lockstep: the ranks' shards are
gathered into the same global tree, one rank writes it, and every rank
cuts its own shard from it on a restore, so a checkpoint written on one
mesh restores on another, on one device, or in the other package.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree", "latest_step", "CheckpointStore",
           "MeshCheckpointStore"]

# dtype name -> (torch dtype, numpy view on disk, torch view of the same
# width that numpy can hold)
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the JAX package's flatten order."""

    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        if hasattr(tree, "_fields"):      # a NamedTuple
            items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
        else:
            items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        return [(path, tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out.extend(_flatten(sub, path + key))
    return out


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in the
    order :func:`_flatten` walks them (dicts keep ``like``'s key order)."""

    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        items = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    if isinstance(like, dict):
        built = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    return next(leaves)


def _snapshot(leaf: Any) -> Any:
    """A host copy of one leaf that later writes to ``leaf`` cannot reach.
    A card tensor is copied into pinned memory: the copy then runs at the
    link's rate (into pageable memory it runs at a few GB/s), and the
    caching host allocator hands the same blocks to the next save once the
    writer has dropped them."""

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t.clone()
    return np.array(leaf)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array written to disk, the dtype name the manifest records)."""

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for name, (dtype, np_view, torch_view) in _EXT_DTYPES.items():
            if t.dtype == dtype:
                return t.view(torch_view).numpy().view(np_view), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    ext = _EXT_DTYPES.get(dtype_name)
    if ext is None:
        return torch.from_numpy(arr)
    dtype, _, torch_view = ext
    signed = np.int16 if torch_view == torch.int16 else np.uint8
    return torch.from_numpy(arr.view(signed)).view(dtype)


def save_pytree(directory: str, step: int, tree: Any,
                extra: Optional[Dict[str, Any]] = None) -> str:
    flat = _flatten(tree)
    host = [_to_numpy(leaf) for _, leaf in flat]

    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "leaf_paths": [p for p, _ in flat],
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [name for _, name in host],
            "extra": extra or {},
        }
        for i, (arr, _) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # Unique temp name: a dangling writer from a crashed predecessor run
    # must not race this commit on a shared LATEST.tmp.
    fd, tmp_latest = tempfile.mkstemp(dir=directory, prefix=".LATEST.")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_latest, os.path.join(directory, "LATEST"))
    except BaseException:
        if os.path.exists(tmp_latest):
            os.unlink(tmp_latest)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore_pytree(directory: str, like: Any,
                   step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``like`` (shapes validated).  Each
    leaf comes back as a tensor of the dtype on disk, on the device of
    ``like``'s leaf when that is a tensor, else on the CPU."""

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat = _flatten(like)
    want_paths = [p for p, _ in flat]
    have_paths = manifest.get("leaf_paths", [])
    if manifest["n_leaves"] != len(flat) or (
        have_paths and have_paths != want_paths
    ):
        missing = [p for p in want_paths if p not in have_paths]
        surplus = [p for p in have_paths if p not in want_paths]
        raise ValueError(
            f"checkpoint step {step} under {directory} does not match the "
            f"restore target's tree structure: checkpoint has "
            f"{manifest['n_leaves']} leaves, target expects {len(flat)}"
            + (f"; leaves only in target: {missing[:4]}" if missing else "")
            + (f"; leaves only in checkpoint: {surplus[:4]}" if surplus else "")
            + " — was this checkpoint written by a different program/model?"
        )
    out = []
    for i, (_, ref) in enumerate(flat):
        arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
        if list(arr.shape) != manifest["shapes"][i]:
            raise ValueError(
                f"checkpoint leaf_{i}.npy shape {list(arr.shape)} disagrees "
                f"with its manifest entry {manifest['shapes'][i]} — "
                f"checkpoint step {step} under {directory} is corrupt"
            )
        if hasattr(ref, "shape") and tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf {manifest['leaf_paths'][i]} has shape "
                f"{arr.shape}, target expects {tuple(ref.shape)} — "
                "refusing to restore a mismatched model"
            )
        t = _from_numpy(arr, manifest["dtypes"][i])
        if isinstance(ref, torch.Tensor):
            t = t.to(ref.device)
        out.append(t)
    return _unflatten(like, iter(out)), step, manifest.get("extra", {})


class CheckpointStore:
    """Async checkpointing with retention, for the host fixpoint driver.

    A background-save failure is never swallowed: it is re-raised on the
    next ``wait()``, ``save()`` or ``restore()`` (each drains the writer
    thread first), so a driver learns its last checkpoint is bad *before*
    it overwrites the only good one or tries to restore garbage.
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # device->host copy on the caller thread (consistent snapshot);
        # serialization + IO on the writer thread.
        host = _unflatten(tree, iter([_snapshot(leaf)
                                      for _, leaf in _flatten(tree)]))

        def work():
            try:
                save_pytree(self.directory, step, host, extra)
                self._gc(step)
            except BaseException as exc:  # surfaced on next wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def quiesce(self) -> None:
        """Join any in-flight background save *without* surfacing its error
        (for abnormal exit paths where another exception is already
        propagating; a stored error still re-raises on the next ``wait()``).
        """

        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, like: Any, step: Optional[int] = None):
        self.wait()
        return restore_pytree(self.directory, like, step)

    def _gc(self, step: int) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n[len("step_"):]) for n in os.listdir(self.directory)
            if n.startswith("step_")
        )
        # Steps above the one just committed are stale lineage: a fresh run
        # reusing this directory restarted the step counter, so LATEST now
        # points below them and they can never be restored.  They must not
        # survive retention either — their higher numbers would shadow the
        # live run's checkpoints and starve them out of the keep window.
        live = [s for s in steps if s <= step]
        stale = [s for s in steps if s > step]
        for s in stale + live[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )


class MeshCheckpointStore:
    """A :class:`CheckpointStore` that every rank of a mesh drives in
    lockstep (on one device, ``mesh=None``, it is that store).

    Checkpoints keep the unsharded layout above.  ``save`` hands the
    rank's tree to ``to_global`` (a collective: the gather of the shards)
    and exactly one rank, the mesh's linear index 0, writes the step
    directory and ``LATEST``.  ``restore`` reads the agreed step on every
    rank into ``like`` (the global template) and hands it to ``to_local``,
    which cuts the rank's shard.  The writer's state is agreed before any
    rank reads or saves: the writer drains its writer thread, and one
    all-reduce over the mesh carries the step it committed last and
    whether its last save failed, so every rank reads the same step and a
    failed save raises on every rank at once (one rank raising alone would
    leave the others waiting in their next collective).  Every rank calls
    ``save``, ``latest``, ``restore`` and ``wait`` at the same point of
    the same program, as SPMD code does; ``quiesce`` is local unless
    every rank abandons the run together.
    """

    def __init__(self, directory: str, keep: int = 3, mesh: Any = None,
                 to_global: Any = None, to_local: Any = None) -> None:
        self.directory = directory
        self.mesh = mesh
        self.to_global = to_global or (lambda tree: tree)
        self.to_local = to_local or (lambda tree: tree)
        self.writer = mesh is None or \
            mesh.linear_index(mesh.axis_names) == 0
        self.store = CheckpointStore(directory, keep) if self.writer \
            else None

    def _drained(self) -> Optional[BaseException]:
        """The writer's last save's failure, after its thread ended."""

        if self.store is None:
            return None
        try:
            self.store.wait()
        except BaseException as exc:  # agreed below, then re-raised
            return exc
        return None

    def _agree(self, value: int, error: Optional[BaseException]) -> int:
        """The writer's ``value`` on every rank; a writer's ``error``
        raises on every rank."""

        if self.mesh is not None and self.mesh.wide_axes:
            from repro_torch.parallel import collectives as C

            t = torch.tensor([float(value), 1.0 if error else 0.0],
                             dtype=torch.float64, device=self.mesh.device)
            with C.bind(self.mesh):
                t = C.pmax(t, self.mesh.wide_axes).cpu()
            value = int(t[0])
            if t[1] > 0 and error is None:
                raise RuntimeError(
                    f"the checkpoint writer of this mesh failed to save "
                    f"under {self.directory} (its rank raised the error)")
        if error is not None:
            raise error
        return value

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        tree = self.to_global(tree)
        if self.store is not None:
            self.store.save(step, tree, extra)

    def wait(self) -> None:
        self._agree(-1, self._drained())

    def quiesce(self, agreed: bool = False) -> None:
        """Join the writer thread without surfacing its error (a failure is
        already propagating).  ``agreed``: every rank is abandoning the run
        at once, and one collective tells every rank that the writer is
        drained, so that no rank starts a successor run (a resume on the
        survivors' mesh) while the old writer still replaces a step."""

        if self.store is not None:
            self.store.quiesce()
        if agreed:
            self._agree(-1, None)

    def latest(self) -> Optional[int]:
        """The last committed step, the same on every rank (None: no
        checkpoint yet)."""

        error, step = self._drained(), -1
        if self.store is not None and error is None:
            found = latest_step(self.directory)
            step = -1 if found is None else found
        step = self._agree(step, error)
        return None if step < 0 else step

    def restore(self, like: Any, step: Optional[int] = None):
        """``(this rank's tree, step, extra)`` of ``step`` (default: the
        agreed latest), read into the global template ``like``."""

        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.directory}")
        tree, step, extra = restore_pytree(self.directory, like, step)
        return self.to_local(tree), step, extra
