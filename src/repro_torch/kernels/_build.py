"""Build and load the hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/kernels/`` at the root of the checkout.  The library's file
name carries a hash of its source, so an edited source builds anew and an
unchanged one is loaded as it is.  Libraries are loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "build_all", "load"]

_ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _command(src: Path, lib: Path) -> List[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(lib), str(src),
    ]


def build_all() -> Dict[str, str]:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: compiler output}`` for
    the sources built; raises if any build fails."""

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = _library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src.stem] = (tmp, lib, subprocess.Popen(
            _command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first if
    needed)."""

    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            path = _library_path(src)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib
