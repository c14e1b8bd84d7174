"""Build the CUDA kernels from ``src/repro_torch/csrc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for ``sm_90a``,
into its own shared library with a plain C interface, under ``build/kernels/``
at the repository root (listed in ``.gitignore``). The library's file name
carries a hash of its source, the ``csrc`` headers it includes and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each library's launch function: (symbol, argtypes)
SIGNATURES = {
    "sbmax": ("sbmax_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "boundsum_gather": ("boundsum_gather_launch", [_P] * 6 + [_I] * 6 + [_P]),
    "doc_score": ("doc_score_fwd_launch", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "doc_score_flat": ("doc_score_flat_launch", [_P] * 7 + [_I] * 7 + [_P]),
    "dequant_matmul": ("dequant_matmul_launch", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def _source_bytes(path: Path, seen: set) -> bytes:
    """``path`` followed by every header of ``csrc`` it includes (``#include
    "x.cuh"``), recursively, each once."""
    seen.add(path)
    src = path.read_bytes()
    parts = [src]
    for header in re.findall(rb'^\s*#include\s+"([^"]+)"', src, re.M):
        dep = CSRC / header.decode()
        if dep not in seen:
            parts.append(_source_bytes(dep, seen))
    return b"".join(parts)


def library_path(name: str) -> Path:
    """Where library ``name`` is built: its file name hashes the source, the
    headers it includes and the flags, so an edit to any of them rebuilds it."""
    src = _source_bytes(CSRC / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named kernel library that is not built yet, one nvcc per
    source, all started together; returns nvcc's output by name (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out)
    logs = {}
    for name, (proc, tmp, out) in started.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
        os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file
    return logs


@functools.cache
def load(name: str):
    """The launch function of kernel library ``name``, building it if needed."""
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_tensor(name: str, t, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    ``dtype`` and rank ``ndim`` on ``device``."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")
