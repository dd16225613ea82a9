"""The host library: ``host_pipeline.cc``'s threaded batch-assembly loops,
bound with ctypes (which releases the GIL for each call).

Counterpart of ``dcvgan_tpu/native``, with its own copy of the source. Built
at first use with g++ into ``dcvgan_torch/_build/libdcvgan_host-<hash>.so``
by the build steps of ``dcvgan_torch/ops/build.py``: the hash covers the
source and the flags, so an edited source builds anew and an unchanged one
is reused, and the library is written under a temporary name and renamed,
so a process that loads it sees all of it or none.

Unlike the JAX module, nothing falls back to numpy: where g++ is missing or
the build fails, the first call raises with the compiler's output. The
numpy forms are ``dcvgan_torch.data.host_ops``; the results are equal bit
for bit.

A call takes one thread per ``MIN_ELEMENTS_PER_THREAD`` elements, up to the
JAX module's count, and the calling thread works one chunk itself (the JAX
module starts its full count of threads on every call). Public API (all
return float32 numpy arrays):

- ``normalize_u8(x, divisor, shift)``: float32(x) / divisor + shift
- ``one_hot(labels, n_classes)``: uint8 labels -> float32 one-hot; a label
  outside the range gives an all-zero row
- ``scale_f32(x, scale)``: x * scale
- ``available()``: whether the library builds and loads here
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from dcvgan_torch.ops.build import BUILD_DIR, finish_build, hashed_target, start_build

SOURCE = Path(__file__).resolve().parent / "host_pipeline.cc"
# no -march=native: the library's name does not say which CPU built it, so
# a checkout shared by two machines could load on one a library that uses
# instructions only the other has; the loops are memory-bound either way
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# the JAX module's thread count, the most a call takes
DEFAULT_THREADS = max(1, min(8, (os.cpu_count() or 4) // 2))
# each call starts its threads anew, so by default a call takes one thread
# per this many elements: a per-sample array (16 x 64 x 64 x 2 floats) on
# the JAX module's 4 threads took 0.57-0.61 ms where numpy took 0.02 ms, on
# the 8-core host of an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
# "native" line, PERF.md)
MIN_ELEMENTS_PER_THREAD = 1 << 18

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def target(src: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """The library path for ``src`` at its current content."""
    return hashed_target("dcvgan_host", [src], CXX_FLAGS, build_dir)


def build(src: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` unless its library exists; returns the library's path.
    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    out = target(src, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the host library needs g++, which is not on PATH")
    failed = finish_build(*start_build([cxx, *CXX_FLAGS], src, out), out)
    if failed:
        raise RuntimeError(f"host library build of {src} failed: {failed}")
    return out


def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with its three functions' signatures set."""
    lib = ctypes.CDLL(str(path))
    lib.normalize_u8_to_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    lib.one_hot_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.scale_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
    ]
    for fn in (lib.normalize_u8_to_f32, lib.one_hot_f32, lib.scale_f32):
        fn.restype = None
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = load(build())
    return _lib


def available() -> bool:
    """Whether the library builds and loads here. Where it does not, the
    functions below raise; they never fall back."""
    try:
        _get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def _threads(size: int) -> int:
    """One thread per ``MIN_ELEMENTS_PER_THREAD`` elements, at most
    ``DEFAULT_THREADS``."""
    return max(1, min(DEFAULT_THREADS, size // MIN_ELEMENTS_PER_THREAD))


def normalize_u8(x: np.ndarray, divisor: float, shift: float) -> np.ndarray:
    """float32(x) / divisor + shift (a division, not a reciprocal), equal bit
    for bit to ``host_ops.normalize_u8``."""
    lib = _get_lib()
    x = np.ascontiguousarray(x, dtype=np.uint8)
    out = np.empty(x.shape, np.float32)
    lib.normalize_u8_to_f32(
        x.ctypes.data, out.ctypes.data, x.size, divisor, shift, _threads(x.size)
    )
    return out


def one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """uint8 labels (...,) -> float32 one-hot (..., n_classes); a label
    outside the range gives an all-zero row, as ``host_ops.one_hot`` does."""
    if n_classes < 1:
        raise ValueError(f"n_classes must be at least 1, got {n_classes}")
    lib = _get_lib()
    labels = np.ascontiguousarray(labels, dtype=np.uint8)
    out = np.zeros(labels.shape + (n_classes,), np.float32)
    lib.one_hot_f32(
        labels.ctypes.data, out.ctypes.data, labels.size, n_classes, _threads(labels.size)
    )
    return out


def scale_f32(x: np.ndarray, scale: float) -> np.ndarray:
    """float32(x) * scale, equal bit for bit to ``host_ops.scale_f32``."""
    lib = _get_lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, np.float32)
    lib.scale_f32(x.ctypes.data, out.ctypes.data, x.size, scale, _threads(x.size))
    return out
