"""Build the CUDA sources under ``dcvgan_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface. The
hash covers the source, the shared headers and the flags, so an edited
source builds anew and an unchanged one is reused. Every source that is not
built yet gets its own ``nvcc`` process, all started together, except those
in :data:`ON_DEMAND`, which build only when their own library is asked for.
Nothing is built at import time: the first :func:`library` call builds what
is missing.
:func:`hashed_target`, :func:`start_build` and :func:`finish_build` are the
steps of one build, shared with the host library (``dcvgan_torch/native``),
which g++ compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

# sources that only some configurations run: a run that never asks for
# their library never builds it (segmentation's one-hot input conv and
# softmax head)
ON_DEMAND = frozenset({"onehot_conv", "softmax_codes"})

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default toolkit."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def hashed_target(
    name: str, sources: Iterable[Path], flags: Sequence[str], build_dir: Path = BUILD_DIR
) -> Path:
    """``build_dir/lib<name>-<hash>.so``, the hash over ``flags`` and the
    content of ``sources``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return Path(build_dir) / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_build(compiler: Sequence[str], src: Path, out: Path) -> Tuple[subprocess.Popen, Path]:
    """Start ``compiler -o <tmp> src``, writing beside ``out`` under a
    temporary name; :func:`finish_build` moves it into place."""
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(out).with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(
        [*compiler, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp


def finish_build(proc: subprocess.Popen, tmp: Path, out: Path) -> Optional[str]:
    """Wait for a :func:`start_build`; on success rename its output to
    ``out`` (atomic: a process loading it sees all of it or none) and return
    None, else remove it and return the compiler's exit code and output."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{Path(proc.args[0]).name} exit {proc.returncode}:\n{log}"
    os.replace(tmp, out)
    return None


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at its current content."""
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    return hashed_target(name, [CSRC_DIR / f"{name}.cu", *headers], NVCC_FLAGS)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source whose library is missing, one nvcc each, in
    parallel: those named in ``names``, or by default all of them.

    Returns the seconds each compiled source took; raises with the compiler's
    output if any fails.
    """
    wanted = None if names is None else set(names)
    todo = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        if wanted is not None and src.stem not in wanted:
            continue
        out = target(src.stem)
        if not out.exists():
            todo[src.stem] = (src, out)
    if not todo:
        return {}
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {name: (*start_build([nvcc, *NVCC_FLAGS], src, out), out)
             for name, (src, out) in todo.items()}
    seconds, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        failed = finish_build(proc, tmp, out)
        seconds[name] = time.perf_counter() - t0
        if failed:
            failures.append(f"{name}.cu: {failed}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    every other missing library that is not :data:`ON_DEMAND`."""
    lib = _loaded.get(name)
    if lib is None:
        path = target(name)
        if not path.exists():
            build_all({p.stem for p in CSRC_DIR.glob("*.cu")} - ON_DEMAND | {name})
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
