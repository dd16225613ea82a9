"""Raw-dataset preprocessors + explicit registry.

Counterpart of ``dcvgan_tpu/data/preprocess``: a registry keyed by dataset
name, with the same entries: ``mock`` (the fixture), ``synthetic`` and
``synthetic-large`` (generated moving shapes), ``surreal`` and ``isogd``
(the raw datasets' trees), and ``mug``, a stub that raises as the JAX one
does (MUG was preprocessed out of band).

The raw-dataset preprocessors run one job per video on a thread pool
(:func:`parallel_map`); OpenCV and the file writes release the GIL.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable, List, TypeVar

T = TypeVar("T")

PreprocessFunc = Callable[[Path, Path, str, int, int, int], None]

_REGISTRY: Dict[str, PreprocessFunc] = {}


def register(name: str):
    def deco(fn: PreprocessFunc) -> PreprocessFunc:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_preprocessor(name: str) -> PreprocessFunc:
    # import on demand so cv2-heavy modules don't load unless needed;
    # variant names live in their base module ("synthetic-large" ->
    # synthetic.py registers both)
    if name not in _REGISTRY:
        import importlib

        for mod in (name.replace("-", "_"), name.split("-")[0]):
            try:
                importlib.import_module(f"dcvgan_torch.data.preprocess.{mod}")
            except ModuleNotFoundError:
                continue
            if name in _REGISTRY:
                break
    if name not in _REGISTRY:
        raise KeyError(
            f"no preprocessor registered for dataset {name!r}; "
            f"have {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


@register("mock")
def preprocess_mock_dataset(
    dataset_path: Path,
    save_path: Path,
    mode: str,
    length: int,
    img_size: int,
    n_jobs: int,
) -> None:
    """Regenerate the synthetic mock fixture (tests + debug configs)."""
    del dataset_path, mode, length, n_jobs
    from dcvgan_torch.data.mock import generate_mock_dataset

    generate_mock_dataset(Path(save_path), image_size=img_size)


@register("mug")
def preprocess_mug_dataset(
    dataset_path: Path,
    save_path: Path,
    mode: str,
    length: int,
    img_size: int,
    n_jobs: int,
) -> None:
    """MUG was preprocessed out of band by the reference, which left this
    function unimplemented; so does the JAX package."""
    raise NotImplementedError(
        "MUG preprocessing is not implemented (matches the reference); "
        "provide a preprocessed directory tree instead"
    )


def n_workers(n_jobs: int) -> int:
    """Threads for ``n_jobs`` as joblib reads it: a positive count as is,
    -1 all CPUs, -2 all but one, and so on."""
    if n_jobs == 0:
        raise ValueError("n_jobs == 0 has no meaning")
    if n_jobs < 0:
        return max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    return n_jobs


def parallel_map(fn: Callable[..., T], jobs: Iterable[tuple], n_jobs: int) -> List[T]:
    """``[fn(*job) for job in jobs]`` on :func:`n_workers` threads, in the
    jobs' order; the first exception is raised."""
    with ThreadPoolExecutor(max_workers=n_workers(n_jobs)) as pool:
        return list(pool.map(lambda job: fn(*job), jobs))
