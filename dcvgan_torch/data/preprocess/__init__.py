"""Raw-dataset preprocessors + explicit registry.

Counterpart of ``dcvgan_tpu/data/preprocess``: a registry keyed by dataset
name. The port offers ``mock`` (the fixture), ``synthetic`` and
``synthetic-large`` (generated moving shapes); the isogd, mug and surreal
preprocessors are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict

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
