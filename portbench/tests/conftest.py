"""The harness's CPU tests: ``python -m pytest portbench/tests -q`` from the
repo root. Cases that need the card carry the ``gpu`` marker and skip in a
fixture where there is none."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


# a tiny flagship for the CPU: every width cut to 8 channels, 4 videos a batch
TINY = {"ggen.ngf": 8, "cgen.ngf": 8, "idis.ndf": 8, "vdis.ndf": 8, "gdis.ndf": 8,
        "batchsize": 4, "trainer.precision": "float32"}


@pytest.fixture
def tiny(tmp_path):
    """Configuration overrides of a tiny run whose tree and run directory
    lie under ``tmp_path``."""
    return dict(TINY, **{"dataset.processed_root": str(tmp_path / "data"),
                         "log_dir": str(tmp_path / "run"), "tensorboard_dir": str(tmp_path / "run/tb")})
