"""The run post-processor of the port (``dcvgan_torch.tools.demo``) against
the repository's JAX tool (``tools/train_demo.py``), on a run the port's
``Trainer`` writes on the CPU: ``configs/headtohead-tpu.yml`` at ngf/ndf 8
in f32, 8 videos in batches of 4 (2 steps), a checkpoint and a log row
each step, an evaluation (IS, FID) at steps 0 and 2.

- ``parse_log`` gives the JAX tool's header and rows, and ``write_csv`` its
  bytes;
- the charts are drawn (matplotlib is imported only there), byte for byte
  as the JAX tool draws them;
- the strip and the mp4 grid the port lays out from given samples equal the
  JAX tool's from the same arrays (both tools run with their samplers,
  checkpoints and writers replaced by recorders);
- ``render_checkpoint_samples`` writes one strip per checkpoint; the last
  equals, byte for byte after the PNG round trip, the strip of
  ``generate_samples`` on the live trained state from the same seed, and
  ``final_samples.mp4`` reads back as (16, 64, 4 * 64, 3) uint8.
"""

import csv
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import yaml

from dcvgan_torch import prng
from dcvgan_torch.eval.sampler import generate_samples
from dcvgan_torch.io.image import read_img
from dcvgan_torch.io.video import read_video
from dcvgan_torch.tools import demo, headtohead
from torch_port_util import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import train_demo as jax_tool  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
N_SAMPLES = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run directory, trainer) of a 2-step ngf-8 run."""
    root = tmp_path_factory.mktemp("demo")
    raw = yaml.safe_load((REPO / "configs" / "headtohead-tpu.yml").read_text())
    for name in ("ggen", "cgen"):
        raw[name]["ngf"] = 8
    for name in ("idis", "vdis", "gdis"):
        raw[name]["ndf"] = 8
    raw.update(batchsize=4, n_epochs=1, snapshot_interval=1, evaluation_interval=2, log_interval=1,
               trainer={"precision": "float32"})
    raw["dataset"].update(number_limit=8, n_workers=0)
    raw["evaluation"].update(num_samples=4, batchsize=2)
    config = root / "tiny.yml"
    config.write_text(yaml.safe_dump(raw))
    trainer, _ = headtohead.train(config, root / "work", device="cpu")
    return root / "work" / trainer.run_dir, trainer


def test_parse_log_and_write_csv_equal_the_jax_tools(run, tmp_path):
    run_dir, _ = run
    header, rows = demo.parse_log(run_dir)
    assert (header, rows) == jax_tool.parse_log(run_dir)
    assert header[:2] == ["epoch", "iteration"] and {"loss_gen", "fid", "is"} <= set(header)
    assert [r[header.index("iteration")] for r in rows] == [1.0, 2.0]
    demo.write_csv(header, rows, tmp_path / "port.csv")
    jax_tool.write_csv(header, rows, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with (tmp_path / "port.csv").open() as f:
        assert len(list(csv.reader(f))) == 1 + len(rows)


def test_the_charts_are_drawn_as_the_jax_tool_draws_them(run, tmp_path):
    header, rows = demo.parse_log(run[0])
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    demo.plot_curves(header, rows, tmp_path / "port")
    jax_tool.plot_curves(header, rows, tmp_path / "jax")
    charts = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert charts == ["fid.png", "is.png", "losses.png"]
    for name in charts:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def _record_render(monkeypatch, render, modules: dict, xg, xc, tmp_path) -> dict:
    """``render`` run with its sampler returning (xg, xc), one checkpoint at
    step 7 and its image and video writers recorded; ``modules``: the
    package's modules by role."""
    seen = {}

    class Manager:
        def __init__(self, directory):
            self._mgr = self

        def all_steps(self):
            return [7]

        def restore(self, template, step=None):
            return template

    class GAN:
        def __init__(self, cfg, device=None):
            self.device = "cpu"

        def init_state(self, key):
            return None

    monkeypatch.setattr(modules["config"], "load_config", lambda path: SimpleNamespace(seed=0))
    monkeypatch.setattr(modules["sampler"], "generate_samples", lambda *args, **kwargs: (xg, xc))
    monkeypatch.setattr(modules["checkpoint"], "CheckpointManager", Manager)
    monkeypatch.setattr(modules["step"], "DCVGAN", GAN)
    monkeypatch.setattr(modules["image"], "write_img", lambda img, path: seen.update(img=img, img_name=path.name))
    monkeypatch.setattr(modules["video"], "write_video", lambda v, path: seen.update(video=v, video_name=path.name))
    render(tmp_path, tmp_path)
    return seen


def test_the_strip_layout_equals_the_jax_tools(monkeypatch, tmp_path):
    import dcvgan_torch.config
    import dcvgan_torch.eval.sampler
    import dcvgan_torch.io.image
    import dcvgan_torch.io.video
    import dcvgan_torch.train.checkpoint
    import dcvgan_torch.train.step
    import dcvgan_tpu.config
    import dcvgan_tpu.eval.sampler
    import dcvgan_tpu.io.image
    import dcvgan_tpu.io.video
    import dcvgan_tpu.train.checkpoint
    import dcvgan_tpu.train.step

    rng = np.random.default_rng(0)
    xg = rng.integers(0, 256, (N_SAMPLES, 16, 8, 6, 3), dtype=np.uint8)
    xc = rng.integers(0, 256, (N_SAMPLES, 16, 8, 6, 3), dtype=np.uint8)
    port = _record_render(monkeypatch, demo.render_checkpoint_samples, {
        "config": dcvgan_torch.config, "sampler": dcvgan_torch.eval.sampler, "image": dcvgan_torch.io.image,
        "video": dcvgan_torch.io.video, "checkpoint": dcvgan_torch.train.checkpoint,
        "step": dcvgan_torch.train.step}, xg, xc, tmp_path)
    jax = _record_render(monkeypatch, jax_tool.render_checkpoint_samples, {
        "config": dcvgan_tpu.config, "sampler": dcvgan_tpu.eval.sampler, "image": dcvgan_tpu.io.image,
        "video": dcvgan_tpu.io.video, "checkpoint": dcvgan_tpu.train.checkpoint,
        "step": dcvgan_tpu.train.step}, xg, xc, tmp_path)
    assert port["img_name"] == jax["img_name"] == "samples_step_000007.png"
    assert port["video_name"] == jax["video_name"] == "final_samples.mp4"
    assert port["img"].shape == (2 * N_SAMPLES * 8, 8 * 6, 3) and np.array_equal(port["img"], jax["img"])
    assert port["video"].shape == (16, 8, N_SAMPLES * 6, 3) and np.array_equal(port["video"], jax["video"])
    assert np.array_equal(port["img"], demo.sample_strip(xg, xc))


def test_strips_from_checkpoints_equal_sampling_the_live_state(run, tmp_path):
    run_dir, trainer = run
    assert demo.render_checkpoint_samples(run_dir, tmp_path, device="cpu") == [1, 2]
    assert sorted(p.name for p in tmp_path.glob("*.png")) == ["samples_step_000001.png", "samples_step_000002.png"]
    xg, xc = generate_samples(trainer.gan, trainer.state, prng.base_key(demo.SAMPLE_SEED), N_SAMPLES, N_SAMPLES)
    assert np.array_equal(read_img(tmp_path / "samples_step_000002.png"), demo.sample_strip(xg, xc))
    video = read_video(tmp_path / "final_samples.mp4")
    assert video.shape == (16, 64, N_SAMPLES * 64, 3) and video.dtype == np.uint8
