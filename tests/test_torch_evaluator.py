"""The port's Evaluator against the JAX package's, and the trainer's hook.

The same uint8 videos and the same extractor npz go through both
evaluators. Features agree within 1e-4 abs + 1e-4 rel (float32
convolutions summed in another order); IS and FID computed from them are
held within 1e-4 rel and 1e-3 rel + 1e-3 abs (the Fréchet distance's matrix
square root carries the features' differences).
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

from dcvgan_torch import prng
from dcvgan_torch.cli import train as cli_train
from dcvgan_torch.config import ExperimentConfig, load_config
from dcvgan_torch.eval.evaluator import Evaluator
from dcvgan_torch.eval.features import FeatureExtractor
from dcvgan_torch.io.video import read_video, read_videos_parallel, write_video, write_videos_parallel
from dcvgan_torch.logging.logger import Logger
from dcvgan_torch.train.step import DCVGAN
from dcvgan_torch.train.trainer import Trainer
from dcvgan_tpu.eval.evaluator import Evaluator as JaxEvaluator
from dcvgan_tpu.eval.features import FeatureExtractor as JaxExtractor

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "assets" / "extractor-synthetic.npz"
SCORE_TOL = {"is": (0.0, 1e-4), "fid": (1e-3, 1e-3), "fvd": (1e-3, 1e-3)}


def _videos(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 64, 64, 3), dtype=np.uint8)


class ArrayDataset:
    """``sample(i, rng)`` like VideoDataset's, over fixed uint8 videos; keeps
    each (index, crop draw) it was asked for."""

    def __init__(self, videos):
        self.videos = videos
        self.calls = []

    def __len__(self):
        return len(self.videos)

    def sample(self, i, rng):
        self.calls.append((i, int(rng.integers(0, 1000))))
        return {"color": self.videos[i]}


@pytest.fixture(scope="module")
def extractors():
    return FeatureExtractor(weights_path=ASSET, device="cpu"), JaxExtractor(weights_path=str(ASSET))


def _close(got, want):
    assert got.keys() == want.keys()
    for k in got:
        atol, rtol = SCORE_TOL[k]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_score_videos_matches_the_jax_evaluator(extractors):
    px, jx = extractors
    real, fake = _videos(10, seed=1), _videos(9, seed=2)
    fake[:3] //= 3  # darker clips: a spread of features
    kw = dict(metrics=["is", "fid", "fvd"], num_samples=9, batchsize=4, max_real_samples=8)
    got = Evaluator(dataset=ArrayDataset(real), extractor=px, **kw).score_videos(fake)
    want = JaxEvaluator(dataset=ArrayDataset(real), extractor=jx, **kw).score_videos(fake)
    _close(got, want)
    assert got["fid"] > 0 and got["is"] >= 1.0


def test_real_features_pick_the_same_clips_and_crops(extractors):
    px, jx = extractors
    real = _videos(12, seed=3)
    ours, theirs = ArrayDataset(real), ArrayDataset(real)
    f = Evaluator(["fid"], 1, 3, dataset=ours, extractor=px, max_real_samples=7)._real_features()
    Evaluator(["fid"], 1, 3, dataset=ours, extractor=px, max_real_samples=7)._real_features()
    JaxEvaluator(["fid"], 1, 3, dataset=theirs, extractor=jx, max_real_samples=7)._real_features()
    assert ours.calls[:7] == theirs.calls and ours.calls[7:] == theirs.calls
    assert f.shape == (7, 128) and len({i for i, _ in theirs.calls}) == 7


def test_evaluate_dirs_matches_the_jax_evaluator(tmp_path, extractors):
    px, jx = extractors
    gen, ref = tmp_path / "gen", tmp_path / "ref"
    gen.mkdir()
    ref.mkdir()
    gvids, rvids = _videos(5, seed=4), _videos(6, seed=5)
    gvids[2:] //= 2
    out = write_videos_parallel(gvids, [gen / f"{i:06d}.mp4" for i in range(5)], n_jobs=3)
    np.testing.assert_array_equal(out, gvids)
    write_videos_parallel(rvids, [ref / f"{i:06d}.mp4" for i in range(6)])
    kw = dict(metrics=["is", "fid"], num_samples=0, batchsize=2, max_real_samples=4)
    got = Evaluator(extractor=px, **kw).evaluate_dirs(gen, ref)
    want = JaxEvaluator(extractor=jx, **kw).evaluate_dirs(gen, ref)
    _close(got, want)
    with pytest.raises(FileNotFoundError):
        Evaluator(extractor=px, **kw).evaluate_dirs(tmp_path / "none")
    with pytest.raises(ValueError, match="reference features"):
        Evaluator(extractor=px, **kw).evaluate_dirs(gen)


def test_video_io_round_trip_and_grey_frames(tmp_path):
    grey = np.random.default_rng(6).integers(0, 256, (16, 64, 64, 1), dtype=np.uint8)
    write_video(grey, tmp_path / "g.mp4")
    back = read_video(tmp_path / "g.mp4")
    assert back.shape == (16, 64, 64, 3) and back.dtype == np.uint8
    flat = np.full((16, 64, 64, 3), 77, np.uint8)
    write_video(flat, tmp_path / "f.mp4")
    a, b = read_videos_parallel([tmp_path / "f.mp4", tmp_path / "g.mp4"], n_jobs=2)
    # mp4v stores YUV 4:2:0: a flat grey frame comes back flat, each channel
    # within a few levels (74, 76, 73 for 77 with this OpenCV)
    assert a.shape == (16, 64, 64, 3) and np.ptp(a.reshape(-1, 3), axis=0).max() <= 1
    assert np.abs(a.astype(int) - 77).max() <= 6
    assert np.array_equal(b, back)
    with pytest.raises(RuntimeError, match="could not open video writer"):
        write_video(flat, tmp_path / "missing" / "x.mp4")
    with pytest.raises(FileNotFoundError):
        read_video(tmp_path / "missing.mp4")


def _tiny_cfg(**trainer):
    return ExperimentConfig.from_dict({
        "batchsize": 2,
        "geometric_info": {"name": "depth", "channel": 1},
        "ggen": {"dim_z_content": 8, "dim_z_motion": 4, "ngf": 8},
        "cgen": {"dim_z_color": 4, "ngf": 8},
        "idis": {"ndf": 8}, "vdis": {"ndf": 8}, "gdis": {"ndf": 8},
        "trainer": {"precision": "float32", **trainer},
    })


def test_device_resident_eval_matches_the_host_path(extractors):
    px, _ = extractors
    gan = DCVGAN(_tiny_cfg(), device="cpu")
    state = gan.init_state(0)
    ev = Evaluator(["is", "fid"], num_samples=5, batchsize=2, dataset=ArrayDataset(_videos(6, 7)),
                   extractor=px)
    key = prng.base_key(42)
    fused = ev.evaluate(gan, state, key, device_resident=True)
    host = ev.evaluate(gan, state, key, device_resident=False)
    assert fused.keys() == host.keys() == {"is", "fid"}
    for k in fused:
        np.testing.assert_allclose(fused[k], host[k], rtol=1e-4, atol=1e-5)
    feats, probs = ev.sample_and_embed(gan, state, key)
    assert feats.shape == (5, 128) and probs.shape == (5, 24)


def test_trainer_evaluate_defines_and_updates_the_metrics(tmp_path):
    raw = yaml.safe_load((REPO / "configs" / "debug-mock-depth.yml").read_text())
    raw.update(log_dir=str(tmp_path / "result"), tensorboard_dir=str(tmp_path / "runs"),
               evaluation={"batchsize": 2, "num_samples": 3, "metrics": ["is", "prd"],
                           "extractor_weights": "assets/extractor-synthetic.npz"})
    raw["dataset"].update(path=str(tmp_path / "raw"), processed_root=str(tmp_path / "processed"))
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(raw))
    cfg = load_config(tmp_path / "cfg.yml")
    dataset = cli_train.build_dataset(cfg)
    evaluator = cli_train.build_evaluator(cfg, dataset, device="cpu")
    assert evaluator.extractor.fingerprint == JaxExtractor(weights_path=str(ASSET)).fingerprint
    logger = Logger(tmp_path / "run", None)
    trainer = Trainer(cfg, dataset, logger=logger, evaluator=evaluator, device="cpu")
    trainer.evaluate(0)
    trainer.evaluate(5)
    assert {"is", "prd", "prd_f1_8"} <= set(logger.metrics)
    assert np.isfinite(logger.metrics["is"].value) and logger.metrics["is"].value >= 1.0
    assert 0.0 <= logger.metrics["prd_f1_8"].value <= 1.0
    assert (tmp_path / "run" / "log").read_text().count("eval extractor: small-npz/sha256=") == 1
    cfg.evaluation.extractor_weights = "assets/no-such-file.npz"
    with pytest.raises(FileNotFoundError, match="no-such-file"):
        cli_train.build_evaluator(cfg, dataset, device="cpu")
    cfg.evaluation.metrics = []
    assert cli_train.build_evaluator(cfg, dataset) is None

