"""The port's infer, evaluate and import_torch CLIs on the CPU.

``configs/debug-mock-depth.yml`` (the self-generating mock dataset, ngf 8,
f32) trains one step with ``cli.train --device cpu``; ``cli.infer`` writes
mp4 files from that run, ``cli.evaluate`` scores them (held against the JAX
package's CLI on the same files), and ``cli.import_torch`` turns
reference-named ``.pth`` snapshots into a run that ``cli.infer`` reads.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dcvgan_torch.cli import evaluate as cli_evaluate
from dcvgan_torch.cli import import_torch as cli_import
from dcvgan_torch.cli import infer as cli_infer
from dcvgan_torch.cli import train as cli_train
from dcvgan_torch.config import load_config
from dcvgan_torch.io.video import read_video
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN
from dcvgan_tpu.cli import evaluate as jax_cli_evaluate
from dcvgan_tpu.compat.torch_import import gru_cell

REPO = Path(__file__).resolve().parents[1]
DEBUG = REPO / "configs" / "debug-mock-depth.yml"
ASSET = REPO / "assets" / "extractor-synthetic.npz"


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """One training step of the debug config; returns the run directory."""
    work = tmp_path_factory.mktemp("train")
    raw = yaml.safe_load(DEBUG.read_text())
    raw.update(log_dir=str(work / "result"), tensorboard_dir=str(work / "runs"))
    raw["dataset"].update(path=str(work / "raw"), processed_root=str(work / "processed"))
    raw["trainer"] = {**raw.get("trainer", {}), "ema_decay": 0.5}
    (work / "cfg.yml").write_text(yaml.safe_dump(raw))
    cli_train.main(["--config", str(work / "cfg.yml"), "--device", "cpu"])
    return work / "result" / "debug-mock-depth"


@pytest.fixture(scope="module")
def inferred(trained_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("infer") / "gen"
    cli_infer.main([str(trained_run), "-1", str(out), "-n", "3", "-b", "2", "--device", "cpu"])
    return out


def test_infer_writes_the_layout_of_the_jax_cli(inferred):
    for sub in ("color", "depth"):
        files = sorted(p.name for p in (inferred / sub).iterdir())
        assert files == ["000000.mp4", "000001.mp4", "000002.mp4"], (sub, files)
        for name in files:
            v = read_video(inferred / sub / name)
            assert v.shape == (16, 64, 64, 3) and v.dtype == np.uint8


def test_infer_samples_the_ema_unless_asked_not_to(trained_run, tmp_path):
    cfg, gan, state = cli_infer.load_run(trained_run, -1, device="cpu")
    assert state.step == 1 and state.ema is not None
    ema = state.generators().with_ema_params()
    live = state.generators()
    # after one step at decay 0.5 the EMA sits between init and live weights
    k = "inconv.main.0.weight"
    assert not torch.equal(dict(ema.cgen.named_parameters())[k], dict(live.cgen.named_parameters())[k])
    cli_infer.main([str(trained_run), "1", str(tmp_path / "live"), "-n", "1", "-b", "1",
                    "--no-ema", "--device", "cpu"])
    assert (tmp_path / "live" / "color" / "000000.mp4").exists()
    with pytest.raises(FileNotFoundError, match="step 9"):
        cli_infer.load_run(trained_run, 9, device="cpu")


def test_evaluate_cli_prints_scores_with_the_fingerprint(inferred, capsys):
    args = [str(inferred / "color"), "--metrics", "is", "fid", "--ref-dir", str(inferred / "depth"),
            "--batchsize", "2", "--weights", str(ASSET)]
    record = cli_evaluate.main(args + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == record and set(record) == {"is", "fid", "extractor"}
    jax_cli_evaluate.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["extractor"] == want["extractor"]
    np.testing.assert_allclose(record["is"], want["is"], rtol=1e-4)
    np.testing.assert_allclose(record["fid"], want["fid"], rtol=1e-3, atol=1e-3)
    with pytest.raises(SystemExit):
        cli_evaluate.main([str(inferred / "color"), "--metrics", "fid", "--device", "cpu"])


def _reference_snapshots(cfg, directory: Path, iteration: int, seed: int):
    """Reference-named ``.pth`` files of a port state drawn from ``seed``,
    the GRU cell's biases split as ``nn.GRUCell`` keeps them (a nonzero
    ``bias_hh`` for the r and z gates). Returns the state dicts written."""
    state = DCVGAN(cfg, device="cpu").init_state(seed)
    written = {}
    for name, module in state.models.items():
        sd = {k: v.clone() for k, v in module.state_dict().items()}
        if name == "ggen":
            h = sd["recurrent.bias_hh"].shape[0] // 3
            sd["recurrent.bias_hh"][: 2 * h] = torch.from_numpy(
                np.random.default_rng(seed).normal(0, 0.1, 2 * h).astype(np.float32))
        torch.save(sd, directory / f"{name}_params_{iteration:05d}.pth")
        written[name] = sd
    return written


def test_import_torch_restores_the_reference_weights(tmp_path):
    cfg_path = tmp_path / "cfg.yml"
    raw = yaml.safe_load(DEBUG.read_text())
    raw["trainer"] = {**raw.get("trainer", {}), "ema_decay": 0.9}
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = load_config(cfg_path)
    snaps = tmp_path / "models"
    snaps.mkdir()
    written = _reference_snapshots(cfg, snaps, 1200, seed=7)
    out = tmp_path / "imported"
    cli_import.main([str(snaps), "1200", "--config", str(cfg_path), "--out", str(out), "--device", "cpu"])

    assert (out / "config.yml").exists()
    assert CheckpointManager(out / "models").all_steps() == [1200]
    _, gan, state = cli_infer.load_run(out, -1, device="cpu")
    assert state.step == 1200
    for name, sd in written.items():
        got = state.models[name].state_dict()
        assert got.keys() == sd.keys(), name
        for k, v in sd.items():
            if name == "ggen" and k in ("recurrent.bias_ih", "recurrent.bias_hh"):
                continue
            assert torch.equal(got[k], v), (name, k)
    # the GRU cell folds the reference's r / z hidden biases into its input
    # biases, as the JAX package's importer does
    ref = written["ggen"]
    h = ref["recurrent.bias_hh"].shape[0] // 3
    flax_cell = gru_cell(ref, "recurrent")
    b_ih = state.models["ggen"].state_dict()["recurrent.bias_ih"]
    np.testing.assert_array_equal(b_ih[:h].numpy(), flax_cell["ir"]["bias"])
    np.testing.assert_array_equal(b_ih[h: 2 * h].numpy(), flax_cell["iz"]["bias"])
    np.testing.assert_array_equal(b_ih[2 * h:].numpy(), ref["recurrent.bias_ih"][2 * h:].numpy())
    b_hh = state.models["ggen"].state_dict()["recurrent.bias_hh"]
    assert not b_hh[: 2 * h].any() and torch.equal(b_hh[2 * h:], ref["recurrent.bias_hh"][2 * h:])
    # the EMA is re-seeded at the imported generators
    for name in ("ggen", "cgen"):
        for k, p in state.models[name].named_parameters():
            assert torch.equal(state.ema[name][k], p), (name, k)
    # and the imported run samples
    cli_infer.main([str(out), "-1", str(tmp_path / "gen"), "-n", "1", "-b", "1", "--device", "cpu"])
    assert read_video(tmp_path / "gen" / "depth" / "000000.mp4").shape == (16, 64, 64, 3)


def test_import_torch_names_the_model_and_keys_of_a_width_mismatch(tmp_path):
    cfg_path = tmp_path / "cfg.yml"
    raw = yaml.safe_load(DEBUG.read_text())
    cfg_path.write_text(yaml.safe_dump(raw))
    snaps = tmp_path / "models"
    snaps.mkdir()
    written = _reference_snapshots(load_config(cfg_path), snaps, 3, seed=1)
    for name in written:
        if name != "ggen":
            (snaps / f"{name}_params_00003.pth").unlink()
    raw["ggen"]["ngf"] = 16
    cfg_path.write_text(yaml.safe_dump(raw))
    with pytest.raises(ValueError, match=r"ggen: .*ggen\.ngf"):
        cli_import.main([str(snaps), "3", "--config", str(cfg_path), "--out", str(tmp_path / "o"),
                         "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="_params_00004.pth"):
        cli_import.main([str(snaps), "4", "--config", str(cfg_path), "--out", str(tmp_path / "o"),
                         "--device", "cpu"])
