"""Weights carried between the packages, the port's config copy, and the
port's independence from JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.compat.from_jax import cgen_from_jax, ggen_from_jax, read_weights_npz
from dcvgan_torch.config import load_config as port_load_config
from dcvgan_torch.models.cgen import ColorVideoGenerator as PortCGen
from dcvgan_torch.models.ggen import GeometricVideoGenerator as PortGGen
from dcvgan_torch.train.step import DCVGAN
from dcvgan_tpu.compat import cgen_from_torch, ggen_from_torch
from dcvgan_tpu.config import load_config as jax_load_config
from dcvgan_tpu.models import ColorVideoGenerator as JaxCGen
from dcvgan_tpu.models import GeometricVideoGenerator as JaxGGen
from torch_port_util import NGF, flatten_tree, randomize_tree

REPO = Path(__file__).resolve().parents[1]


def _jax_trees(name, seed):
    if name == "ggen":
        m = JaxGGen(dim_z_content=6, dim_z_motion=4, channel=1, ngf=NGF, video_length=4)
        v = jax.eval_shape(lambda: m.init(
            {"params": jax.random.key(0), "latent": jax.random.key(0)}, 1, train=False))
    else:
        m = JaxCGen(in_ch=1, dim_z=4, ngf=NGF)
        v = jax.eval_shape(lambda: m.init(
            jax.random.key(0), jnp.zeros((1, 64, 64, 1)), jnp.zeros((1, 4)), train=False))
    rng = np.random.default_rng(seed)
    return randomize_tree(v["params"], rng), randomize_tree(v["batch_stats"], rng)


def _port_module(name):
    if name == "ggen":
        return PortGGen(dim_z_content=6, dim_z_motion=4, channel=1, ngf=NGF, video_length=4)
    return PortCGen(in_ch=1, dim_z=4, ngf=NGF)


FROM_JAX = {"ggen": ggen_from_jax, "cgen": cgen_from_jax}
FROM_TORCH = {"ggen": ggen_from_torch, "cgen": cgen_from_torch}


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", ["ggen", "cgen"])
def test_jax_to_port_to_jax_is_exact(name):
    params, stats = _jax_trees(name, seed=0)
    sd = FROM_JAX[name](params, stats)
    module = _port_module(name)
    module.load_state_dict(sd)  # strict: every key of the port module, no other
    params2, stats2 = FROM_TORCH[name](module.state_dict())
    _assert_trees_equal(params, params2)
    _assert_trees_equal(stats, stats2)


@pytest.mark.parametrize("name", ["ggen", "cgen"])
def test_port_to_jax_to_port_is_exact(name):
    module = _port_module(name)
    module.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for key, buf in module.named_buffers():
            if key.endswith("running_mean"):
                buf.normal_(0, 0.5)
            elif key.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    back = FROM_JAX[name](*FROM_TORCH[name](sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if k == "recurrent.bias_ih":
            # flax folds b_hr, b_hz into the input biases; the n gate stays split
            h = v.shape[0] // 3
            want = torch.cat([v[: 2 * h] + sd["recurrent.bias_hh"][: 2 * h], v[2 * h:]])
            assert torch.equal(back[k], want)
        elif k == "recurrent.bias_hh":
            h = v.shape[0] // 3
            assert torch.equal(back[k], torch.cat([torch.zeros(2 * h), v[2 * h:]]))
        else:
            assert torch.equal(back[k], v), k
    if name == "ggen":  # the refolded GRU computes the same states
        other = _port_module(name)
        other.load_state_dict(back)
        x, h0 = torch.randn(3, 4), torch.randn(3, 4)
        with torch.no_grad():
            torch.testing.assert_close(other.recurrent(x, h0), module.recurrent(x, h0))


def test_weights_npz_loads_into_dcvgan(tmp_path):
    trees = {}
    for name in ("ggen", "cgen"):
        params, stats = _jax_trees(name, seed=3)
        trees[name] = {"params": params, "batch_stats": stats}
    path = tmp_path / "w.npz"
    np.savez(path, **flatten_tree(trees))
    read = read_weights_npz(path)
    _assert_trees_equal(read["cgen"]["params"], trees["cgen"]["params"])

    cfg = port_load_config(REPO / "configs" / "debug-mug-depth.yml")
    cfg.video_length, cfg.trainer.precision = 4, "float32"
    cfg.ggen.dim_z_content, cfg.ggen.dim_z_motion, cfg.ggen.ngf = 6, 4, NGF
    cfg.cgen.dim_z_color, cfg.cgen.ngf = 4, NGF
    state = DCVGAN(cfg, device="cpu").load_state(path)
    assert state.ema is None
    for name in ("ggen", "cgen"):
        want = FROM_JAX[name](trees[name]["params"], trees[name]["batch_stats"])
        got = getattr(state, name).state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)


def test_every_config_loads_like_the_jax_loader():
    paths = sorted((REPO / "configs").glob("*.yml"))
    assert paths
    for p in paths:
        port, ref = port_load_config(p), jax_load_config(p)
        assert port.seed == ref.seed and port.video_length == ref.video_length, p
        assert port.image_size == ref.image_size, p
        assert (port.geometric_info.name, port.geometric_info.channel) == (
            ref.geometric_info.name, ref.geometric_info.channel), p
        assert (port.ggen.dim_z_content, port.ggen.dim_z_motion, port.ggen.ngf) == (
            ref.ggen.dim_z_content, ref.ggen.dim_z_motion, ref.ggen.ngf), p
        assert (port.cgen.dim_z_color, port.cgen.ngf) == (ref.cgen.dim_z_color, ref.cgen.ngf), p
        assert port.trainer.precision == ref.trainer.precision, p
        assert port.trainer.norm == ref.trainer.norm, p
        assert port.trainer.ema_decay == ref.trainer.ema_decay, p


def test_training_schema_matches_the_jax_loader():
    """Every key the port reads has the JAX loader's value in every config,
    defaults included; the one key it drops (``donate_state``) has no
    meaning in eager PyTorch."""
    dropped = {"donate_state"}
    for p in sorted((REPO / "configs").glob("*.yml")):
        port, ref = port_load_config(p).to_dict(), jax_load_config(p).to_dict()
        ref["trainer"] = {k: v for k, v in ref["trainer"].items() if k not in dropped}
        assert port == ref, p


@pytest.mark.parametrize("bad,match", [
    ({"batchsize": 0}, "batchsize"), ({"loss": "wasserstein"}, "loss must be one of"),
    ({"num_gen_update": 0}, "num_gen_update"), ({"idis": {"ndf": 0}}, "ndf"),
    ({"vdis": {"noise_sigma": -1.0}}, "noise_sigma"), ({"cgen": {"optimizer": {"lr": 0}}}, "lr"),
    ({"evaluation": {"metrics": ["psnr"]}}, "metrics"), ({"mesh": {"time": 0}}, "mesh"),
    ({"trainer": {"ema_decay": 1.0}}, "ema_decay"), ({"dataset": {"n_workers": -1}}, "n_workers"),
])
def test_validation_errors_match_the_jax_loader(tmp_path, bad, match):
    from dcvgan_torch.config import ConfigError
    from dcvgan_tpu.config import ConfigError as JaxConfigError
    import yaml

    p = tmp_path / "bad.yml"
    p.write_text(yaml.safe_dump(bad))
    with pytest.raises(JaxConfigError, match=match) as ref:
        jax_load_config(p)
    with pytest.raises(ConfigError, match=match) as got:
        port_load_config(p)
    assert str(got.value) == str(ref.value)


def test_unknown_config_key_raises(tmp_path):
    from dcvgan_torch.config import ConfigError

    p = tmp_path / "bad.yml"
    p.write_text("ggen:\n  ngf: 8\n  wings: 2\n")
    with pytest.raises(ConfigError, match="wings"):
        port_load_config(p)


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "dcvgan_tpu", "tools"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import dcvgan_torch
names = [m.name for m in pkgutil.walk_packages(dcvgan_torch.__path__, "dcvgan_torch.")]
for n in names + ["chip_smoke"]:
    importlib.import_module(n)
for n in ("models.discriminators", "losses", "ops.dequant", "train.checkpoint", "train.trainer",
          "cli.train", "data.dataset", "data.loader", "data.mock", "data.host_ops",
          "data.preprocess.synthetic", "io.image", "logging.logger", "io.video", "eval.metrics",
          "eval.features", "eval.evaluator", "cli.evaluate", "cli.infer", "cli.import_torch",
          "compat.torch_import", "native", "data.preprocess", "data.preprocess.surreal",
          "data.preprocess.isogd", "cli.preprocess", "utils.debug", "utils.video_np",
          "parallel", "parallel.mesh", "parallel.temporal", "tools.headtohead",
          "tools.extractor", "tools.multiembed", "tools.demo"):
    assert "dcvgan_torch." + n in names, n
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "dcvgan_tpu", "tools")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the port was imported
    assert int(out.stdout.strip()) >= 59
