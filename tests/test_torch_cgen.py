"""The port's colour video generator against the JAX package's, eval mode.

On the CPU the down path's ``fused_norm_act_conv`` runs its plain version,
so these cases hold the fused formulation (BatchNorm folded into the next
conv's prologue, the skip taken from ``xn_out``) against flax's
conv -> BN -> LeakyReLU chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.compat.from_jax import cgen_from_jax
from dcvgan_torch.models.cgen import ColorVideoGenerator as PortCGen
from dcvgan_torch.models.layers import cast_for_compute
from dcvgan_torch.ops.fused_block import fused_norm_act_conv
from dcvgan_tpu.models import ColorVideoGenerator as JaxCGen
from torch_port_util import ATOL_F32, NGF, nchw, nhwc, randomize_tree, within
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DZ, N = 4, 4
# bf16 against JAX in bf16: the port normalises the down path in f32 and
# rounds once per block (the fused prologue) where flax rounds after the conv
# and again after BN, and both round every up stage; the differences of a
# few bf16 ulps pass through 13 layers. Measured max |diff| over three seeds:
# 1.1e-2 on outputs in [-1, 1]; held at 2e-2.
BF16_ATOL = 2e-2


def _models(in_ch, geometric_info, dtype_jax, dtype_torch, seed):
    jm = JaxCGen(in_ch=in_ch, dim_z=DZ, geometric_info=geometric_info, ngf=NGF, dtype=dtype_jax)
    x0 = jnp.zeros((1, 64, 64, in_ch), dtype_jax)
    v = jax.eval_shape(lambda: jm.init(jax.random.key(0), x0, jnp.zeros((1, DZ)), train=False))
    rng = np.random.default_rng(seed)
    variables = {
        "params": randomize_tree(v["params"], rng),
        "batch_stats": randomize_tree(v["batch_stats"], rng),
    }
    pm = PortCGen(in_ch=in_ch, dim_z=DZ, geometric_info=geometric_info, ngf=NGF)
    pm.load_state_dict(cgen_from_jax(variables["params"], variables["batch_stats"]))
    cast_for_compute(pm, torch.device("cpu"), dtype_torch).eval()
    return jm, variables, pm


def _jax_forward(jm, variables, x, z):
    return jax.jit(lambda v, x, z: jm.apply(v, x, z, train=False))(variables, x, z)


def _inputs(in_ch, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (N, 64, 64, in_ch)).astype(np.float32)
    z = rng.normal(size=(N, DZ)).astype(np.float32)
    return x, z


@pytest.mark.parametrize(
    "dtypes,atol",
    [((jnp.float32, torch.float32), ATOL_F32), ((jnp.bfloat16, torch.bfloat16), BF16_ATOL)],
    ids=["f32", "bf16"],
)
def test_forward_matches_jax(dtypes, atol):
    jm, variables, pm = _models(1, "depth", *dtypes, seed=0)
    x, z = _inputs(1, 1)
    launches = fused_norm_act_conv.launches
    with torch.no_grad():
        got = pm(nchw(x), torch.from_numpy(z))
    assert fused_norm_act_conv.launches == launches  # the CPU runs the plain version
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = _jax_forward(jm, variables, jnp.asarray(x, dtypes[0]), jnp.asarray(z))
    within(nhwc(got), np.asarray(want, np.float32), atol)


def test_segmentation_rebinarises_by_argmax():
    jm, variables, pm = _models(25, "segmentation", jnp.float32, torch.float32, seed=2)
    x, z = _inputs(25, 3)
    with torch.no_grad():
        got = pm(nchw(x), torch.from_numpy(z))
        # the one-hot re-binarisation makes the output depend only on argmax
        same = pm(nchw(np.where(x == x.max(-1, keepdims=True), 1.0, -1.0)), torch.from_numpy(z))
    want = _jax_forward(jm, variables, jnp.asarray(x), jnp.asarray(z))
    within(nhwc(got), np.asarray(want), ATOL_F32)
    torch.testing.assert_close(got, same, rtol=0, atol=0)


def test_forward_videos_repeats_the_latent_over_time():
    jm, variables, pm = _models(1, "depth", jnp.float32, torch.float32, seed=4)
    rng = np.random.default_rng(5)
    b, t = 2, 2
    xs = rng.uniform(-1, 1, (b, t, 64, 64, 1)).astype(np.float32)
    z = rng.normal(size=(b, DZ)).astype(np.float32)
    with torch.no_grad():
        got = pm.forward_videos(torch.from_numpy(xs), torch.from_numpy(z))
    want = _jax_forward(
        jm, variables, jnp.asarray(xs.reshape(b * t, 64, 64, 1)), jnp.asarray(np.repeat(z, t, axis=0))
    )
    within(got.numpy(), np.asarray(want).reshape(b, t, 64, 64, 3), ATOL_F32)


def test_train_mode_raises():
    # train mode runs unfused on batch statistics, selected by the argument
    # and not by .training; what raises is a missing or wrong number of
    # dropout masks
    pm = PortCGen(in_ch=1, dim_z=DZ, ngf=NGF)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    cast_for_compute(pm, torch.device("cpu"), torch.float32)
    x, z = _inputs(1, 8)
    x, z = nchw(x), torch.from_numpy(z)
    with torch.no_grad():
        ev = pm(x, z)  # a fresh module's .training flag is set: eval all the same
        masks = pm.dropout_masks(x.shape[0], torch.Generator().manual_seed(1), x.device)
        tr = pm(x, z, train=True, update_stats=False, dropout_masks=masks)
        with pytest.raises(ValueError):  # train mode takes its masks
            pm(x, z, train=True, update_stats=False)
        with pytest.raises(IndexError):
            pm(x, z, train=True, update_stats=False, dropout_masks=[])
    assert tr.shape == ev.shape and not torch.allclose(tr, ev)


def test_state_dict_names_are_the_reference_modules():
    pm = PortCGen(in_ch=1, dim_z=DZ, ngf=NGF)
    keys = set(pm.state_dict())
    for want in ("inconv.main.0.weight", "down_blocks.5.main.1.running_var",
                 "up_blocks.0.main.0.weight", "outconv.main.0.weight"):
        assert want in keys
