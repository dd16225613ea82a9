"""The port's GAN objectives against ``dcvgan_tpu.losses``, f32 and bf16 logits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch import losses as port
from dcvgan_tpu import losses as ref

# both sides upcast the logits to f32 and reduce in f32: only the order of
# the mean's summation differs
ATOL = 1e-6


def _logits(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = [(3, 4, 4), (3, 4, 4, 4), (3, 3, 4, 4)]
    ys = [(rng.normal(size=s) * 3).astype(np.float32) for s in shapes]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    return [jnp.asarray(y).astype(jdt) for y in ys], [torch.from_numpy(y).to(tdt) for y in ys]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["adversarial-loss", "hinge-loss"])
def test_pairs_match_jax(name, dtype):
    jy, ty = _logits(0, dtype)
    jp, tp = ref.get_loss(name), port.get_loss(name)
    got = tp.dis(ty[0], ty[1])
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(jp.dis(jy[0], jy[1])), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(tp.gen(*ty).item(), float(jp.gen(*jy)), atol=ATOL, rtol=1e-6)


def test_hinge_generator_term_omits_gdis():
    _, ty = _logits(1, "f32")
    a = port.hinge_gen_loss(ty[0], ty[1], ty[2])
    b = port.hinge_gen_loss(ty[0], ty[1], ty[2] * 100 + 7)
    assert a.item() == b.item()
    c = port.adversarial_gen_loss(ty[0], ty[1], ty[2])
    assert c.item() != port.adversarial_gen_loss(ty[0], ty[1], ty[2] + 1).item()


def test_registry_has_the_jax_names_and_raises_on_unknown():
    assert set(port.LOSS_REGISTRY) == set(ref.LOSS_REGISTRY)
    with pytest.raises(KeyError, match="unknown loss"):
        port.get_loss("wasserstein")


def test_fresh_critic_losses_are_two_ln_two():
    z = torch.zeros(2, 4, 4)
    assert port.adversarial_dis_loss(z, z).item() == pytest.approx(2 * np.log(2), abs=1e-6)
