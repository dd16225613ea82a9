"""The colour generator's train-mode backward, port against JAX, at the
ill-conditioned seed-22 state of ``tests/test_torch_levers.py``.

At ``jax_state(seed=22)`` the whole train step's cgen gradient lies up to
8.2e-2 (per tensor, of the tensor's largest) from JAX's, at the edge of the
suite's ``GRAD_RTOL`` (ROADMAP, faults). Here cgen's backward is taken alone
on identical inputs: that state's cgen parameters and statistics, one
geometry video and one colour latent, the same dropout keep masks and the
same cotangent on cgen's output, all made in numpy and handed to both
packages (the JAX side takes the masks through an interceptor of its
Dropout layers; nothing in the JAX package changes). JAX's gradient comes
from ``jax.vjp`` of the ``ColorVideoGenerator`` apply, the port's from
autograd.

Readings on the CPU (ngf 8, B=2, T=16, 64x64; per tensor, of the tensor's
largest):

- f32, a uniform geometry video: parameters 1.7e-5 (down2's BatchNorm
  bias), input 1.1e-5; held at 1e-3;
- f64 on both sides, the step's own fake (JAX's ggen at the state): 4.4e-14
  and 2.7e-14; held at 1e-9. The two backward passes are the same
  arithmetic;
- f32, the step's fake: 1.1e-2 (up5's BatchNorm bias) and 1.8e-2 from
  rounding alone; the port's ggen gives a fake 1.3e-5 from JAX's, and that
  input change moves the port's own cgen gradient by 9.9e-3.

So the step-level gap is no port fault: at this state cgen's backward turns
1e-5 changes of its input (and f32 rounding) into 1e-2 changes of its
gradient, at the outermost up block's BatchNorm rather than at the 2x2
ones, and the whole step adds the critics' cotangents to that.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_port_util import (
    B, GRAD_RTOL, S, T, flatten_tree, jax_state, one_intra_op_thread, port_state, port_tree,
    record_jax_draws, step_configs,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# identical inputs, f32, a uniform geometry video: the two backward passes
# differ by summation order only; within 1e-3 of each tensor's largest
BACKWARD_RTOL = 1e-3
# float64 on both sides: summation order at 2^-52
F64_RTOL = 1e-9


def masked_dropout(masks):
    """An interceptor that makes flax's Dropout layers apply ``masks`` (keep
    masks ``(N, C)``, in call order) with the layer's own arithmetic."""
    it = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__" and not mod.deterministic:
            x = args[0]
            keep = jnp.asarray(next(it))[:, None, None, :]
            return jax.lax.select(jnp.broadcast_to(keep, x.shape), x / (1.0 - mod.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return interceptor


@pytest.fixture(scope="module")
def seed22():
    """The seed-22 state in both packages, the step's fakes of JAX's and the
    port's ggen from the same latents, and numpy inputs for cgen."""
    jcfg, pcfg = step_configs()
    jgan = JaxGAN(jcfg)
    from dcvgan_torch.train.step import DCVGAN as PortGAN

    jstate = jax_state(jgan, 22)
    pstate = port_state(PortGAN(pcfg, device="cpu"), jstate)
    gv = {"params": jstate.ggen.params, "batch_stats": jstate.ggen.batch_stats}
    (jax_fake, _), d = record_jax_draws(lambda: jgan.ggen.apply(
        gv, B, train=True, rngs={"latent": jax.random.key(3)}, mutable=["batch_stats"]))
    z = d["z"][0].reshape(B, T, -1)[:, 0, : jcfg.ggen.dim_z_content]
    with torch.no_grad():
        port_fake = pstate.ggen(torch.from_numpy(z), torch.from_numpy(d["e"][0]),
                                torch.from_numpy(d["h0"][0]), train=True, update_stats=False)
    rng = np.random.default_rng(2222)
    c = 4 * jcfg.cgen.ngf  # the two dropout layers' channels
    return {
        "jgan": jgan, "jstate": jstate, "pstate": pstate,
        "videos": {"uniform": rng.uniform(-1, 1, (B, T, S, S, 1)).astype(np.float32),
                   "step_fake": np.asarray(jax_fake, np.float32)},
        "port_fake": port_fake.numpy(),
        "z": rng.normal(size=(B, jcfg.cgen.dim_z_color)).astype(np.float32),
        "masks": [rng.random((B * T, c)) < 0.5 for _ in range(2)],
        "cotangent": (rng.normal(size=(B, T, S, S, 3)) / (B * T * S * S)).astype(np.float32),
    }


def jax_backward(s, video, dtype=jnp.float32):
    """JAX's cgen output, parameter gradient and input gradient by
    ``jax.vjp``, computed in ``dtype`` (float64 under ``jax.enable_x64``)."""
    cgen = s["jstate"].cgen
    module = s["jgan"].cgen.clone(dtype=dtype)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), tree)
    stats = cast(cgen.batch_stats)
    z = jnp.repeat(jnp.asarray(s["z"], dtype), T, axis=0)

    def apply(params, x):
        with nn.intercept_methods(masked_dropout(s["masks"])):
            y, _ = module.apply({"params": params, "batch_stats": stats},
                                x.reshape(B * T, S, S, -1), z, train=True, mutable=["batch_stats"])
        return y.reshape(B, T, S, S, 3)

    out, vjp = jax.vjp(apply, cast(cgen.params), jnp.asarray(video, dtype))
    g_params, g_x = vjp(jnp.asarray(s["cotangent"], dtype))
    return (np.asarray(out), flatten_tree(jax.tree.map(np.asarray, g_params)), np.asarray(g_x))


def port_backward(s, video, dtype=torch.float32):
    """The port's cgen output, parameter gradient (as a flat flax tree) and
    input gradient by autograd, computed in ``dtype``."""
    cgen = s["pstate"].cgen
    if dtype != torch.float32:
        cgen = copy.deepcopy(cgen).to(dtype)
        cgen.compute_dtype = dtype
    cgen.zero_grad(set_to_none=True)
    x = torch.tensor(video, dtype=dtype, requires_grad=True)
    out = cgen.forward_videos(x, torch.from_numpy(s["z"]).to(dtype), train=True, update_stats=False,
                              dropout_masks=[torch.from_numpy(m) for m in s["masks"]])
    out.backward(torch.from_numpy(s["cotangent"]).to(dtype))
    grads = flatten_tree(port_tree("cgen", cgen, {k: p.grad for k, p in cgen.named_parameters()}))
    return out.detach().numpy(), grads, x.grad.numpy()


def gaps(got, want):
    """(largest per-tensor parameter gap, its tensor, input gap), each as
    max |diff| / max |want| of the tensor."""
    (_, g_params, g_x), (_, w_params, w_x) = got, want
    assert set(g_params) == set(w_params) and len(w_params) > 10
    per_tensor = {k: float(np.abs(g_params[k] - w).max() / np.abs(w).max()) for k, w in w_params.items()}
    worst = max(per_tensor, key=per_tensor.get)
    return per_tensor[worst], worst, float(np.abs(g_x - w_x).max() / np.abs(w_x).max())


def test_cgen_backward_matches_jax_in_f32_on_a_uniform_video(seed22):
    x = seed22["videos"]["uniform"]
    want, got = jax_backward(seed22, x), port_backward(seed22, x)
    assert np.abs(got[0] - want[0]).max() <= 1e-4
    params, worst, gx = gaps(got, want)
    print(f"seed 22 cgen backward, f32, uniform video: parameters {params:.3e} ({worst}), input {gx:.3e}")
    assert params <= BACKWARD_RTOL and gx <= BACKWARD_RTOL
    assert all(np.abs(w).max() > 0 for w in want[1].values())


def test_cgen_backward_matches_jax_in_f64_on_the_step_fake(seed22):
    """The same arithmetic on both sides: in float64 the gradients agree to
    rounding, where float32 leaves 1e-2 at this input (next test)."""
    x = seed22["videos"]["step_fake"]
    with jax.enable_x64(True):
        want = jax_backward(seed22, x, jnp.float64)
    got = port_backward(seed22, x, torch.float64)
    assert want[0].dtype == got[0].dtype == np.float64
    assert np.abs(got[0] - want[0]).max() <= 1e-12
    params, worst, gx = gaps(got, want)
    print(f"seed 22 cgen backward, f64, step fake: parameters {params:.3e} ({worst}), input {gx:.3e}")
    assert params <= F64_RTOL and gx <= F64_RTOL


def test_at_the_step_fake_f32_rounding_moves_the_gradient_as_far_as_the_fake_gap(seed22):
    """At the step's own fake, f32 rounding alone puts the port's cgen
    gradient 1e-2 from JAX's, and the port's own gradient moves as far when
    its input moves by the 1e-5 that separates the two packages' fakes: the
    backward is that sensitive here, so the whole step's gap (which adds the
    critics' cotangents and both fakes' differences) reaches the suite's
    tolerance at this state."""
    fake = seed22["videos"]["step_fake"]
    on_jax_fake = port_backward(seed22, fake)
    rounding, worst, gx = gaps(on_jax_fake, jax_backward(seed22, fake))
    fake_gap = float(np.abs(seed22["port_fake"] - fake).max())
    moved, moved_worst, _ = gaps(port_backward(seed22, seed22["port_fake"]), on_jax_fake)
    print(f"seed 22, f32, step fake: cgen gradient {rounding:.3e} ({worst}) from JAX's, input "
          f"{gx:.3e}; the fakes {fake_gap:.3e} apart move the port's by {moved:.3e} ({moved_worst})")
    assert 0 < fake_gap <= 1e-4
    assert rounding <= GRAD_RTOL
    assert moved > BACKWARD_RTOL  # the sensitivity: 1e-5 at the input moves the gradient > 1e-3
