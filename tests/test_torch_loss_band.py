"""A loss band: the port's training held against the JAX package's over 300
steps, beside the JAX package's own sensitivity to rounding.

``configs/debug-mock-depth.yml`` (ngf/ndf 8, f32) at 16 frames of 32x32 and
a batch of 2 (``tests/test_torch_time_sharded_step.py``'s shapes), one
state drawn by ``jax_state`` and loaded into the port (``port_state``), a
uint8 mock batch a step (``step_batch``, seeded by the step):

- **JAX**: ``jitted_train_step`` for 300 steps under one key;
- **port**: ``DCVGAN.train_step`` on the same batches, handed each step's
  draws (``step_draws``, read from JAX's streams);
- **control**: JAX again from the same state with every parameter moved by
  one ulp up (``np.nextafter``): how far the dynamics carry a rounding
  difference on their own;
- **null**: the same with every parameter one ulp down, recorded and
  printed but not held: a JAX run judged by the criteria as the port is,
  which shows how often the JAX package fails its own band.

Each loss's relative gap to JAX is recorded at every step, and each
model's parameter relative L2 gap at steps 1, 10, 30, 100, 200 and 300;
the table is printed. A run's loss gap at a step is the largest of its
four losses' relative gaps. Criteria:

- up to the first step at which the control's loss gap exceeds 0.1, the
  port's loss gap is at most max(2e-4, 10 x the control's) at every step;
- over the last 100 steps each loss's mean differs from JAX's by at most
  3 x the control's difference + 0.05.

The step-wise criterion taken loss by loss instead fails as often for the
null as for the port (the control's gap of one loss dips by chance); the
test prints both readings for both runs.

A fault that shows only over many steps (Adam's bias correction, weight
decay on the norms, BatchNorm momentum, the update schedule) would grow the
port's gap faster than the control's. ``slow``: about 10 minutes on the
CPU, outside Tier-1 (``pytest -m slow tests/test_torch_loss_band.py -s``).
"""

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from dcvgan_torch import prng as port_prng
from dcvgan_torch.config import ExperimentConfig as PortConfig
from dcvgan_torch.train.step import DCVGAN as PortGAN
from dcvgan_tpu import prng as jax_prng
from dcvgan_tpu.config import ExperimentConfig as JaxConfig
from dcvgan_tpu.train.step import DCVGAN as JaxGAN
from torch_port_util import (
    LOSSES, MODEL_NAMES, flatten_tree, jax_state, numpy_tree, port_state, port_tree, step_batch,
    step_draws,
)
from torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("one_intra_op_thread")]
REPO = Path(__file__).resolve().parents[1]
STEPS, S, B = 300, 32, 2
RECORD = (1, 10, 30, 100, 200, 300)
HORIZON_GAP = 0.1  # the control's loss gap that ends the step-wise criterion
FLOOR, FACTOR = 2e-4, 10.0
MEAN_FACTOR, MEAN_SLACK, LAST = 3.0, 0.05, 100


def band_configs():
    raw = yaml.safe_load((REPO / "configs" / "debug-mock-depth.yml").read_text())
    raw.update(image_size=S, batchsize=B)
    jcfg, pcfg = JaxConfig.from_dict(dict(raw)), PortConfig.from_dict(dict(raw))
    jcfg.trainer.donate_state = False
    jcfg.validate()
    pcfg.validate()
    assert (pcfg.ggen.ngf, pcfg.idis.ndf, pcfg.trainer.precision) == (8, 8, "float32")
    return jcfg, pcfg


def batch(step):
    return step_batch(1000 + step, np.uint8, B, size=S)


def one_ulp(state, towards: float):
    """``state`` with every parameter leaf moved one ulp towards ``towards``
    (+inf or -inf)."""
    def nudge(ms):
        params = jax.tree.map(lambda p: jnp.asarray(np.nextafter(np.asarray(p), np.float32(towards))),
                              ms.params)
        return ms.replace(params=params)

    return state.replace(**{name: nudge(getattr(state, name)) for name in MODEL_NAMES})


def jax_params(state):
    return {name: {k: np.array(v) for k, v in flatten_tree(numpy_tree(getattr(state, name).params)).items()}
            for name in MODEL_NAMES}


def port_params(state):
    """Copies: the converted arrays may share the live parameters' memory."""
    out = {}
    for name in MODEL_NAMES:
        module = getattr(state, name)
        values = {k: p.detach().clone() for k, p in module.named_parameters()}
        out[name] = {k: np.array(v) for k, v in flatten_tree(port_tree(name, module, values)).items()}
    return out


def rel_l2(got, want) -> float:
    a = np.concatenate([got[k].ravel() for k in want]).astype(np.float64)
    b = np.concatenate([want[k].ravel() for k in want]).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_run(jgan, state, key):
    """(losses ``(STEPS, 4)``, parameters at each recorded step)."""
    losses, params = [], {}
    for step in range(1, STEPS + 1):
        state, m = jgan.jitted_train_step(state, {k: jnp.asarray(v) for k, v in batch(step).items()}, key)
        losses.append([float(m[k]) for k in LOSSES])
        if step in RECORD:
            params[step] = jax_params(state)
    return np.array(losses), params


@pytest.fixture(scope="module")
def band():
    t0 = time.perf_counter()
    jcfg, pcfg = band_configs()
    jgan, pgan = JaxGAN(jcfg), PortGAN(pcfg, device="cpu")
    jstate = jax_state(jgan, seed=50)
    pstate = port_state(pgan, jstate)
    key = jax_prng.base_key(3)
    with ThreadPoolExecutor(1) as pool:
        # the JAX runs on a thread (XLA leaves the interpreter free) while
        # this one reads the draws and runs the port
        jax_runs = pool.submit(lambda: [jax_run(jgan, s, key) for s in
                                        (jstate, one_ulp(jstate, np.inf), one_ulp(jstate, -np.inf))])
        plosses, pparams = [], {}
        for step in range(1, STEPS + 1):
            draws = step_draws(jgan, jstate, key, step, batch=B, size=S)
            pstate, m = pgan.train_step(pstate, batch(step), port_prng.base_key(3), draws)
            plosses.append([m[k].item() for k in LOSSES])
            if step in RECORD:
                pparams[step] = port_params(pstate)
        (jl, jp), (cl, cp), (nl, _) = jax_runs.result()
    assert pstate.step == STEPS
    return {"jax": jl, "port": np.array(plosses), "control": cl, "null": nl,
            "params": {"jax": jp, "port": pparams, "control": cp}, "seconds": time.perf_counter() - t0}


def gaps(band, run):
    """Each loss's relative gap to JAX at each step, ``(STEPS, 4)``."""
    return np.abs(band[run] - band["jax"]) / np.abs(band["jax"])


def band_misses(gap, control):
    """(the horizon, the steps up to it at which ``gap`` exceeds
    max(FLOOR, FACTOR x ``control``)); the horizon is the first step at
    which ``control`` exceeds HORIZON_GAP, else the last."""
    above = np.nonzero(control > HORIZON_GAP)[0]
    horizon = int(above[0]) + 1 if len(above) else STEPS
    return horizon, np.nonzero(gap[:horizon] > np.maximum(FLOOR, FACTOR * control[:horizon]))[0] + 1


def test_port_trains_within_the_jax_package_s_own_rounding_band(band):
    port, control, null = gaps(band, "port"), gaps(band, "control"), gaps(band, "null")
    params = band["params"]
    print(f"\nloss band over {STEPS} steps ({band['seconds']:.0f} s): relative gap to JAX, port / control")
    print("| step | " + " | ".join(LOSSES) + " | " + " | ".join(MODEL_NAMES) + " |")
    print("| --- " * (1 + len(LOSSES) + len(MODEL_NAMES)) + "|")
    for step in RECORD:
        i = step - 1
        cells = [f"{port[i, j]:.2e} / {control[i, j]:.2e}" for j in range(len(LOSSES))]
        cells += [f"{rel_l2(params['port'][step][n], params['jax'][step][n]):.2e} / "
                  f"{rel_l2(params['control'][step][n], params['jax'][step][n]):.2e}" for n in MODEL_NAMES]
        print(f"| {step} | " + " | ".join(cells) + " |")
    means = {run: band[run][-LAST:].mean(0) for run in ("jax", "port", "control", "null")}
    print(f"means over the last {LAST} steps, JAX / port / control / null: " + "; ".join(
        f"{k} {means['jax'][j]:.4f} / {means['port'][j]:.4f} / {means['control'][j]:.4f} / "
        f"{means['null'][j]:.4f}" for j, k in enumerate(LOSSES)))
    for label, gap in (("port", port), ("null", null)):
        per_loss = [band_misses(gap[:, j], control[:, j]) for j in range(len(LOSSES))]
        print(f"{label}, the step-wise criterion loss by loss (not held): " + "; ".join(
            f"{k} horizon {h}, {len(miss)} steps outside{f' from step {miss[0]}' if len(miss) else ''}"
            for k, (h, miss) in zip(LOSSES, per_loss)))

    horizon, miss = band_misses(port.max(1), control.max(1))
    _, null_miss = band_misses(null.max(1), control.max(1))
    print(f"the step-wise criterion: horizon step {horizon}; port outside the band at steps "
          f"{miss.tolist()}; null (not held) at steps {null_miss.tolist()}")
    assert not len(miss), (f"the port's loss gap {port.max(1)[miss[0] - 1]:.3e} at step {miss[0]} exceeds "
                           f"max({FLOOR:g}, {FACTOR:g} x the control's {control.max(1)[miss[0] - 1]:.3e})")
    for j, k in enumerate(LOSSES):
        lim = MEAN_FACTOR * abs(means["control"][j] - means["jax"][j]) + MEAN_SLACK
        assert abs(means["port"][j] - means["jax"][j]) <= lim, (k, means["port"][j], means["jax"][j], lim)
