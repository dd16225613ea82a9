"""Turn a reference (PyTorch) training run into a run directory of the port.

    python -m dcvgan_torch.cli.import_torch <torch_models_dir> <iteration> \
        --config configs/mug-depth.yml --out result/imported-run [--device cuda]

Counterpart of ``dcvgan_tpu/cli/import_torch.py``. Reads the reference's
``<name>_params_<iter:05d>.pth`` snapshots, loads them into the models the
config builds (``compat/torch_import.py``), sets the step to ``iteration``,
re-seeds the EMA (when the config has one) at the imported weights, and
writes ``<out>/config.yml`` and one checkpoint ``<out>/models/step_<N>.pt``
that ``cli.infer`` and a resumed ``cli.train`` read. The optimizers start
fresh: the snapshots hold weights only. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from dcvgan_torch.compat.torch_import import load_into_state, load_reference_state_dicts
from dcvgan_torch.config import load_config, save_config
from dcvgan_torch.train.checkpoint import CheckpointManager
from dcvgan_torch.train.step import DCVGAN


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("torch_models_dir", type=Path)
    parser.add_argument("iteration", type=int)
    parser.add_argument("--config", "-c", required=True)
    parser.add_argument("--out", "-o", type=Path, required=True)
    parser.add_argument("--device", default="cuda", help="torch device ('cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    state = DCVGAN(cfg, device=args.device).init_state(cfg.seed)
    state_dicts = load_reference_state_dicts(args.torch_models_dir, args.iteration)
    if not state_dicts:
        raise FileNotFoundError(
            f"no <name>_params_{args.iteration:05d}.pth files in {args.torch_models_dir}"
        )
    load_into_state(state, state_dicts)
    state.step = args.iteration
    # the EMA was seeded at the random init: sample the imported generators
    state.with_reseeded_ema()

    args.out.mkdir(parents=True, exist_ok=True)
    save_config(cfg, args.out / "config.yml")
    CheckpointManager(args.out / "models").save(state, force=True)
    print(f"imported {sorted(state_dicts)} at iteration {args.iteration} -> {args.out}")


if __name__ == "__main__":
    main()
