"""Evaluation: batched sampling, the feature extractor, video metrics (IS /
FID / PRD).

``generate_samples`` is exported, as the JAX package's ``eval`` does, as an
attribute that imports ``eval.sampler`` on first use, so that importing this
package (or ``eval.metrics`` alone) loads no model code.
"""


def __getattr__(name):
    if name != "generate_samples":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from dcvgan_torch.eval.sampler import generate_samples

    return generate_samples
