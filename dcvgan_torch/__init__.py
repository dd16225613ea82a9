"""dcvgan_torch: DCVGAN in PyTorch for NVIDIA Hopper.

The port of ``dcvgan_tpu`` (JAX on a TPU), slice by slice; module names
mirror the JAX package's. It imports nothing of JAX or of ``dcvgan_tpu``.
Entry points run on ``cuda`` and raise without a CUDA device unless the
caller passes ``device="cpu"``. Kernels written by hand live in ``csrc/``
and are built with ``nvcc`` at first use (``ops/build.py``).
"""
