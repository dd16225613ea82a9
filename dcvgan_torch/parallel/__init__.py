"""Data and time parallelism over a ``torch.distributed`` process group:
the counterpart of ``dcvgan_tpu/parallel`` (``mesh.py``, and
``temporal.py``'s halo exchange for the time-sharded critics)."""

from dcvgan_torch.parallel.mesh import (  # noqa: F401
    SINGLE,
    Layout,
    all_reduce_mean_,
    all_reduce_sum,
    batch_size_divisor,
    create_layout,
    init_distributed,
    replicate,
    shard_batch,
)
