"""Data parallelism over a ``torch.distributed`` process group: the
counterpart of ``dcvgan_tpu/parallel`` (``mesh.py``; the time-sharded
critics of ``temporal.py`` are not ported)."""

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
