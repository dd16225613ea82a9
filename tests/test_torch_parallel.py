"""The port's data-parallel layout (``dcvgan_torch/parallel``) against
``dcvgan_tpu.parallel``, on the virtual CPU devices and gloo ranks.

- ``create_layout`` against ``create_mesh`` on a table of (world, data,
  time, dcn, batch), raises included: the rank order of the mesh's
  devices, ``time > 1`` too; where JAX takes a device subset the port
  raises;
- ``shard_batch``: rank r keeps rows ``r*B/W .. (r+1)*B/W``, the time ranks
  of a data row the row's;
- the loader's rank slices against the JAX loader's process slices;
- the BatchNorm with global-batch statistics, forward and gradients, over
  2 ranks against flax's BatchNorm on a batch sharded under ``jit``;
- ``init_distributed`` without a launch environment, and its backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvgan_torch.data.dataset import VideoDataset as PortDataset
from dcvgan_torch.data.loader import VideoLoader as PortLoader
from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.parallel import create_layout, init_distributed, shard_batch
from dcvgan_torch.parallel.mesh import batch_size_divisor
from dcvgan_tpu.data.dataset import VideoDataset as JaxDataset
from dcvgan_tpu.data.loader import VideoLoader as JaxLoader
from dcvgan_tpu.parallel.mesh import create_mesh
from torch_dist_util import run_ranks
from torch_port_util import GLOBAL_B, WORLD, within
from torch_port_util import jax_native_built, one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native_built", "one_intra_op_thread")

# (world, data, time, dcn, batchsize)
LAYOUTS = [
    (8, -1, 1, 1, None), (8, -1, 1, 1, 8), (8, -1, 1, 1, 16), (4, -1, 1, 1, 12),
    (8, 8, 1, 1, 8), (8, -1, 1, 2, 8), (8, 4, 1, 2, 16), (4, 2, 1, 2, 4), (2, 2, 1, 1, 4),
    (1, -1, 1, 1, 20), (1, 1, 1, 1, 3),
    # JAX takes a subset of the devices: the port raises
    (8, -1, 1, 1, 2), (8, -1, 1, 1, 6), (8, 3, 1, 1, None), (8, 2, 1, 2, 4),
    # JAX raises
    (8, 9, 1, 1, None), (8, 8, 1, 1, 2), (8, -1, 1, 3, None), (4, 4, 1, 2, 8), (1, 4, 1, 1, 4),
    # time > 1
    (8, 4, 2, 1, 8), (8, -1, 2, 1, None), (8, 9, 2, 1, None),
    (4, 1, 4, 1, 2), (8, 2, 2, 2, 4), (8, -1, 4, 1, 6), (8, -1, 3, 1, None), (4, -1, 2, 1, 3),
]


@pytest.mark.parametrize("world,data,time,dcn,batch", LAYOUTS)
def test_layout_follows_create_mesh(devices, world, data, time, dcn, batch):
    def port(rank=0):
        return create_layout(data=data, time=time, dcn=dcn, batchsize=batch, world=world, rank=rank)

    try:
        mesh = create_mesh(data=data, time=time, dcn=dcn, batchsize=batch, devices=devices[:world])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(e)
        return
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    if mesh.devices.size < world:
        with pytest.raises(ValueError, match="unused"):
            port()
        return
    layouts = [port(r) for r in range(world)]
    # rank r is device r of the mesh: its position is its coordinates
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, lay in enumerate(layouts):
        assert (lay.dcn, lay.data, lay.time, lay.rank) == (
            shape.get("dcn", 1), shape["data"], shape["time"], r)
        coords = np.argwhere(ids == devices[r].id)[0]
        assert lay.row == int(np.ravel_multi_index(coords[:-1], ids.shape[:-1]))
        assert lay.time_index == coords[-1]
        assert lay.world == world and batch_size_divisor(lay) == world // shape["time"]


def test_layout_reads_the_config_and_explicit_arguments_win():
    from dcvgan_torch.config import ExperimentConfig

    cfg = ExperimentConfig.from_dict({"batchsize": 8, "mesh": {"data": 2, "dcn": 2}})
    lay = create_layout(cfg, world=4)
    assert (lay.dcn, lay.data) == (2, 2)
    lay = create_layout(cfg, data=4, dcn=1, world=4)
    assert (lay.dcn, lay.data) == (1, 4)
    cfg.mesh.time = 2
    with pytest.raises(ValueError, match="mesh 2x2x2 exceeds 4 visible devices"):
        create_layout(cfg, world=4)
    lay = create_layout(cfg, world=8, rank=5)
    assert (lay.dcn, lay.data, lay.time, lay.row, lay.time_index) == (2, 2, 2, 2, 1)
    assert create_layout(cfg, time=1, world=4).data == 2


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_keeps_the_ranks_rows(world):
    batch = {"color": np.arange(8 * 3).reshape(8, 3), "depth": torch.arange(8)}
    seen = []
    for r in range(world):
        rows = shard_batch(batch, create_layout(world=world, rank=r))
        b = 8 // world
        np.testing.assert_array_equal(rows["color"], batch["color"][r * b:(r + 1) * b])
        assert torch.equal(rows["depth"], torch.arange(r * b, (r + 1) * b))
        seen.append(rows["color"])
    np.testing.assert_array_equal(np.concatenate(seen), batch["color"])
    lay = create_layout(world=4, rank=1)
    assert lay.rows(2).tolist() == [2, 3] and lay.rows(2, parts=2).tolist() == [2, 3, 10, 11]
    # data 2 x time 2: ranks 2 and 3 hold data row 1
    for r in (2, 3):
        timed = create_layout(data=2, time=2, world=4, rank=r)
        assert timed.rows(2).tolist() == [2, 3] and timed.rows(2, parts=2).tolist() == [2, 3, 6, 7]
        np.testing.assert_array_equal(shard_batch(batch, timed)["color"], batch["color"][4:])
    with pytest.raises(ValueError, match="split"):
        shard_batch({"x": np.zeros(6)}, lay)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The port's and the JAX package's dataset over one synthetic tree (10
    videos of 24 frames at 32x32, cropped to 16 at random)."""
    root = tmp_path_factory.mktemp("data")
    get_preprocessor("synthetic")(root / "raw", root / "synthetic" / "train", "train", 16, 32, -1)
    args = dict(name="synthetic", preprocess_func=None, video_length=16, image_size=32,
                number_limit=10, processed_root=root)
    return PortDataset(**args), JaxDataset(**args)


@pytest.mark.parametrize("process_count,batch,drop_last", [
    (2, 4, True), (2, 4, False), (4, 4, False), (3, 6, False),
])
def test_loader_rank_slices_match_the_jax_process_slices(datasets, process_count, batch, drop_last):
    """Every rank decodes the JAX process's slice of each global batch, with
    the crops of the global positions; the partial last batch is kept only
    where every rank gets an equal share."""
    port_ds, jax_ds = datasets
    for rank in range(process_count):
        kw = dict(batchsize=batch, n_workers=1, seed=5, drop_last=drop_last,
                  process_index=rank, process_count=process_count, shard_divisor=process_count)
        with PortLoader(port_ds, **kw) as pl, JaxLoader(jax_ds, **kw) as jl:
            assert len(pl) == len(jl)
            for got, want in zip(pl.epoch_iterator(1), jl.epoch_iterator(1)):
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
            for k, v in jl.fetch_batch(epoch=3).items():
                np.testing.assert_array_equal(pl.fetch_batch(epoch=3)[k], v)


@pytest.mark.parametrize("ndim", [2, 3])
def test_global_batch_norm_matches_flax_on_a_sharded_batch(tmp_path, ndim):
    from flax import linen as nn
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(ndim)
    c = 6
    spatial = (5, 5) if ndim == 2 else (4, 5, 5)
    x = rng.normal(0.5, 2.0, (GLOBAL_B,) + spatial + (c,)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.5, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    sharded = NamedSharding(create_mesh(data=WORLD, batchsize=GLOBAL_B), P("data"))

    @jax.jit
    def fwd_bwd(variables, x, ct):
        def f(params, x):
            y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, mut["batch_stats"])

        (_, (y, stats)), (dp, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            variables["params"], x)
        return y, dx, dp, stats

    y, dx, dp, stats = jax.block_until_ready(
        fwd_bwd(variables, jax.device_put(x, sharded), jax.device_put(ct, sharded)))
    to_nc = (0, ndim + 1) + tuple(range(1, ndim + 1))  # NHWC -> NCHW
    payload = {"x": torch.from_numpy(x.transpose(to_nc).copy()),
               "ct": torch.from_numpy(ct.transpose(to_nc).copy()),
               "bn": {"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                      "running_mean": torch.from_numpy(mean0), "running_var": torch.from_numpy(var0)}}
    ranks = run_ranks("batch_norm_rows", WORLD, payload, tmp_path)
    back = tuple(np.argsort(to_nc))
    out = np.concatenate([r["out"].numpy() for r in ranks]).transpose(back)
    grad_x = np.concatenate([r["dx"].numpy() for r in ranks]).transpose(back)
    within(out, np.asarray(y), 1e-5, 1e-5)
    within(grad_x, np.asarray(dx), 1e-5, 1e-5)
    # each rank's parameter gradient is its rows' share: they sum to flax's
    within(sum(r["dweight"].numpy() for r in ranks), np.asarray(dp["scale"]), 1e-4, 1e-5)
    within(sum(r["dbias"].numpy() for r in ranks), np.asarray(dp["bias"]), 1e-4, 1e-5)
    for r in ranks:  # the global statistics, on every rank
        within(r["mean"].numpy(), np.asarray(stats["mean"]), 1e-6, 1e-6)
        within(r["var"].numpy(), np.asarray(stats["var"]), 1e-6, 1e-6)


def test_init_distributed_needs_the_launch_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is None and init_distributed("gloo", "cpu") is None
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nccl"):
        init_distributed("mpi", "cpu")
    # nccl without a card raises; nothing falls back to gloo or the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("nccl")
    assert not torch.distributed.is_initialized()
