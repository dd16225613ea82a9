"""The port's raw-dataset preprocessors against the JAX package's.

Raw SURREAL and IsoGD trees are built here from a numpy seed, at 60x80 and
20 frames, each with good videos and one video for every rejection branch.
Both packages' preprocessors write their trees from the same raw files, on
1 and 2 threads, and the trees must be the same: every file but the preview
mp4s byte for byte (``list.txt``, the JPEG frames, the ``.npy`` arrays), the
mp4s frame for frame once decoded (their container bytes may differ). The
port's dataset reads the port's tree as the JAX dataset reads the JAX tree.
Also here: the ``mug`` stub, both CLIs, and the image and video helpers the
preprocessors use.
"""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from dcvgan_torch import native
from dcvgan_torch.cli.preprocess import main as port_cli
from dcvgan_torch.data.dataset import VideoDataset as PortDataset
from dcvgan_torch.data.preprocess import get_preprocessor as port_preprocessor
from dcvgan_torch.data.preprocess import n_workers
from dcvgan_torch.io import image as port_image
from dcvgan_torch.io.video import read_video, write_video
from dcvgan_torch.utils import video_np as port_video_np
from dcvgan_tpu.cli.preprocess import main as jax_cli
from dcvgan_tpu.data.dataset import VideoDataset as JaxDataset
from dcvgan_tpu.data.preprocess import get_preprocessor as jax_preprocessor
from dcvgan_tpu.io import image as jax_image
from dcvgan_tpu.utils import video_np as jax_video_np
from torch_port_util import jax_native_built  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native_built")

T_RAW, H_RAW, W_RAW = 20, 60, 80
LENGTH, SIZE = 16, 32
PACKAGES = {"port": port_preprocessor, "jax": jax_preprocessor}

# SURREAL raw videos: (sequence, frames, height, width, joints' x range in
# the raw frame, .mat files written, the rejection's stderr message or None)
SURREAL_VIDEOS = (
    ("00_01", T_RAW, H_RAW, W_RAW, (0.4, 0.6), ("depth", "segm", "info"), None),
    ("01_01", T_RAW, H_RAW, W_RAW, (0.3, 0.7), ("depth", "segm", "info"), None),
    ("02_01", T_RAW, H_RAW, W_RAW, (0.45, 0.55), ("depth", "segm", "info"), None),
    ("03_01", 10, H_RAW, W_RAW, (0.4, 0.6), ("depth", "segm", "info"), "too short, skipped"),
    # centre-cropped to columns 10..70: joints at raw x 10..16 sit at 0..6,
    # left of w // 8
    ("04_01", T_RAW, H_RAW, W_RAW, (10 / W_RAW, 16 / W_RAW), ("depth", "segm", "info"),
     "human on frame edge, excluded"),
    # a portrait frame keeps 10 columns after the crop; joints spread to x 14
    # with their centre inside: the human's box leaves the frame
    ("05_01", T_RAW, 80, 60, (-10 / 60, 4 / 60), ("depth", "segm", "info"),
     "human bbox out of frame, excluded"),
    ("06_01", T_RAW, H_RAW, W_RAW, (0.4, 0.6), ("depth", "info"), "missing segm"),
)


def make_surreal_raw(root: Path) -> None:
    """A SURREAL-style tree: mp4 + depth, segm and info .mat files per video."""
    rng = np.random.default_rng(0)
    run = root / "train" / "run0"
    for seq_name, t, h, w, (x0, x1), mats, _ in SURREAL_VIDEOS:
        seq = run / seq_name
        seq.mkdir(parents=True, exist_ok=True)
        stem = f"{seq_name}_c0001"
        write_video(rng.integers(0, 255, (t, h, w, 3), np.uint8), seq / f"{stem}.mp4")
        if "depth" in mats:
            scipy.io.savemat(seq / f"{stem}_depth.mat", {
                f"depth_{i + 1}": np.where(rng.random((h, w)) < 0.3,
                                           rng.uniform(2, 5, (h, w)), 1e10).astype(np.float32)
                for i in range(t)})
        if "segm" in mats:
            scipy.io.savemat(seq / f"{stem}_segm.mat", {
                f"segm_{i + 1}": rng.integers(0, 25, (h, w), np.uint8) for i in range(t)})
        joints = np.zeros((2, 24, t))
        joints[0] = rng.uniform(w * x0, w * x1, (24, t))
        joints[1] = rng.uniform(h * 0.3, h * 0.7, (24, t))
        scipy.io.savemat(seq / f"{stem}_info.mat", {"joints2D": joints})


# IsoGD raw rows: (video, frames, files written)
ISOGD_VIDEOS = ((0, T_RAW, True), (1, T_RAW, True), (2, T_RAW, True), (3, 10, True), (4, T_RAW, False))


def make_isogd_raw(root: Path) -> None:
    """An IsoGD-style tree: colour and depth mp4s and ``train_list.txt``; one
    row too short, one naming files that are not there."""
    rng = np.random.default_rng(1)
    rows = []
    for v, t, written in ISOGD_VIDEOS:
        color_rel, depth_rel = f"train/{v:03d}/M_{v:05d}.mp4", f"train/{v:03d}/K_{v:05d}.mp4"
        if written:
            (root / "train" / f"{v:03d}").mkdir(parents=True, exist_ok=True)
            # smooth frames that move two pixels a frame, so that the flow is not noise
            frame = np.repeat(np.repeat(rng.integers(0, 255, (6, 8, 3), np.uint8), 10, 0), 10, 1)
            color = np.stack([np.roll(frame, 2 * i, axis=1) for i in range(t)])
            write_video(color, root / color_rel)
            write_video(rng.integers(0, 255, (t, H_RAW, W_RAW, 3), np.uint8), root / depth_rel)
        rows.append(f"{color_rel} {depth_rel} {v + 1}")
    (root / "train_list.txt").write_text("\n".join(rows) + "\n")


def run_preprocessor(get, name, raw, out, n_jobs):
    """``get(name)`` on ``raw`` into ``out``; returns what it wrote to stderr."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        get(name)(raw, out, "train", LENGTH, SIZE, n_jobs)
    return err.getvalue()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """``{(dataset, package, n_jobs): (processed root, stderr)}``; each tree
    lies at ``<root>/<dataset>/train``, where the dataset reads it."""
    base = tmp_path_factory.mktemp("preprocess")
    make_surreal_raw(base / "raw" / "surreal")
    make_isogd_raw(base / "raw" / "isogd")
    out = {}
    for dataset in ("surreal", "isogd"):
        for package, get in PACKAGES.items():
            for n_jobs in (1, 2):
                root = base / f"{package}-{n_jobs}"
                err = run_preprocessor(get, dataset, base / "raw" / dataset,
                                       root / dataset / "train", n_jobs)
                out[dataset, package, n_jobs] = (root, err)
    return out


def files_of(root: Path) -> dict:
    return {p.relative_to(root): p for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_tree(a: Path, b: Path) -> int:
    """Same files; mp4s equal frame for frame when decoded, every other
    file byte for byte. Returns the number of files."""
    fa, fb = files_of(a), files_of(b)
    assert list(fa) == list(fb)
    for rel, pa in fa.items():
        if rel.suffix == ".mp4":
            va, vb = read_video(pa), read_video(fb[rel])
            assert va.shape == vb.shape and np.array_equal(va, vb), rel
        else:
            assert pa.read_bytes() == fb[rel].read_bytes(), rel
    return len(fa)


@pytest.mark.parametrize("n_jobs", [1, 2])
@pytest.mark.parametrize("dataset", ["surreal", "isogd"])
def test_the_port_writes_the_jax_tree(trees, dataset, n_jobs):
    port_root, jax_root = trees[dataset, "port", n_jobs][0], trees[dataset, "jax", n_jobs][0]
    n = assert_same_tree(port_root / dataset, jax_root / dataset)
    listing = (port_root / dataset / "train" / "list.txt").read_text().splitlines()
    assert len(listing) == 3 and all(line.endswith(f" {T_RAW}") for line in listing)
    per_video = {"surreal": T_RAW + 2, "isogd": 2 * T_RAW + 1}[dataset]  # frames, npys
    assert n == 1 + 3 * (per_video + 3)  # list.txt, and each video's files and 3 previews


@pytest.mark.parametrize("dataset", ["surreal", "isogd"])
def test_one_and_two_threads_write_the_same_tree(trees, dataset):
    assert_same_tree(trees[dataset, "port", 1][0] / dataset, trees[dataset, "port", 2][0] / dataset)


def test_the_tree_holds_the_shapes_the_dataset_reads(trees):
    root = trees["surreal", "port", 1][0] / "surreal" / "train"
    name = (root / "list.txt").read_text().split()[0]
    assert np.load(root / name / "depth.npy").shape == (T_RAW, SIZE, SIZE)
    segm = np.load(root / name / "segm.npy")
    assert segm.shape == (T_RAW, SIZE, SIZE) and segm.dtype == np.uint8 and segm.max() < 25
    root = trees["isogd", "port", 1][0] / "isogd" / "train"
    name = (root / "list.txt").read_text().split()[0]
    flow = np.load(root / name / "optical-flow.npy")
    assert flow.shape == (T_RAW - 1, SIZE, SIZE, 2) and np.abs(flow).max() > 0.5


@pytest.mark.parametrize("video", [v for v in SURREAL_VIDEOS if v[-1]], ids=lambda v: v[-1])
def test_a_rejected_surreal_video_is_named_on_stderr(trees, video):
    name = f"run0-{video[0]}_c0001"
    for package in PACKAGES:
        root, err = trees["surreal", package, 1]
        assert name not in (root / "surreal" / "train" / "list.txt").read_text()
        assert f"{video[-1]}: {name}" in err or f"skipped {name}: {video[-1]}" in err, package


def test_a_missing_isogd_sample_is_named_and_a_short_one_dropped(trees):
    """The JAX package drops a video too short without a word; so does the port."""
    for package in PACKAGES:
        root, err = trees["isogd", package, 1]
        listing = (root / "isogd" / "train" / "list.txt").read_text()
        assert "_00003_" not in listing and "_00004_" not in listing
        named = [line for line in err.splitlines() if line.startswith("sample not found, skipped: ")]
        assert len(named) == 1 and named[0].endswith("004"), package
        assert "003" not in err


def test_mug_is_a_stub_as_in_jax(tmp_path):
    for get in PACKAGES.values():
        with pytest.raises(NotImplementedError, match="MUG preprocessing is not implemented"):
            get("mug")(tmp_path, tmp_path / "out", "train", LENGTH, SIZE, 1)
    with pytest.raises(KeyError):
        port_preprocessor("no-such-dataset")


def test_n_jobs_reads_as_joblib_does():
    import os

    assert n_workers(3) == 3 and n_workers(-1) == os.cpu_count()
    assert n_workers(-2) == max(1, os.cpu_count() - 1)
    with pytest.raises(ValueError):
        n_workers(0)


def test_both_clis_write_the_same_tree(tmp_path):
    make_isogd_raw(tmp_path / "raw")
    for cli, tag in ((port_cli, "port"), (jax_cli, "jax")):
        with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
            cli(["isogd", str(tmp_path / "raw"), str(tmp_path / tag), "--img-size", str(SIZE),
                 "--n-jobs", "2"])
    assert assert_same_tree(tmp_path / "port", tmp_path / "jax") == 1 + 3 * (2 * T_RAW + 4)


DATASET_CASES = [("surreal", "depth"), ("surreal", "segmentation"),
                 ("isogd", "depth"), ("isogd", "optical-flow")]


@pytest.mark.parametrize("raw_uint8", [False, True], ids=["normalised", "raw"])
@pytest.mark.parametrize("dataset,geo", DATASET_CASES, ids=["-".join(c) for c in DATASET_CASES])
def test_the_port_dataset_reads_its_tree_as_jax_reads_its_own(trees, dataset, geo, raw_uint8):
    args = dict(name=dataset, preprocess_func=None, video_length=LENGTH, image_size=SIZE,
                geometric_info=geo, raw_uint8=raw_uint8)
    port = PortDataset(processed_root=trees[dataset, "port", 1][0], **args)
    jax = JaxDataset(processed_root=trees[dataset, "jax", 1][0], **args)
    assert len(port) == len(jax) == 3
    for i in range(3):
        a = port.sample(i, np.random.default_rng(i))
        b = jax.sample(i, np.random.default_rng(i))
        assert a.keys() == b.keys() == {"color", geo}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_dataset_assembles_through_the_native_library(trees, monkeypatch):
    calls = []
    for fn in ("normalize_u8", "one_hot", "scale_f32"):
        real = getattr(native, fn)
        monkeypatch.setattr(native, fn, lambda *a, _f=real, _n=fn: calls.append(_n) or _f(*a))
    for dataset, geo in DATASET_CASES:
        ds = PortDataset(name=dataset, video_length=LENGTH, image_size=SIZE, geometric_info=geo,
                         processed_root=trees[dataset, "port", 1][0])
        ds.sample(0, np.random.default_rng(0))
    # colour x 4, the one_hot of segmentation, isogd's depth and flow
    assert sorted(calls) == sorted(["normalize_u8"] * 5 + ["one_hot", "scale_f32"])


# ------------------------------------------------------------------- helpers
FRAME = np.random.default_rng(7).integers(0, 256, (24, 36, 3), np.uint8)


@pytest.mark.parametrize("mode", ["nearest", "linear", "area", "cubic", "lanczos4"])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_img_matches_jax(mode, channels):
    img = np.ascontiguousarray(FRAME[..., :channels])
    got = port_image.resize_img(img, (16, 20), mode)
    assert got.shape == (20, 16, channels)  # cv2's (W, H); one channel kept
    np.testing.assert_array_equal(got, jax_image.resize_img(img, (16, 20), mode))
    assert port_image._CV_MODES == jax_image._CV_MODES


def test_resize_video_matches_jax():
    video = np.random.default_rng(8).normal(size=(5, 24, 36, 2)).astype(np.float32)
    for mode in ("nearest", "linear"):
        got = port_image.resize_video(video, (12, 10), mode)
        assert got.shape == (5, 10, 12, 2)
        np.testing.assert_array_equal(got, jax_image.resize_video(video, (12, 10), mode))


@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "grey"])
def test_save_video_as_images_matches_jax(tmp_path, grayscale):
    video = np.random.default_rng(9).integers(0, 256, (3, 16, 16, 1 if grayscale else 3), np.uint8)
    port_image.save_video_as_images(video, tmp_path / "port", grayscale)
    jax_image.save_video_as_images(video, tmp_path / "jax", grayscale)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["000.jpg", "001.jpg", "002.jpg"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def test_calc_optical_flow_and_segm_color_match_jax():
    base = np.random.default_rng(10).integers(0, 256, (6, 8, 3), np.uint8)
    frame = np.repeat(np.repeat(base, 6, 0), 6, 1)
    video = np.stack([np.roll(frame, i, axis=1) for i in range(4)])
    got = port_video_np.calc_optical_flow(video)
    assert got.shape == (3, 36, 48, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_video_np.calc_optical_flow(video))
    for i in range(26):
        np.testing.assert_array_equal(port_video_np.segm_color(i), jax_video_np.segm_color(i))
