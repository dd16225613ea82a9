"""The multi-embedding scorer of the port (``dcvgan_torch.tools.multiembed``)
against the repository's JAX tool (``tools/multiembed_score.py``).

- ``summarize`` equals the JAX tool's on every embedding's rows of the three
  committed ``results/multiembed_scores*.json``, and both equal the file's
  summary; ``resummarize`` of a copy with its summaries removed writes them
  back;
- the manifest is the JAX tool's, set for set;
- on two committed sets (a reference final evaluation and a TPU run's
  iteration 1600) and a real set the port's synthetic preprocessor writes,
  each cut to its first 16 clips: the clips decode alike, the port's features
  and probabilities under the committed extractor equal the JAX package's
  within 2e-4 (the parity suite's f32 tolerance), and the IS and FID of
  ``score_all``'s rows within 1e-3 relative of the JAX package's
  ``score_features`` on its own embedding (the rows are rounded to 4
  decimals); each row name carries its fingerprint, and a seeded tower is
  the port's own (``random-torch:``);
- ``--out`` has no default.
"""

import json
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

from dcvgan_torch.data.preprocess import get_preprocessor
from dcvgan_torch.eval.features import FeatureExtractor
from dcvgan_torch.tools import headtohead, multiembed
from dcvgan_tpu.eval.features import FeatureExtractor as JaxFeatureExtractor
from dcvgan_tpu.eval.metrics import score_features as jax_score_features
from tools import multiembed_score as jax_tool
from torch_port_util import ATOL_F32, one_intra_op_thread, within  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
REPO = Path(__file__).resolve().parents[1]
RECORDS = sorted((REPO / "results").glob("multiembed_scores*.json"))
V1 = REPO / "assets" / "extractor-synthetic.npz"
SETS = [multiembed.MANIFEST[0], multiembed.MANIFEST[-1]]  # reference seed0@final, tpu seed3@1600
CLIPS = 16
SCORE_RTOL = 1e-3


def test_the_records_are_the_three_committed_files():
    assert [p.name for p in RECORDS] == ["multiembed_scores.json", "multiembed_scores_trained.json",
                                         "multiembed_scores_v2.json"]


@pytest.mark.parametrize("record", RECORDS, ids=lambda p: p.stem)
def test_summarize_equals_the_jax_tools(record):
    data = json.loads(record.read_text())
    for name, rows in data["embeddings"].items():
        assert multiembed.summarize(rows) == jax_tool.summarize(rows) == data["summary"][name], name


@pytest.mark.parametrize("record", RECORDS, ids=lambda p: p.stem)
def test_resummarize_writes_the_committed_summaries_back(record, tmp_path):
    data = json.loads(record.read_text())
    copy = tmp_path / record.name
    copy.write_text(json.dumps({**data, "summary": {}}))
    assert multiembed.resummarize(copy)["summary"] == data["summary"]
    assert json.loads(copy.read_text())["summary"] == data["summary"]


def test_the_manifest_is_the_jax_tools():
    assert multiembed.MANIFEST == jax_tool.MANIFEST
    assert all(p.is_dir() and len(list(p.glob("*.mp4"))) == 128 for _, _, p in multiembed.MANIFEST)


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """The real set and each of SETS, cut to their first CLIPS mp4 files
    (links), and a manifest of the two sets."""
    root = tmp_path_factory.mktemp("multiembed")
    train = root / "synthetic" / "train"
    get_preprocessor("synthetic")(Path("unused"), train, "train", 16, 64, 1)

    def first(path: Path, d: Path) -> Path:
        d.mkdir()
        for f in sorted(path.glob("*.mp4"))[:CLIPS]:
            (d / f.name).symlink_to(f)
        return d

    manifest = [(side, run, first(path, root / run.replace("@", "_"))) for side, run, path in SETS]
    return first(headtohead.real_set(train), root / "real"), manifest


@pytest.fixture(scope="module")
def jax_side(cut):
    """The JAX tool's embedding of the real set and of each cut set under the
    committed extractor."""
    real, manifest = cut
    ex = JaxFeatureExtractor(weights_path=str(V1))
    ref, _ = jax_tool.embed_clips(ex, jax_tool.load_clips(real), 8)
    return ex.fingerprint, ref, [jax_tool.embed_clips(ex, jax_tool.load_clips(d), 8) for _, _, d in manifest]


@pytest.mark.parametrize("i", range(len(SETS)), ids=[r for _, r, _ in SETS])
def test_the_embedding_equals_the_jax_tools(cut, jax_side, i):
    _, manifest = cut
    clips = multiembed.load_clips(manifest[i][2])
    assert clips.shape == (CLIPS, 16, 64, 64, 3) and clips.dtype == np.uint8
    assert np.array_equal(clips, jax_tool.load_clips(SETS[i][2], limit=CLIPS))
    feats, probs = multiembed.embed_clips(FeatureExtractor(weights_path=V1, device="cpu"), clips, 8)
    within(feats, jax_side[2][i][0], ATOL_F32)
    within(probs, jax_side[2][i][1], ATOL_F32)


def test_score_all_rows_equal_the_jax_scorers(cut, jax_side, monkeypatch, tmp_path):
    real, manifest = cut
    fingerprint, ref, embedded = jax_side
    monkeypatch.setattr(multiembed, "MANIFEST", manifest)
    args = Namespace(real=real, weights=[V1], seeds=[], widths=[], batchsize=8, out=tmp_path / "s.json",
                     device="cpu")
    out = multiembed.score_all(args)
    assert json.loads(args.out.read_text()) == out and out["missing_sets"] == []
    assert out["fingerprints"] == {"trained:extractor-synthetic": fingerprint}
    rows = out["embeddings"]["trained:extractor-synthetic"]
    assert [(r["side"], r["run"]) for r in rows] == [(s, r) for s, r, _ in SETS]
    for row, (feats, probs) in zip(rows, embedded):
        want = jax_score_features(["is", "fid"], feats, probs, ref)
        for k in ("is", "fid"):
            assert abs(row[k] - want[k]) <= SCORE_RTOL * abs(want[k]), (row, want)
    assert out["summary"] == {"trained:extractor-synthetic": jax_tool.summarize(rows)}


def test_seeded_towers_are_the_ports_own():
    args = Namespace(weights=[V1], seeds=[1, 2], widths=[8], device="cpu")
    got = {name: ex.fingerprint for name, ex in multiembed.build_embeddings(args).items()}
    assert got == {"trained:extractor-synthetic": JaxFeatureExtractor(weights_path=str(V1)).fingerprint,
                   "random-torch:s1w8": "c3d-seeded-torch/seed=1,width=8",
                   "random-torch:s2w8": "c3d-seeded-torch/seed=2,width=8"}


def test_main_needs_an_out_path(cut):
    with pytest.raises(SystemExit):
        multiembed.main(["--real", str(cut[0])])
