"""No module a run loads is JAX's or the JAX package's, compared by whole
top-level names, and the reference imports nothing of the program."""

import re
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import REPO


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jax_like", "jaxtyping", "dcvgan_tpux", "dcvgan_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, None)
    hits = set(harness.forbidden_modules())
    assert not hits & {"jax_like", "jaxtyping", "dcvgan_tpux", "dcvgan_torch", "flaxen"}
    for name in ("jaxlib.xla_client", "optax", "orbax.checkpoint", "dcvgan_tpu.models"):
        monkeypatch.setitem(sys.modules, name, None)
    assert {"jaxlib", "optax", "orbax", "dcvgan_tpu"} <= set(harness.forbidden_modules())


def _fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          check=True, timeout=300).stdout


def test_reference_imports_nothing_of_the_program():
    out = _fresh("import sys; import portbench.reference.steps, portbench.reference.models, "
                 "portbench.weights, portbench.yardstick, portbench.judge; "
                 "print(sorted({m.split('.')[0] for m in sys.modules} & "
                 "{'dcvgan_torch', 'dcvgan_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert out.strip() == "[]"


def _imports(text: str):
    return {m.group(1).split(".")[0]
            for m in re.finditer(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", text, re.M)}


def test_sources_name_no_forbidden_import():
    for path in harness.ROOT.rglob("*.py"):
        found = _imports(path.read_text())
        assert not found & set(harness.FORBIDDEN), path
        if "reference" in path.parts or path.name in ("weights.py", "yardstick.py", "judge.py"):
            assert "dcvgan_torch" not in found, path


def test_a_directory_without_the_program_refuses(tmp_path):
    """With only BENCHMARK.json and the harness, a run exits non-zero and
    prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_work", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "mug-depth.train-b20",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
