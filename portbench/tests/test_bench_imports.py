"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the
program."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    mods = {"ocrfdet_tpu_torch": 1, "ocrfdet_tpu_torch.entry": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax": 1, "jax.numpy": 1, "ocrfdet_tpu.models": 1,
                 "flax.linen": 1, "jaxlib": 1})
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "ocrfdet_tpu.models"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_sources_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        roots = set(imported_roots(path))
        assert not roots & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "ref").rglob("*.py"):
        assert harness.PROGRAM not in set(imported_roots(path)), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.ref.models.detector, portbench.ref.ops.nms\n"
            "import portbench.refrun, portbench.check, portbench.gen, portbench.work\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('ocrfdet_tpu_torch', 'ocrfdet_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n") % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_run_loads_no_jax_without_a_card(tmp_path):
    """The run exits non-zero without a card, and prints no result."""
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "flagship-serve-b1", "--seed",
                        str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        return
    assert r.returncode != 0
    assert r.stdout.strip() == ""
