"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, and its entry points run on the card unless asked not to.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ocrfdet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ocrfdet_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "bench_kernel_builds.py",
                                         ROOT / "bench_trees.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke, bench_kernel_builds, bench_trees\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    # the training slice's modules are among them
    assert {"ocrfdet_tpu_torch.train.step", "ocrfdet_tpu_torch.train.optim",
            "ocrfdet_tpu_torch.ops.splat.composite",
            "ocrfdet_tpu_torch.ops.splat.render_tiled",
            "ocrfdet_tpu_torch.core.targets",
            "ocrfdet_tpu_torch.bench_train",
            "ocrfdet_tpu_torch.parallel.collectives",
            "ocrfdet_tpu_torch.parallel.halo"} <= set(modules)
    assert len(modules) >= 35


def test_entry_points_default_to_cuda():
    """Without a device argument the entry points run on "cuda"; where
    there is none, they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ocrfdet_tpu_torch import entry
    from ocrfdet_tpu_torch.config import tiny_config
    cfg = tiny_config(with_ocrf=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_detector(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.make_batch(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_trainer(cfg)
    model = entry.build_detector(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training
    # the measuring tools that run on the card
    from ocrfdet_tpu_torch.tools import (benchmark_infer, get_flops,
                                         profile_step, step_variants)
    for tool in (benchmark_infer, get_flops, profile_step, step_variants):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--tiny"])


def test_unported_options_raise():
    """Spatial sharding builds where JAX runs it, a renderer other than
    "dense", "xla" and "pallas" is refused; training is ported, but an
    eval model (no render heads) refuses it. The profiling seams
    (`vt.ablate`) are ported: each builds, and an unknown one raises."""
    import dataclasses
    from ocrfdet_tpu_torch.config import VGGTTeacherConfig, tiny_config
    from ocrfdet_tpu_torch.data.synthetic import make_batch
    from ocrfdet_tpu_torch.models.detector import OcRFDet
    model = OcRFDet(tiny_config(with_ocrf=True))
    batch = {k: [torch.from_numpy(t) for t in v] if isinstance(v, list)
             else torch.from_numpy(v) for k, v in
             make_batch(model.cfg, batch_size=1, with_targets=True).items()}
    with pytest.raises(ValueError, match="render_heads=True"):
        model.train()(batch)
    # GeoEnhDet's teacher is ported: a config with one is no longer
    # refused (OcRFDet builds its student, GeoEnhDet adds the teacher)
    OcRFDet(tiny_config(vggt_teacher=VGGTTeacherConfig(
        depth=1, vit_depth=1, embed_dim=32, num_heads=4)))
    # the space axis is ported: it refuses only what JAX cannot run, the
    # cameras sharded over a space axis that does not divide them
    cfg = tiny_config(with_ocrf=False)
    for space, ok in ((2, True), (cfg.data.num_cams + 1, False)):
        sharded = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, space_axis=space, shard_cameras=True))
        if ok:
            OcRFDet(sharded)
        else:
            with pytest.raises(ValueError, match="cameras"):
                OcRFDet(sharded)
    from ocrfdet_tpu_torch.models.ocrf.view_transformer_ocrf import SEAMS
    cfg = tiny_config(with_ocrf=True)
    for ablate in [(s,) for s in SEAMS] + [SEAMS]:
        for render_heads in (False, True):
            OcRFDet(dataclasses.replace(cfg, vt=dataclasses.replace(
                cfg.vt, ablate=ablate)), render_heads)
    with pytest.raises(ValueError, match="ablate"):
        OcRFDet(dataclasses.replace(cfg, vt=dataclasses.replace(
            cfg.vt, ablate=("nerf", "hao"))))
    with pytest.raises(ValueError, match="renderer"):
        OcRFDet(dataclasses.replace(cfg, vt=dataclasses.replace(
            cfg.vt, renderer="scan")))
    for renderer in ("dense", "xla", "pallas"):
        OcRFDet(dataclasses.replace(cfg, vt=dataclasses.replace(
            cfg.vt, renderer=renderer)))


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_bench_kernel_builds_refuses_without_cuda():
    """bench_kernel_builds.py exits non-zero and prints no reading
    without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "bench_kernel_builds.py"),
                          str(ROOT)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert '"builds"' not in res.stdout


def test_bench_trees_refuses_a_tree_without_the_package(tmp_path):
    """bench_trees.py exits non-zero, before it starts any run, when a
    tree holds no ocrfdet_tpu_torch/."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "bench_trees.py"),
                          str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "holds no ocrfdet_tpu_torch/" in res.stderr
    assert '"trees"' not in res.stdout
