"""The port's measuring tools end to end on the CPU at the tiny config
(`python -m ocrfdet_tpu_torch.tools.<name>`; the card tools with
`--device cpu`): their output keys, and where a number can be held on
the CPU, the number.

* get_flops: the parameter count equals the element count of the JAX
  package's tiny init tree (`jax.eval_shape`), in eval and in train
  mode; the K1-K5 rows are `ops/work.py`'s counts of the calls the
  forward makes (K5 only in train mode).
* step_variants: every variant runs interleaved, the deltas against
  `full` are there, and a CPU run reports no device time.
* benchmark_infer, profile_step, bench_loader and bench_eval_host: one
  short run each.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu_torch.tools import (bench_eval_host, bench_loader,
                                     benchmark_infer, get_flops,
                                     profile_step, step_variants)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_get_flops_counts_jax_parameters(train, capsys):
    jcfg = jconfig.tiny_config()
    jb = jax.tree.map(jnp.asarray, jmake_batch(jcfg, batch_size=1, seed=0))
    shapes = jax.eval_shape(lambda: JaxOcRFDet(jcfg).init(
        jax.random.PRNGKey(0), jb, train=train))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    argv = ["--tiny", "--device", "cpu"] + (["--train"] if train else [])
    out = get_flops.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["params"] == want
    rows = out["kernels"]
    assert [rows[f"K{i} {n}"]["calls"] for i, n in enumerate(
        ("cost_volume", "bev_pool", "ht_pool", "point_sample",
         "composite_tiles"), 1)] == [2, 2, 2, 2, 1 if train else 0]
    assert all(r["flops"] > 0 and r["bytes"] > 0 for r in rows.values()
               if r["calls"])
    assert out["torch_flops"] > 0
    assert out["total_flops"] == out["torch_flops"] + out["kernel_flops"]


def test_step_variants_runs_interleaved(tmp_path):
    path = tmp_path / "variants.json"
    out = step_variants.main([
        "--tiny", "--device", "cpu", "--steps", "1", "--warmup", "1",
        "--variants", "full,no_ocrf,ablate_sample+splat",
        "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    v = out["variants"]
    assert list(v) == ["full", "no_ocrf", "ablate_sample+splat"]
    for name, r in v.items():
        assert len(r["step_ms"]) == 1 and r["step_ms_median"] > 0
        assert np.isfinite(r["loss_total"]) and r["skipped"] == 0.0
        assert r["busy_ms_per_step"] is None          # no card
        assert set(r["launches_per_step"]) == {
            k.name for k in step_variants.path_kernels()}
        assert ("delta_ms_vs_full" in r) == (name != "full")
    assert v["no_ocrf"]["delta_busy_ms_vs_full"] is None
    with pytest.raises(ValueError, match="seams"):
        step_variants.variant_config("ablate_nerf+hao", 2)


def test_benchmark_infer_runs():
    out = benchmark_infer.main(["--tiny", "--device", "cpu", "--iters", "2",
                                "--warmup", "1"])
    assert out["device"] == "cpu" and out["tasks"] == 6
    assert out["frames_per_s"] > 0
    assert out["ms_per_batch"] == pytest.approx(1e3 / out["frames_per_s"])


@pytest.mark.parametrize("fwd_only", [False, True], ids=["step", "forward"])
def test_profile_step_runs(fwd_only):
    argv = ["--tiny", "--device", "cpu", "--steps", "1"]
    out = profile_step.main(argv + (["--fwd-only"] if fwd_only else []))
    assert out["mode"] == ("forward" if fwd_only else "step")
    assert out["wall_ms_per_step"] > 0
    assert out["device_busy_ms"] is None and out["category_ms"] == {}
    assert profile_step.category_of("K4 point_sample bwd") == \
        profile_step.KERNELS
    assert profile_step.category_of("index / gather") == "other"


def test_bench_loader_runs():
    out = bench_loader.main(["--samples", "4", "--batches", "2",
                             "--workers", "1,2", "--img-hw", "90,160"])
    assert set(out["per_workers"]) == {"1", "2"}
    assert out["value"] == max(out["per_workers"].values()) > 0
    assert out["img_hw"] == [90, 160]


def test_bench_eval_host_runs(tmp_path):
    path = tmp_path / "eval_host.json"
    out = bench_eval_host.main(["--samples", "10", "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["nms_ms_per_sample"] > 0 and out["kept_boxes_per_sample"] > 0
    assert out["val_scale_host_s"] == pytest.approx(
        (out["nms_ms_per_sample"] + out["accumulate_ms_per_sample"])
        * 6019 / 1e3 + out["summarize_s"])
