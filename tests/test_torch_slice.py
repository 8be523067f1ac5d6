"""The port's eval forward of the with_ocrf=False slice against the JAX
detector on the CPU, at the tiny config (fp32), with the same weights
(JAX init, random BN statistics/scales/biases, carried over by the
weight bridge with a strict load) and the same synthetic requests.

(a) use_stereo=False: no cost volume is involved, so heatmaps, depth and
    semantic probabilities and decoded scores agree to fp32 rounding
    (measured: max |diff| 3e-6 of the output scale; tolerance rtol 1e-4,
    atol 1e-4 of the output scale).
(b) use_stereo=True: JAX's CPU cost volume (`cost_volume_scan`) weights
    and sums the taps in bf16 while the port computes them in fp32, so
    the costs differ by up to ~0.3 before the softmax. Measured: max
    |diff| 1.0e-4 of the output scale over every head (with_prev=1; the
    previous frame carries the only non-trivial volume, since the key
    frame's k2s is the identity); tolerance atol 1e-3 of the output
    scale, rtol 1e-3 (10x the measurement).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.core.coder import decode_all_tasks as jdecode
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.ops import bev_pool, cost_volume
from ocrfdet_tpu_torch.utils.weights import load_flax_variables


def perturbed(variables, seed=0):
    """numpy copy of flax variables with random BN statistics, BN scales
    and biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return x
    return {k: jax.tree_util.tree_map_with_path(leaf, dict(v))
            for k, v in variables.items()}


def _run_both(stereo: bool):
    """Both detectors on request seed 0 with with_prev 1 and 0."""
    jcfg = jconfig.tiny_config(with_ocrf=False, use_stereo=stereo)
    cfg = tconfig.tiny_config(with_ocrf=False, use_stereo=stereo)
    jmodel = JaxOcRFDet(jcfg)
    jb = {k: jnp.asarray(v) for k, v in
          jmake_batch(jcfg, batch_size=1, seed=0, with_targets=False).items()}
    v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    v = perturbed({"params": v["params"], "batch_stats": v["batch_stats"]})
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    jout = {wp: apply(v, dict(jb, with_prev=jnp.asarray(float(wp))))
            for wp in (1, 0)}
    model = load_flax_variables(OcRFDet(cfg), v).eval()
    tb = entry.make_batch(cfg, seed=0, device="cpu")
    with torch.no_grad():
        tout = {wp: model(dict(tb, with_prev=torch.tensor(float(wp))))
                for wp in (1, 0)}
    return dict(cfg=cfg, jcfg=jcfg, jout=jout, tout=tout, model=model,
                batch=tb)


@pytest.fixture(scope="module")
def no_stereo():
    return _run_both(stereo=False)


@pytest.fixture(scope="module")
def stereo():
    return _run_both(stereo=True)


def _compare(run, with_prev, rtol, atol):
    (jpreds, jaux), (tpreds, taux) = run["jout"][with_prev], \
        run["tout"][with_prev]
    pairs = [(f"task{t}/{k}", tp[k].numpy(), np.asarray(jp[k]))
             for t, (tp, jp) in enumerate(zip(tpreds, jpreds)) for k in tp]
    pairs += [(k, taux[k].numpy(), np.asarray(jaux[k]))
              for k in ("depth", "semantic")]
    for name, got, want in pairs:
        assert got.shape == want.shape, name
        np.testing.assert_allclose(
            got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()),
            err_msg=name)


@pytest.mark.parametrize("with_prev", [1, 0])
def test_slice_without_stereo_matches_jax(no_stereo, with_prev):
    _compare(no_stereo, with_prev, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_prev", [1, 0])
def test_slice_with_stereo_matches_jax(stereo, with_prev):
    _compare(stereo, with_prev, rtol=1e-3, atol=1e-3)


def test_slice_shapes(stereo):
    cfg = stereo["cfg"]
    preds, aux = stereo["tout"][1]
    N, D = cfg.data.num_cams, cfg.grid.num_depth_bins
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    assert len(preds) == len(cfg.head.tasks)
    assert preds[0]["heatmap"].shape == (1, cfg.vt.bev_h, cfg.vt.bev_w, 1)
    assert aux["depth"].shape == (1, N, h, w, D)
    assert aux["semantic"].shape == (1, N, h, w, 2)
    np.testing.assert_allclose(aux["depth"].sum(-1).numpy(), 1.0,
                               rtol=1e-5)


def test_slice_decoded_scores_match_jax(no_stereo):
    """Decoded top-K scores (sorted) and their count above threshold."""
    jpreds, _ = no_stereo["jout"][1]
    tpreds, _ = no_stereo["tout"][1]
    jdec = jdecode(jpreds, no_stereo["jcfg"].head, no_stereo["jcfg"].grid)
    tdec = entry.decode_all_tasks(tpreds, no_stereo["cfg"].head,
                                  no_stereo["cfg"].grid)
    for t, j in zip(tdec, jdec):
        np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                                   rtol=1e-4, atol=1e-6)
        assert int(t.valid.sum()) == int(np.asarray(j.valid).sum())


def test_with_prev_gates_the_previous_frame(stereo):
    """with_prev=0 changes the prediction (the previous frame's BEV is
    zeroed) but not the key frame's depth."""
    (p1, a1), (p0, a0) = stereo["tout"][1], stereo["tout"][0]
    assert not torch.allclose(p1[0]["heatmap"], p0[0]["heatmap"])
    torch.testing.assert_close(a1["depth"], a0["depth"])


def test_infer_on_cpu_runs_the_plain_versions(stereo):
    """entry.infer on CPU tensors: the plain versions, no kernel launch;
    host NMS answers per sample."""
    before = (cost_volume.KERNEL.launches, bev_pool.KERNEL.launches)
    preds, aux, decoded, dets = entry.infer(stereo["model"],
                                            stereo["batch"])
    assert len(dets) == 1 and dets[0]["boxes"].shape[1:] == (9,)
    assert (cost_volume.KERNEL.launches, bev_pool.KERNEL.launches) == before
    torch.testing.assert_close(preds[0]["heatmap"],
                               stereo["tout"][1][0][0]["heatmap"])
    cfg = stereo["cfg"]
    assert len(decoded) == len(cfg.head.tasks)
    assert decoded[0].boxes.shape == (1, cfg.head.max_num, 9)
    assert all(bool(torch.isfinite(d.boxes).all()) for d in decoded)
