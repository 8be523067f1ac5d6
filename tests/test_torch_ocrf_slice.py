"""The port's eval forward of the OcRF slice (`with_ocrf=True`: HT pool,
NeRF alphas, voxel sampling, HOA, fusion and gates) against the JAX
detector on the CPU, at the tiny config (fp32), with the same weights
(JAX init, random BN statistics/scales/biases, carried over by the
weight bridge with a strict load and no key left over on either side)
and the same synthetic requests. JAX runs its `auto` dispatch, which on
the CPU is the fp32 gather path of the HT pool and the point sampling
(`ht_pool_ref`, `point_sample_ref`); the port runs the plain versions of
K2, K3 and K4.

(a) use_stereo=False: heatmaps and the other head maps, depth, semantic,
    bev_mask_logit, opacity_bev_logit and decoded scores agree to fp32
    rounding (measured: max |diff| 5e-6 of the output scale; tolerance
    rtol 1e-4, atol 1e-4 of the output scale, as slice 1).
(b) use_stereo=True: JAX's CPU cost volume weights and sums the taps in
    bf16, the port in fp32 (see tests/test_torch_slice.py); measured:
    max |diff| 3e-5 of the output scale; tolerance rtol 1e-3, atol 1e-3
    of the output scale, as slice 1.
The HT indices (nearest pixel / bin, validity) agree exactly between the
packages (tests/test_torch_ocrf_ops.py counts 0 flips), so no index is
fed across.
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
from ocrfdet_tpu_torch.ops import bev_pool, cost_volume, ht_pool
from ocrfdet_tpu_torch.ops import point_sample
from ocrfdet_tpu_torch.utils.weights import (conv_transpose_scopes,
                                             flax_to_state_dict,
                                             load_flax_variables)

AUX_KEYS = ("depth", "semantic", "bev_mask_logit", "opacity_bev_logit")


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


def _run_both(jcfg, cfg, with_prevs=(1, 0)):
    """Both detectors on request seed 0 for each with_prev."""
    jmodel = JaxOcRFDet(jcfg)
    jb = {k: jnp.asarray(v) for k, v in
          jmake_batch(jcfg, batch_size=1, seed=0, with_targets=False).items()}
    v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    v = perturbed({"params": v["params"], "batch_stats": v["batch_stats"]})
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    jout = {wp: apply(v, dict(jb, with_prev=jnp.asarray(float(wp))))
            for wp in with_prevs}
    model = load_flax_variables(OcRFDet(cfg), v).eval()
    tb = entry.make_batch(cfg, seed=0, device="cpu")
    with torch.no_grad():
        tout = {wp: model(dict(tb, with_prev=torch.tensor(float(wp))))
                for wp in with_prevs}
    return dict(cfg=cfg, jcfg=jcfg, jout=jout, tout=tout, model=model,
                batch=tb, variables=v)


def _tiny(stereo):
    return _run_both(jconfig.tiny_config(with_ocrf=True, use_stereo=stereo),
                     tconfig.tiny_config(with_ocrf=True, use_stereo=stereo))


@pytest.fixture(scope="module")
def no_stereo():
    return _tiny(stereo=False)


@pytest.fixture(scope="module")
def stereo():
    return _tiny(stereo=True)


def _compare(run, with_prev, rtol, atol):
    (jpreds, jaux), (tpreds, taux) = run["jout"][with_prev], \
        run["tout"][with_prev]
    pairs = [(f"task{t}/{k}", tp[k].numpy(), np.asarray(jp[k]))
             for t, (tp, jp) in enumerate(zip(tpreds, jpreds)) for k in tp]
    pairs += [(k, taux[k].numpy(), np.asarray(jaux[k])) for k in AUX_KEYS]
    for name, got, want in pairs:
        assert got.shape == want.shape, name
        np.testing.assert_allclose(
            got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()),
            err_msg=name)


@pytest.mark.parametrize("with_prev", [1, 0])
def test_ocrf_slice_without_stereo_matches_jax(no_stereo, with_prev):
    _compare(no_stereo, with_prev, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_prev", [1, 0])
def test_ocrf_slice_with_stereo_matches_jax(stereo, with_prev):
    _compare(stereo, with_prev, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("run", ["no_stereo", "stereo"])
def test_ocrf_decoded_scores_match_jax(request, run):
    """Decoded top-K scores (sorted) and their count above threshold."""
    r = request.getfixturevalue(run)
    tol = 1e-4 if run == "no_stereo" else 1e-3
    jpreds, _ = r["jout"][1]
    tpreds, _ = r["tout"][1]
    jdec = jdecode(jpreds, r["jcfg"].head, r["jcfg"].grid)
    tdec = entry.decode_all_tasks(tpreds, r["cfg"].head, r["cfg"].grid)
    for t, j in zip(tdec, jdec):
        np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                                   rtol=tol, atol=1e-6)
        assert int(t.valid.sum()) == int(np.asarray(j.valid).sum())


def test_weight_bridge_loads_every_ocrf_variable(no_stereo):
    """The eval variables of the JAX OcRF detector map one to one onto
    the port's state_dict: no key left over on either side."""
    model = no_stereo["model"]
    sd = flax_to_state_dict(no_stereo["variables"],
                            conv_transpose_scopes(model))
    assert set(sd) == set(model.state_dict())
    vt = {k.split(".")[1] for k in sd if k.startswith("img_view_transformer")}
    assert vt == {"A_MLP", "OpacityVoxelToBEV", "defor_cross_attention",
                  "fuser", "geom_att", "height_b", "height_bn", "height_w",
                  "image_feat_resize", "lss", "opacity_gate", "pos_enc",
                  "pos_enc_hoa", "prob", "sigma"}
    assert {k for k in sd if k.endswith(("up1.weight", "up2.weight",
                                         "up3.weight"))} \
        <= {f"{s}.weight" for s in conv_transpose_scopes(model)}


def test_ocrf_slice_shapes_and_gates(stereo):
    cfg = stereo["cfg"]
    preds, aux = stereo["tout"][1]
    N, D = cfg.data.num_cams, cfg.grid.num_depth_bins
    h = cfg.data.input_size[0] // cfg.vt.downsample
    w = cfg.data.input_size[1] // cfg.vt.downsample
    Y, X = cfg.vt.bev_h, cfg.vt.bev_w
    assert preds[0]["heatmap"].shape == (1, Y, X, 1)
    assert aux["depth"].shape == (1, N, h, w, D)
    assert aux["bev_mask_logit"].shape == (1, Y, X, 1)
    assert aux["opacity_bev_logit"].shape == (1, Y, X, 1)
    for k in AUX_KEYS:
        assert bool(torch.isfinite(aux[k]).all()), k
    np.testing.assert_allclose(aux["depth"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_ocrf_infer_on_cpu_runs_the_plain_versions(stereo):
    """entry.infer on CPU tensors: the plain versions, no kernel launch;
    host NMS answers per sample."""
    kernels = (cost_volume.KERNEL, bev_pool.KERNEL, ht_pool.KERNEL,
               point_sample.KERNEL)
    before = [k.launches for k in kernels]
    timings = {}
    preds, aux, decoded, dets = entry.infer(stereo["model"], stereo["batch"],
                                            timings=timings)
    assert [k.launches for k in kernels] == before
    torch.testing.assert_close(preds[0]["heatmap"],
                               stereo["tout"][1][0][0]["heatmap"])
    torch.testing.assert_close(aux["opacity_bev_logit"],
                               stereo["tout"][1][1]["opacity_bev_logit"])
    assert set(timings) == {"dispatch", "wait", "nms"}
    assert len(dets) == 1
    n_valid = sum(int(d.valid.sum()) for d in decoded)
    assert 0 < len(dets[0]["boxes"]) <= n_valid
    assert dets[0]["boxes"].shape[1] == 9
    assert len(dets[0]["scores"]) == len(dets[0]["labels"])


@pytest.mark.slow
def test_flagship_ocrf_slice_matches_jax():
    """`ocrfdet_config(batch_size=1)` (ResNet-50, 6 cameras at 256x704,
    128x128 BEV, 13 heights) in fp32: the heatmap of task 0 and the
    depth, the outputs `__graft_entry__.entry()` returns, with stereo.
    Tolerance as (b). Needs tens of GB of host memory."""
    jcfg = jconfig.ocrfdet_config(batch_size=1, compute_dtype="float32")
    cfg = tconfig.ocrfdet_config(batch_size=1, compute_dtype="float32")
    run = _run_both(jcfg, cfg, with_prevs=(1,))
    (jpreds, jaux), (tpreds, taux) = run["jout"][1], run["tout"][1]
    for got, want in ((tpreds[0]["heatmap"], jpreds[0]["heatmap"]),
                      (taux["depth"], jaux["depth"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * max(1.0, np.abs(want).max()))


@pytest.mark.slow
def test_flagship_ocrf_slice_with_jax_cost_volumes_matches_jax():
    """The flagship case above with JAX's two stereo cost volumes (the key
    frame's and the previous frame's) replayed as constants in both
    packages: every output at (a)'s tolerance, which puts what the
    stereo case leaves on the cost volume alone. There JAX's CPU cost
    volume weights and sums the taps in bf16 (see the module docstring);
    the port's, in fp32, is held after the softmax within 1e-3 of the
    same formula accumulated in float64 (`cost_volume_plain` given the
    coefficients in float64). Prints each volume's distances. Needs
    ~7 GB of host memory and a few minutes."""
    from unittest import mock

    from ocrfdet_tpu.models import detector as jdetector
    from ocrfdet_tpu_torch.models import detector as tdetector

    jcfg = jconfig.ocrfdet_config(batch_size=1, compute_dtype="float32")
    cfg = tconfig.ocrfdet_config(batch_size=1, compute_dtype="float32")
    jmodel = JaxOcRFDet(jcfg)
    jb = {k: jnp.asarray(v) for k, v in
          jmake_batch(jcfg, batch_size=1, seed=0, with_targets=False).items()}
    jb = dict(jb, with_prev=jnp.asarray(1.0))
    v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    v = perturbed({"params": v["params"], "batch_stats": v["batch_stats"]})

    jrecorded, jstereo_cost_volume = [], jdetector.stereo_cost_volume

    def jrecord(*args, **kw):
        jrecorded.append(jstereo_cost_volume(*args, **kw))
        return jrecorded[-1]

    def jvolumes(v, b):
        jrecorded.clear()
        jmodel.apply(v, b, train=False)
        return list(jrecorded)
    with mock.patch.object(jdetector, "stereo_cost_volume", jrecord):
        jcvs = [np.asarray(c) for c in jax.jit(jvolumes)(v, jb)]

    def replay(volumes):
        def f(*args, **kw):
            f.calls += 1
            return volumes[f.calls - 1]
        f.calls = 0
        return f
    with mock.patch.object(jdetector, "stereo_cost_volume",
                           replay([jnp.asarray(c) for c in jcvs])):
        jpreds, jaux = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            v, jb)

    model = load_flax_variables(OcRFDet(cfg), v).eval()
    tb = dict(entry.make_batch(cfg, seed=0, device="cpu"),
              with_prev=torch.tensor(1.0))
    calls = []

    def trecord(*args):
        calls.append((args, cost_volume.cost_volume_plain(*args)))
        return calls[-1][1]
    with torch.no_grad(), mock.patch.object(cost_volume, "cost_volume",
                                            trecord):
        model(tb)
    rp = replay([torch.tensor(c) for c in jcvs])
    with torch.no_grad(), mock.patch.object(tdetector, "stereo_cost_volume",
                                            rp):
        tpreds, taux = model(tb)
    assert len(jcvs) == len(calls) == rp.calls == 2

    _compare(dict(jout={1: (jpreds, jaux)}, tout={1: (tpreds, taux)}), 1,
             rtol=1e-4, atol=1e-4)
    for i, ((args, cost), jcv) in enumerate(zip(calls, jcvs)):
        curr, prev, depths, az, bz, a2, b2, bias = args
        f64 = torch.softmax(-cost_volume.cost_volume_plain(
            curr, prev, depths.double(), az.double(), bz.double(),
            a2.double(), b2.double(), bias).double(), dim=2).numpy()
        d_port = np.abs(torch.softmax(-cost, dim=2).numpy() - f64)
        d_jax = np.abs(jcv - f64)
        print(f"cost volume {i}: port (fp32) vs float64 max {d_port.max():.3e}"
              f" rms {np.sqrt((d_port ** 2).mean()):.3e}; JAX vs float64 max "
              f"{d_jax.max():.3e} rms {np.sqrt((d_jax ** 2).mean()):.3e}")
        assert d_port.max() <= 1e-3, i
