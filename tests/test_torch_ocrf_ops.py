"""The port's OcRF ops against the JAX package on the CPU: the HT
projection, kernel K3's and K4's plain versions, and the host NMS.

* `project_points` + `_indices`: the nearest pixel, depth bin and
  validity of every projected height point are identical (0 flips) at
  the tiny and the flagship geometry of `make_batch`, every frame;
  uvd agrees to rtol 1e-5 where valid.
* K3, `ht_pool_points_plain` (through the CPU wrapper `ht_pool`)
  against the JAX `ht_pool_ref` (fp32 gather): rtol 1e-5, atol 1e-5 of
  the output scale (another summation order only); against the Pallas
  `ht_pool_mm` in interpret mode: the repo's bf16 tolerance (rtol
  3e-2, atol 3e-3; tests/test_ht_pool.py), since Pallas casts depth and
  context to bf16.
* K4, `point_sample_points_plain` (through the CPU wrapper
  `point_sample`) against the JAX `point_sample_ref`: rtol 1e-5, atol
  1e-6, with boundary points in (-1, 0) and (W-1, W);
  against `point_sample_mm` in interpret mode: rtol 3e-2, atol 2e-2
  (bf16 products; tests/test_point_sample.py).
* NMS: the port's rotated IoU (C++) against the JAX one (atol 1e-9,
  both in float64), and `multi_task_nms` over the CPU's suppression
  rows (`nms_rows`: the host's pair tests) and over `nms_rows_plain`'s
  against the JAX one on the tiny config's decoded boxes: identical
  kept sets, boxes and scores to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.core import coder as jcoder
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.geometry import frustum as jfr
from ocrfdet_tpu.ops import ht_pool as jht
from ocrfdet_tpu.ops import nms as jnms
from ocrfdet_tpu.ops import point_sample as jps
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.core import coder as tcoder
from ocrfdet_tpu_torch.geometry import frustum as tfr
from ocrfdet_tpu_torch.ops import ht_pool as tht
from ocrfdet_tpu_torch.ops import nms as tnms
from ocrfdet_tpu_torch.ops import point_sample as tps

CAM_KEYS = ("rots", "trans", "intrins", "post_rots", "post_trans")


def _projection(name, f):
    """(JAX, port) uvd, valid, pix, di, wv of frame f of make_batch."""
    jcfg = getattr(jconfig, name)(batch_size=1)
    cfg = getattr(tconfig, name)(batch_size=1)
    b = jmake_batch(jcfg, batch_size=1, seed=0, with_targets=False)
    vt, grid = cfg.vt, cfg.grid
    ref = jfr.ht_reference_points(vt.bev_h, vt.bev_w, vt.num_height,
                                  z_pillar=grid.z[1] - grid.z[0])
    np.testing.assert_array_equal(
        tfr.ht_reference_points(vt.bev_h, vt.bev_w, vt.num_height,
                                z_pillar=grid.z[1] - grid.z[0]), ref)
    shape = (1, cfg.data.num_cams, cfg.data.input_size[0] // vt.downsample,
             cfg.data.input_size[1] // vt.downsample, grid.num_depth_bins)
    cams = [b[k][:, f] for k in CAM_KEYS] + [b["bda"]]
    drange = (grid.depth[0], grid.depth[1])

    def jrun(*a):
        l2i, aug = jfr.ego_to_image(*a)
        uvd, valid = jfr.project_points(jnp.asarray(ref), jcfg.grid.pc_range,
                                        drange, l2i, aug,
                                        jcfg.data.input_size)
        return (uvd, valid) + jht._indices(shape, uvd, valid)
    jout = [np.asarray(x) for x in
            jax.jit(jrun)(*[jnp.asarray(a) for a in cams])]
    l2i, aug = tfr.ego_to_image(*[torch.from_numpy(np.ascontiguousarray(a))
                                  for a in cams])
    uvd, valid = tfr.project_points(torch.from_numpy(ref), grid.pc_range,
                                    drange, l2i, aug, cfg.data.input_size)
    tout = [x.numpy() for x in (uvd, valid) + tht._indices(shape, uvd,
                                                            valid)]
    return jout, tout


@pytest.mark.parametrize("name", ["tiny_config", "ocrfdet_config"])
def test_project_points_index_parity(name):
    """0 flips of pix, di and valid over every frame; uvd to rtol 1e-5
    where valid (far behind the camera u reaches ~1e6, where the two
    frameworks' 3x3 products round differently)."""
    for f in range(3):
        (ju, jv, jp, jd, jw), (tu, tv, tp, td, tw) = _projection(name, f)
        flips = {k: int((a != b).sum()) for k, a, b in
                 (("valid", tv, jv), ("pix", tp, jp), ("di", td, jd))}
        assert flips == {"valid": 0, "pix": 0, "di": 0}, (f, flips)
        np.testing.assert_array_equal(tw, jw)
        assert tv.sum() > 0
        np.testing.assert_allclose(tu[tv], ju[jv], rtol=1e-5, atol=1e-6)


def _ht_case(B=1, N=2, h=4, w=11, D=16, C=8, Zh=5, Nq=300, seed=0):
    """tests/test_ht_pool.py::_rand_case: in-view, out-of-view and
    invalid points; Nq not a multiple of the Pallas 256-pillar block."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (B, N, h, w, D)).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    context = rng.normal(0, 1, (B, N, h, w, C)).astype(np.float32)
    uvd = rng.uniform(-0.3, 1.3, (B, N, Zh, Nq, 3)).astype(np.float32)
    valid = ((rng.random((B, N, Zh, Nq)) > 0.2)
             & np.all((uvd > 0.0) & (uvd < 1.0), -1))
    return depth.astype(np.float32), context, uvd, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kw", [dict(Nq=300), dict(Nq=256, Zh=13, seed=7),
                                dict(B=2, N=3, C=80, Nq=130, seed=3)],
                         ids=["nq300", "zh13", "b2c80"])
def test_ht_pool_plain_matches_ht_pool_ref(kw):
    depth, context, uvd, valid = _ht_case(**kw)
    want = np.asarray(jht.ht_pool_ref(*[jnp.asarray(a) for a in
                                        (depth, context, uvd, valid)]))
    before = tht.KERNEL.launches
    got = tht.ht_pool(*_t(depth, context, uvd, valid)).numpy()
    assert tht.KERNEL.launches == before      # CPU tensors: plain version
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_ht_pool_plain_matches_pallas_interpret():
    depth, context, uvd, valid = _ht_case(seed=1)
    want = np.asarray(jht.ht_pool_mm(*[jnp.asarray(a) for a in
                                       (depth, context, uvd, valid)],
                                     interpret=True))
    got = tht.ht_pool(*_t(depth, context, uvd, valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-3)


def test_ht_pool_all_invalid_is_zero():
    depth, context, uvd, _ = _ht_case(seed=5, Nq=64)
    valid = np.zeros(uvd.shape[:-1], bool)
    out = tht.ht_pool(*_t(depth, context, uvd, valid)).numpy()
    np.testing.assert_array_equal(out, 0.0)


def _ps_case(B=1, N=2, H=12, W=20, C=3, P=700, seed=0):
    """tests/test_point_sample.py::_case plus boundary points: px in
    (-1, 0) and (W-1, W), py in (-1, 0) and (H-1, H), integers, and far
    outside."""
    rng = np.random.default_rng(seed)
    maps = rng.normal(0, 1, (B, N, H, W, C)).astype(np.float32)
    px = rng.uniform(-3, W + 3, (B, N, P))
    py = rng.uniform(-3, H + 3, (B, N, P))
    k = P // 8
    px[..., :k] = rng.uniform(-1, 0, (B, N, k))
    px[..., k:2 * k] = rng.uniform(W - 1, W, (B, N, k))
    py[..., 2 * k:3 * k] = rng.uniform(-1, 0, (B, N, k))
    py[..., 3 * k:4 * k] = rng.uniform(H - 1, H, (B, N, k))
    px[..., 4 * k:5 * k] = rng.integers(-1, W + 1, (B, N, k))
    py[..., 4 * k:5 * k] = rng.integers(-1, H + 1, (B, N, k))
    px[..., 5 * k] = -1e6
    py[..., 5 * k + 1] = 1e7
    return maps, px.astype(np.float32), py.astype(np.float32)


@pytest.mark.parametrize("C", [1, 3, 4])
def test_point_sample_plain_matches_point_sample_ref(C):
    maps, px, py = _ps_case(C=C, seed=C)
    want = np.asarray(jps.point_sample_ref(
        *[jnp.asarray(a) for a in (maps, px, py)]))
    before = tps.KERNEL.launches
    got = tps.point_sample(*_t(maps, px, py)).numpy()
    assert tps.KERNEL.launches == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_point_sample_edge_tap_weight():
    """For px in (-1, 0) only the tap u = 0 contributes, with weight
    1 - |px|; the same at the far edge for u = W - 1."""
    maps = np.arange(1 * 1 * 2 * 3 * 1, dtype=np.float32).reshape(
        1, 1, 2, 3, 1) + 1.0
    px = np.asarray([[[-0.25, 2.5, -1.0, 3.0]]], np.float32)
    py = np.zeros_like(px)
    got = tps.point_sample(*_t(maps, px, py)).numpy()[0, 0, :, 0]
    np.testing.assert_allclose(got, [0.75 * maps[0, 0, 0, 0, 0],
                                     0.5 * maps[0, 0, 0, 2, 0], 0.0, 0.0])


def test_point_sample_plain_matches_pallas_interpret():
    maps, px, py = _ps_case(seed=9)
    want = np.asarray(jps.point_sample_mm(
        *[jnp.asarray(a) for a in (maps, px, py)], interpret=True))
    got = tps.point_sample(*_t(maps, px, py)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=2e-2)


def _random_boxes(rng, n, spread=6.0):
    return np.stack([rng.uniform(-spread, spread, n),
                     rng.uniform(-spread, spread, n),
                     rng.uniform(0.5, 4.0, n), rng.uniform(0.5, 4.0, n),
                     rng.uniform(-np.pi, np.pi, n)], -1)


def test_rotated_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, 25), _random_boxes(rng, 30)
    want = jnms.rotated_iou_matrix(a, b)
    assert (want > 0).sum() > 20
    np.testing.assert_allclose(tnms.rotated_iou_matrix(a, b), want, rtol=0,
                               atol=1e-9)


def test_native_nms_library_is_built_from_the_port():
    lib = tnms.native_library()
    assert tnms.library_path().exists()
    assert tnms.library_path().parent.name == "build"
    assert lib is tnms.native_library()


@pytest.fixture(scope="module")
def decoded_tiny():
    """Decoded boxes of random tiny-config head outputs, in both
    packages: the heatmaps are shifted so that ~half the top-K pass the
    score threshold, and the sizes are large enough to overlap."""
    jcfg = jconfig.tiny_config()
    cfg = tconfig.tiny_config()
    rng = np.random.default_rng(0)
    Y, X = cfg.vt.bev_h, cfg.vt.bev_w
    preds = []
    for task in cfg.head.tasks:
        p = {"heatmap": rng.normal(-1.5, 1.0, (2, Y, X,
                                               len(task.class_names))),
             "reg": rng.uniform(0, 1, (2, Y, X, 2)),
             "height": rng.normal(0, 1, (2, Y, X, 1)),
             "dim": rng.normal(1.5, 0.5, (2, Y, X, 3)),
             "rot": rng.normal(0, 1, (2, Y, X, 2)),
             "vel": rng.normal(0, 1, (2, Y, X, 2))}
        preds.append({k: v.astype(np.float32) for k, v in p.items()})
    jdec = jcoder.decode_all_tasks(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        jcfg.head, jcfg.grid)
    tdec = tcoder.decode_all_tasks(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
        cfg.head, cfg.grid)
    jdec = [{k: np.asarray(v) for k, v in d._asdict().items()}
            for d in jdec]
    return jcfg, cfg, jdec, tdec


@pytest.mark.parametrize("rows", ["plain", "cpp"])
def test_multi_task_nms_matches_jax(decoded_tiny, rows):
    jcfg, cfg, jdec, decoded = decoded_tiny
    if rows == "cpp":               # the op on the CPU: the host's pair tests
        bits = tnms.nms_rows(decoded, cfg.head)
    else:
        bits = tnms.nms_rows_plain([d.boxes for d in decoded],
                                   [d.labels for d in decoded],
                                   *tnms.task_params(cfg.head))
    bits = bits.numpy().view(np.uint64)
    tdec = [{k: v.numpy() for k, v in d._asdict().items()} for d in decoded]
    suppressed = 0
    for b in range(2):
        want = jnms.multi_task_nms([{k: v[b] for k, v in d.items()}
                                    for d in jdec], jcfg.head)
        got = tnms.multi_task_nms([{k: v[b] for k, v in d.items()}
                                   for d in tdec], cfg.head,
                                  list(bits[:, b]))
        assert len(got["boxes"]) == len(want["boxes"]) > 0
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-6,
                                   atol=1e-6)
        suppressed += sum(int(d["valid"][b].sum()) for d in tdec) \
            - len(got["boxes"])
    assert suppressed > 0        # the case really exercises suppression
