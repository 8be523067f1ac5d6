"""The port's host data layer against the JAX package's on the same
files and seeds: the quaternion and augmentation helpers (to 1e-12), the
fake nuScenes writer (the same info file, JPEG bytes and point labels,
noise and rendered scenes), `prepare_sample` (bit-equal arrays for
training and eval, several indices and epochs, tiny config), the CBGS
indices and the threaded loader's batches (shuffle, drop_last=False
padding, two-process slicing); and the dtypes of `collate`'s output
against what the port's model and losses read from
`data/synthetic.make_batch`.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data import dataset as jdataset
from ocrfdet_tpu.data import fake_nuscenes as jfake
from ocrfdet_tpu.data import infos as jinfos
from ocrfdet_tpu.geometry import quaternion as jquat
from ocrfdet_tpu.geometry import transforms as jtf
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.data import dataset as tdataset
from ocrfdet_tpu_torch.data import fake_nuscenes as tfake
from ocrfdet_tpu_torch.data import infos as tinfos
from ocrfdet_tpu_torch.data import synthetic
from ocrfdet_tpu_torch.geometry import quaternion as tquat
from ocrfdet_tpu_torch.geometry import transforms as ttf
from ocrfdet_tpu_torch.train.trainer import HOST_ONLY_KEYS, device_batch


def _cases(seed=0, n=6):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        q = rng.normal(size=4) * rng.uniform(0.1, 3.0)
        t = rng.normal(size=3) * 10
        yield dict(q=q, t=t, resize=float(rng.uniform(0.3, 1.2)),
                   crop=tuple(int(v) for v in rng.integers(0, 200, 4)),
                   flip=bool(rng.integers(0, 2)),
                   rot=float(rng.uniform(-10, 10)),
                   scale=float(rng.uniform(0.9, 1.1)),
                   fx=bool(rng.integers(0, 2)), fy=bool(rng.integers(0, 2)),
                   boxes=rng.normal(size=(5, 9)) * 5)


GEOMETRY = {
    "quat_to_matrix": lambda m, c: m.quat_to_matrix(c["q"]),
    "se3_from_quat": lambda m, c: m.se3_from_quat(c["q"], c["t"]),
    "inv_se3": lambda m, c: m.inv_se3(m.se3_from_quat(c["q"], c["t"])),
    "rot2d": lambda m, c: m.rot2d(np.deg2rad(c["rot"])),
    "fold_img_aug": lambda m, c: np.concatenate([a.ravel() for a in
                                                 m.fold_img_aug(
        c["resize"], c["crop"], c["flip"], c["rot"])]),
    "expand_post_3x3": lambda m, c: np.concatenate([a.ravel() for a in
                                                    m.expand_post_3x3(
        *m.fold_img_aug(c["resize"], c["crop"], c["flip"], c["rot"]))]),
    "bda_matrix": lambda m, c: m.bda_matrix(c["rot"], c["scale"], c["fx"],
                                            c["fy"]),
    "apply_bda_to_boxes": lambda m, c: m.apply_bda_to_boxes(
        c["boxes"], c["rot"], c["scale"], c["fx"], c["fy"]),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_helpers_match_jax(name):
    f = GEOMETRY[name]
    for c in _cases():
        jm = jquat if name in ("quat_to_matrix", "se3_from_quat",
                               "inv_se3") else jtf
        tm = tquat if jm is jquat else ttf
        np.testing.assert_allclose(f(tm, c), f(jm, c), rtol=0, atol=1e-12)


def _relative(infos, root):
    """The info list with the writer's root cut from every image path."""
    out = []
    for info in infos:
        info = dict(info, cams={
            k: dict(v, data_path=os.path.relpath(v["data_path"], root))
            for k, v in info["cams"].items()})
        out.append(info)
    return out


def _same_tree(a, b, where="infos"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("scene", [False, True])
def test_fake_nuscenes_writes_the_same_files(tmp_path, scene):
    cfg = tconfig.tiny_config()
    kw = dict(n_samples=3, img_hw=(64, 160), seed=3, scene=scene,
              scene_len=2, n_objects=6)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jpkl = jfake.build_fake_nuscenes(jroot, jconfig.tiny_config(), **kw)
    tpkl = tfake.build_fake_nuscenes(troot, cfg, **kw)
    with open(jpkl, "rb") as f:
        jdata = pickle.load(f)
    with open(tpkl, "rb") as f:
        tdata = pickle.load(f)
    assert jdata["metadata"] == tdata["metadata"]
    _same_tree(_relative(jdata["infos"], jroot),
               _relative(tdata["infos"], troot))
    for sub in ("samples", "samples_point_label"):
        names = sorted(os.listdir(os.path.join(jroot, sub)))
        assert names == sorted(os.listdir(os.path.join(troot, sub)))
        assert len(names) == 3 * cfg.data.num_cams
        for n in names:
            with open(os.path.join(jroot, sub, n), "rb") as f:
                jb = f.read()
            with open(os.path.join(troot, sub, n), "rb") as f:
                assert f.read() == jb, n


@pytest.fixture(scope="module")
def scene_set(tmp_path_factory):
    """A rendered fake set of two scenes (written by the JAX package),
    read by both packages' datasets."""
    root = tmp_path_factory.mktemp("fake_scene")
    jcfg = jconfig.tiny_config()
    pkl = jfake.build_fake_nuscenes(str(root), jcfg, n_samples=6,
                                    img_hw=(96, 264), seed=1, scene=True,
                                    scene_len=3, n_objects=8)
    return pkl


def _assert_same_sample(js, ts):
    assert js.keys() == ts.keys()
    for k in js:
        if k == "sample_token":
            assert js[k] == ts[k]
        elif isinstance(js[k], list):
            assert len(js[k]) == len(ts[k]), k
            for a, b in zip(js[k], ts[k]):
                assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            a, b = np.asarray(js[k]), np.asarray(ts[k])
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            assert a.shape == b.shape, k
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("is_train", [True, False])
def test_prepare_sample_is_bit_equal(scene_set, is_train):
    jds = jdataset.NuScenesDataset(jconfig.tiny_config(), scene_set,
                                   is_train=is_train, cbgs=False)
    tds = tdataset.NuScenesDataset(tconfig.tiny_config(), scene_set,
                                   is_train=is_train, cbgs=False)
    assert len(jds) == len(tds) == 6
    for i, epoch in ((0, 0), (2, 0), (4, 1), (5, 3)):
        _assert_same_sample(jds.sample(i, epoch), tds.sample(i, epoch))


def test_cbgs_indices_match_jax(scene_set):
    jinf = jinfos.load_infos(scene_set)
    tinf = tinfos.load_infos(scene_set)
    for seed in (0, 7):
        j = jinfos.cbgs_indices(jinf, num_classes=10, seed=seed)
        t = tinfos.cbgs_indices(tinf, num_classes=10, seed=seed)
        assert j.dtype == t.dtype and np.array_equal(j, t)
        assert len(t) > len(tinf)       # duplicated by class balance
    for index in range(len(tinf)):
        a = jinfos.adjacent_infos(jinf, index, 1, True)
        b = tinfos.adjacent_infos(tinf, index, 1, True)
        assert [x["token"] for x in a] == [x["token"] for x in b]


def test_loader_batches_match_jax(scene_set):
    """CBGS training set, shuffled, batch 6 of 2 processes (each loads
    its 3), drop_last=False: the ragged tail batch is padded by cycling
    its own samples."""
    jcfg, tcfg = jconfig.tiny_config(), tconfig.tiny_config()
    jds = jdataset.NuScenesDataset(jcfg, scene_set, is_train=True, cbgs=True)
    tds = tdataset.NuScenesDataset(tcfg, scene_set, is_train=True, cbgs=True)
    assert np.array_equal(jds.indices, tds.indices)
    assert len(tds) % 6, "the set must leave a ragged tail batch"
    for proc in (0, 1):
        kw = dict(batch_size=6, shuffle=True, drop_last=False,
                  num_workers=3, prefetch=2, process_index=proc,
                  process_count=2)
        jl, tl = jdataset.Loader(jds, **kw), tdataset.Loader(tds, **kw)
        assert len(jl) == len(tl) == -(-len(tds) // 6)
        for epoch in (0, 1):
            jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
            assert len(jb) == len(tb) == len(tl)
            for a, b in zip(jb, tb):
                assert b["imgs"].shape[0] == 3
                _assert_same_sample(a, b)


def test_loader_stops_its_thread_when_closed(scene_set):
    """A consumer that stops early ends the loader's scheduler thread
    (the JAX loader leaves it blocked on its full queue)."""
    import threading
    tds = tdataset.NuScenesDataset(tconfig.tiny_config(), scene_set,
                                   is_train=False, cbgs=False)
    loader = tdataset.Loader(tds, 1, shuffle=False, num_workers=2,
                             prefetch=1)
    it = loader.epoch(0)
    next(it)
    assert any("scheduler" in t.name for t in threading.enumerate())
    it.close()
    assert not any("scheduler" in t.name for t in threading.enumerate())


def test_collate_dtypes_match_synthetic_batch(scene_set):
    """A loader batch carries what the model and the losses read from
    `synthetic.make_batch(with_targets=True)`, in the same dtypes and
    layout; the ragged host-only entries never reach the device."""
    cfg = tconfig.tiny_config()
    ds = tdataset.NuScenesDataset(cfg, scene_set, is_train=True, cbgs=False)
    batch = next(tdataset.Loader(ds, 2, shuffle=False).epoch(0))
    syn = synthetic.make_batch(cfg, batch_size=2, with_targets=True)
    dev = device_batch(batch, 1.0, 0.0, "cpu")
    want = {k: v for k, v in syn.items()
            if k not in HOST_ONLY_KEYS and k != "kd_pair"}  # kd: GeoEnhDet
    assert set(dev) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert len(dev[k]) == len(v), k
            pairs = zip(dev[k], v)
        else:
            pairs = [(dev[k], v)]
        for got, ref in pairs:
            ref = torch.from_numpy(np.array(ref))
            assert got.dtype == ref.dtype, (k, got.dtype, ref.dtype)
            assert got.shape == ref.shape, (k, got.shape, ref.shape)
    for k in HOST_ONLY_KEYS:
        assert isinstance(batch[k], list) and len(batch[k]) == 2
    assert batch["gt_boxes"][0].dtype == np.float32
    assert batch["gt_labels"][0].dtype == np.int64
