"""The port's evaluation against the JAX package's on the CPU:

* `DetectionEvaluator` (with `merge` and token dedup) and `nusc_format`
  give JAX's metrics dict and results JSON exactly, on seeded random
  detections and GT;
* `run_eval` at the tiny config (`with_ocrf=False`, no stereo: the JAX
  CPU cost volume interpolates in bf16, see tests/test_torch_slice.py)
  on a fake nuScenes set, the same weights carried across by
  `utils/weights.load_flax_variables`: the decoded boxes of every batch
  agree with JAX's within the eval slice's tolerance (rtol 1e-4, atol
  1e-4 of the output scale, as tests/test_torch_slice.py), and the
  runner's plumbing (NMS, the gravity shift, tokens with the padded tail
  deduplicated, the JSON) gives JAX's metrics and JSON exactly when fed
  JAX's decoded outputs, and when both are fed the same decoded boxes
  made from the GT (so that mAP is far from 0).
"""
import json

import jax
import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.core import eval_metrics as jmetrics
from ocrfdet_tpu.core import nusc_format as jnusc
from ocrfdet_tpu.data import dataset as jdataset
from ocrfdet_tpu.data.fake_nuscenes import build_fake_nuscenes
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu.train import evaluate as jeval
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.core import eval_metrics as tmetrics
from ocrfdet_tpu_torch.core import nusc_format as tnusc
from ocrfdet_tpu_torch.data import dataset as tdataset
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.train import evaluate as teval
from ocrfdet_tpu_torch.utils.weights import load_flax_variables



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small CPU models: beside
    the other test workers on the same cores, torch's threads wait on
    each other far longer than they save (the resume test took 22 s on
    one thread and 202 s on eight beside seven busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def _random_samples(seed, n, names):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        m = int(rng.integers(0, 8))
        gt = np.zeros((m, 9))
        gt[:, :2] = rng.uniform(-45, 45, (m, 2))
        gt[:, 2] = rng.uniform(-1, 1, m)
        gt[:, 3:6] = rng.uniform(0.5, 5, (m, 3))
        gt[:, 6] = rng.uniform(-np.pi, np.pi, m)
        gt[:, 7:9] = rng.normal(0, 2, (m, 2))
        gl = rng.integers(0, len(names), m)
        # detections: noisy copies of some GT plus false positives
        keep = rng.random(m) < 0.7
        det = gt[keep] + rng.normal(0, 0.4, (int(keep.sum()), 9))
        fp = int(rng.integers(0, 4))
        det = np.concatenate([det, rng.uniform(-40, 40, (fp, 9))])
        det[:, 3:6] = np.abs(det[:, 3:6]) + 0.3
        dl = np.concatenate([gl[keep], rng.integers(0, len(names), fp)])
        out.append((det, rng.uniform(0.05, 1, len(det)), dl, gt, gl,
                    f"tok{seed}_{s}"))
    return out


def test_evaluator_and_json_match_jax_exactly(tmp_path):
    names = tconfig.CLASS_NAMES
    shards = [_random_samples(seed, 12, names) for seed in (0, 1)]
    shards[1].append(shards[0][3])          # a padded duplicate across
    results = {}
    for pkg, mod, nusc in (("jax", jmetrics, jnusc),
                           ("port", tmetrics, tnusc)):
        evs = []
        sample_json = {}
        for shard in shards:
            ev = mod.DetectionEvaluator(names)
            for det, sc, dl, gt, gl, tok in shard:
                ev.add_sample(det, sc, dl, gt, gl, token=tok)
                pose = dict(ego2global_rotation=[0.9, 0.1, -0.2, 0.3],
                            ego2global_translation=[100.0, -5.0, 1.0])
                sample_json[tok] = nusc.boxes_to_nusc_sample(
                    det, sc, dl, names, pose)
            evs.append(ev)
        evs[0].merge(evs[1])
        path = tmp_path / f"{pkg}.json"
        nusc.write_results_json(sample_json, str(path))
        results[pkg] = (evs[0].evaluate(), path.read_bytes(),
                        evs[0].n_samples)
    _same(results["jax"][0], results["port"][0])
    assert results["jax"][1] == results["port"][1]
    assert results["port"][2] == 24
    assert 0.05 < results["port"][0]["mAP"] < 0.95


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    """3 samples of a noise fake set, the eval loaders of both packages
    at batch 2 (the tail batch padded), JAX's eval variables (random BN
    statistics, scales and biases) and the port's model loaded from
    them."""
    root = tmp_path_factory.mktemp("eval_set")
    jcfg = jconfig.tiny_config(with_ocrf=False, use_stereo=False)
    cfg = tconfig.tiny_config(with_ocrf=False, use_stereo=False)
    pkl = build_fake_nuscenes(str(root), jcfg, n_samples=3, seed=5)
    kw = dict(batch_size=2, shuffle=False, drop_last=False, num_workers=2)
    jloader = jdataset.Loader(jdataset.NuScenesDataset(
        jcfg, pkl, is_train=False, cbgs=False), **kw)
    tloader = tdataset.Loader(tdataset.NuScenesDataset(
        cfg, pkl, is_train=False, cbgs=False), **kw)
    jmodel = JaxOcRFDet(jcfg)
    first = jeval._device_batch(next(jloader.epoch(0)))
    v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), first)
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return x
    v = {k: jax.tree_util.tree_map_with_path(leaf, dict(v[k]))
         for k in ("params", "batch_stats")}
    model = load_flax_variables(OcRFDet(cfg), v).eval()
    return dict(jcfg=jcfg, cfg=cfg, jloader=jloader, tloader=tloader,
                jmodel=jmodel, v=v, model=model, root=root)


def _jax_run(es, monkeypatch, decoded=None):
    """JAX's run_eval; returns (metrics, JSON, the decoded outputs of
    each batch). With `decoded`, its forward returns those instead."""
    seen = []
    build = jeval.build_eval_forward

    def recording(cfg, model):
        fwd = build(cfg, model)

        def run(params, stats, batch):
            if decoded is not None:
                out = decoded[len(seen)]
            else:
                out = jax.tree.map(np.asarray, fwd(params, stats, batch))
            seen.append(out)
            return out
        return run
    with monkeypatch.context() as m:
        m.setattr(jeval, "build_eval_forward", recording)
        path = es["root"] / "jax.json"
        metrics = jeval.run_eval(es["jcfg"], es["jmodel"], es["v"]["params"],
                                 es["v"]["batch_stats"], es["jloader"],
                                 out_json=str(path))
    return metrics, path.read_bytes(), seen


def _port_run(es, monkeypatch, decoded=None):
    seen = []
    fwd = teval.eval_forward

    def recording(cfg, model, batch):
        out = decoded[len(seen)] if decoded is not None else \
            fwd(cfg, model, batch)
        seen.append(out)
        return out
    with monkeypatch.context() as m:
        m.setattr(teval, "eval_forward", recording)
        path = es["root"] / "port.json"
        metrics = teval.run_eval(es["cfg"], es["model"], es["tloader"],
                                 out_json=str(path))
    return metrics, path.read_bytes(), seen


def test_run_eval_matches_jax(eval_set, monkeypatch):
    jm, jjson, jdec = _jax_run(eval_set, monkeypatch)
    tm, _, tdec = _port_run(eval_set, monkeypatch)
    assert len(jdec) == len(tdec) == 2
    for jb, tb in zip(jdec, tdec):
        for jt, tt in zip(jb, tb):
            assert jt.keys() == tt.keys()
            for k in jt:
                want, got = np.asarray(jt[k]), tt[k]
                assert got.shape == want.shape, k
                if k in ("labels", "valid"):
                    assert np.array_equal(got, want), k
                else:
                    np.testing.assert_allclose(
                        got, want, rtol=1e-4,
                        atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=k)
    assert set(tm) == set(jm)
    # the runner fed JAX's decoded outputs gives JAX's result exactly
    tm2, tjson, _ = _port_run(eval_set, monkeypatch, decoded=jdec)
    _same(jm, tm2)
    assert tjson == jjson
    res = json.loads(tjson)["results"]
    assert sorted(res) == ["tok0", "tok1", "tok2"]   # the pad deduplicated


def test_run_eval_plumbing_matches_jax_on_gt_boxes(eval_set, monkeypatch):
    """Both runners fed the same decoded boxes, made from each sample's
    GT with noise (task-local labels, gravity-centred z, a few invalid
    slots): the same metrics, far from 0, and the same JSON."""
    cfg = eval_set["cfg"]
    rng = np.random.default_rng(3)
    K = cfg.head.max_num
    decoded = []
    for batch in eval_set["tloader"].epoch(0):
        B = batch["imgs"].shape[0]
        per_task = []
        offset = 0
        for task in cfg.head.tasks:
            n_cls = len(task.class_names)
            d = dict(boxes=np.zeros((B, K, 9), np.float32),
                     scores=np.zeros((B, K), np.float32),
                     labels=np.zeros((B, K), np.int64),
                     valid=np.zeros((B, K), bool))
            for b in range(B):
                gl = batch["gt_labels"][b]
                sel = np.nonzero((gl >= offset) & (gl < offset + n_cls))[0]
                for j, g in enumerate(sel[:K]):
                    box = batch["gt_boxes"][b][g].copy()
                    box[:3] += rng.normal(0, 0.3, 3)
                    d["boxes"][b, j] = box
                    d["scores"][b, j] = rng.uniform(0.2, 0.9)
                    d["labels"][b, j] = gl[g] - offset
                    d["valid"][b, j] = rng.random() < 0.9
            per_task.append(d)
            offset += n_cls
        decoded.append(per_task)
    jm, jjson, _ = _jax_run(eval_set, monkeypatch, decoded=decoded)
    tm, tjson, _ = _port_run(eval_set, monkeypatch, decoded=decoded)
    _same(jm, tm)
    assert tjson == jjson
    assert tm["mAP"] > 0.2, tm["mAP"]


def test_ema_detector_refuses_an_incomplete_ema():
    cfg = tconfig.tiny_config(with_ocrf=False)
    model = OcRFDet(cfg)
    ema = {k: v.float() for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    params = {k: v for k, v in ema.items() if "running" not in k}
    stats = {k: v for k, v in ema.items() if "running" in k}
    got = teval.ema_detector(cfg, dict(ema_params=params, ema_stats=stats),
                             device="cpu")
    assert not got.training
    dropped = sorted(params)[0]
    del params[dropped]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        teval.ema_detector(cfg, dict(ema_params=params, ema_stats=stats),
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            teval.ema_detector(cfg, dict(ema_params=ema, ema_stats={}))
