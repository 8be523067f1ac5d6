"""The 8-frame variant (num_adj = 7: 7 adjacent frames, the key frame and
the stereo reference) in the port against the JAX package on the CPU, and
the two configs this slice adds.

* `geoenh_config()` and `ocrfdet_8f_config()` (and their batch-1 forms)
  equal JAX's field for field;
* the tiny eval forward (`tiny_config(num_adj=7)`, OcRF and stereo on,
  fp32) from the same random weights (the shapes of JAX's init, values
  drawn as tests/test_torch_train_step.py draws them) and the same
  request: the heads, depth, semantic, both BEV logits and the temporal
  concat (JAX's sown `bev_cat`, the port's input to the BEV encoder), so
  that the nine frame slots are laid out as JAX lays them. JAX's CPU cost
  volume interpolates in bf16, the port's in fp32 (see
  tests/test_torch_train_stereo.py), and eight volumes feed this forward,
  so it is compared twice:
  - with JAX's eight cost volumes of this forward replayed in the port:
    rtol 1e-4, atol 1e-4 of the scale, the slice tolerance without
    stereo (measured <= 1e-5 of the scale, in the temporal concat);
  - with the port's own volumes: rtol 1e-2, atol 1e-2 of the scale
    (measured <= 6.5e-3 of the scale in the temporal concat, <= 3.3e-3
    in the heads);
* the slots as tests/test_8frame.py pins them in JAX: with_prev 0 zeroes
  the 7 adjacent blocks and the key frame keeps the last; a change to
  frame 3's images leaves the blocks of the older frames 7..4 (slots
  0..3) as they were and moves frame 3's own slot 4;
* a request through `entry.infer` on the CPU gives finite detections.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import random_variables

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.data.synthetic import make_batch as jmake_batch
from ocrfdet_tpu.models import detector as jdetector
from ocrfdet_tpu.models.depthnet import \
    stereo_cost_volume as jstereo_cost_volume
from ocrfdet_tpu.models.detector import OcRFDet as JaxOcRFDet
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.models import detector as tdetector
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.utils.weights import load_flax_variables

AUX_KEYS = ("depth", "semantic", "bev_mask_logit", "opacity_bev_logit")


@pytest.mark.parametrize("name,overrides", [
    ("geoenh_config", {}), ("geoenh_config", dict(batch_size=1)),
    ("ocrfdet_8f_config", {}), ("ocrfdet_8f_config", dict(batch_size=1))])
def test_new_configs_equal_jax(name, overrides):
    mine = getattr(tconfig, name)(**overrides)
    ref = getattr(jconfig, name)(**overrides)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def _port_forward(model, batch):
    """(preds, aux, the temporal concat [B, Y, X, C*F] channel-last)."""
    seen = {}
    hook = model.img_bev_encoder_backbone.register_forward_pre_hook(
        lambda mod, args: seen.update(x=args[0]))
    try:
        with torch.no_grad():
            preds, aux = model(batch)
    finally:
        hook.remove()
    return preds, aux, seen["x"].permute(0, 2, 3, 1)


def _replay(volumes):
    """A stand-in for stereo_cost_volume that returns `volumes` in call
    order, whatever its inputs."""
    def f(*args, **kw):
        f.calls += 1
        return volumes[(f.calls - 1) % len(volumes)]
    f.calls = 0
    return f


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = jconfig.tiny_config(num_adj=7), tconfig.tiny_config(num_adj=7)
    assert cfg.num_frames == 8 and cfg.total_frames == 9
    jm = JaxOcRFDet(jcfg)
    jb = {k: jnp.asarray(v) for k, v in jmake_batch(
        jcfg, batch_size=1, seed=0, with_targets=False).items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb,
                                            train=False))
    v = random_variables({"params": shapes["params"],
                          "batch_stats": shapes["batch_stats"]})
    # JAX's forward, and the cost volumes it built
    recorded = []

    def record(*args, **kw):
        out = jstereo_cost_volume(*args, **kw)
        recorded.append(out)
        return out

    def forward(v, b):
        recorded.clear()
        return jm.apply(v, b, train=False, mutable=["intermediates"]), \
            list(recorded)
    with mock.patch.object(jdetector, "stereo_cost_volume", record):
        ((jpreds, jaux), inter), cvs = jax.jit(forward)(v, jb)
    model = load_flax_variables(OcRFDet(cfg), v).eval()
    batch = entry.make_batch(cfg, seed=0, device="cpu")
    assert batch["imgs"].shape[1] == 9
    replay = _replay([torch.tensor(np.asarray(c)) for c in cvs])
    with mock.patch.object(tdetector, "stereo_cost_volume", replay):
        replayed = _port_forward(model, batch)
    assert replay.calls == len(cvs) == 8
    return dict(cfg=cfg, model=model, batch=batch, jpreds=jpreds, jaux=jaux,
                jbev_cat=np.asarray(inter["intermediates"]["bev_cat"][0]),
                own=_port_forward(model, batch), replayed=replayed)


@pytest.mark.parametrize("which,tol", [("replayed", 1e-4), ("own", 1e-2)])
def test_8frame_eval_forward_matches_jax(run, which, tol):
    preds, aux, bev_cat = run[which]
    assert bev_cat.shape[-1] == run["cfg"].vt.out_channels * 8
    pairs = [(f"task{t}/{k}", tp[k], jp[k]) for t, (tp, jp) in
             enumerate(zip(preds, run["jpreds"])) for k in tp]
    pairs += [(k, aux[k], run["jaux"][k]) for k in AUX_KEYS]
    pairs += [("bev_cat", bev_cat, run["jbev_cat"])]
    for name, got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * max(1.0, np.abs(want).max()),
                                   err_msg=name)


def test_8frame_slot_layout(run):
    cfg, model, batch = run["cfg"], run["model"], run["batch"]
    C, nf = cfg.vt.out_channels, cfg.num_frames
    base = run["own"][2]
    _, _, cat0 = _port_forward(model, dict(batch, with_prev=torch.tensor(0.0)))
    assert torch.all(cat0[..., :C * (nf - 1)] == 0.0)
    torch.testing.assert_close(cat0[..., -C:], base[..., -C:])
    f = 3
    imgs = batch["imgs"].clone()
    imgs[:, f] += 3.0
    _, _, catp = _port_forward(model, dict(batch, imgs=imgs))
    slot = nf - 1 - f
    torch.testing.assert_close(catp[..., :slot * C], base[..., :slot * C],
                               rtol=0, atol=1e-6)
    own = slice(slot * C, (slot + 1) * C)
    assert float((catp[..., own] - base[..., own]).abs().max()) > 1e-4


def test_8frame_request_through_entry_infer(run):
    preds, aux, decoded, dets = entry.infer(run["model"], run["batch"])
    assert len(dets) == 1 and dets[0]["boxes"].shape[1:] == (9,)
    assert np.isfinite(dets[0]["boxes"]).all()
    assert all(bool(torch.isfinite(d.scores).all()) for d in decoded)
