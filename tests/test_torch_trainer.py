"""The port's trainer on the CPU at the tiny config (OcRF on, ASPP
dropout on so that the dropout generator matters), from a fake nuScenes
set on disk through the augmenting loader:

* `epoch_flags` equals the JAX trainer's;
* two straight steps (epochs 1 and 2: `with_prev` 0 then 1, the box
  mask off then on) equal one step, `save`, a new trainer's `resume` and
  the second step, bit for bit: parameters, BatchNorm buffers,
  optimizer moments, both EMAs, the generator and the step count;
* the EMA eval model holds exactly the EMA tensors, from the state and
  from the checkpoint; `metrics.jsonl` is written with the JAX keys and
  the loader wait;
* the tools refuse what is not ported and the card when there is none,
  the train tool picks the JAX tool's config for --geoenh (with
  --vggt-ckpt) and --frames8, and `tools.eval` evaluates the checkpoint
  on the CPU when asked.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu.train.trainer import Trainer as JaxTrainer
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.data.dataset import Loader, NuScenesDataset
from ocrfdet_tpu_torch.data.fake_nuscenes import build_fake_nuscenes
from ocrfdet_tpu_torch.tools import eval as eval_tool
from ocrfdet_tpu_torch.tools import train as train_tool
from ocrfdet_tpu_torch.train.evaluate import ema_detector
from ocrfdet_tpu_torch.train.trainer import Trainer



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

@pytest.mark.parametrize("start", [0, 2, 3])
def test_epoch_flags_match_jax(start):
    def cfg(mod):
        c = mod.tiny_config()
        return dataclasses.replace(c, optim=dataclasses.replace(
            c.optim, temporal_start_epoch=start))
    jt, t = SimpleNamespace(cfg=cfg(jconfig)), SimpleNamespace(cfg=cfg(tconfig))
    for epoch in range(6):
        assert Trainer.epoch_flags(t, epoch) == \
            JaxTrainer.epoch_flags(jt, epoch)


def _cfg():
    c = tconfig.tiny_config()
    return dataclasses.replace(c, vt=dataclasses.replace(
        c.vt, depthnet=dataclasses.replace(c.vt.depthnet,
                                           aspp_dropout=0.1)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    cfg = _cfg()
    pkl = build_fake_nuscenes(str(root / "data"), cfg, n_samples=4)
    loader = Loader(NuScenesDataset(cfg, pkl, is_train=True, cbgs=False),
                    batch_size=2, num_workers=2)

    def trainer(name):
        t = Trainer(cfg, str(root / name), len(loader), device="cpu")
        t.init_state()
        return t
    straight = trainer("straight")
    s1 = straight.run_epoch(loader, 1, max_steps=1, log_every=1)
    s2 = straight.run_epoch(loader, 2, max_steps=1, log_every=1)
    first = trainer("resumed")
    r1 = first.run_epoch(loader, 1, max_steps=1, log_every=1)
    first.save(1)
    resumed = trainer("resumed")
    start = resumed.resume()
    step_at_resume = resumed.state.step
    r2 = resumed.run_epoch(loader, 2, max_steps=1, log_every=1)
    return dict(cfg=cfg, pkl=pkl, loader=loader, straight=straight,
                resumed=resumed, start=start, step_at_resume=step_at_resume,
                stats=(s1, s2, r1, r2), root=root)


def test_resume_is_a_bitwise_continuation(runs):
    assert runs["start"] == 2 and runs["step_at_resume"] == 1
    s1, s2, r1, r2 = runs["stats"]
    assert s1.metrics == r1.metrics and s2.metrics == r2.metrics
    assert all(m["skipped_nonfinite"] == 0.0 for m in s1.metrics + s2.metrics)
    a, b = runs["straight"].state, runs["resumed"].state
    assert a.step == b.step == 2
    sa, sb = a.state_dict(), b.state_dict()
    assert torch.equal(sa.pop("generator"), sb.pop("generator"))
    sa.pop("step"), sb.pop("step")
    for part in sa:
        assert sa[part].keys() == sb[part].keys(), part
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    # the steps moved what they should: the BN statistics, the moments
    init = Trainer(runs["cfg"], str(runs["root"] / "init"), 2, device="cpu")
    init.init_state()
    s0 = init.state.state_dict()
    moved = [k for k, v in sa["model"].items()
             if k.endswith("running_mean") and not torch.equal(
                 v, s0["model"][k])]
    assert moved and any(v.abs().sum() > 0
                         for v in sa["optimizer"].values())


def test_ema_eval_model_holds_the_ema(runs):
    """From the state and from a checkpoint: every parameter and running
    statistic of the eval model is its EMA tensor; the EMA also holds
    the render heads, which the eval model lacks."""
    state = runs["straight"].state
    with open(os.path.join(runs["root"], "resumed", "latest.json")) as f:
        ckpt = torch.load(json.load(f)["path"])
    for source, sd in ((state, state.state_dict()), (ckpt, ckpt)):
        ema = dict(sd["ema_params"], **sd["ema_stats"])
        model = ema_detector(runs["cfg"], source, device="cpu")
        assert not model.training
        got = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        for k, v in got.items():
            assert torch.equal(v, ema[k]), k
        assert len(ema) > len(got)
        raw = state.model.state_dict()
        assert any(not torch.equal(raw[k], ema[k]) for k in got)


def test_metrics_log_has_the_jax_keys(runs):
    path = os.path.join(runs["root"], "straight", "metrics.jsonl")
    recs = [json.loads(line) for line in open(path)]
    assert [(r["epoch"], r["iter"]) for r in recs] == [(1, 0), (2, 0)]
    for r in recs:
        assert {"frames_per_s", "loss_total", "skipped_nonfinite",
                "loss_depth", "loader_wait_s", "step_s"} <= set(r)
        assert r["loader_wait_s"] >= 0.0


def test_eval_tool_on_the_cpu(runs, capsys):
    with open(os.path.join(runs["root"], "resumed", "latest.json")) as f:
        path = json.load(f)["path"]
    out = str(runs["root"] / "results.json")
    metrics = eval_tool.main(["--infos", runs["pkl"], "--ckpt", path,
                              "--tiny", "--batch-size", "2", "--out", out,
                              "--device", "cpu"])
    assert 0.0 <= metrics["mAP"] <= 1.0 and 0.0 <= metrics["NDS"] <= 1.0
    with open(out) as f:
        assert len(json.load(f)["results"]) == 4
    assert '"mAP"' in capsys.readouterr().out


@pytest.mark.parametrize("flag,item", [("--multihost", "13b")])
def test_train_tool_refuses_unported_options(flag, item, monkeypatch):
    """`--multihost` runs the data axis and, since ROADMAP item `item`,
    the space axis (parallel.space_axis > 1); a space axis wider than
    the world is refused before any process group starts."""
    cfg = tconfig.tiny_config()
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, space_axis=2))
    monkeypatch.setattr(train_tool, "select_config", lambda args: cfg)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="smaller than the space axis 2"):
        train_tool.main(["--infos", "unused.pkl", flag, "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def _jax_geoenh(ckpt=None):
    cfg = jconfig.geoenh_config()
    return dataclasses.replace(cfg, vggt_teacher=dataclasses.replace(
        cfg.vggt_teacher, ckpt_path=ckpt)) if ckpt else cfg


@pytest.mark.parametrize("flags,want", [
    (["--geoenh"], lambda: _jax_geoenh()),
    (["--geoenh", "--vggt-ckpt", "vggt/model.pt"],
     lambda: _jax_geoenh("vggt/model.pt")),
    (["--frames8"], jconfig.ocrfdet_8f_config),
    (["--geoenh", "--frames8"], lambda: _jax_geoenh()),
    (["--tiny", "--geoenh"], jconfig.tiny_config),
    (["--frames8", "--batch-size", "1", "--no-ocrf"],
     lambda: jconfig.ocrfdet_8f_config(batch_size=1, with_ocrf=False))],
    ids=["geoenh", "geoenh_ckpt", "frames8", "geoenh_over_frames8",
         "tiny_over_geoenh", "frames8_overrides"])
def test_train_tool_selects_the_jax_tools_config(flags, want):
    """The JAX tool's precedence (tools_tpu/train.py): --tiny, then
    --geoenh with --vggt-ckpt, then --frames8, then the overrides;
    checked without building a model."""
    args = train_tool.parse_args(["--infos", "unused.pkl"] + flags)
    assert dataclasses.asdict(train_tool.select_config(args)) == \
        dataclasses.asdict(want())


def test_tools_and_trainer_need_the_card_unless_asked(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(runs["cfg"], str(runs["root"] / "gpu"), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_tool.main(["--infos", runs["pkl"], "--tiny",
                         "--work-dir", str(runs["root"] / "gpu")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_tool.main(["--infos", runs["pkl"], "--ckpt", "unused.pt",
                        "--tiny"])


def test_overfit_and_generalize_tools_on_the_cpu(tmp_path):
    """Both proofs end to end at a toy size: a fake set written, trained
    on, checkpointed and evaluated (decode -> NMS -> mAP)."""
    from ocrfdet_tpu_torch.tools import generalize, overfit
    rc = overfit.main(["--samples", "2", "--epochs", "1", "--batch-size",
                       "2", "--work-dir", str(tmp_path / "of"),
                       "--device", "cpu"])
    with open(tmp_path / "of" / "overfit_result.json") as f:
        res = json.load(f)
    assert rc == 1 and res["steps"] == 1 and res["device"] == "cpu"
    assert np.isfinite(res["loss_total_first"]) and 0 <= res["mAP"] <= 1
    res = generalize.main(["--train-samples", "4", "--held-samples", "2",
                           "--scene-len", "2", "--objects", "4",
                           "--img-hw", "64", "176", "--epochs", "1",
                           "--max-steps-per-epoch", "1", "--tiny",
                           "--work-dir", str(tmp_path / "gen"),
                           "--device", "cpu"])
    assert set(res["evals"]) == {"train_subset", "held_out",
                                 "held_out_no_prev"}
    assert os.path.exists(tmp_path / "gen" / "ckpt_epoch_0.pt")
