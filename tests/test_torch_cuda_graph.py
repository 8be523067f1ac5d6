"""The OcRF view transformer replayed as a CUDA graph in served eval
(`utils/cuda_graph.py`, `models/detector.py::_vt_graphed`).

On the CPU: the cached constants (`cuda_graph.constant`) give the bits
of the tensors they replace, on repeated calls and at two shapes each;
the tiny model's eval forward creates no tensor from host data inside
the view transformer once its constants exist (the model on `meta`, a
TorchFunctionMode watching the calls); and the view transformer runs
eagerly on the CPU, in training, with grad, on the space axis and under
torch.export, the span recorder counting `vt_calls` and no `vt_replays`.

On the card (marker `cuda`; skipped without CUDA): the flagship at batch
1 and 4, with the benchmark's weights (`portbench/weights.py`), on four
inputs of `portbench/gen.py` with other ego motion, image augmentation,
BDA and intrinsics: every replay gives the eager forward's bits
(`geom_feat`, depth, semantic, both logits, and the head maps), the
first call's outputs stay as they were, one graph is captured, a replay
allocates only its output clones, and the kernels' launch counts and
the span counters count one view transformer per frame.
"""
import contextlib
from types import SimpleNamespace

import pytest
import torch
from torch.overrides import TorchFunctionMode

from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.config import ocrfdet_config, tiny_config
from ocrfdet_tpu_torch.geometry import frustum as FR
from ocrfdet_tpu_torch.models import detector as det
from ocrfdet_tpu_torch.models.ocrf import deform_attn
from ocrfdet_tpu_torch.utils import cuda_graph, spans
from ocrfdet_tpu_torch.utils.weights import init_weights


def _fresh(values, dtype, device):
    """What the cached constants replace: a new tensor from host data."""
    return torch.tensor(tuple(values), dtype=dtype, device=device)


def _deform(shape):
    torch.manual_seed(0)
    m = deform_attn.DeformableAttention2D(dim=13)
    B, H, W = shape
    g = torch.Generator().manual_seed(1)
    xq, xkv = (torch.randn((B, 13, H, W), generator=g) for _ in range(2))
    return deform_attn, lambda: (m(xq, xkv),)


def _voxels(shape):
    grid = ocrfdet_config().grid
    g = torch.Generator().manual_seed(2)
    coor = torch.randn((*shape, 3), generator=g) * 40.0
    lower = (grid.x[0], grid.y[0], grid.z[0])
    step = (grid.x[2], grid.y[2], grid.z[2])
    return FR, lambda: FR.voxel_indices(coor, lower, step, (128, 128, 1))


def _projection(shape):
    B, bev = shape
    cfg = tiny_config(batch_size=B)
    batch = entry.make_batch(cfg, seed=3, batch_size=B, device="cpu")
    l2i, aug = FR.ego_to_image(*(batch[k][:, 0] for k in (
        "rots", "trans", "intrins", "post_rots", "post_trans")),
        batch["bda"])
    ref = torch.from_numpy(FR.ht_reference_points(bev, bev, 13))
    return FR, lambda: FR.project_points(
        ref, cfg.grid.pc_range, cfg.grid.depth[:2], l2i, aug,
        cfg.data.input_size)


@pytest.mark.parametrize("make, shape", [
    (_deform, (1, 21, 21)), (_deform, (2, 16, 24)),
    (_voxels, (2, 3, 5, 4, 6)), (_voxels, (1, 6, 7, 5, 9)),
    (_projection, (1, 8)), (_projection, (2, 5))],
    ids=["deform-21x21", "deform-b2-16x24", "voxels-b2", "voxels-b1",
         "project-b1", "project-b2"])
def test_constants_give_the_bits_of_fresh_tensors(make, shape, monkeypatch):
    module, run = make(shape)
    with monkeypatch.context() as m:
        m.setattr(module, "constant", _fresh)
        want = run()
    for _ in range(3):
        got = run()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_constant_is_made_once_and_is_a_normal_tensor():
    with torch.inference_mode():
        a = cuda_graph.constant((3.5, -1.0), torch.float32, "cpu")
    b = cuda_graph.constant([3.5, -1.0], torch.float32, torch.device("cpu"))
    assert a is b and not a.is_inference()
    assert torch.equal(a, torch.tensor([3.5, -1.0]))
    assert cuda_graph.constant((3.5, -1.0), torch.float64, "cpu") is not a


HOST_DATA = {torch.tensor, torch.as_tensor, torch.Tensor.new_tensor,
             torch.from_numpy}


class HostTensors(TorchFunctionMode):
    """Calls inside an `ocrfdet.vt` span that make a tensor from host data
    or take a CPU tensor, with (function, innermost span)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        stack = spans._active.stack if spans._active is not None else []
        if "ocrfdet.vt" in stack:
            leaves = torch.utils._pytree.tree_leaves((args, kwargs))
            if func in HOST_DATA or any(
                    isinstance(t, torch.Tensor) and t.device.type == "cpu"
                    for t in leaves):
                self.calls.append((getattr(func, "__name__", str(func)),
                                   stack[-1]))
        return func(*args, **kwargs)


def test_eval_vt_makes_no_tensor_from_the_host(monkeypatch):
    """The tiny eval forward on `meta`: a tensor that comes from the host
    would be a CPU tensor or a call of `HOST_DATA`. The first forward
    makes the constants; the second makes none. Fresh tensors in their
    place are seen in every forward (the check sees what it looks for)."""
    cfg = tiny_config()
    model = entry.build_detector(cfg, device="cpu").to("meta")
    batch = {k: v.to("meta") for k, v in
             entry.make_batch(cfg, seed=0, device="cpu").items()}
    # autocast refuses the meta device; the tiny config runs in fp32
    monkeypatch.setattr(det, "towers_autocast",
                        lambda *a: contextlib.nullcontext())

    def forward():
        with torch.inference_mode(), spans.recording(), \
                HostTensors() as seen:
            model(batch)
        return seen.calls
    forward()
    assert forward() == []
    monkeypatch.setattr(FR, "constant", _fresh)
    monkeypatch.setattr(deform_attn, "constant", _fresh)
    for _ in range(2):
        assert sorted({s for _, s in forward()}) == [
            "ocrfdet.vt.hoa", "ocrfdet.vt.ht_pool", "ocrfdet.vt.splat"]


class StubGraphs:
    """Stands in for the model's `CudaGraphs`: counts a replay and runs
    the function eagerly."""

    def __call__(self, fn, module, *args):
        spans.count("vt_replays", 1)
        return fn(*args)


@pytest.fixture(scope="module")
def tiny():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = tiny_config()
    model = init_weights(det.OcRFDet(cfg, render_heads=True), 0)
    batch = entry.make_batch(cfg, seed=0, device="cpu", with_targets=True)
    yield model, batch
    torch.set_num_threads(n)


# case -> (the device check passes, replays of the 2 calls a request)
CASES = {"served": (True, 2), "cpu": (False, 0), "train": (True, 0),
         "grad": (True, 0), "space": (True, 0), "export": (None, 0)}


@pytest.mark.parametrize("case", list(CASES))
def test_vt_is_eager_off_served_eval(tiny, case, monkeypatch):
    """Only served eval goes through the graph: with the card's device
    check passed (`capturable`), training, grad and a space axis each
    keep the view transformer eager; on the CPU the device check keeps
    it eager; under torch.export the trace's tensors do (with only the
    device check passed)."""
    model, batch = tiny
    model.eval()
    monkeypatch.setattr(model, "vt_graphs", StubGraphs())
    on_card, want = CASES[case]
    if on_card:
        monkeypatch.setattr(det, "capturable", lambda x: True)
    elif on_card is None:
        monkeypatch.setattr(det, "capturable",
                            lambda x: not cuda_graph.traced(x))
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    if case == "train":
        model.train()
    if case == "space":
        monkeypatch.setattr(model, "space",
                            SimpleNamespace(size=1, index=0))
    try:
        with spans.recording() as rec, grad:
            if case == "export":
                from ocrfdet_tpu_torch.tools.export import export_program
                export_program(model, {k: v for k, v in batch.items()
                                       if not isinstance(v, list)})
            else:
                model(batch)
    finally:
        model.eval()
    assert rec.counts["vt_calls"] == 2
    assert rec.counts.get("vt_replays", 0) == want
    assert not cuda_graph.capturable(batch["imgs"])


# ---------------------------------------------------------------- the card

def _inputs(cfg, B, dev):
    """Four requests of `portbench/gen.py` (their own ego motion and
    images), three with other camera tensors: an image augmentation
    (resize and crop), a BDA flip and a moved camera, longer focal
    lengths."""
    from portbench import gen
    out = [gen.make_input(cfg, B, 4100000031, i, dev, (0.0, 7.5),
                          (-0.1, 0.1)) for i in range(4)]
    out[1]["post_rots"][..., :2, :2] *= 0.9
    out[1]["post_trans"][..., 0] -= 12.0
    out[2]["bda"][:, 0, 0] = -1.0
    out[2]["trans"][..., 1] += 0.2
    out[3]["intrins"][..., :2, :2] *= 1.05
    return out


class Spy:
    """Wraps the model's `CudaGraphs`: keeps each call's arguments (cloned)
    and outputs."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __call__(self, fn, module, *args):
        out = self.inner(fn, module, *args)
        self.calls.append(([None if a is None else a.clone() for a in args],
                           out))
        return out


def _vt_outputs(out):
    geom, aux = out
    return [geom] + [aux[k] for k in ("depth", "semantic", "bev_mask_logit",
                                      "opacity_bev_logit")]


@pytest.fixture(scope="module", params=[1, 4], ids=["b1", "b4"])
def served(request):
    """The flagship at batch B served four requests through the graph,
    then the same requests eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import refrun, weights
    from portbench.ref import config as ref_config
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    B = request.param
    cfg = ocrfdet_config(batch_size=B)
    model = weights.build(det.OcRFDet, cfg).to(dev)
    weights.load(model, weights.draw(
        refrun.structure(ref_config.ocrfdet_config(batch_size=B)), 7, dev))
    model.eval()
    spy = model.vt_graphs = Spy(model.vt_graphs)
    inputs = _inputs(cfg, B, dev)
    from ocrfdet_tpu_torch.ops import (bev_pool, cost_volume, ht_pool,
                                       point_sample)
    kernels = [m.KERNEL for m in (cost_volume, bev_pool, ht_pool,
                                  point_sample)]
    graphed, counts, launches = [], [], []
    with torch.inference_mode():
        for inp in inputs:
            before = [k.launches for k in kernels]
            with spans.recording() as rec:
                preds, aux = model(inp)
            torch.cuda.synchronize()
            launches.append([k.launches - b for k, b in zip(kernels, before)])
            counts.append(dict(rec.counts))
            graphed.append((preds, aux))
        first = [t.clone() for t in _vt_outputs(spy.calls[0][1])]
        model._vt_graphed = lambda x: False
        eager = [model(inp)[0] for inp in inputs]
        del model._vt_graphed
    return SimpleNamespace(model=model, spy=spy, graphed=graphed,
                           eager=eager, first=first, counts=counts,
                           launches=launches, dev=dev)


@pytest.mark.cuda
def test_replay_gives_the_eager_bits(served):
    assert len(served.spy.calls) == 8
    with torch.inference_mode():
        for args, out in served.spy.calls:
            want = _vt_outputs(served.model._vt_eval(*args))
            for a, b in zip(_vt_outputs(out), want):
                assert a.dtype == b.dtype and torch.equal(a, b)
    for (got, _), want in zip(served.graphed, served.eager):
        for p, q in zip(got, want):
            for k in q:
                assert torch.equal(p[k], q[k]), k


@pytest.mark.cuda
def test_first_outputs_outlive_the_replays(served):
    for a, b in zip(_vt_outputs(served.spy.calls[0][1]), served.first):
        assert torch.equal(a, b)
    outs = [o for _, o in served.spy.calls]
    for i, a in enumerate(outs):        # fresh tensors on every call
        for b in outs[i + 1:]:
            assert a[0].data_ptr() != b[0].data_ptr()


@pytest.mark.cuda
def test_one_capture_and_its_counts(served):
    assert len(served.spy.inner.graphs) == 1
    assert served.counts[0]["vt_calls"] == 2
    assert served.counts[0].get("vt_replays", 0) == 1     # the capture
    for c in served.counts[1:]:
        assert c["vt_calls"] == 2 and c["vt_replays"] == 2
    for n in served.launches:           # K1-K4: one a frame, as eager
        assert n == [2, 2, 2, 2]


@pytest.mark.cuda
def test_a_replay_allocates_only_its_clones(served):
    args, _ = served.spy.calls[-1]
    graphs = served.spy.inner
    with torch.inference_mode():
        torch.cuda.synchronize()
        n0 = torch.cuda.memory_stats(served.dev)["allocation.all.allocated"]
        out = graphs(served.model._vt_eval, served.model.img_view_transformer,
                     *args)
        n1 = torch.cuda.memory_stats(served.dev)["allocation.all.allocated"]
    assert n1 - n0 == len(_vt_outputs(out))
