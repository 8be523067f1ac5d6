"""The port's span recorder (`ocrfdet_tpu_torch/utils/spans.py`) in a
served request at the tiny config on the CPU: `entry.infer(timings=)`
keeps its three host-clock numbers and adds every stage's span, nested
in its parent's and sharing one request id; with nothing on, no record
is kept and the outputs are the timed call's bits; under the profiler
the spans are ranges of the trace; and `profile_infer.device_breakdown`
puts each kernel under the innermost span above the op that launched
it (stub events)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ocrfdet_tpu_torch import entry, profile_infer
from ocrfdet_tpu_torch.config import tiny_config
from ocrfdet_tpu_torch.utils import spans

# name -> (parent, calls a batch-1 request); None: any count >= 1
TABLE = {
    "ocrfdet.dispatch": (None, 1),
    "ocrfdet.forward": ("ocrfdet.dispatch", 1),
    "ocrfdet.decode": ("ocrfdet.dispatch", 1),
    "ocrfdet.wait": (None, 1),
    "ocrfdet.nms": (None, 1),
    "ocrfdet.nms.circle": ("ocrfdet.nms", None),
    "ocrfdet.nms.rotated": ("ocrfdet.nms", None),
    "ocrfdet.encoder": ("ocrfdet.forward", 3),
    "ocrfdet.stereo": ("ocrfdet.forward", 2),
    "ocrfdet.vt": ("ocrfdet.forward", 2),
    **{f"ocrfdet.vt.{c}": ("ocrfdet.vt", 2) for c in (
        "depthnet", "splat", "ht_pool", "lift", "nerf", "sample", "hoa",
        "fuse")},
    "ocrfdet.bev": ("ocrfdet.forward", 3),
    "ocrfdet.head": ("ocrfdet.forward", 1),
}


@pytest.fixture(scope="module")
def served():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = tiny_config()
    model = entry.build_detector(cfg, device="cpu")
    batch = entry.make_batch(cfg, seed=0, device="cpu")
    entry.infer(model, batch)
    yield model, batch
    torch.set_num_threads(n)


def _timed(model, batch, monkeypatch):
    made = []

    class Kept(spans.Recorder):
        def __init__(self):
            super().__init__()
            made.append(self)
    monkeypatch.setattr(spans, "Recorder", Kept)
    tm = {}
    out = entry.infer(model, batch, timings=tm)
    assert len(made) == 1
    return tm, out, made[0]


def test_timings_keep_host_clock_numbers(served, monkeypatch):
    tm, _, _ = _timed(*served, monkeypatch)
    for k in ("dispatch", "wait", "nms"):
        assert isinstance(tm[k], float) and tm[k] >= 0.0, (k, tm[k])
    assert "allocs" not in tm["counts"]          # no allocator on the CPU
    assert tm["counts"]["nms_kept"] <= tm["counts"]["nms_candidates"]
    assert tm["counts"]["nms_kept"] > 0


def test_spans_nest_and_share_one_request(served, monkeypatch):
    tm, _, rec = _timed(*served, monkeypatch)
    got = tm["spans"]
    names = [s[0] for s in got]
    for name, (parent, calls) in TABLE.items():
        assert name in names, name
        if calls is not None:
            assert names.count(name) == calls, (name, names.count(name))
    for name, parent, s, e in got:
        assert 0.0 <= s <= e
        assert parent == TABLE[name][0], (name, parent)
        if parent is not None:          # inside one of its parent's spans
            assert any(p[0] == parent and p[2] <= s and e <= p[3]
                       for p in got), name
    assert {r[2] for r in rec.records} == {tm["request"]}
    assert len(rec.records) == len(got)
    by = {k: sum(e - s for n, _, s, e in got if n == k) for k in TABLE}
    assert tm["dispatch"] == pytest.approx(by["ocrfdet.dispatch"])
    assert tm["nms"] == pytest.approx(by["ocrfdet.nms"])
    assert by["ocrfdet.nms.circle"] + by["ocrfdet.nms.rotated"] <= tm["nms"]


def test_untimed_call_keeps_no_record_and_same_bits(served, monkeypatch):
    model, batch = served
    calls = []
    real = spans._Span

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(spans, "_Span", counted)
    preds, aux, decoded, dets = entry.infer(model, batch)
    assert calls == [] and spans._active is None
    monkeypatch.setattr(spans, "_Span", real)
    _, (tpreds, taux, tdecoded, tdets), _ = _timed(model, batch, monkeypatch)
    for p, q in zip(preds, tpreds):
        for k in p:
            assert torch.equal(p[k], q[k]), k
    assert torch.equal(aux["depth"], taux["depth"])
    for d, t in zip(decoded, tdecoded):
        for a, b in zip(d, t):
            assert torch.equal(a, b)
    for d, t in zip(dets, tdets):
        for k in d:
            np.testing.assert_array_equal(d[k], t[k])


def test_spans_are_profiler_ranges(served):
    model, batch = served
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        entry.infer(model, batch)
    names = {e.name for e in prof.events()}
    assert set(TABLE) <= names, set(TABLE) - names
    assert spans.span("ocrfdet.x") is spans.span("ocrfdet.y")


def test_span_off_is_one_shared_null_object():
    assert spans._active is None
    a, b = spans.span("ocrfdet.a"), spans.span("ocrfdet.b")
    assert a is b
    with a as got:
        assert got is None
    spans.count("nms_kept", 3)          # nothing active: no effect
    with spans.recording() as rec:
        with spans.span("ocrfdet.a"):
            spans.count("nms_kept", 3)
        assert spans.span("ocrfdet.b") is not a
    assert rec.counts == {"nms_kept": 3}
    assert [r[0] for r in rec.records] == ["ocrfdet.a"]
    assert spans._active is None


def _evt(name, parent=None, device=False, start=0.0, end=0.0,
         kernels=(), annotation=False):
    dt = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, cpu_parent=parent, is_user_annotation=annotation,
        device_type=dt.CUDA if device else dt.CPU,
        kernels=[SimpleNamespace(name=n, device=0, duration=d)
                 for n, d in kernels],
        time_range=SimpleNamespace(start=start, end=end))


def test_device_breakdown_stage_ms_on_stub_events():
    vt = _evt("ocrfdet.vt")
    splat = _evt("ocrfdet.vt.splat", vt)
    mm = _evt("aten::mm", vt)
    events = [
        vt, splat, mm,
        _evt("cudaLaunchKernel", mm, kernels=[("gemm", 30.0)]),
        _evt("cudaLaunchKernel", _evt("aten::index_add_", splat),
             kernels=[("bev_pool_cells_kernel", 5.0)]),
        _evt("cudaLaunchKernel", _evt("aten::add"),
             kernels=[("vectorized_elementwise_kernel", 10.0)]),
        _evt("gemm", device=True, start=0.0, end=30.0),
        _evt("bev_pool_cells_kernel", device=True, start=40.0, end=45.0),
        _evt("vectorized_elementwise_kernel", device=True, start=50.0,
             end=60.0),
        # the span drawn on the device's timeline: no kernel
        _evt("ocrfdet.vt", device=True, start=0.0, end=100.0,
             annotation=True),
    ]
    prof = SimpleNamespace(events=lambda: events)
    out = profile_infer.device_breakdown(prof, n=2, wall_us=200.0)
    assert out["stage_ms"] == {"ocrfdet.vt": 30.0 / 2e3,
                               profile_infer.OUTSIDE: 10.0 / 2e3,
                               "ocrfdet.vt.splat": 5.0 / 2e3}
    assert list(out["stage_ms"]) == ["ocrfdet.vt", profile_infer.OUTSIDE,
                                     "ocrfdet.vt.splat"]
    assert out["device_busy_ms"] == pytest.approx(45.0 / 2e3)
    assert out["device_events"] == 3
    assert out["device_idle_share"] == pytest.approx(1.0 - 45.0 / 200.0)
    assert out["group_ms"]["K2 bev_pool"] == pytest.approx(5.0 / 2e3)
