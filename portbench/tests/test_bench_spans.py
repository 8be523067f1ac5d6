"""The readers of the program's spans and counters, fed the record of a
serving window at the tiny configuration on the CPU: each reads a
number (the allocator's count only on the card), the NMS parts fit in
the NMS, and a program that records no spans gives them nothing to
read."""
import pytest
import torch

from portbench import harness
from portbench.drivers import serve

from .common import serve_ctx

SPAN_METRICS = ("wait_ms.serve", "encoder_dispatch_ms.serve",
                "vt_dispatch_ms.serve", "bev_dispatch_ms.serve",
                "head_dispatch_ms.serve", "decode_dispatch_ms.serve",
                "nms_circle_ms.serve", "nms_rotated_ms.serve")
COUNTERS = ("allocs_per_request.serve",)


@pytest.fixture(scope="module")
def record():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ctx = serve_ctx(batch=2)
    state = serve.setup(ctx)
    timings = []
    serve.window(ctx, state, 0.5, lambda *a: None, timings)
    torch.set_num_threads(n)
    return dict(timings=timings)


def test_every_reader_reads_the_window(record):
    for name in SPAN_METRICS:
        v = harness.reader(name)(record)
        assert v is not None and v >= 0.0, name
    for name in COUNTERS:        # the caching allocator is the card's
        assert harness.reader(name)(record) is None


def test_nms_parts_fit_in_the_nms(record):
    for t in record["timings"]:
        part = {k: sum(e - s for n, _, s, e in t["spans"] if n == k)
                for k in ("ocrfdet.nms.circle", "ocrfdet.nms.rotated")}
        assert sum(part.values()) <= t["nms"]
        assert all(v > 0 for v in part.values()), part
    if len(record["timings"]) == 1:
        one = {n: harness.reader(n)(record) for n in
               ("nms_circle_ms.serve", "nms_rotated_ms.serve",
                "nms_ms.serve")}
        assert (one["nms_circle_ms.serve"] + one["nms_rotated_ms.serve"]
                <= one["nms_ms.serve"])


def test_stage_readers_fit_in_the_dispatch(record):
    for t in record["timings"]:
        one = dict(timings=[t])
        stages = sum(harness.reader(n)(one) for n in SPAN_METRICS[1:6])
        assert stages <= harness.reader("dispatch_ms.serve")(one)


def test_a_program_without_spans_gives_nothing(record):
    old = dict(timings=[{k: t[k] for k in ("dispatch", "wait", "nms")}
                        for t in record["timings"]])
    for name in SPAN_METRICS[1:] + COUNTERS:
        assert harness.reader(name)(old) is None
        assert harness.reader(name)({}) is None
    assert harness.reader("wait_ms.serve")(old) is not None
