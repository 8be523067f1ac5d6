"""`nms_rows_share.serve`: the share of the tasks' NMS calls that
scanned suppression rows built on the card. On the CPU the program tests
its pairs on the host (0%); counted scans read as their share; a program
without the counters gives nothing to read."""
import torch

from portbench import harness
from portbench.drivers import serve

from .common import serve_ctx

READ = harness.reader("nms_rows_share.serve")


def test_the_cpu_window_reads_no_rows():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ctx = serve_ctx(batch=1)
    state = serve.setup(ctx)
    timings = []
    serve.window(ctx, state, 0.3, lambda *a: None, timings)
    torch.set_num_threads(n)
    assert all(t["counts"]["nms_tasks"] > 0 for t in timings)
    assert READ(dict(timings=timings)) == 0.0


def test_counted_scans_read_as_their_share():
    def req(tasks, scans):
        counts = dict(nms_tasks=tasks)
        if scans:
            counts["nms_rows_tasks"] = scans
        return dict(counts=counts)
    assert READ(dict(timings=[req(6, 6), req(6, 5), req(6, 6)])) == 100.0
    assert READ(dict(timings=[req(6, 3), req(6, 0), req(4, 2)])) == 50.0
    assert READ(dict(timings=[dict(counts={"nms_tasks": 0})])) is None
    assert READ(dict(timings=[dict(counts={"allocs": 3})])) is None
    assert READ({}) is None
