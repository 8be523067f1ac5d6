"""`vt_replay_share.serve`: the share of the view transformer's calls
that replayed a captured graph. On the CPU the program runs it eagerly
(0%); counted replays read as their share; a program without the
counters gives nothing to read."""
import torch

from portbench import harness
from portbench.drivers import serve

from .common import serve_ctx

READ = harness.reader("vt_replay_share.serve")


def test_the_cpu_window_reads_no_replay():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ctx = serve_ctx(batch=1)
    state = serve.setup(ctx)
    timings = []
    serve.window(ctx, state, 0.3, lambda *a: None, timings)
    torch.set_num_threads(n)
    assert all(t["counts"]["vt_calls"] == 2 for t in timings)
    assert READ(dict(timings=timings)) == 0.0


def test_counted_replays_read_as_their_share():
    def req(calls, replays):
        counts = dict(vt_calls=calls)
        if replays:
            counts["vt_replays"] = replays
        return dict(counts=counts)
    assert READ(dict(timings=[req(2, 2), req(2, 1), req(2, 2)])) == 100.0
    assert READ(dict(timings=[req(2, 1), req(2, 0), req(2, 1)])) == 50.0
    assert READ(dict(timings=[dict(counts={"allocs": 3})])) is None
    assert READ(dict(timings=[dict(dispatch=0.1)])) is None
    assert READ({}) is None
