"""The traced part of a `--trace 1` run: spans that the benchmark puts
around the program's layers (`torch.profiler.record_function` by
patching the module functions the program calls through), CUDA events
bracketing each call of a kernel's custom op, and the reading of the
profiler's trace: device busy time (the union of kernel intervals), the
device operations that took most time, and the idle gaps by what the
host was doing.

Nothing here runs in an untraced run."""
from __future__ import annotations

import contextlib
import functools
import importlib
from collections import defaultdict
from typing import Dict, List

import torch

from . import stats


@contextlib.contextmanager
def patched(target: str, wrap):
    """Replace the module function `target` ("package.module:name") by
    `wrap(original)` inside the block."""
    mod_name, attr = target.split(":")
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


@contextlib.contextmanager
def patched_attr(obj, attr: str, wrap):
    """Replace `obj.attr` by `wrap(original)` inside the block."""
    orig = getattr(obj, attr)
    setattr(obj, attr, wrap(orig))
    try:
        yield
    finally:
        if attr in vars(obj):
            delattr(obj, attr)
        if getattr(obj, attr) is not orig:
            setattr(obj, attr, orig)


def device_seconds(profiler_s: float, launch_event_s: float):
    """A kernel's device time: the profiler's (the device time of the
    kernels launched inside its custom op's range), unless CUDA events
    around the kernel's own launches read over a tenth more, where the
    profiler lost events; (seconds, which)."""
    if profiler_s and launch_event_s <= 1.1 * profiler_s:
        return profiler_s, "profiler"
    return launch_event_s, "events"


def span(name: str):
    """A wrapper that records each call as the profiler range `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner
    return wrap


class OpEvents:
    """CUDA events around each call of patched kernel wrappers."""

    def __init__(self):
        self.calls: Dict[str, List] = defaultdict(list)

    def wrap(self, name: str):
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.calls[name].append((e0, e1))
                return out
            return inner
        return wrap

    def seconds(self, name: str) -> float:
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in
                   self.calls[name]) / 1e3


@contextlib.contextmanager
def module_span(module: torch.nn.Module, name: str):
    """Record each forward of `module` as the profiler range `name`, by
    hooks of the benchmark's own."""
    open_ranges = []

    def pre(mod, args):
        r = torch.profiler.record_function(name)
        r.__enter__()
        open_ranges.append(r)

    def post(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)
    h0 = module.register_forward_pre_hook(pre)
    h1 = module.register_forward_hook(post)
    try:
        yield
    finally:
        h0.remove()
        h1.remove()


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _on_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _annotation(evt) -> bool:
    """A range of ours (or the profiler's) drawn on the device's
    timeline: no kernel."""
    return (getattr(evt, "is_user_annotation", False)
            or evt.name.startswith("portbench.")
            or evt.name.startswith("ProfilerStep"))


def _is_device(evt) -> bool:
    """A kernel, copy or set on the device."""
    return _on_device(evt) and not _annotation(evt)


WINDOW = "portbench.window"


GAPS_NAMED = 2000    # the longest idle gaps attributed one by one


def innermost(host, mids):
    """For each time in `mids`, the name of the shortest host range
    covering it (None where none does). host: (starts, ends, names)."""
    import numpy as np
    starts, ends, names = host
    out = []
    for k in range(0, len(mids), 256):
        m = np.asarray(mids[k:k + 256])[:, None]
        cover = (starts[None] <= m) & (ends[None] > m)
        dur = np.where(cover, (ends - starts)[None], np.inf)
        j = dur.argmin(1)
        out += [names[jj] if cover[r, jj] else None for r, jj in enumerate(j)]
    return out


def busy_within(dev_sorted, a: float, b: float) -> float:
    """Union length of the device intervals (sorted by start) inside
    [a, b)."""
    import bisect
    starts = dev_sorted[0]
    hi = bisect.bisect_left(starts, b)
    return stats.union_length((max(s, a), min(e, b)) for s, e in
                              zip(dev_sorted[0][:hi], dev_sorted[1][:hi])
                              if e > a)


def read(prof) -> Dict:
    """The traced window (the range `WINDOW` around the traced work):
    busy seconds (union of device intervals), window seconds, device time
    by operation, the device busy time inside each of our ranges and the
    device time of each operator's kernels (its `device_time_total`),
    and the idle gaps by the innermost host range that covers each gap's
    middle (the longest `GAPS_NAMED` gaps; the rest in one entry)."""
    import numpy as np
    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} {WINDOW} ranges in the trace")
    t0, t1 = win[0].time_range.start, win[0].time_range.end
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1))
                 for e in events if _is_device(e)
                 and e.time_range.end > t0 and e.time_range.start < t1)
    by_op = defaultdict(float)
    for e in events:
        if _is_device(e):
            by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    busy = stats.union_length(dev) / 1e6
    hs = [e for e in events if not _on_device(e) and e.name != WINDOW]
    host = (np.array([e.time_range.start for e in hs], dtype=np.float64),
            np.array([e.time_range.end for e in hs], dtype=np.float64),
            [e.name for e in hs])
    gaps = sorted(stats.gaps(dev, t0, t1), key=lambda g: g[0] - g[1])
    named, rest = gaps[:GAPS_NAMED], gaps[GAPS_NAMED:]
    idle = defaultdict(float)
    for (s, e), what in zip(named, innermost(host, [0.5 * (s + e)
                                                  for s, e in named])):
        idle[what or "host outside any traced range"] += (e - s) / 1e6
    if rest:
        idle[f"the {len(rest)} shortest gaps"] += sum(e - s for s, e in
                                                      rest) / 1e6
    dev_sorted = ([s for s, _ in dev], [e for _, e in dev])
    ranges = defaultdict(float)
    for e in events:        # our ranges: the kernels' busy time inside
        if _on_device(e) and _annotation(e):
            ranges[e.name] += busy_within(dev_sorted, e.time_range.start,
                                          e.time_range.end) / 1e6
    for row in prof.key_averages():
        if row.key.startswith("portbench."):
            continue
        t = getattr(row, "device_time_total", None)
        if t is None:
            t = getattr(row, "cuda_time_total", 0.0)
        ranges[row.key] = t / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    worst = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=(t1 - t0) / 1e6,
                device_ops=[[n[:120], t] for n, t in top],
                idle_gaps=[[n[:120], t] for n, t in worst],
                range_device_s=dict(ranges), device_events=len(dev))
