"""The port's one tracing mechanism: named spans and counters at the
layer boundaries of a served request.

    from ..utils import spans
    with spans.span("ocrfdet.vt.splat"):
        ...
    spans.count("nms_kept", len(keep))

A span is on in either of two ways, or both:

  * the profiler is running (`torch.profiler.profile`): the span is a
    `torch.profiler.record_function` range, in the same trace as the
    kernels, on the profiler's clock;
  * a `Recorder` is active (`recording()`; `entry.infer` activates one
    when it is given `timings`): the span appends a record (name,
    parent, request id, start and end in `time.perf_counter` seconds)
    to it, in memory. `count` adds to the recorder's counters.

With neither on, `span` checks two flags and returns one shared null
context, and `count` does nothing. Records hold no tensors. One recorder
is active at a time in a process: a request is served on one thread.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_active: Optional["Recorder"] = None
_requests = itertools.count()


class Recorder:
    """The spans and counters of one request."""

    def __init__(self):
        self.request = next(_requests)
        self.t0 = time.perf_counter()
        # (name, parent, request, start_s, end_s), in the order they end
        self.records: List[Tuple[str, Optional[str], int, float, float]] = []
        self.counts: Dict[str, int] = {}
        self.stack: List[str] = []     # the names of the open spans

    def seconds(self, name: str) -> float:
        """The summed length of the spans called `name`."""
        return sum(e - s for n, _, _, s, e in self.records if n == name)

    def relative(self) -> List[list]:
        """[name, parent, start_s, end_s] of each span, from the
        recorder's start."""
        return [[n, p, s - self.t0, e - self.t0]
                for n, p, _, s, e in self.records]


class _Span:
    __slots__ = ("name", "rec", "prof", "start")

    def __init__(self, name: str, rec: Optional[Recorder], prof: bool):
        self.name, self.rec = name, rec
        self.prof = torch.profiler.record_function(name) if prof else None

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        if self.rec is not None:
            self.rec.stack.append(self.name)
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            end = time.perf_counter()
            rec.stack.pop()
            parent = rec.stack[-1] if rec.stack else None
            rec.records.append((self.name, parent, rec.request, self.start,
                                end))
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def span(name: str):
    """The range `name` around a block (see the module's docstring)."""
    prof = _profiler._is_profiler_enabled
    if _active is None and not prof:
        return _NULL
    return _Span(name, _active, prof)


def count(name: str, n: int) -> None:
    """Add `n` to the active recorder's counter `name`."""
    if _active is not None:
        _active.counts[name] = _active.counts.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Activate a new `Recorder` inside the block."""
    global _active
    prev, _active = _active, Recorder()
    try:
        yield _active
    finally:
        _active = prev


def allocations(device) -> Optional[int]:
    """The caching allocator's count of allocations so far on `device`
    (None off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device).get("allocation.all.allocated")
