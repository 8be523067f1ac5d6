"""Replay a callable as captured CUDA graphs, and the small constants
that let a graph copy nothing from the host.

    graphs = CudaGraphs(counter="vt_replays")
    out = graphs(fn, module, x, y)

`CudaGraphs` keeps one graph per signature of the tensor arguments
(their shapes, dtypes and device; an argument may be None). The first
call of a signature runs `fn` eagerly on a side stream, on static copies
of the arguments, and returns those outputs; then `torch.cuda.graph`
captures `fn` on the same stream and buffers, with autocast's weight
cache off (autocast regions open and close inside `fn`). A later call
copies its arguments into the static buffers, replays the graph and
returns clones of the static outputs: fresh tensors, which a caller may
keep across calls. A capture error raises.

`fn` must have fixed shapes for fixed input shapes, no host read and no
copy from the host. It reads `module`'s parameters and buffers where
they are: a change in place (`load_state_dict`) is seen by the next
replay; a move (`module.to(...)`) changes their addresses, and the next
call drops every graph and captures again. The kernels' launch counts
(`kernels.Kernel.launches`) count what ran: a capture launches nothing,
a replay adds what its capture would have launched. A replay adds one
to the span recorder's counter `counter` (`utils/spans.py`).

`constant(values, dtype, device)` is a 1-D tensor of Python numbers,
made once per (values, dtype, device) and then reused. `capturable(x)`
says whether a graph may capture work on `x`.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import kernels
from . import spans

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), made on the
    first call of (values, dtype, device) and then the same tensor, a
    normal one even under inference mode. Under torch.compile or
    torch.export a new tensor each call, which the trace holds."""
    values = tuple(values)
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=dtype, device=device)
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=dtype, device=device)
        if type(t) is torch.Tensor:       # not a fake or traced tensor
            _CONSTANTS[key] = t
    return t


def traced(x) -> bool:
    """Whether `x` belongs to a trace: a fake or functional tensor of
    torch.export, or anything under torch.compile."""
    return type(x) is not torch.Tensor or torch.compiler.is_compiling()


def capturable(x) -> bool:
    """Whether a CUDA graph may capture work on `x`: a real tensor on the
    card, outside any trace."""
    return x.is_cuda and not traced(x)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list            # the static input buffers (None where None)
    outputs: object         # the static outputs, `fn`'s structure
    state: list             # (tensor, data_ptr) of the module's state
    launches: list          # (Kernel, launches) that one replay makes


def _signature(args) -> Tuple:
    return tuple(None if a is None else (tuple(a.shape), a.dtype, a.device)
                 for a in args)


def _moved(state) -> bool:
    return any(t.data_ptr() != p for t, p in state)


class CudaGraphs:
    """One captured CUDA graph of `fn` per signature of its arguments
    (see the module's docstring)."""

    def __init__(self, counter: str):
        self.counter = counter
        self.graphs: Dict[Tuple, _Graph] = {}
        self.stream: Optional[torch.cuda.Stream] = None

    def __call__(self, fn: Callable, module: torch.nn.Module, *args):
        key = _signature(args)
        g = self.graphs.get(key)
        if g is not None and _moved(g.state):
            self.graphs.clear()
            g = None
        if g is None:
            return self._capture(key, fn, module, args)
        for dst, src in zip(g.inputs, args):
            if dst is not None:
                dst.copy_(src)
        g.graph.replay()
        for k, n in g.launches:
            k.launches += n
        spans.count(self.counter, 1)
        return pytree.tree_map(torch.clone, g.outputs)

    def _capture(self, key, fn, module, args):
        """Run `fn` once eagerly on the side stream, then capture it there;
        returns the eager run's outputs."""
        dev = next(a.device for a in args if a is not None)
        if self.stream is None or self.stream.device != dev:
            self.stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        inputs = [None if a is None else a.clone() for a in args]
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn(*inputs)
        counted = list(kernels.KERNELS)
        before = [k.launches for k in counted]
        graph = torch.cuda.CUDAGraph()
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(*inputs)
        finally:
            torch.set_autocast_cache_enabled(cache)
        launches = [(k, k.launches - n) for k, n in zip(counted, before)
                    if k.launches != n]
        for k, n in launches:           # captured, not run
            k.launches -= n
        cur.wait_stream(self.stream)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        state = [(t, t.data_ptr()) for t in itertools.chain(
            module.parameters(), module.buffers())]
        self.graphs[key] = _Graph(graph, inputs, outputs, state, launches)
        return out
