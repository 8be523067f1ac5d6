"""Running the frozen reference (`ref/`) on the cell's inputs after the
window: in float32 with TF32 off, or as the control, one precision step
below what the configuration states (the conv towers, which run in
bf16, in fp8 e4m3 with a scale per tensor; the rest, which runs in fp32,
under bf16 autocast). With `count`, FlopCounterMode counts the matrix
products and convolutions, and each call of the five kernels' plain
versions adds its frozen work formula (`work.py`) instead of what its
plain version computes."""
from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

from . import check, trace, weights, work

FP8_MAX = 448.0      # largest float8_e4m3fn
_QUANTIZED = {F.conv2d, F.conv_transpose2d, F.linear, torch.conv2d,
              torch.conv_transpose2d}


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor; the
    gradient passes through the rounding unchanged, as in training with
    fp8 weights and activations."""
    with torch.no_grad():
        s = t.abs().amax().float().clamp_min(1e-30) / FP8_MAX
        q = ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)
    return t + (q - t) if not t.requires_grad else t + (q - t).detach()


class _Fp8Towers(TorchFunctionMode):
    """Inside the towers, the inputs and weights of convolutions and
    linear layers rounded to fp8."""

    def __init__(self):
        super().__init__()
        self.depth = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth and func in _QUANTIZED and len(args) >= 2:
            args = (fp8(args[0]), fp8(args[1])) + tuple(args[2:])
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(mode: str, device):
    """`"reference"`: float32, TF32 off. `"control"`: the control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "reference":
        yield
        return
    from .ref.models import detector
    q = _Fp8Towers()

    @contextlib.contextmanager
    def towers(dev, dtype):
        q.depth += 1
        try:
            with torch.autocast(device_type=torch.device(dev).type,
                                dtype=torch.bfloat16):
                yield
        finally:
            q.depth -= 1
    saved = detector.towers_autocast
    detector.towers_autocast = towers
    try:
        with q, torch.autocast(device_type=torch.device(device).type,
                               dtype=torch.bfloat16):
            yield
    finally:
        detector.towers_autocast = saved


KERNEL_WRAPPERS = {
    "k1": "portbench.ref.ops.cost_volume:cost_volume",
    "k2": "portbench.ref.ops.bev_pool:lss_pool",
    "k3": "portbench.ref.ops.ht_pool:ht_pool_points",
    "k4": "portbench.ref.ops.point_sample:point_sample_points",
}


def _kernel_work(name: str, args, out) -> Dict:
    if name == "k1":
        return work.cost_volume_work(*args[:7], out)
    if name == "k2":
        from .ref.ops.bev_pool import lss_points
        w, pix, cell, feat, cells = lss_points(*args)
        return work.bev_pool_work(w, pix, cell, feat, out, cells)
    if name == "k3":
        return work.ht_pool_work(*args, out)
    return work.point_sample_work(*args, out)


class Counter:
    """FLOPs of the reference's products and convolutions plus the
    kernels' frozen formulas; each kernel call's work."""

    def __init__(self):
        self.mode = None
        self.calls: Dict[str, List[Dict]] = defaultdict(list)
        self.torch_flops = 0

    @contextlib.contextmanager
    def counting(self):
        """Count what runs inside (FlopCounterMode starts from 0 at each
        entry, so each block's count is added on its way out)."""
        self.mode = FlopCounterMode(display=False)
        self._excluded = 0
        with contextlib.ExitStack() as stack:
            for name, target in KERNEL_WRAPPERS.items():
                stack.enter_context(trace.patched(target, self._wrap(name)))
            stack.enter_context(self.mode)
            yield
        self.torch_flops += self.mode.get_total_flops() - self._excluded

    def _wrap(self, name):
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*a):
                before = self.mode.get_total_flops()
                out = fn(*a)
                self._excluded += self.mode.get_total_flops() - before
                with torch.no_grad():
                    self.calls[name].append(_kernel_work(name, a, out))
                return out
            return inner
        return wrap

    def flops(self) -> float:
        total = self.torch_flops
        for ws in self.calls.values():
            total += sum(w["flops"] for w in ws)
        return float(total)


def structure(cfg):
    """The reference's eval detector of `cfg` on the CPU, uninitialised:
    its names and shapes for `weights.draw`."""
    from .ref.models.detector import OcRFDet
    return weights.build(OcRFDet, cfg)


def build_eval(cfg, seed: int, device):
    """The reference's eval detector with the benchmark's weights."""
    model = structure(cfg).to(device)
    weights.load(model, weights.draw(model, seed, device))
    return model.eval()


@torch.no_grad()
def serve(model, batch: Dict, device, mode: str = "reference",
          detections: bool = False):
    """One request through the reference: (preds, key-frame depth, with
    `detections` the detections per sample after decode and NMS, else
    None)."""
    dets = None
    with precision(mode, device):
        preds, aux = model(batch)
        if detections:
            dets = check.expected_detections(preds, model.cfg.head,
                                             model.cfg.grid)
    preds = [{k: v.float() for k, v in t.items()} for t in preds]
    return preds, aux["depth"].float(), dets
