"""The benchmark's weights: drawn from the seed on the device, in a few
large calls, by the rules of flax's default initialisers that the port's
`utils/weights.py::init_weights` follows (truncated-normal lecun kernels,
zero biases or a module's `init_bias`, BatchNorm scale 1 / shift 0 /
mean 0 / var 1, LayerNorm 1 / 0, the raw parameters' own inits).

`draw(model, seed, device)` names every parameter and BatchNorm buffer
of `model` (a module of the frozen reference, whose names are the
port's) and returns them as one state dict on `device`; the program and
the reference load the same dict. `build(cls, *args)` constructs a
module without running its default initialisers, which `draw`
overwrites anyway.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

# raw flax parameters and their init: (kind, argument)
RAW_PARAMS = {
    "height_w": ("normal", 1.0),
    "height_b": ("zeros", None),
    "row_embed": ("uniform", 1.0),
    "col_embed": ("uniform", 1.0),
    "w": ("constant", 0.5),
}
TRUNC = 0.87962566103423978   # std of the standard normal cut at +-2
_LAYERS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


@contextlib.contextmanager
def no_default_init():
    """Construct layers without their default initialisers."""
    saved = [(c, c.reset_parameters) for c in _LAYERS]
    for c, _ in saved:
        c.reset_parameters = lambda self: None
    try:
        yield
    finally:
        for c, f in saved:
            c.reset_parameters = f


def build(cls, *args, **kwargs) -> nn.Module:
    with no_default_init():
        return cls(*args, **kwargs)


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    n_in = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
    return n_in * (w[0, 0].numel() if w.dim() > 2 else 1)


@torch.no_grad()
def draw(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and BatchNorm statistic of `model`, from `seed`."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 2 ** 20])
    g = torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    spec = {}       # name -> (kind, argument, shape)
    for mname, m in model.named_modules():
        def key(leaf):
            return f"{mname}.{leaf}" if mname else leaf
        if isinstance(m, _LAYERS):
            std = math.sqrt(1.0 / _fan_in(m)) / TRUNC
            spec[key("weight")] = ("lecun", std, m.weight.shape)
            if m.bias is not None:
                spec[key("bias")] = ("constant", getattr(m, "init_bias", 0.0),
                                     m.bias.shape)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            for leaf, val in (("weight", 1.0), ("bias", 0.0),
                              ("running_mean", 0.0), ("running_var", 1.0)):
                t = getattr(m, leaf, None)
                if t is not None:
                    spec[key(leaf)] = ("constant", val, t.shape)
            if getattr(m, "num_batches_tracked", None) is not None:
                spec[key("num_batches_tracked")] = ("count", 0, ())
        for leaf, p in m.named_parameters(recurse=False):
            if key(leaf) in spec:
                continue
            kind, arg = (getattr(m, "raw_inits", {}).get(leaf)
                         or RAW_PARAMS.get(leaf, (None, None)))
            if kind is None:
                raise KeyError(f"no init rule for {key(leaf)}")
            spec[key(leaf)] = (kind, arg, p.shape)
    sizes = {"lecun": 0, "normal": 0, "uniform": 0}
    for kind, _, shape in spec.values():
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    flat = {"lecun": torch.fmod(torch.randn(sizes["lecun"], generator=g,
                                            device=device), 2.0),
            "normal": torch.randn(sizes["normal"], generator=g,
                                  device=device),
            "uniform": torch.rand(sizes["uniform"], generator=g,
                                  device=device)}
    at = dict.fromkeys(sizes, 0)
    sd = {}
    for name, (kind, arg, shape) in spec.items():
        if kind in flat:
            n = math.prod(shape)
            t = flat[kind][at[kind]:at[kind] + n].reshape(shape) * arg
            at[kind] += n
        elif kind == "count":
            t = torch.zeros((), dtype=torch.long, device=device)
        else:
            t = torch.full(shape, float(arg or 0.0), device=device)
        sd[name] = t
    return sd


def load(model: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Load `sd` into `model` (strict: every key must match)."""
    model.load_state_dict(sd, strict=True)
    return model
