"""Weights: flax variables -> the port's state_dict, and seeded init.

`flax_to_state_dict` is the reverse of ocrfdet_tpu/utils/torch_weights.py.
It takes the JAX package's variables as a nested dict of numpy arrays
({"params": ..., "batch_stats": ...}); the port names its submodules
after flax's scopes, so a flax path `a/b/Conv_0/kernel` becomes the key
`a.b.Conv_0.weight`:
  * conv kernel HWIO -> weight OIHW (a depthwise conv's (kh, kw, 1,
    C) kernel becomes the grouped (C, 1, kh, kw) weight);
  * ConvTranspose kernel (kh, kw, in, out) -> weight (in, out, kh, kw),
    spatially flipped: flax's `ConvTranspose` ('SAME', kernel = stride,
    transpose_kernel=False) gives out[s*m + r] = x[m] * K[k-1-r], while
    torch's `ConvTranspose2d` gives out[s*m + r] = x[m] * W[r];
  * Dense kernel [in,out] -> [out,in];
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var
    (+ num_batches_tracked = 0);
  * the raw parameters in `RAW_PARAMS` (flax `self.param` leaves that
    are not kernels) as they are.
`load_flax_variables` loads the result with strict=True, so a key left
over or missing on either side raises.
"""
from __future__ import annotations

import math
from typing import Collection, Dict, Mapping, Set

import numpy as np
import torch
import torch.nn as nn

# raw flax parameters and their flax init: (kind, argument)
RAW_PARAMS = {
    "height_w": ("normal", 1.0),     # nn.initializers.normal(1.0)
    "height_b": ("zeros", None),
    "row_embed": ("uniform", 1.0),   # nn.initializers.uniform(1.0)
    "col_embed": ("uniform", 1.0),
    "w": ("constant", 0.5),          # LearnedBlend's scalar
}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def flax_to_state_dict(variables: Mapping,
                       conv_transpose: Collection[str] = ()
                       ) -> Dict[str, torch.Tensor]:
    """`conv_transpose`: the scopes (dotted paths) whose 4-D kernels
    belong to a flax `ConvTranspose` (see `conv_transpose_scopes`)."""
    sd: Dict[str, torch.Tensor] = {}

    def key(scope, name):          # a bare module's leaves have no scope
        return f"{scope}.{name}" if scope else name
    for path, a in _flatten(variables.get("params", {})).items():
        scope, _, leaf = path.rpartition(".")
        a = np.asarray(a, dtype=np.float32)
        if leaf == "kernel" and a.ndim == 4 and scope in conv_transpose:
            sd[key(scope, "weight")] = torch.from_numpy(np.array(
                a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1], order="C"))
        elif leaf == "kernel" and a.ndim == 4:
            sd[key(scope, "weight")] = torch.from_numpy(
                np.array(a.transpose(3, 2, 0, 1), order="C"))
        elif leaf == "kernel" and a.ndim == 2:
            sd[key(scope, "weight")] = torch.from_numpy(
                np.array(a.T, order="C"))
        elif leaf == "scale":
            sd[key(scope, "weight")] = torch.from_numpy(a.copy())
        elif leaf == "bias":
            sd[key(scope, "bias")] = torch.from_numpy(a.copy())
        elif leaf in RAW_PARAMS:
            sd[path] = torch.from_numpy(a.copy())
        else:
            raise KeyError(f"unmapped flax parameter {path}")
    for path, a in _flatten(variables.get("batch_stats", {})).items():
        scope, _, leaf = path.rpartition(".")
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise KeyError(f"unmapped flax batch statistic {path}")
        sd[key(scope, name)] = torch.from_numpy(
            np.asarray(a, dtype=np.float32).copy())
        sd[key(scope, "num_batches_tracked")] = torch.tensor(0)
    return sd


def conv_transpose_scopes(model: nn.Module) -> Set[str]:
    """The names of `model`'s ConvTranspose2d submodules."""
    return {name for name, m in model.named_modules()
            if isinstance(m, nn.ConvTranspose2d)}


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax variables into `model` (strict: every key must match)."""
    model.load_state_dict(flax_to_state_dict(
        variables, conv_transpose_scopes(model)), strict=True)
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init on the CPU generator, flax's defaults:
    truncated-normal (lecun) conv/dense/transposed-conv kernels, zero
    biases (or a module's `init_bias`), BN scale 1 / shift 0 / mean 0 /
    var 1, and the raw parameters' own inits (`RAW_PARAMS`)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            # flax's fan_in: the kernel's receptive field x its input
            # features (a ConvTranspose2d weight is (in, out, kh, kw))
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[1]) * (w[0, 0].numel()
                                          if w.dim() > 2 else 1)
            # std of the +-2 sigma truncated normal that has variance 1/fan_in
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            cpu = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                  generator=g)
            w.copy_(cpu)
            if m.bias is not None:
                m.bias.fill_(getattr(m, "init_bias", 0.0))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    for name, p in model.named_parameters():
        kind, arg = RAW_PARAMS.get(name.rsplit(".", 1)[-1], (None, None))
        cpu = torch.empty(p.shape, dtype=torch.float32)
        if kind == "normal":
            p.copy_(cpu.normal_(0.0, arg, generator=g))
        elif kind == "uniform":
            p.copy_(cpu.uniform_(0.0, arg, generator=g))
        elif kind == "zeros":
            p.zero_()
        elif kind == "constant":
            p.fill_(arg)
    return model
