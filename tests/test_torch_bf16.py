"""The bf16 path: the tiny OcRF config with `compute_dtype="bfloat16"`
(stereo off) through the eval forward of the port and of the JAX
package on the CPU, from the same weights and request (as
tests/test_torch_ocrf_slice.py, which runs them in fp32).

The two packages give the towers bf16 in different ways. The JAX
package sets each flax module's dtype; the port runs the towers under
torch autocast (`models/view_transformer.py::towers_autocast`). Both
compute convolutions and matrix products from bf16 operands with fp32
sums and keep activations in bf16. Where they differ, an op runs in
fp32 in the port while the reference rounds it to bf16 (on the card,
CUDA autocast computes these in fp32; CPU autocast, which runs here,
keeps them in bf16 like the reference):
  eval and training:
  - the attention softmax of the deformable attention
    (`models/ocrf/deform_attn.py:89`; JAX `deform_attn.py:110`);
  - the softplus of the NeRF density head `SigmaMLP`
    (`models/ocrf/heads.py:49`; JAX's `sigma_mlp`);
  training only (the render branch):
  - the colour and depth factor softmaxes of the NeRF render
    (`models/ocrf/view_transformer_ocrf.py:301,304`; JAX
    `view_transformer_ocrf.py:487,490`);
  - the softplus of the Gaussian scale head `ScaleMLP`
    (`models/ocrf/heads.py:89`), and the sum and rsqrt that normalise
    the rotation quaternion (`models/ocrf/heads.py:102`).
`card_policy` below reproduces CUDA autocast's fp32 ops on the CPU (a
TorchFunctionMode that upcasts the bf16 operands of the ops CUDA
autocast runs in fp32), and counts the ops it upcast: for the eval
forward that is exactly the softmax and the softplus above.

Tolerance, from the measured bf16 spread: per output, the spread is
the larger of the two packages' distance (relative RMS over the
output, to max(1, its max |value|)) between their own bf16 and fp32
outputs. Two evaluations of one function that each round to bf16
independently differ by about sqrt(2) times that spread; a dtype
policy that differs systematically adds to it. So the port's bf16
output, under CPU autocast and under the card's policy, is held to
the JAX package's bf16 output within sqrt(2) x the spread. (Measured:
spreads 1.1e-3 to 3.6e-3, the port's distance to JAX 0.57 to 1.24
times the spread; the card's policy moves no output here, because the
upcast softmax is rounded to bf16 by the product that follows, and
the NeRF alphas do not reach the tiny config's eval outputs.)
"""
import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ocrfdet_tpu import config as jconfig
from ocrfdet_tpu_torch import config as tconfig
from test_torch_ocrf_slice import AUX_KEYS, _run_both

# ops that CUDA autocast computes in fp32 and that the port's towers can
# reach (PyTorch's CUDA autocast fp32 lists)
CUDA_FP32_OPS = {
    torch.softmax: "softmax", torch.Tensor.softmax: "softmax",
    F.softmax: "softmax", torch.log_softmax: "log_softmax",
    F.log_softmax: "log_softmax", F.softplus: "softplus",
    torch.exp: "exp", torch.Tensor.exp: "exp", torch.log: "log",
    torch.Tensor.log: "log", torch.log1p: "log1p", torch.rsqrt: "rsqrt",
    torch.Tensor.rsqrt: "rsqrt", torch.pow: "pow", torch.Tensor.pow: "pow",
    torch.Tensor.__pow__: "pow", torch.sum: "sum", torch.Tensor.sum: "sum",
    torch.cumsum: "cumsum", torch.Tensor.cumsum: "cumsum",
    F.layer_norm: "layer_norm", F.group_norm: "group_norm",
    torch.reciprocal: "reciprocal", torch.Tensor.reciprocal: "reciprocal",
    torch.prod: "prod", torch.Tensor.prod: "prod",
}


class CardPolicy(TorchFunctionMode):
    """Under CPU autocast, run the ops of CUDA_FP32_OPS on fp32 copies of
    their bf16 operands, as CUDA autocast does; count them by name."""

    def __init__(self):
        super().__init__()
        self.upcast = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = CUDA_FP32_OPS.get(func)
        if name and torch.is_autocast_enabled("cpu") and any(
                isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                for a in args):
            self.upcast[name] += 1
            args = tuple(a.float() if isinstance(a, torch.Tensor)
                         and a.dtype == torch.bfloat16 else a for a in args)
        return func(*args, **kwargs)


def _outputs(preds, aux):
    """{name: f32 numpy} of the head maps and AUX_KEYS, either package."""
    out = {f"task{t}/{k}": p[k] for t, p in enumerate(preds) for k in p}
    out.update({k: aux[k] for k in AUX_KEYS})
    return {k: v.float().numpy() if torch.is_tensor(v)
            else np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for dtype in ("float32", "bfloat16"):
        r = _run_both(jconfig.tiny_config(with_ocrf=True, use_stereo=False,
                                          compute_dtype=dtype),
                      tconfig.tiny_config(with_ocrf=True, use_stereo=False,
                                          compute_dtype=dtype),
                      with_prevs=(1,))
        out[f"jax_{dtype}"] = _outputs(*r["jout"][1])
        out[f"port_{dtype}"] = _outputs(*r["tout"][1])
    policy = CardPolicy()
    with torch.no_grad(), policy:
        preds, aux = r["model"](dict(r["batch"],
                                     with_prev=torch.tensor(1.0)))
    out["card_bfloat16"] = _outputs(preds, aux)
    out["upcast"] = dict(policy.upcast)
    return out


def _rms(a, b, scale):
    return float(np.sqrt(np.mean((a - b) ** 2))) / scale


def test_card_policy_upcasts_the_listed_ops(runs):
    """The eval forward reaches exactly the two ops listed above that
    CUDA autocast computes in fp32 (once per temporal frame)."""
    assert runs["upcast"] == {"softmax": 2, "softplus": 2}


@pytest.mark.parametrize("port", ["port_bfloat16", "card_bfloat16"])
def test_bf16_eval_matches_jax_within_the_spread(runs, port):
    j32, j16 = runs["jax_float32"], runs["jax_bfloat16"]
    t32, t16 = runs["port_float32"], runs[port]
    assert set(t16) == set(j16)
    for k in j16:
        scale = max(1.0, float(np.abs(j32[k]).max()))
        spread = max(_rms(j16[k], j32[k], scale),
                     _rms(runs["port_bfloat16"][k], t32[k], scale))
        # bf16 really ran, and the fp32 outputs agree (rounding)
        assert spread > 1e-4, k
        assert _rms(t32[k], j32[k], scale) < 1e-5, k
        got = _rms(t16[k], j16[k], scale)
        assert got <= np.sqrt(2.0) * spread, (k, got, spread)
