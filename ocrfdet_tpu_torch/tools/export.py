"""Export the inference program with `torch.export` (counterpart of
tools_tpu/export.py).

    python -m ocrfdet_tpu_torch.tools.export --out build/ocrfdet_infer.pt2 \
        [--tiny] [--batch-size 1] [--device cuda]

The program is `entry.infer` without the copy to the host and without
NMS, which stays on the host as in the JAX package: the eval forward of
seeded random weights and `decode_all_tasks`, traced on `--device` (the
card unless `--device cpu` is given) for one static batch shape. The
kernels are the custom ops `torch.ops.ocrfdet.*`, which the trace keeps
as single nodes, so the program runs the hand-written kernels on the
card and their plain versions on the CPU, as eager does. Its inputs are
the request's tensors (`make_batch` without targets, `with_prev`
among them); the weights are the program's state. `load_program` gives
back a callable on the same batch dict in a fresh process: importing
this package registers the custom ops first.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from .. import entry, kernels
from ..core.coder import decode_all_tasks


class InferProgram(nn.Module):
    """The exported function: batch -> (preds, aux, decoded), the first
    three results of `entry.infer` with each task's decoded boxes as a
    dict of tensors."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]):
        preds, aux = self.model(batch)
        decoded = decode_all_tasks(preds, self.model.cfg.head,
                                   self.model.cfg.grid)
        return preds, aux, [d._asdict() for d in decoded]


# functions the towers reach whose ops CUDA autocast runs in fp32
# (PyTorch's CUDA autocast fp32 list)
CUDA_AUTOCAST_FP32 = (
    F.interpolate, torch.softmax, torch.Tensor.softmax, F.softmax,
    torch.log_softmax, F.log_softmax, F.softplus, torch.exp,
    torch.Tensor.exp, torch.log, torch.Tensor.log, torch.log1p,
    torch.rsqrt, torch.Tensor.rsqrt, torch.pow, torch.Tensor.pow,
    torch.Tensor.__pow__, torch.sum, torch.Tensor.sum, torch.cumsum,
    torch.Tensor.cumsum, F.layer_norm, F.group_norm, torch.reciprocal,
    torch.Tensor.reciprocal, torch.prod, torch.Tensor.prod)


class ExplicitCudaAutocast(TorchFunctionMode):
    """While CUDA autocast is on, hand the functions of
    `CUDA_AUTOCAST_FP32` fp32 copies of their reduced-precision tensor
    arguments: the cast CUDA autocast makes for them, made explicit.
    Eager gives the same bits either way; `torch.export` needs it, since
    it records those ops' outputs in their inputs' dtype and then drops
    a later `.to()` that it takes for a no-op, so that the program fails
    its dtype check at run time."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in CUDA_AUTOCAST_FP32 and torch.is_autocast_enabled("cuda"):
            args = tuple(a.float() if isinstance(a, torch.Tensor)
                         and a.dtype in (torch.bfloat16, torch.float16)
                         else a for a in args)
        return func(*args, **kwargs)


def export_program(model: nn.Module, batch: Dict[str, torch.Tensor]):
    """`torch.export.export` of the eval-mode `model`'s forward and decode
    at `batch`'s shapes and device. It traces without autograd, as
    inference runs, so the model's grad-mode regions (the earlier frames,
    the cost volume) leave no subgraph, and with CUDA autocast's fp32
    casts explicit (`ExplicitCudaAutocast`)."""
    with torch.no_grad(), ExplicitCudaAutocast():
        return torch.export.export(InferProgram(model.eval()), (batch,))


def load_program(path: str) -> Callable:
    """The saved program as a callable on a batch dict."""
    return torch.export.load(path).module()


def custom_op_nodes(program) -> Dict[str, int]:
    """How many nodes of each of the kernels' custom ops
    (`kernels.OPS_NAMESPACE`) the program's graphs hold (the top graph
    and any subgraph)."""
    prefix = f"{kernels.OPS_NAMESPACE}."
    counts: Dict[str, int] = {}
    for module in program.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            name = str(node.target)
            if node.op == "call_function" and name.startswith(prefix):
                op = name.split(".")[1]
                counts[op] = counts.get(op, 0) + 1
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/ocrfdet_infer.pt2")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import ocrfdet_config, tiny_config

    device = entry.resolve_device(args.device)
    cfg = (tiny_config(batch_size=args.batch_size) if args.tiny
           else ocrfdet_config(batch_size=args.batch_size))
    model = entry.build_detector(cfg, device)
    batch = entry.make_batch(cfg, seed=0, batch_size=args.batch_size,
                             device=device)
    t0 = time.perf_counter()
    program = export_program(model, batch)
    t_export = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    inputs = [s.arg.name for s in program.graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    print(f"exported {os.path.getsize(args.out) / 1e6:.1f} MB program -> "
          f"{args.out} in {t_export:.1f} s")
    print(f"inputs: {len(inputs)} ({', '.join(sorted(batch))})")
    print(f"custom ops: {custom_op_nodes(program)}")
    return program


if __name__ == "__main__":
    main()
