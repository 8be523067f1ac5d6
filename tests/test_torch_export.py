"""The kernels as `torch.library` custom ops and the exported inference
program (`ocrfdet_tpu_torch/tools/export.py`), on the CPU.

* `torch.library.opcheck` on every `ocrfdet::` op at small shapes (the
  NMS rows' too): its schema, its fake (shape) implementation against
  the CPU one, its autograd registration and AOT dispatch with dynamic
  shapes;
* the registered backwards on the CPU give the plain versions' bits:
  K2's and K3's the autograd of the plain forward, K4's the plain walk
  in the kernel's order, K5's the written-out plain backward;
* no `torch.autograd.Function` and no branch on the device type is left
  between the model and a kernel;
* the tiny config's exported program gives eager `entry.infer`'s
  forward and decode bit for bit, in this process and, saved and
  loaded, in a fresh one; its graphs hold each of K1-K4's op once per
  temporal frame, the eager launch rule of a request.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.library import opcheck

from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.config import tiny_config
from ocrfdet_tpu_torch.ops import bev_pool as bp
from ocrfdet_tpu_torch.ops import cost_volume as cvm
from ocrfdet_tpu_torch.ops import ht_pool as htp
from ocrfdet_tpu_torch.ops import point_sample as ps
from ocrfdet_tpu_torch.ops.splat import composite as ct
from ocrfdet_tpu_torch.tools import export

ROOT = Path(__file__).resolve().parent.parent
OPS = ("cost_volume", "bev_pool", "bev_pool_backward", "ht_pool",
       "ht_pool_backward", "point_sample", "point_sample_backward",
       "composite_forward", "composite_backward", "nms_rows")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _k2(g, grad=False):
    B, P, npix, C, cells = 2, 300, 11, 3, 40
    w = torch.rand(B, P, generator=g).requires_grad_(grad)
    pix = torch.randint(0, npix, (B, P), generator=g, dtype=torch.int32)
    cell = torch.randint(0, cells + 1, (B, P), generator=g,
                         dtype=torch.int32)
    feat = torch.rand(B, npix, C, generator=g).requires_grad_(grad)
    return w, pix, cell, feat, cells


def _k3(g, grad=False):
    B, N, HW, D, C, Zh, Nq = 2, 3, 20, 6, 5, 4, 7
    dep = torch.rand(B, N, HW, D, generator=g).requires_grad_(grad)
    ctx = torch.rand(B, N, HW, C, generator=g).requires_grad_(grad)
    pix = torch.randint(0, HW, (B, N, Zh, Nq), generator=g,
                        dtype=torch.int32)
    di = torch.randint(0, D, (B, N, Zh, Nq), generator=g, dtype=torch.int32)
    wv = (torch.rand(B, N, Zh, Nq, generator=g) > 0.3).float()
    return dep, ctx, pix, di, wv


def _k4(g, grad=False):
    BN, H, W, C, P = 3, 20, 37, 4, 300
    maps = torch.rand(BN, H, W, C, generator=g).requires_grad_(grad)
    px = torch.rand(BN, P, generator=g) * (W + 2) - 1.5
    py = torch.rand(BN, P, generator=g) * (H + 2) - 1.5
    return maps, px, py


def _k5(g, grad=False):
    NT, M = 4, 130
    a = torch.rand(NT, M, 11, generator=g)
    a[..., :2] *= 16
    a[..., 2:5] = torch.tensor([0.3, 0.01, 0.3])
    a[..., 5] = 8.0
    a[..., 6] *= 10.0
    a[..., 7] *= 0.9
    return a.requires_grad_(grad), 2, 2, 16, 16


def _op_args(name):
    g = _gen(1)
    if name == "cost_volume":
        B, N, H, W, C, D = 1, 2, 5, 8, 8, 4
        az = 1.0 + 0.1 * torch.rand(B, N, H, W, generator=g)
        a2 = torch.rand(B, N, H, W, 2, generator=g) * torch.tensor(
            [W - 1.0, H - 1.0])
        return (torch.rand(B, N, H, W, C, generator=g),
                torch.rand(B, N, H, W, C, generator=g),
                torch.linspace(1.0, 4.0, D), az, torch.zeros(B, N), a2,
                torch.zeros(B, N, 2), 0.5)
    if name.startswith("bev_pool"):
        w, pix, cell, feat, cells = _k2(g, name == "bev_pool")
        if name == "bev_pool":
            return w, pix, cell, feat, cells, None
        return (w, pix, cell, feat,
                torch.rand(w.shape[0], cells, feat.shape[-1], generator=g),
                cells, None)
    if name.startswith("ht_pool"):
        dep, ctx, pix, di, wv = _k3(g, name == "ht_pool")
        if name == "ht_pool":
            return dep, ctx, pix, di, wv
        return (dep, ctx, pix, di, wv,
                torch.rand(dep.shape[0], pix.shape[3], ctx.shape[-1],
                           generator=g))
    if name.startswith("point_sample"):
        maps, px, py = _k4(g, name == "point_sample")
        H, W = maps.shape[1:3]
        if name == "point_sample":
            return maps, px, py
        return px, py, torch.rand(*px.shape, maps.shape[-1], generator=g), H, W
    if name == "nms_rows":
        B, K = 2, 70
        boxes = [torch.rand(B, K, 9, generator=g) * 4 for _ in range(3)]
        labels = [torch.randint(0, 2, (B, K), generator=g) for _ in range(3)]
        fac = [1.0] * 8 + [0.5, 2.0] + [1.0] * 6 + [1.0] * 8
        return boxes, labels, [0, 0, 1], [0.1, 0.3, 1.0], fac, [-1, 2, 0]
    attrs, *dims = _k5(g, name == "composite_forward")
    if name == "composite_forward":
        return (attrs, *dims)
    rgb, med, logt, cross = torch.ops.ocrfdet.composite_forward(attrs, *dims)
    return (attrs, rgb, torch.rand(rgb.shape, generator=g),
            torch.rand(logt.shape, generator=g),
            torch.rand(med.shape, generator=g), cross, *dims)


def test_every_kernel_entry_point_is_a_registered_op():
    import ocrfdet_tpu_torch  # noqa: F401 (registers the ops)
    for name in OPS:
        assert hasattr(torch.ops.ocrfdet, name), name


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    res = opcheck(getattr(torch.ops.ocrfdet, name), _op_args(name))
    assert set(res.values()) == {"SUCCESS"}, res


def test_registered_backwards_give_the_plain_bits():
    g = _gen(2)
    w, pix, cell, feat, cells = _k2(g, grad=True)
    out = bp.bev_pool_points(w, pix, cell, feat, cells)
    cot = torch.rand(out.shape, generator=g)
    want = torch.autograd.grad(
        bp.bev_pool_points_plain(w, pix, cell, feat, cells), (w, feat), cot)
    got = torch.autograd.grad(out, (w, feat), cot)
    assert all(map(torch.equal, got, want))

    dep, ctx, pix, di, wv = _k3(g, grad=True)
    out = htp.ht_pool_points(dep, ctx, pix, di, wv)
    cot = torch.rand(out.shape, generator=g)
    want = torch.autograd.grad(
        htp.ht_pool_points_plain(dep, ctx, pix, di, wv), (dep, ctx), cot)
    got = torch.autograd.grad(out, (dep, ctx), cot)
    assert all(map(torch.equal, got, want))

    maps, px, py = _k4(g, grad=True)
    out = ps.point_sample_points(maps, px, py)
    cot = torch.rand(out.shape, generator=g)
    (got,) = torch.autograd.grad(out, (maps,), cot)
    assert torch.equal(got, ps.point_sample_backward_walk_plain(
        px, py, cot, tuple(maps.shape)))

    attrs, *dims = _k5(g, grad=True)
    outs = ct.composite_tiles(attrs, *dims)
    cots = [torch.rand(t.shape, generator=g) for t in outs]
    (got,) = torch.autograd.grad(outs, (attrs,), cots)
    (want,) = torch.autograd.grad(ct.composite_tiles_plain(attrs, *dims),
                                  (attrs,), cots)
    assert torch.equal(got, want)


def test_no_autograd_function_or_device_branch_before_a_kernel():
    """The wrappers the model calls hold no `torch.autograd.Function`
    (K5's plain version, which any device may run, is the one left) and
    no branch on a tensor's device type: the dispatcher picks the CPU
    or CUDA implementation."""
    functions = []
    for mod in (bp, cvm, htp, ps, ct):
        src = Path(mod.__file__).read_text()
        assert "device.type" not in src, mod.__name__
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.ClassDef) and any(
                    ast.unparse(b).endswith("autograd.Function")
                    for b in node.bases):
                functions.append(f"{mod.__name__}.{node.name}")
    assert functions == ["ocrfdet_tpu_torch.ops.splat.composite."
                         "_CompositePlain"]


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    cfg = tiny_config()
    model = entry.build_detector(cfg, "cpu")
    batch = entry.make_batch(cfg, seed=0, device="cpu")
    ep = export.export_program(model, batch)
    path = tmp_path_factory.mktemp("export") / "tiny.pt2"
    torch.save(batch, path.with_suffix(".batch"))
    torch.export.save(ep, str(path))
    preds, aux, decoded, _ = entry.infer(model, batch)
    eager = (preds, aux, [d._asdict() for d in decoded])
    return dict(cfg=cfg, batch=batch, ep=ep, path=path, eager=eager)


def _assert_same(got, want):
    flat_g, spec_g = torch.utils._pytree.tree_flatten(got)
    flat_w, spec_w = torch.utils._pytree.tree_flatten(want)
    assert spec_g == spec_w
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_exported_program_equals_eager(program):
    with torch.inference_mode():
        got = program["ep"].module()(program["batch"])
    _assert_same(got, program["eager"])


def test_exported_bf16_program_rounds_where_eager_does():
    """The towers' bf16 autocast, traced into the program, casts where
    eager autocast casts: the same bits."""
    cfg = tiny_config(compute_dtype="bfloat16")
    model = entry.build_detector(cfg, "cpu")
    batch = entry.make_batch(cfg, seed=1, device="cpu")
    with torch.inference_mode():
        got = export.export_program(model, batch).module()(batch)
    preds, aux, decoded, _ = entry.infer(model, batch)
    assert preds[0]["heatmap"].dtype == torch.bfloat16
    _assert_same(got, (preds, aux, [d._asdict() for d in decoded]))


def test_exported_graph_holds_the_eager_launch_rule(program):
    """Each of K1-K4 once per temporal frame of a request, no backward
    or K5 op."""
    F = program["cfg"].num_frames
    assert export.custom_op_nodes(program["ep"]) == {
        "cost_volume": F, "bev_pool": F, "ht_pool": F, "point_sample": F}
    inputs = [s for s in program["ep"].graph_signature.input_specs
              if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    assert len(inputs) == len(program["batch"])


def test_saved_program_loads_in_a_fresh_process(program):
    path, out = program["path"], program["path"].with_suffix(".out")
    code = ("import sys, torch\n"
            "from ocrfdet_tpu_torch.tools.export import load_program\n"
            "fn = load_program(sys.argv[1])\n"
            "batch = torch.load(sys.argv[2])\n"
            "with torch.inference_mode():\n"
            "    torch.save(fn(batch), sys.argv[3])\n")
    res = subprocess.run(
        [sys.executable, "-c", code, str(path),
         str(path.with_suffix(".batch")), str(out)], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    _assert_same(torch.load(out), program["eager"])


def test_export_tool_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "p.pt2"
    export.main(["--tiny", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert out.exists() and "inputs: 9" in text
    assert np.isclose(out.stat().st_size / 1e6,
                      float(text.split("exported ")[1].split(" MB")[0]),
                      atol=0.1)


def test_another_tree_registers_its_ops_beside_the_checkouts(tmp_path,
                                                              monkeypatch):
    """`bench_kernel_builds.load_tree` imports another copy of the
    package into this process: its ops register as `ocrfdet_tree<n>::`,
    beside the checkout's `ocrfdet::` (whose name a saved program
    keeps), and its wrappers run its own ops."""
    import importlib
    import shutil
    monkeypatch.syspath_prepend(str(ROOT))
    import bench_kernel_builds as bkb
    shutil.copytree(ROOT / "ocrfdet_tpu_torch",
                    tmp_path / "ocrfdet_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # the tree's wrappers only, without building their kernels
    monkeypatch.setattr(bkb, "wrappers", lambda: {
        k: importlib.import_module(f"{bkb.PKG}.{m}")
        for k, m in bkb.WRAPPERS.items()})
    other = bkb.load_tree(str(tmp_path), 7)
    assert Path(other["k3"].__file__).is_relative_to(tmp_path)
    assert sys.modules["ocrfdet_tpu_torch.ops.ht_pool"] is htp
    assert hasattr(torch.ops.ocrfdet_tree7, "ht_pool")
    dep, ctx, pix, di, wv = _k3(_gen(4))
    assert torch.equal(other["k3"].ht_pool_points(dep, ctx, pix, di, wv),
                       htp.ht_pool_points(dep, ctx, pix, di, wv))
