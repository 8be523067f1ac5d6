"""The NMS pair tests as suppression rows (`ops/nms.py::nms_rows`, kernel
`csrc/nms.cu`) and the host's greedy scan over them
(`csrc/nms.cpp::nms_scan_rows`).

On the CPU: the scan over `nms_rows_plain`'s rows gives exactly the
served set of the host's pair tests (`multi_task_nms` without rows, on
the C++ path) and of the benchmark's frozen reference
(`portbench/ref/ops/nms.py`), on flagship-sized decodes (6 tasks, K 500,
the flagship's thresholds and Scale-NMS factors), on bf16-rounded
scores whose tied boxes overlap, with no valid box, with every box
valid, with `pre_max_size` below K and a small `post_max_size`, and a
circle pair exactly at the radius; the `no_suppression` fault still
takes hold where rows are given. The plain rows equal, bit for bit, the
rows of the host's pair tests (`pair_test_rows`); no clip can pass the
kernel's vertex buffer; and the plain version counts the kernel's
operations as its code does them.

On the card (marker `cuda`, skipped without CUDA; this file imports no
JAX, so it runs with `--noconftest`): the kernel's rows equal
`nms_rows_plain`'s and the host pair tests' bit for bit at batch 1 and 4
on the flagship's decode, `entry.infer` launches it once a request and
serves the reference's NMS of its own head maps, and a fault inside the kernel
comes to light at `torch.cuda.synchronize()`.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ocrfdet_tpu_torch import entry
from ocrfdet_tpu_torch.config import ocrfdet_config, tiny_config
from ocrfdet_tpu_torch.core.coder import DecodedBoxes
from ocrfdet_tpu_torch.ops import nms
from ocrfdet_tpu_torch.utils import spans
from portbench import faults
from portbench.ref.ops import nms as ref_nms

ROOT = Path(__file__).resolve().parent.parent
HEAD = ocrfdet_config(batch_size=1).head


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode(seed, B=1, K=500, spread=20.0, levels=None, valid_share=0.9):
    """Flagship-like decoded tasks: each sample's boxes around a centre
    (spread m), sizes around 1.6 m, any yaw, scores rounded through bf16
    (to `levels` steps where given, so that many ties overlap)."""
    g = np.random.default_rng(seed)
    out = []
    for task in HEAD.tasks:
        ncls = len(task.class_names)
        c = (g.normal(0, spread, (B, 1, 2))
             + g.normal(0, spread / 3, (B, K, 2)))
        boxes = np.concatenate([
            c, g.normal(0, 1, (B, K, 1)),
            np.exp(g.normal(0.5, 0.5, (B, K, 3))),
            g.uniform(-np.pi, np.pi, (B, K, 1)),
            g.normal(0, 1, (B, K, 2))], -1).astype(np.float32)
        scores = torch.from_numpy(g.uniform(0, 1, (B, K)).astype(np.float32))
        if levels:
            scores = (scores * levels).round() / levels
        scores = scores.bfloat16().float()
        labels = torch.from_numpy(g.integers(0, ncls, (B, K)))
        valid = torch.from_numpy(g.uniform(0, 1, (B, K)) < valid_share)
        out.append(DecodedBoxes(torch.from_numpy(boxes), scores, labels,
                                valid))
    return out


def _host(decoded):
    return [{k: v.numpy() for k, v in d._asdict().items()} for d in decoded]


def _sample(host, b):
    return [{k: v[b] for k, v in d.items()} for d in host]


def _task_rows(rows, b):
    return list(rows.numpy().view(np.uint64)[:, b])


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores",
                                                    "labels"))


def _check_sets(decoded, head=HEAD, with_ref=True):
    """Every sample's set from the rows equals the host's pair tests' (and
    the reference's); returns the sets."""
    rows = nms.nms_rows(decoded, head)
    host = _host(decoded)
    sets = []
    for b in range(decoded[0].boxes.shape[0]):
        tr = _sample(host, b)
        want = nms.multi_task_nms(tr, head)
        got = nms.multi_task_nms(tr, head, rows=_task_rows(rows, b))
        assert _same(got, want)
        if with_ref:
            assert _same(got, ref_nms.multi_task_nms(tr, head))
        sets.append(got)
    return rows, sets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rows_give_the_host_set_on_flagship_decodes(seed):
    decoded = _decode(seed, spread=[20.0, 10.0, 40.0, 14.0][seed])
    rows, _ = _check_sets(decoded)
    # every box suppresses itself (the diagonal), and others besides
    bits = rows.numpy().view(np.uint64)
    assert np.unpackbits(bits.view(np.uint8)).sum() > 6 * 500


@pytest.mark.parametrize("seed", [0, 1])
def test_tied_bf16_scores_whose_boxes_overlap(seed):
    decoded = _decode(seed, K=160, spread=3.0, levels=8)
    scores = decoded[0].scores[0].numpy()
    assert len(np.unique(scores)) <= 9
    rows, _ = _check_sets(decoded)
    K = len(scores)
    bits = np.unpackbits(rows[0, 0].numpy().view(np.uint8),
                         bitorder="little").reshape(K, -1)[:, :K]
    tied = scores[:, None] == scores[None, :]
    np.fill_diagonal(tied, False)
    assert (bits.astype(bool) & tied).sum() > 20   # tied pairs that overlap


@pytest.mark.parametrize("kind", ["no_valid", "all_valid", "pre_max_size",
                                  "post_max_size", "one_task_empty"])
def test_edge_cases(kind):
    head = HEAD
    decoded = _decode(7, K=200, spread=6.0,
                      valid_share={"no_valid": 0.0,
                                   "all_valid": 1.0}.get(kind, 0.9))
    if kind == "pre_max_size":
        head = dataclasses.replace(HEAD, pre_max_size=120)
    if kind == "post_max_size":
        head = dataclasses.replace(HEAD, post_max_size=5)
    if kind == "one_task_empty":
        decoded[2].valid.zero_()
        decoded[3].valid.zero_()
    with spans.recording() as rec:
        _, sets = _check_sets(decoded, head)
    n = len(sets[0]["boxes"])
    want_tasks = {"no_valid": 0, "one_task_empty": 4}.get(kind, 6)
    assert rec.counts.get("nms_tasks", 0) == 2 * want_tasks
    assert rec.counts.get("nms_rows_tasks", 0) == want_tasks
    if kind == "no_valid":
        assert n == 0
    if kind == "post_max_size":
        assert n == 6 * 5


def test_circle_pair_exactly_at_the_radius():
    """The circle task's bit is d2 <= radius in fp32: a pair at exactly
    the radius suppresses, one float step further out does not."""
    decoded = _decode(3, K=8, spread=1000.0)
    t = HEAD.nms_type.index("circle")
    r = np.float32(HEAD.circle_nms_min_radius[t])
    root = np.sqrt(r, dtype=np.float32)
    assert root * root == r
    xy = [[100.0 * k, 0.0] for k in range(8)]
    xy[1] = [float(root), 0.0]                                  # d2 == r
    xy[2] = [0.0, 300.0]
    xy[3] = [float(np.nextafter(root, np.float32(2))), 300.0]   # d2 > r
    decoded[t].boxes[0, :, :2] = torch.tensor(xy)
    decoded[t].scores[0] = torch.linspace(0.9, 0.2, 8)
    decoded[t].valid[0] = True
    rows, _ = _check_sets(decoded)
    assert (int(rows[t, 0, 0, 0]) & 0xff) == 0b11
    assert (int(rows[t, 0, 2, 0]) & 0xff) == 0b100
    cands = np.concatenate([decoded[t].boxes[0, :, :2].numpy(),
                            decoded[t].scores[0, :, None].numpy()], -1)
    keep = nms.circle_nms(nms.with_rows(
        cands, rows[t, 0].numpy().view(np.uint64), np.arange(8)), r)
    assert keep.tolist() == [0, 2, 3, 4, 5, 6, 7]
    assert keep.tolist() == nms.circle_nms(cands, r).tolist()


def test_no_suppression_fault_takes_hold_with_rows():
    decoded = _decode(5, K=200, spread=6.0)
    rows = nms.nms_rows(decoded, HEAD)
    tr = _sample(_host(decoded), 0)
    sound = nms.multi_task_nms(tr, HEAD, rows=_task_rows(rows, 0))
    with faults.planted("no_suppression"):
        unsuppressed = nms.multi_task_nms(tr, HEAD)
        got = nms.multi_task_nms(tr, HEAD, rows=_task_rows(rows, 0))
    assert _same(got, unsuppressed)
    assert not _same(got, sound)


def _pair_test_rows(decoded, head=HEAD):
    """[T, B, K, W] uint64: every task's and sample's rows from the
    host's pair tests."""
    host = _host(decoded)
    return np.stack([np.stack([
        nms.pair_test_rows(d["boxes"][b], d["labels"][b], head, t)
        for b in range(len(d["boxes"]))]) for t, d in enumerate(host)])


@pytest.mark.parametrize("seed", [4, 5])
def test_plain_rows_equal_the_host_pair_tests(seed):
    """Bit for bit, every row of every task: the rescale, the fp64 clip
    and the fp32 circle test are the host's."""
    decoded = _decode(seed, spread=[8.0, 25.0][seed - 4])
    rows = nms.nms_rows(decoded, HEAD).numpy().view(np.uint64)
    want = _pair_test_rows(decoded)
    assert np.array_equal(rows, want)
    assert np.unpackbits(want.view(np.uint8)).sum() > 2 * 6 * 500


def test_a_clip_never_passes_the_kernels_vertex_buffer():
    """A Sutherland-Hodgman pass over an n-gon writes one vertex for
    each inside vertex and one for each change of side around it: over
    every inside/outside pattern of every n a pass can meet, at most
    floor(3n/2), so four passes from a quadrilateral reach at most 19,
    the kernel's buffer and the plain version's."""
    for n in range(3, 14):
        for pattern in range(2 ** n):
            inside = [(pattern >> k) & 1 for k in range(n)]
            changes = sum(inside[k] != inside[k - 1] for k in range(n))
            assert sum(inside) + changes <= 3 * n // 2
    n = 4
    for _ in range(4):
        n = 3 * n // 2
    assert n == nms.CLIP_VERTICES == 19
    src = (ROOT / "ocrfdet_tpu_torch/csrc/nms.cu").read_text()
    assert "constexpr int kPoly = 19;" in src


def test_plain_version_counts_the_kernels_operations():
    """Two equal axis-aligned boxes in a rotated task: every pair is
    clipped, no vertex changes side, so each of the four passes tests 1 +
    4 vertices (9 + 4 x 7 fp64) and the shoelace takes 4 x 4 + 1; a pair
    adds its distance test (7), union (2) and quotient (1), a box its
    set-up (40 fp64, 2 fp32). The circle task: 5 fp32 a pair."""
    boxes = torch.tensor([[[0.0, 0.0, 0.0, 2.0, 1.0, 1.0, 0.0, 0.0, 0.0]]
                          * 2])
    labels = torch.zeros((1, 2), dtype=torch.long)
    fac = [1.0] * nms.MAX_CLASSES
    work = {}
    rows = nms.nms_rows_plain([boxes], [labels], [0], [0.5], fac, [-1],
                              work=work)
    assert rows[0, 0, :, 0].tolist() == [0b11, 0b11]
    clip = 4 * (9 + 4 * 7) + 4 * 4 + 1
    assert work == dict(fp32=2 * 2, fp64=2 * 40 + 4 * (7 + clip + 3),
                        near_pairs=4)
    work = {}
    nms.nms_rows_plain([boxes], [labels], [1], [1.0], fac, [0], work=work)
    assert work == dict(fp32=5 * 4)


def test_scan_rows_is_the_greedy_scan():
    """The C++ scan against the greedy loop on random rows, with bits
    set for earlier and for absent boxes."""
    g = np.random.default_rng(0)
    K = 200
    bits = g.uniform(size=(K, K)) < 0.05
    rows = nms._pack(torch.from_numpy(bits)).numpy().view(np.uint64)
    order = g.permutation(K)[:150]
    for max_keep in (1000, 20, 0):
        removed = np.zeros(K, bool)
        want = []
        for a, i in enumerate(order):
            if removed[i] or len(want) == max_keep:
                continue
            want.append(a)
            removed |= bits[i]
        assert nms.scan_rows(rows, order, max_keep).tolist() == want
    with pytest.raises(ValueError, match="outside"):
        nms.scan_rows(rows, np.array([K]), 10)


def test_task_params_of_the_flagship():
    circle, thr, fac, nfac = nms.task_params(HEAD)
    assert circle == [0, 0, 0, 1, 0, 0]
    assert thr == [0.3, 0.1, 0.1, 1.0, 0.1, 0.5]
    assert nfac == [-1, 2, 2, 0, 2, 2]
    assert fac[8:10] == [0.7, 0.7] and fac[40:42] == [4.5, 9.0]
    assert len(fac) == 6 * nms.MAX_CLASSES


def test_cpu_requests_test_their_pairs_on_the_host():
    """On the CPU `entry.infer` builds no rows: every task's NMS tests
    its pairs, and the kernel is never launched."""
    cfg = tiny_config()
    model = entry.build_detector(cfg, device="cpu")
    batch = entry.make_batch(cfg, seed=0, device="cpu")
    launches = nms.ROWS_KERNEL.launches
    tm = {}
    entry.infer(model, batch, timings=tm)
    assert nms.ROWS_KERNEL.launches == launches
    assert "nms_rows_tasks" not in tm["counts"]
    assert not any(s[0] == "ocrfdet.nms.rows" for s in tm["spans"])


# ------------------------------------------------------------ on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flagship_decode(dev, B, seed=0):
    cfg = ocrfdet_config(batch_size=B)
    model = entry.build_detector(cfg, dev, seed=seed)
    batch = entry.make_batch(cfg, seed=seed, batch_size=B, device=dev)
    with torch.inference_mode():
        preds, _ = model(batch)
        return model, batch, preds, entry.decode_all_tasks(
            preds, cfg.head, cfg.grid)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_kernel_rows_equal_the_plain_rows(dev, B):
    _, _, _, decoded = _flagship_decode(dev, B)
    before = nms.ROWS_KERNEL.launches
    rows = nms.nms_rows(decoded, HEAD)
    torch.cuda.synchronize()
    assert nms.ROWS_KERNEL.launches == before + 1
    cpu = [d._replace(**{k: v.cpu() for k, v in d._asdict().items()})
           for d in decoded]
    assert torch.equal(rows.cpu(), nms.nms_rows(cpu, HEAD))
    # and on random decodes whose boxes overlap more
    rnd = [d._replace(**{k: v.to(dev) for k, v in d._asdict().items()})
           for d in _decode(B, B=B, spread=4.0, levels=8)]
    want = nms.nms_rows(_decode(B, B=B, spread=4.0, levels=8), HEAD)
    assert torch.equal(nms.nms_rows(rnd, HEAD).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_kernel_rows_equal_the_host_pair_tests(dev, B):
    """The card's fp64 sincos is not glibc's: on the flagship's decode
    and on random overlapping ones no bit differs all the same."""
    _, _, _, decoded = _flagship_decode(dev, B)
    rnd = _decode(10 + B, B=B, spread=4.0, levels=8)
    for d in (decoded, rnd):
        cpu = [x._replace(**{k: v.cpu() for k, v in x._asdict().items()})
               for x in d]
        gpu = [x._replace(**{k: v.to(dev) for k, v in x._asdict().items()})
               for x in d]
        rows = nms.nms_rows(gpu, HEAD).cpu().numpy().view(np.uint64)
        assert np.array_equal(rows, _pair_test_rows(cpu))


@pytest.mark.cuda
def test_infer_launches_once_and_serves_the_reference_set(dev):
    from portbench import check
    model, batch, _, _ = _flagship_decode(dev, 1)
    before = nms.ROWS_KERNEL.launches
    tm = {}
    preds, _, _, dets = entry.infer(model, batch, timings=tm)
    assert nms.ROWS_KERNEL.launches == before + 1
    assert tm["counts"]["nms_rows_tasks"] == tm["counts"]["nms_tasks"] == 6
    assert any(s[0] == "ocrfdet.nms.rows" for s in tm["spans"])
    want = check.expected_detections(preds, model.cfg.head, model.cfg.grid)
    assert check.set_gap(dets, want) == 0


@pytest.mark.cuda
def test_a_fault_inside_the_kernel_comes_to_light_at_synchronize(dev):
    """A build of the kernel that traps (`-DNMS_ROWS_FAULT`) launches
    without error; the fault is raised at the next synchronize. In a
    process of its own, since the fault spoils its CUDA context."""
    code = textwrap.dedent("""
        import torch
        from ocrfdet_tpu_torch import kernels
        from ocrfdet_tpu_torch.ops import nms
        k = kernels.Kernel(name="nms_rows_fault", source="nms.cu",
                           symbol="nms_rows",
                           argtypes=nms.ROWS_KERNEL.argtypes,
                           replaces="", defines=("NMS_ROWS_FAULT",))
        nms.ROWS_KERNEL = k
        dev = torch.device("cuda")
        boxes = [torch.rand(1, 64, 9, device=dev)] * 6
        labels = [torch.zeros(1, 64, dtype=torch.long, device=dev)] * 6
        rows = nms._nms_rows_op(boxes, labels, *nms.task_params(
            nms_head()))
        print("launched", k.launches, flush=True)
        try:
            torch.cuda.synchronize()
        except RuntimeError as e:
            print("raised at synchronize:", e, flush=True)
    """).replace("nms_head()", "__import__('ocrfdet_tpu_torch.config', "
                 "fromlist=['x']).ocrfdet_config().head")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "launched 1" in res.stdout, res.stdout + res.stderr
    assert "raised at synchronize" in res.stdout, res.stdout + res.stderr
