"""Per-sample nuScenes training/eval pipeline (host-side, numpy + PIL; a
copy of ocrfdet_tpu/data/pipeline.py, so that the port needs no JAX
package).

One function, `prepare_sample`, replaces the reference pipeline chain
PrepareImageInputs -> LoadAnnotationsBEVDepth -> GetBEVMask ->
ObjectRange/NameFilter -> Collect3D (configs/ocrfdet/ocrfdet.py:168-186)
and additionally bakes the CenterHead targets (the reference generates
them inside the training step, centerpoint_head.py:437-585).

The output dict is the detector's channel-last batch layout (see
data/synthetic.py, which mirrors these shapes); `collate` keeps the
per-task targets as lists and the GT boxes, labels and sample tokens
as host-only lists (`train/trainer.py::HOST_ONLY_KEYS`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ..config import OcRFDetConfig
from ..core import targets as TG
from ..geometry import transforms as T
from . import infos as INF

# ImageNet statistics (mmlabNormalize, RGB order)
IMG_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)


@dataclass
class AugParams:
    resize: float
    resize_dims: tuple      # (W, H) PIL order
    crop: tuple             # (x0, y0, x1, y1)
    flip: bool
    rotate: float           # degrees


def sample_aug(cfg: OcRFDetConfig, rng: np.random.Generator,
               is_train: bool, H: int, W: int) -> AugParams:
    """Reference sample_augmentation (loading.py:901-933)."""
    fH, fW = cfg.data.input_size
    if is_train:
        resize = float(fW) / float(W) + rng.uniform(*cfg.data.resize)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*cfg.data.crop_h)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = cfg.data.flip and bool(rng.integers(0, 2))
        rotate = float(rng.uniform(*cfg.data.rot))
    else:
        resize = float(fW) / float(W) + cfg.data.resize_test
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(cfg.data.crop_h)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip, rotate = False, 0.0
    return AugParams(resize, resize_dims, crop, flip, rotate)


def transform_image(img: Image.Image, aug: AugParams) -> Image.Image:
    img = img.resize(aug.resize_dims).crop(aug.crop)
    if aug.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img.rotate(aug.rotate)


def transform_point_label(pts: np.ndarray, aug: AugParams,
                          input_size) -> tuple:
    """Sparse [K, 4] (x, y, depth, class) -> dense depth+semantic maps
    at input resolution (loading.py point_label_transform:858-891)."""
    H, W = input_size
    p = pts.copy().astype(np.float64)
    p[:, :2] *= aug.resize
    p[:, 0] -= aug.crop[0]
    p[:, 1] -= aug.crop[1]
    if aug.flip:
        p[:, 0] = W - p[:, 0]
    p[:, 0] -= W / 2.0
    p[:, 1] -= H / 2.0
    rot = T.rot2d(np.deg2rad(aug.rotate))
    p[:, :2] = p[:, :2] @ rot.T
    p[:, 0] += W / 2.0
    p[:, 1] += H / 2.0
    coords = p[:, :2].astype(np.int16)
    ok = ((coords[:, 0] >= 0) & (coords[:, 0] < W)
          & (coords[:, 1] >= 0) & (coords[:, 1] < H))
    depth = np.zeros((H, W), np.float32)
    sem = np.zeros((H, W), np.float32)
    depth[coords[ok, 1], coords[ok, 0]] = p[ok, 2]
    sem[coords[ok, 1], coords[ok, 0]] = (p[ok, 3] >= 0).astype(np.float32)
    return depth, sem


def fill_polygon(canvas: np.ndarray, poly: np.ndarray):
    """Scanline fill of a convex polygon [K, 2] (x, y) into canvas
    [H, W] (replaces cv2.fillPoly for the BEV mask)."""
    H, W = canvas.shape
    ys = poly[:, 1]
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())), H - 1)
    K = len(poly)
    for y in range(y0, y1 + 1):
        xs = []
        yc = y + 0.5
        for i in range(K):
            x_a, y_a = poly[i]
            x_b, y_b = poly[(i + 1) % K]
            if (y_a <= yc < y_b) or (y_b <= yc < y_a):
                t = (yc - y_a) / (y_b - y_a)
                xs.append(x_a + t * (x_b - x_a))
        if len(xs) >= 2:
            xs.sort()
            xa = max(int(np.ceil(xs[0] - 0.5)), 0)
            xb = min(int(np.floor(xs[-1] - 0.5)), W - 1)
            if xb >= xa:
                canvas[y, xa:xb + 1] = 1.0


def bev_mask_from_boxes(boxes: np.ndarray, grid) -> np.ndarray:
    """Rasterise BEV box footprints into the BEV grid, matching the
    reference GetBEVMask axis conventions (get_bev_mask.py:56-121: the
    sequence of flips/rotation lands footprint (x, y) on canvas
    (row=y_cell, col=x_cell))."""
    nx, ny = grid.bev_size
    canvas = np.zeros((ny, nx), np.float32)
    for b in boxes:
        x, y, yaw = b[0], b[1], b[6]
        dx, dy = b[3], b[4]
        c, s = np.cos(yaw), np.sin(yaw)
        lx = np.array([dx / 2, dx / 2, -dx / 2, -dx / 2])
        ly = np.array([dy / 2, -dy / 2, -dy / 2, dy / 2])
        px = (x + c * lx - s * ly - grid.x[0]) / grid.x[2]
        py = (y + s * lx + c * ly - grid.y[0]) / grid.y[2]
        fill_polygon(canvas, np.stack([px, py], -1))
    return canvas


def project_boxes_to_image(boxes: np.ndarray, s2ke: np.ndarray,
                           K_aug: np.ndarray, input_size) -> np.ndarray:
    """Axis-aligned 2D mask of projected 3D GT boxes on one camera
    (replaces the reference's precomputed-2D-box Box2dtoMask,
    view_transformer_ocrf.py:1337-1352)."""
    H, W = input_size
    mask = np.zeros((H, W), np.float32)
    if len(boxes) == 0:
        return mask
    e2s = np.linalg.inv(s2ke)
    for b in boxes:
        x, y, z, dx, dy, dz, yaw = b[:7]
        c, s = np.cos(yaw), np.sin(yaw)
        sx = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * dx / 2
        sy = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * dy / 2
        sz = np.array([1, -1, 1, -1, 1, -1, 1, -1]) * dz / 2
        cx = x + c * sx - s * sy
        cy = y + s * sx + c * sy
        cz = z + dz / 2 + sz
        pts = np.stack([cx, cy, cz, np.ones(8)])
        cam = e2s @ pts
        if np.all(cam[2] < 0.1):
            continue
        ok = cam[2] > 0.1
        uvw = K_aug @ cam[:3, ok]
        u = uvw[0] / uvw[2]
        v = uvw[1] / uvw[2]
        u0, u1 = int(max(u.min(), 0)), int(min(u.max(), W - 1))
        v0, v1 = int(max(v.min(), 0)), int(min(v.max(), H - 1))
        if u1 > u0 and v1 > v0:
            mask[v0:v1 + 1, u0:u1 + 1] = 1.0
    return mask


def prepare_sample(cfg: OcRFDetConfig, all_infos: List[dict], index: int,
                   rng: np.random.Generator, is_train: bool = True,
                   data_root: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Build the full per-sample input dict (see module docstring)."""
    info = all_infos[index]
    adj = INF.adjacent_infos(all_infos, index, cfg.num_adj, cfg.use_stereo)
    frames = [info] + adj                    # key, prev..., stereo extra
    F = len(frames)
    N = cfg.data.num_cams
    H, W = cfg.data.input_size
    cams = cfg.data.cams

    imgs = np.zeros((F, N, H, W, 3), np.float32)
    imgs_wo_norm = np.zeros((N, H, W, 3), np.float32)
    rots = np.zeros((F, N, 3, 3), np.float32)
    trans = np.zeros((F, N, 3), np.float32)
    intrins = np.zeros((F, N, 3, 3), np.float32)
    post_rots = np.zeros((F, N, 3, 3), np.float32)
    post_trans = np.zeros((F, N, 3), np.float32)
    k2s = np.tile(np.eye(4, dtype=np.float32), (F, N, 1, 1))
    gt_depth = np.zeros((N, H, W), np.float32)
    gt_semantic = np.zeros((N, H, W), np.float32)

    key_front = info["cams"]["CAM_FRONT"]
    augs = []
    for n, cam in enumerate(cams):
        cd = info["cams"][cam]
        with Image.open(cd["data_path"]) as im:
            # aug is sampled from the RAW size (available pre-decode);
            # draft mode then lets libjpeg decode at the nearest
            # >= resize_dims scale before the exact PIL resize
            aug = sample_aug(cfg, rng, is_train, im.height, im.width)
            augs.append(aug)
            if cfg.data.jpeg_draft:
                im.draft("RGB", aug.resize_dims)
            im = im.convert("RGB")
            img_aug = transform_image(im, aug)
        arr = np.asarray(img_aug, dtype=np.float32)
        imgs_wo_norm[n] = arr
        imgs[0, n] = (arr - IMG_MEAN) / IMG_STD
        pr2, pt2 = T.fold_img_aug(aug.resize, aug.crop, aug.flip,
                                  aug.rotate)
        pr, pt = T.expand_post_3x3(pr2, pt2)
        intrins[:, n] = np.asarray(cd["cam_intrinsic"], np.float32)
        post_rots[:, n] = pr
        post_trans[:, n] = pt

        s2ke = INF.sensor2keyego(cd, key_front)
        rots[0, n] = s2ke[:3, :3]
        trans[0, n] = s2ke[:3, 3]

        if is_train and cfg.with_ocrf:
            pl_path = cd["data_path"].replace(
                "samples/", "samples_point_label/").rsplit(".", 1)[0] + ".npy"
            try:
                pts = np.load(pl_path).astype(np.float64)[:4].T
                gt_depth[n], gt_semantic[n] = transform_point_label(
                    pts, aug, cfg.data.input_size)
            except FileNotFoundError:
                pass

        # adjacent frames: same augmentation per camera
        for f, adj_info in enumerate(adj, start=1):
            acd = adj_info["cams"][cam]
            with Image.open(acd["data_path"]) as im2:
                if cfg.data.jpeg_draft:
                    im2.draft("RGB", aug.resize_dims)
                arr2 = np.asarray(
                    transform_image(im2.convert("RGB"), aug),
                    dtype=np.float32)
            imgs[f, n] = (arr2 - IMG_MEAN) / IMG_STD
            a_s2ke = INF.sensor2keyego(acd, key_front)
            rots[f, n] = a_s2ke[:3, :3]
            trans[f, n] = a_s2ke[:3, 3]

        # key->sweep sensor transforms for the stereo cost volume
        # (prepare_inputs curr2adjsensor, detectors/bevdet.py:445-462)
        chain = [info] + adj
        for f in range(F - 1):
            cur = chain[f]["cams"][cam]
            nxt = chain[f + 1]["cams"][cam]
            cur_s2e, cur_e2g = INF.cam_transforms(cur)
            nxt_s2e, nxt_e2g = INF.cam_transforms(nxt)
            k2s[f, n] = (np.linalg.inv(nxt_e2g @ nxt_s2e)
                         @ cur_e2g @ cur_s2e).astype(np.float32)

    # BDA augmentation + boxes
    boxes, labels = INF.ann_arrays(info)
    if is_train:
        rot_bda = float(rng.uniform(*cfg.bda.rot_lim))
        scale_bda = float(rng.uniform(*cfg.bda.scale_lim))
        flip_dx = bool(rng.random() < cfg.bda.flip_dx_ratio)
        flip_dy = bool(rng.random() < cfg.bda.flip_dy_ratio)
    else:
        rot_bda, scale_bda, flip_dx, flip_dy = 0.0, 1.0, False, False
    bda = T.bda_matrix(rot_bda, scale_bda, flip_dx, flip_dy)
    boxes = T.apply_bda_to_boxes(boxes, rot_bda, scale_bda, flip_dx,
                                 flip_dy)
    # range + name filters (both already in class id space)
    if len(boxes):
        pc = cfg.grid.pc_range
        keep = ((boxes[:, 0] >= pc[0]) & (boxes[:, 0] <= pc[3])
                & (boxes[:, 1] >= pc[1]) & (boxes[:, 1] <= pc[4]))
        boxes, labels = boxes[keep], labels[keep]

    batch: Dict[str, np.ndarray] = dict(
        imgs=imgs, imgs_wo_norm=imgs_wo_norm, rots=rots, trans=trans,
        intrins=intrins, post_rots=post_rots, post_trans=post_trans,
        bda=bda.astype(np.float32), k2s_sensor=k2s,
        gt_depth=gt_depth, gt_semantic=gt_semantic,
    )
    batch["gt_bev_mask"] = bev_mask_from_boxes(boxes, cfg.grid)

    # gravity-centred boxes for target generation
    boxes_g = boxes.copy()
    if len(boxes_g):
        boxes_g[:, 2] += boxes_g[:, 5] * 0.5
    tgt = TG.centerpoint_targets(boxes_g, labels, cfg.head, cfg.grid)
    batch.update(tgt)
    batch["gt_boxes"] = boxes_g
    batch["gt_labels"] = labels

    # render camera + its 2D box mask
    cam_idx = int(rng.integers(0, N)) if is_train else 0
    batch["render_cam"] = np.int32(cam_idx)
    pr = post_rots[0, cam_idx]
    pt = post_trans[0, cam_idx]
    P3 = np.eye(3)
    P3[:2, :2] = pr[:2, :2]
    P3[:2, 2] = pt[:2]
    K_aug = P3 @ intrins[0, cam_idx]
    s2ke4 = np.eye(4)
    s2ke4[:3, :3] = bda @ rots[0, cam_idx]
    s2ke4[:3, 3] = bda @ trans[0, cam_idx]
    batch["render_box_mask"] = project_boxes_to_image(
        boxes_g, s2ke4, K_aug, cfg.data.input_size)
    batch["sample_token"] = info["token"]

    # GeoEnhDet distillation inputs (reference ocrfdet_vggt.py):
    #   kd_pair — random adjacent camera pair, rig neighbour with the
    #     back-camera swap (get_pair_indices, ocrfdet_vggt.py:166-173).
    #   (The reference also plumbs an un-augmented image tensor
    #   `imgs_wo_aug` through its input list, but the teacher actually
    #   consumes the AUGMENTED key tensor — resize_img(img.detach()),
    #   ocrfdet_vggt.py:244 — so that ~13 MB/sample tensor is not
    #   built here; models/geoenh.py reads batch['imgs'][:, 0].)
    if cfg.vggt_teacher is not None:
        i1 = int(rng.integers(0, N)) if is_train else 0
        i2 = (i1 + 1) % N
        if N == 6 and i2 in (3, 5):
            i2 = 8 - i2
        batch["kd_pair"] = np.asarray([i1, i2], dtype=np.int32)
    return batch


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack sample dicts; per-task target lists stay lists."""
    out: Dict[str, np.ndarray] = {}
    keys = samples[0].keys()
    for k in keys:
        v = samples[0][k]
        if k in ("heatmaps", "anno_boxes", "inds", "masks"):
            out[k] = [np.stack([s[k][t] for s in samples])
                      for t in range(len(v))]
        elif k == "sample_token":
            out[k] = [s[k] for s in samples]
        elif k in ("gt_boxes", "gt_labels"):
            out[k] = [s[k] for s in samples]   # ragged; host-side only
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


@dataclass(frozen=True)
class TTASpec:
    """Test-time-aug spec for multi_scale_flip_aug (reference
    MultiScaleFlipAug3D ctor args img_scale / flip)."""
    scales: tuple = (1.0,)
    flip: bool = False


def multi_scale_flip_aug(sample: Dict[str, np.ndarray],
                         spec: TTASpec = TTASpec()
                         ) -> List[Dict[str, np.ndarray]]:
    """Eval-pipeline TTA wrapper — the analog of the reference's
    MultiScaleFlipAug3D (mmdet3d/datasets/pipelines/test_time_aug.py),
    which wraps every test sample in a list of augmented variants.

    The shipped OcRFDet eval config is IDENTITY TTA: one scale,
    flip=False, and the inner transforms are format/collect only
    (configs/ocrfdet/ocrfdet.py:202-212), so the reference's wrapper
    contributes exactly one unmodified variant per sample — which is
    what this returns. A non-identity spec would need aug-consistent
    camera tensors per variant plus a prediction-fusion step that the
    reference never implements for 3D boxes either; refuse it rather
    than silently mis-evaluate.
    """
    if tuple(spec.scales) != (1.0,) or spec.flip:
        raise NotImplementedError(
            "non-identity test-time augmentation (scales != (1.0,) or "
            "flip) is not supported — the reference's shipped eval "
            "config is identity TTA too")
    return [sample]
