"""OcRFDet detector assembly (counterpart of
ocrfdet_tpu/models/detector.py).

ResNet backbone -> CustomFPN (per camera) -> view transformer with the
stereo cost volume (kernel K1): with `with_ocrf` the OcRF view
transformer (LSS splat K2, HT pool K3, NeRF alphas sampled by K4, HOA,
fusion and gates; models/ocrf/), else the LSS view transformer and its
splat (K2) -> per-frame BEV pre-process -> temporal concat ->
CustomResNet + FPN_LSS -> CenterHead.

Batch layout (channel-last, as the JAX package):
  imgs          [B, F, N, H, W, 3]   F = num_frames (+1 stereo ref)
  rots/intrins/post_rots [B, F, N, 3, 3]; trans/post_trans [B, F, N, 3]
  bda           [B, 3, 3]
  k2s_sensor    [B, F, N, 4, 4]  key->sweep sensor transforms
  with_prev     []  scalar {0., 1.}

Frames run oldest first; the stereo reference frame goes through the
stem only; the cost volume of frame f is built from (stem_f, stem_{f+1})
with k2s_sensor[:, f] and frame f's cameras, and is detached; non-key BEV
features are detached and multiplied by `with_prev`. The conv towers run
in `cfg.compute_dtype` under autocast; geometry, the cost volume, the
depth softmax, the splat, the HT pool and the point sampling run in
fp32.

In train mode (`model.train()`) BatchNorm normalises with batch
statistics and moves its running statistics (flax's update, models/
norm.py) in every frame, the ASPP applies dropout, the image backbone's
blocks are checkpointed when `cfg.backbone.remat`, every frame but the
key frame runs under `torch.no_grad()` (the JAX package's
stop_gradient), and the key frame adds the OcRF render branch's outputs
to aux; a training model is built with `render_heads=True`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import OcRFDetConfig
from ..geometry.transforms import camera_mlp_input
from ..ops.cost_volume import stereo_cost_volume
from .centerhead import CenterHead
from .fpn import CustomFPN, FPN_LSS
from .resnet import CustomResNet, ResNet
from .ocrf.view_transformer_ocrf import OcRFViewTransformer
from .view_transformer import (CameraParams, LSSViewTransformer,
                               towers_autocast)


def check_supported(cfg: OcRFDetConfig) -> None:
    """Raise on the parts of the config this port does not run yet."""
    p = cfg.parallel
    if p.space_axis > 1 and (p.shard_cameras or p.shard_vt or p.shard_bev
                             or p.shard_render):
        raise NotImplementedError(
            "spatial sharding (parallel.space_axis > 1) is not ported yet")
    if cfg.vt.renderer not in ("dense", "xla", "pallas"):
        raise ValueError(f"vt.renderer {cfg.vt.renderer!r}: 'dense', 'xla' "
                         f"or 'pallas' expected")


class OcRFDet(nn.Module):
    def __init__(self, cfg: OcRFDetConfig, render_heads: bool = False):
        """`render_heads`: build the OcRF render branch's heads, which
        only training runs."""
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.img_backbone = ResNet(cfg.backbone.depth,
                                   cfg.backbone.out_indices,
                                   remat=cfg.backbone.remat)
        ch = self.img_backbone.stage_channels
        self.img_neck = CustomFPN(
            [ch[i] for i in cfg.backbone.out_indices[1:]],
            out_channels=cfg.vt.in_channels)
        if cfg.with_ocrf:
            self.img_view_transformer = OcRFViewTransformer(
                cfg.grid, cfg.vt, cfg.data.input_size, render_heads)
        else:
            self.img_view_transformer = LSSViewTransformer(
                cfg.grid, cfg.vt, cfg.data.input_size)
        c = cfg.vt.out_channels
        self.pre_process = CustomResNet(c, (c,), num_layer=(2,), stride=(1,),
                                        backbone_output_ids=(0,))
        cin = c * cfg.num_frames
        chans = tuple(cin * m // 2 for m in cfg.bev_encoder.channel_mults)
        self.img_bev_encoder_backbone = CustomResNet(
            cin, chans, cfg.bev_encoder.num_layer, cfg.bev_encoder.stride)
        self.img_bev_encoder_neck = FPN_LSS(
            chans[0] + chans[2], cfg.bev_encoder.neck_out_channels)
        self.pts_bbox_head = CenterHead(cfg.head)

    @property
    def lss(self) -> LSSViewTransformer:
        vt = self.img_view_transformer
        return vt.lss if self.cfg.with_ocrf else vt

    def image_encoder(self, imgs, stem_only: bool = False):
        """imgs [B,N,H,W,3] -> (fpn [B,N,C,h,w] or None, stem
        [B,N,C0,h0,w0]), NCHW."""
        B, N, H, W, C = imgs.shape
        x = imgs.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
        if stem_only:
            stem = self.img_backbone(x, stem_only=True)
            return None, stem.reshape(B, N, *stem.shape[1:])
        feats = self.img_backbone(x)
        fpn = self.img_neck(feats[1:])
        return (fpn.reshape(B, N, *fpn.shape[1:]),
                feats[0].reshape(B, N, *feats[0].shape[1:]))

    def _frame_cams(self, batch, f) -> CameraParams:
        return CameraParams(
            rots=batch["rots"][:, f], trans=batch["trans"][:, f],
            intrins=batch["intrins"][:, f],
            post_rots=batch["post_rots"][:, f],
            post_trans=batch["post_trans"][:, f], bda=batch["bda"])

    def _cost_volume(self, stem, stem_prev, batch, cams, f):
        """[B,N,C,h,w] stems -> softmaxed volume [B*N, D, Hc, Wc]."""
        cfg = self.cfg
        pool = cfg.vt.depthnet.cv_downsample // 4

        def channel_last(t):
            B, N = t.shape[:2]
            t = t.reshape(B * N, *t.shape[2:])
            if pool > 1:
                t = F.avg_pool2d(t, pool, pool)
            return t.permute(0, 2, 3, 1).reshape(B, N, *t.shape[2:],
                                                 t.shape[1])
        # prev goes in as it is: the cost volume rounds it to bf16
        cv = stereo_cost_volume(
            channel_last(stem).float(), channel_last(stem_prev),
            self.lss.cv_frustum, batch["k2s_sensor"][:, f],
            cams.intrins, cams.post_rots, cams.post_trans,
            cfg.data.input_size, cfg.vt.depthnet.cost_volume_bias)
        B, N = cv.shape[:2]
        return cv.reshape(B * N, *cv.shape[2:]).to(self.dtype)

    def set_dropout_generator(self, generator) -> None:
        """The generator of the ASPP's dropout masks in train mode."""
        aspp = self.lss.depth_net.aspp
        if aspp is not None:
            aspp.generator = generator

    def _frame(self, batch, f, is_key, stem_prev, key_cams, towers):
        """One temporal frame: (bev [B,C,Y,X] after the pre-process, aux,
        stem)."""
        cfg = self.cfg
        with towers():
            fpn, stem = self.image_encoder(batch["imgs"][:, f])
        cams = self._frame_cams(batch, f)
        mlp_input = camera_mlp_input(
            key_cams.rots, key_cams.trans, cams.intrins, cams.post_rots,
            cams.post_trans, batch["bda"]).float()
        cv = None
        if cfg.use_stereo and stem_prev is not None:
            cv = self._cost_volume(stem.detach(), stem_prev, batch, cams, f)
        if cfg.with_ocrf:
            bev, aux = self.img_view_transformer(
                fpn, cams, mlp_input, cv, towers, batch=batch, is_key=is_key)
        else:
            with towers():
                depth, semantic, context = self.img_view_transformer(
                    fpn, mlp_input, cost_volume=cv)
            bev = self.img_view_transformer.splat(depth, context, cams) \
                .permute(0, 3, 1, 2)
            aux = dict(depth=depth, semantic=semantic)
        with towers():
            bev = self.pre_process(bev)[0]
        if is_key:          # for GeoEnhDet's distillation
            aux["fpn_key"] = fpn
        return bev, aux, stem

    def forward(self, batch: Dict[str, torch.Tensor]):
        """Returns (preds, aux): preds is one dict per task of
        channel-last [B,H,W,ch] maps; aux holds the key frame's depth
        [B,N,h,w,D], semantic [B,N,h,w,2] and FPN features fpn_key
        [B,N,C,h',w'] and, with `with_ocrf`, its bev_mask_logit and
        opacity_bev_logit [B,Y,X,1] and, in train mode, the render
        branch's outputs."""
        cfg = self.cfg
        imgs = batch["imgs"]
        F_total = imgs.shape[1]
        key_cams = self._frame_cams(batch, 0)

        def towers():
            return towers_autocast(imgs.device, self.dtype)
        stem_prev = None
        bev_feats = []          # temporal frames only, oldest first
        key_aux: Dict[str, torch.Tensor] = {}
        for f in range(F_total - 1, -1, -1):
            is_key = f == 0
            # only the key frame is differentiated (the JAX package's
            # stop_gradient on every other frame)
            with torch.set_grad_enabled(is_key and torch.is_grad_enabled()):
                if cfg.use_stereo and f == F_total - 1:
                    with towers():
                        _, stem_prev = self.image_encoder(imgs[:, f],
                                                          stem_only=True)
                    stem_prev = stem_prev.detach()
                    continue
                bev, aux, stem = self._frame(batch, f, is_key, stem_prev,
                                             key_cams, towers)
            if is_key:
                key_aux = aux
            else:
                bev = bev.detach() * batch["with_prev"].to(bev.dtype)
            bev_feats.append(bev)
            stem_prev = stem.detach()
        # channel concat, oldest..key, as the reference
        bev_cat = torch.cat(bev_feats, dim=1)
        with towers():
            feats = self.img_bev_encoder_backbone(bev_cat)
            x = self.img_bev_encoder_neck(feats[0], feats[2])
            preds = self.pts_bbox_head(x)
        return preds, key_aux
