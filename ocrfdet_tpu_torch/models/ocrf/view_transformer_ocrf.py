"""OcRF view transformer (counterpart of
ocrfdet_tpu/models/ocrf/view_transformer_ocrf.py).

Per frame:
  1. the LSS view transformer (`lss`) gives depth, semantic and context;
     depth below depth_threshold / D is zeroed and context is masked
     where the foreground probability is below semantic_threshold;
  2. the LSS splat (kernel K2) and the height-trick pool (kernel K3) of
     the thresholded depth and context onto the BEV grid;
  3. the voxel lift of the HT feature (per-height affine, BatchNorm over
     the height axis, ReLU) and its opacity (`A_MLP`);
  4. NeRF alphas 1 - exp(-sigma) of every camera at full image
     resolution, sampled at the projected voxel points (kernel K4) and
     averaged over the cameras that see each point;
  5. HOA: deformable attention of the opacity (query) over the alphas
     (key/value) at 1/6 scale, added back to the opacity, then the
     opacity U-Net -> BEV opacity logit;
  6. dual LSS/HT fusion, ProbNet (BEV mask logit) and the two gates;
  7. in training, for the key frame only, the render branch: step 4
     samples [alpha, RGB] (the unnormalised images) as one C=4 map, the
     per-voxel Gaussian heads give scale, rotation and colour, one camera
     per sample (`render_cam`) is rendered by the tiled splat renderer
     (kernel K5; the exact dense compositor with `renderer="dense"`)
     with the augmentation folded into K, and by NeRF
     compositing of its full-resolution feature, and `LearnedBlend`
     mixes the two.

With the `space` axis (`space`, parallel/collectives.py::Axis) the
camera axis of x, cams, mlp_input and the cost volume is this rank's
block: the cross-camera sums (the LSS splat, the HT pool, the voxel
sample's sum and count) are `psum`s over the axis, the render branch
takes every rank's FPN features and alphas (`all_gather_cat`) and the
whole frame's cameras (`cams_full`), and with `render_band` each rank
renders one band of the image's rows (`splat_render`).

The render-only heads exist when the module is built with
`render_heads=True` (the trainer's model); an eval model has none, as a
JAX model initialised for eval.

`cfg.ablate` holds the JAX package's profiling seams, each of which
replaces a sub-block by zeros of its output's shape and dtype: "nerf"
the NeRF alphas, "sample" the voxel sampling (K4), "hoa" the deformable
attention (the opacity passes through), "render" the whole render
branch, "splat" the Gaussian render (K5; its zeros are scaled by the
sums of the colours and opacities, so those heads stay in the graph)
and "nerfcomp" the NeRF render of the chosen camera. flax creates a
module's parameters only when it is called, so the module builds
exactly the submodules that the JAX package's init creates for the same
seams and mode (`built_heads`), and the weight bridge and the optimizer
see the same parameter set. The conv towers run under the caller's
autocast (`towers`); geometry, K2, K3, K4, the masked camera mean, the
Gaussian projection and the renderer run in fp32. Module layouts are
NCHW; the BEV output is NCHW [B, C, Y, X], the aux logits and renders
keep the JAX package's channel-last layout.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import GridConfig, ViewTransformerConfig
from ...geometry import frustum as FR
from ...geometry.cameras import splat_camera
from ...ops.ht_pool import ht_pool
from ...ops.point_sample import point_sample
from ...ops.splat.preprocess import (Gaussians2D, preprocess_gaussians,
                                     quat_scale_to_cov3d)
from ...ops.splat.render_dense import render_gaussians_dense
from ...ops.splat.render_tiled import render_gaussians_tiled
from ...parallel.collectives import all_gather_cat, psum
from ...utils.spans import span
from ..fpn import resize_bilinear
from ..norm import BatchNorm2d
from ..view_transformer import CameraParams, LSSViewTransformer
from .deform_attn import DeformableAttention2D
from .fusion import (BEVGeomAttention, DualFeatFusion,
                     LearnedPositionalEncoding, OpacityMask, ProbNet)
from .heads import (MLP2, ColorMLP, LearnedBlend, OpacityMLP,
                    ResizeNetwork, RotationMLP, ScaleMLP, SigmaMLP)
from .hoa import OpacityVoxelToBEV


SEAMS = ("nerf", "render", "sample", "hoa", "splat", "nerfcomp")


def built_heads(ablate, render_heads: bool) -> set:
    """The seam-dependent submodules that the JAX package's init creates
    for `ablate` (`render_heads`: a training model): the NeRF density
    head `sigma` unless "nerf"; the full-resolution `image_feat_resize`
    where the NeRF alphas or the NeRF render call it; the deformable
    attention unless "hoa"; the NeRF render's factor MLPs where the
    render branch runs it."""
    unknown = set(ablate) - set(SEAMS)
    if unknown:
        raise ValueError(f"vt.ablate {sorted(unknown)}: seams are {SEAMS}")
    render = render_heads and "render" not in ablate
    nerfcomp = render and "nerfcomp" not in ablate
    out = set()
    if "nerf" not in ablate:
        out.add("sigma")
    if "nerf" not in ablate or nerfcomp:
        out.add("image_feat_resize")
    if "hoa" not in ablate:
        out.add("defor_cross_attention")
    if nerfcomp:
        out.add("C_MLP_nerf")
    return out


class OcRFViewTransformer(nn.Module):
    def __init__(self, grid: GridConfig, cfg: ViewTransformerConfig,
                 input_size, render_heads: bool = False):
        super().__init__()
        self.grid = grid
        self.cfg = cfg
        self.lss = LSSViewTransformer(grid, cfg, input_size)
        c, Zh = cfg.out_channels, cfg.num_height
        self.register_buffer("ref_points", torch.from_numpy(
            FR.ht_reference_points(cfg.bev_h, cfg.bev_w, Zh,
                                   z_pillar=grid.z[1] - grid.z[0])),
            persistent=False)
        self.fuser = DualFeatFusion(c)
        self.prob = ProbNet(c)
        self.geom_att = BEVGeomAttention()
        self.opacity_gate = OpacityMask()
        self.pos_enc = LearnedPositionalEncoding(c // 2, cfg.bev_h,
                                                 cfg.bev_w)
        self.pos_enc_hoa = LearnedPositionalEncoding(2, cfg.bev_h,
                                                     cfg.bev_w)
        # voxel lift: per-height scalar affine + BN over the height axis
        self.height_w = nn.Parameter(torch.ones(Zh))
        self.height_b = nn.Parameter(torch.zeros(Zh))
        self.height_bn = BatchNorm2d(Zh, eps=1e-5)
        self.A_MLP = OpacityMLP(c)
        built = built_heads(cfg.ablate, render_heads)
        if "image_feat_resize" in built:
            self.image_feat_resize = ResizeNetwork(cfg.in_channels, c)
        if "sigma" in built:
            self.sigma = SigmaMLP(c)
        if "defor_cross_attention" in built:
            self.defor_cross_attention = DeformableAttention2D(
                dim=Zh, dim_head=8, heads=1, downsample_factor=4,
                offset_scale=4.0, offset_kernel_size=6)
        self.OpacityVoxelToBEV = OpacityVoxelToBEV(Zh)
        # the render branch runs (in training, for the key frame)
        self.render_heads = render_heads and "render" not in cfg.ablate
        if self.render_heads:
            self.S_MLP = ScaleMLP(c)
            self.R_MLP = RotationMLP(c)
            self.C_MLP = ColorMLP(c + 3)
            if "C_MLP_nerf" in built:
                self.C_MLP_nerf = MLP2(c + 3, 4, 3)
                self.D_MLP_nerf = MLP2(c + 3, 4, 1)
                self.img_feat_resize1 = MLP2(c + 3, 4, 3)
                self.img_feat_resize2 = MLP2(c + 3, 4, 1)
            self.blend_img = LearnedBlend()
            self.blend_depth = LearnedBlend()
            # metric voxel centres, the Gaussian means [Zh*Nq, 3]
            pc = torch.tensor(grid.pc_range, dtype=torch.float64)
            self.register_buffer("gauss_means", (
                self.ref_points.double() * (pc[3:6] - pc[0:3]) + pc[0:3])
                .reshape(-1, 3).float(), persistent=False)

    @property
    def D(self) -> int:
        return self.lss.D

    def ht_pool(self, depth, context, cams: CameraParams, space=None):
        """Height-trick branch: project the Zh points of every pillar
        into all cameras and pool depth-weighted context at the nearest
        feature pixel / bin (K3). Returns (ht [B,C,Y,X] in context's
        dtype, uvd [B,N,Zh,Nq,3], valid [B,N,Zh,Nq]); with `space` the
        pool is summed over the axis, uvd and valid stay the rank's."""
        cfg = self.cfg
        l2i, aug = FR.ego_to_image(cams.rots, cams.trans, cams.intrins,
                                   cams.post_rots, cams.post_trans, cams.bda)
        uvd, valid = FR.project_points(
            self.ref_points, self.grid.pc_range,
            (self.grid.depth[0], self.grid.depth[1]), l2i, aug,
            self.lss.input_size)
        acc = ht_pool(depth, context, uvd, valid)           # [B, Nq, C]
        if space is not None:
            acc = psum(acc, space)
        B, _, C = acc.shape
        ht = acc.transpose(1, 2).reshape(B, C, cfg.bev_h, cfg.bev_w)
        return ht, uvd, valid

    @staticmethod
    def sample_at_voxels(maps, uvd, valid, space=None):
        """Sample per-camera full-res maps [B,N,H,W,C] at the projected
        voxel points (K4) and average over the cameras that see each
        point. Returns [B, Zh, Nq, C] f32. With `space` the sum and the
        count are summed over the axis before the division."""
        B, N, H, W, C = maps.shape
        Zh, Nq = uvd.shape[2], uvd.shape[3]
        px = (uvd[..., 0] * W).reshape(B, N, Zh * Nq)
        py = (uvd[..., 1] * H).reshape(B, N, Zh * Nq)
        vals = point_sample(maps, px, py).reshape(B, N, Zh, Nq, C)
        vmask = valid[..., None].to(vals.dtype)
        s = (vals * vmask).sum(dim=1)
        cnt = vmask.sum(dim=1)
        if space is not None:
            s, cnt = psum(s, space), psum(cnt, space)
        return s / torch.clamp(cnt, min=1.0)

    def nerf_alphas(self, x):
        """x [B,N,Cin,h,w] FPN features -> alphas [B,N,H,W] f32, where
        H, W = 16h, 16w. Cameras go through in groups so the transient
        full-resolution feature stays at most 8 images large."""
        B, N = x.shape[:2]
        group = max(1, min(N, 8 // max(B, 1)))
        parts = []
        for n0 in range(0, N, group):
            xs = x[:, n0:n0 + group]
            gN = xs.shape[1]
            full = self.image_feat_resize(xs.reshape(B * gN, *xs.shape[2:]))
            sigma = self.sigma(full)
            del full
            a = (1.0 - torch.exp(-sigma.float()))[:, 0]
            parts.append(a.reshape(B, gN, *a.shape[1:]))
        return torch.cat(parts, dim=1)

    def forward(self, x, cams: CameraParams, mlp_input, cost_volume,
                towers: Callable, batch=None, is_key: bool = False,
                space=None, cams_full: CameraParams = None,
                render_band: bool = False):
        """x [B,N,Cin,h,w] FPN features; mlp_input [B,N,27]; cost_volume
        [B*N,D,Hc,Wc] or None; towers() the autocast context of the conv
        towers; batch the request (the render branch reads imgs_wo_norm,
        render_cam and gt_depth). Returns (bev [B,C,Y,X], aux) with aux =
        depth [B,N,h,w,D], semantic [B,N,h,w,2], bev_mask_logit and
        opacity_bev_logit [B,Y,X,1], and in training for the key frame
        the renders of `render_branch`. With `space` N is this rank's
        block of cameras, `cams_full` the frame's cameras and
        `render_band` renders a band of rows per rank."""
        cfg = self.cfg
        ablate = cfg.ablate
        render_on = is_key and self.training and "render" not in ablate
        if render_on and not self.render_heads:
            raise ValueError("training needs the render heads: build the "
                             "model with render_heads=True")
        B = x.shape[0]
        Zh, Y, X = cfg.num_height, cfg.bev_h, cfg.bev_w
        with span("ocrfdet.vt.depthnet"), towers():
            depth, semantic, context = self.lss(x, mlp_input, cost_volume)
        thr = cfg.depth_threshold / self.D
        f_depth = torch.where(depth < thr, torch.zeros_like(depth), depth)
        img_mask = semantic[..., 1:2] >= cfg.semantic_threshold
        f_context = context * img_mask.to(context.dtype)
        cdt = context.dtype                 # the towers' compute dtype

        with span("ocrfdet.vt.splat"):
            lss_feat = self.lss.splat(f_depth, f_context, cams, space) \
                .permute(0, 3, 1, 2)                       # [B,C,Y,X]
        with span("ocrfdet.vt.ht_pool"):
            ht_feat, uvd, valid = self.ht_pool(f_depth, f_context, cams,
                                               space)

        # voxel lift [B,C,Y,X] -> [B,Zh,Nq,C] (fp32), BN over the heights
        with span("ocrfdet.vt.lift"):
            ht_last = ht_feat.float().flatten(2).transpose(1, 2)  # [B,Nq,C]
            vf = (ht_last[:, None] * self.height_w[None, :, None, None]
                  + self.height_b[None, :, None, None])
            voxel_feat = F.relu(self.height_bn(vf))
            with towers():
                opacity = self.A_MLP(voxel_feat)[..., 0]     # [B,Zh,Nq]
        if "nerf" in ablate:                   # profiling-only seam
            alphas = x.new_zeros((B, x.shape[1], *cfg.render_image_size),
                                 dtype=torch.float32)
        else:
            with span("ocrfdet.vt.nerf"), towers():
                alphas = self.nerf_alphas(x)                 # [B,N,H,W]
        if "sample" in ablate:                 # profiling-only seam
            sampled = x.new_zeros((B, Zh, Y * X, 4 if render_on else 1),
                                  dtype=torch.float32)
        else:
            maps = alphas[..., None]
            if render_on:
                imgs_rgb = batch["imgs_wo_norm"].float() / 255.0
                if space is not None:       # the batch holds every camera
                    n = x.shape[1]
                    imgs_rgb = imgs_rgb.narrow(1, space.index * n, n)
                maps = torch.cat([maps, imgs_rgb], dim=-1)
            with span("ocrfdet.vt.sample"):
                sampled = self.sample_at_voxels(maps, uvd, valid, space)
            del maps
        alpha_vox = sampled[..., 0].reshape(B, Zh, Y, X)
        opac_vox = opacity.reshape(B, Zh, Y, X)

        # HOA at 1/6 scale (at least 8, so the stride-4 offset conv has
        # an output), residual add
        ds_hw = (max(Y // 6, 8), max(X // 6, 8))
        with towers():
            with span("ocrfdet.vt.hoa"):
                if "hoa" in ablate:            # profiling-only seam
                    opacity_alpha = opac_vox
                else:
                    op_ds = resize_bilinear(opac_vox, ds_hw)
                    al_ds = resize_bilinear(alpha_vox.to(op_ds.dtype), ds_hw)
                    att = self.defor_cross_attention(op_ds, al_ds)
                    opacity_alpha = resize_bilinear(att, (Y, X)) + opac_vox
                opacity_bev_logit = self.OpacityVoxelToBEV(
                    opacity_alpha.to(cdt), self.pos_enc_hoa(B).to(cdt))

            with span("ocrfdet.vt.fuse"):
                channel_feat = self.fuser(lss_feat, ht_feat)
                bev_mask_logit = self.prob(self.pos_enc(B).to(cdt)
                                           + channel_feat)
                geom_feat = self.geom_att(channel_feat, bev_mask_logit) \
                    * channel_feat
                geom_feat = geom_feat * self.opacity_gate(geom_feat,
                                                          opacity_bev_logit)
        aux: Dict[str, torch.Tensor] = dict(
            depth=depth, semantic=semantic,
            bev_mask_logit=bev_mask_logit.permute(0, 2, 3, 1),
            opacity_bev_logit=opacity_bev_logit.permute(0, 2, 3, 1))
        if render_on:
            band = None
            if space is not None:
                # the render camera is any of the frame's: every rank's
                # FPN features and alphas, and the whole frame's cameras
                x = all_gather_cat(x, space, 1)
                alphas = all_gather_cat(alphas, space, 1)
                cams = cams_full
                band = space if render_band else None
            aux.update(self.render_branch(x, cams, batch, voxel_feat,
                                          opacity, sampled[..., 1:4],
                                          alphas, towers, band))
        return geom_feat, aux

    def render_branch(self, x, cams: CameraParams, batch, voxel_feat,
                      opacity, vox_rgb, alphas, towers: Callable,
                      band=None):
        """Render one camera per sample (`render_cam`) from the voxel
        Gaussians (tiled splat, K5) and by NeRF compositing, and blend
        them. vox_rgb [B,Zh,Nq,3] is the voxels' mean reprojected colour,
        alphas [B,N,H,W] the NeRF alphas. Returns the renders and their
        targets, channel-last: render_img(_g/_n) [B,H,W,3],
        render_depth(_g/_n) [B,H,W], render_gt_img [B,H,W,3],
        render_gt_depth [B,H,W]. With `band` (the `space` axis) the splat
        render is banded (`splat_render`)."""
        cfg = self.cfg
        B = x.shape[0]
        Zh = cfg.num_height
        G = Zh * cfg.bev_h * cfg.bev_w
        H, W = cfg.render_image_size
        cam = batch["render_cam"].long()
        b = torch.arange(B, device=cam.device)
        imgs_rgb = batch["imgs_wo_norm"].float() / 255.0

        def take_cam(t):
            return t[b, cam]

        g_in = voxel_feat.reshape(B, G, -1)
        with towers():
            color = self.C_MLP(torch.cat(
                [g_in, vox_rgb.reshape(B, G, 3).to(g_in.dtype)], -1))
        opac = opacity.reshape(B, G)
        gt_img = take_cam(imgs_rgb)                            # [B,H,W,3]
        if "splat" in cfg.ablate:              # profiling-only seam
            img_g = color.sum().float() * x.new_zeros((B, H, W, 3))
            dep_g = opac.sum().float() * x.new_zeros((B, H, W))
        else:
            img_g, dep_g = self.splat_render(g_in, color, opac, cams,
                                             take_cam, towers, band)
        if "nerfcomp" in cfg.ablate:           # profiling-only seam
            img_n = x.new_zeros((B, H, W, 3))
            dep_n = x.new_zeros((B, H, W))
        else:
            img_n, dep_n = self.nerf_render(x, alphas, gt_img, take_cam,
                                            towers)
        return dict(
            render_img=self.blend_img(img_g, img_n), render_img_g=img_g,
            render_img_n=img_n,
            render_depth=self.blend_depth(dep_g, dep_n),
            render_depth_g=dep_g, render_depth_n=dep_n,
            render_gt_img=gt_img,
            render_gt_depth=take_cam(batch["gt_depth"]))

    def splat_render(self, g_in, color, opac, cams: CameraParams,
                     take_cam: Callable, towers: Callable, band=None):
        """The voxel Gaussians rendered into each sample's chosen camera
        (`take_cam`): (img_g [B,H,W,3], dep_g [B,H,W]).

        With `band` (the `space` axis of S ranks, and H a multiple of
        16 S) rank s renders rows [s Hr, (s + 1) Hr) of the image, Hr =
        H / S: the projected means move up by s Hr rows and an Hr-row
        image is rendered, whose tiles are exactly those rows' tiles of
        the full image (each tile composites on its own), and the bands
        are gathered along H (`all_gather_cat`). Otherwise every rank
        renders the whole image."""
        cfg = self.cfg
        B = g_in.shape[0]
        H, W = cfg.render_image_size
        with towers():
            scaling = self.S_MLP(g_in)
            rotation = self.R_MLP(g_in)

        # the chosen camera's pose in the BDA ego frame, aug folded into K
        rot_c, tran_c, K_c = (take_cam(t) for t in (cams.rots, cams.trans,
                                                     cams.intrins))
        pr_c, pt_c = take_cam(cams.post_rots), take_cam(cams.post_trans)
        c2e = torch.zeros((B, 4, 4), device=g_in.device)
        c2e[:, :3, :3] = cams.bda @ rot_c
        c2e[:, :3, 3] = (cams.bda @ tran_c[..., None])[..., 0]
        c2e[:, 3, 3] = 1.0
        P3 = torch.zeros((B, 3, 3), device=g_in.device)
        P3[:, :2, :2] = pr_c[:, :2, :2]
        P3[:, :2, 2] = pt_c[:, :2]
        P3[:, 2, 2] = 1.0
        sc = splat_camera(c2e, P3 @ K_c, (H, W), znear=cfg.znear,
                          zfar=cfg.zfar)
        cov3d = quat_scale_to_cov3d(rotation.float(), scaling.float())
        g = preprocess_gaussians(self.gauss_means, cov3d, sc)
        if band is not None and H % (16 * band.size):
            band = None                 # the bands must hold whole tiles
        Hr = H if band is None else H // band.size
        if band is not None:
            y0 = float(band.index * Hr)
            g = g._replace(mean2d=g.mean2d - g.mean2d.new_tensor([0.0, y0]))
        if cfg.renderer == "dense":
            # the exact compositor, one sample at a time (no tile cap)
            views = [render_gaussians_dense(
                Gaussians2D(*(f[i] for f in g)), color[i].float(),
                opac[i].float(), Hr, W) for i in range(B)]
            img_g = torch.stack([v[0] for v in views])
            dep_g = torch.stack([v[1] for v in views])
        else:                       # "xla" or "pallas": tiled, kernel K5
            img_g, dep_g, _ = render_gaussians_tiled(g, color.float(),
                                                     opac.float(), Hr, W)
        if band is not None:
            img_g = all_gather_cat(img_g, band, 1)
            dep_g = all_gather_cat(dep_g, band, 1)
        return img_g, dep_g

    def nerf_render(self, x, alphas, gt_img, take_cam: Callable,
                    towers: Callable):
        """NeRF compositing of the chosen camera's full-resolution
        feature: (img_n [B,H,W,3], dep_n [B,H,W]) in fp32."""
        with towers():
            full = self.image_feat_resize(take_cam(x))         # [B,c,H,W]
            alpha_c = take_cam(alphas)[:, None].to(full.dtype)
            fc_in = torch.cat([full, gt_img.permute(0, 3, 1, 2)
                               .to(full.dtype)], dim=1)
            cw = torch.softmax(torch.sigmoid(
                self.C_MLP_nerf.forward_nchw(fc_in)), dim=1)
            radiance = F.relu(self.img_feat_resize1.forward_nchw(fc_in)) * cw
            dw = torch.softmax(F.relu(self.D_MLP_nerf.forward_nchw(fc_in)),
                               dim=1)
            radiance_d = F.relu(
                self.img_feat_resize2.forward_nchw(fc_in)) * dw
            img_n = (alpha_c * radiance).float().permute(0, 2, 3, 1)
            dep_n = (alpha_c * radiance_d)[:, 0].float()
        return img_n, dep_n
