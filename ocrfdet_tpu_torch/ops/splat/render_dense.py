"""Exact dense alpha-compositing renderer (counterpart of
ocrfdet_tpu/ops/splat/render_xla.py::render_gaussians_dense).

Every pixel composites every Gaussian in front-to-back depth order:

    T_i = exp(sum_{j<i} log(1 - alpha_j)),  C = sum_i c_i alpha_i T_i
    D_med = depth of the first i with T_{i+1} < 0.5 (15.0 if none)

O(G x H x W), differentiable by autograd: the reference for the tiled
renderer and K5, used by the tests at small sizes.
"""
from __future__ import annotations

import torch

from .composite import ALPHA_EPS, MEDIAN_DEPTH_DEFAULT
from .preprocess import Gaussians2D


def render_gaussians_dense(g: Gaussians2D, color, opacity, height: int,
                           width: int, bg_color=(0.0, 0.0, 0.0),
                           chunk: int = 256):
    """One view: g fields [G, ...] (no batch dim), color [G, 3], opacity
    [G]. Returns (image [H, W, 3], median depth [H, W])."""
    G = color.shape[0]
    dev = color.device
    px = torch.arange(width, dtype=torch.float32, device=dev).repeat(height)
    py = torch.arange(height, dtype=torch.float32,
                      device=dev).repeat_interleave(width)
    order = torch.argsort(torch.where(g.valid, g.depth, torch.full_like(
        g.depth, float("inf"))), stable=True)
    accum = torch.zeros((px.shape[0], 3), device=dev)
    log_t = torch.zeros_like(px)
    med = torch.full_like(px, MEDIAN_DEPTH_DEFAULT)
    found = torch.zeros_like(px, dtype=torch.bool)
    for k0 in range(0, G, chunk):
        idx = order[k0:k0 + chunk]
        m = g.mean2d[idx]
        dx = px[None, :] - m[:, 0:1]
        dy = py[None, :] - m[:, 1:2]
        con = g.conic[idx]
        power = (-0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy)
                 - con[:, 1:2] * dx * dy)
        alpha = opacity[idx][:, None] * torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.clamp(alpha, max=0.99)
        rad = g.radius[idx][:, None]
        keep = ((dx.abs() <= rad) & (dy.abs() <= rad) & (power <= 0.0)
                & (alpha >= ALPHA_EPS) & g.valid[idx][:, None])
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-alpha)
        cum_in = torch.cumsum(log1m, dim=0)
        excl = torch.cat([torch.zeros_like(cum_in[:1]), cum_in[:-1]], 0)
        t_here = torch.exp(log_t[None, :] + excl)
        accum = accum + (alpha * t_here).t() @ color[idx]
        crossed = (torch.exp(log_t[None, :] + cum_in) < 0.5) & (alpha > 0.0)
        first = torch.argmax(crossed.to(torch.uint8), dim=0)
        any_cross = crossed.any(dim=0)
        med = torch.where(~found & any_cross, g.depth[idx][first], med)
        found = found | any_cross
        log_t = log_t + cum_in[-1]
    bg = torch.tensor(bg_color, dtype=torch.float32, device=dev)
    img = accum + torch.exp(log_t)[:, None] * bg
    return img.reshape(height, width, 3), med.reshape(height, width)
