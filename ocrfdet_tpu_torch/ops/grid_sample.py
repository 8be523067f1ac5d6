"""Bilinear grid sampling for the deformable attention (counterpart of
ocrfdet_tpu/ops/grid_sample.py::grid_sample_2d).

The JAX package computes it with plain XLA gathers, outside any Pallas
kernel, with torch's `grid_sample` semantics
(tests/test_grid_sample.py::test_grid_sample_matches_torch), so the port
calls `F.grid_sample` itself.
"""
from __future__ import annotations

import torch.nn.functional as F


def grid_sample_2d(img, grid, align_corners=True):
    """img [B,C,H,W]; grid [B,h,w,2] in [-1, 1], (x, y) order; zero
    padding. Returns [B,C,h,w]."""
    return F.grid_sample(img, grid, mode="bilinear",
                         padding_mode="zeros", align_corners=align_corners)
