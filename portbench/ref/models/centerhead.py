"""CenterPoint-style detection head (counterpart of
ocrfdet_tpu/models/centerhead.py): a shared 3x3 ConvBN then, per task,
small conv towers for (reg 2, height 1, dim 3, rot 2, vel 2, heatmap K_t).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch.nn as nn

from ..config import CenterHeadConfig
from .resnet import ConvBN


class SeparateHead(nn.Module):
    def __init__(self, in_ch: int, heads: Tuple[Tuple[str, int], ...],
                 head_conv: int = 64, final_kernel: int = 3,
                 init_bias: float = -2.19, num_convs: int = 2):
        super().__init__()
        self.heads = tuple(heads)
        k = final_kernel
        for name, ch in self.heads:
            c = in_ch
            for i in range(num_convs - 1):
                setattr(self, f"{name}_conv{i}", ConvBN(c, head_conv, k))
                c = head_conv
            out = nn.Conv2d(c, ch, k, padding=k // 2, bias=True)
            # read by utils/weights.py::init_weights
            out.init_bias = init_bias if name == "heatmap" else 0.0
            nn.init.constant_(out.bias, out.init_bias)
            setattr(self, f"{name}_out", out)
        self.num_convs = num_convs

    def forward(self, x) -> Dict[str, object]:
        out = {}
        for name, _ in self.heads:
            y = x
            for i in range(self.num_convs - 1):
                y = getattr(self, f"{name}_conv{i}")(y)
            out[name] = getattr(self, f"{name}_out")(y)
        return out


class CenterHead(nn.Module):
    def __init__(self, cfg: CenterHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.shared_conv = ConvBN(cfg.in_channels, cfg.share_conv_channel, 3)
        for t, task in enumerate(cfg.tasks):
            heads = cfg.common_heads + (("heatmap", len(task.class_names)),)
            setattr(self, f"task{t}", SeparateHead(
                cfg.share_conv_channel, heads, cfg.head_conv_channel,
                cfg.final_kernel, cfg.init_bias, cfg.num_head_convs))

    def forward(self, x) -> List[Dict[str, object]]:
        """x [B, C, H, W]. Returns one dict per task of channel-last
        [B, H, W, ch] maps; heatmap is raw logits."""
        x = self.shared_conv(x)
        return [{k: v.permute(0, 2, 3, 1)
                 for k, v in getattr(self, f"task{t}")(x).items()}
                for t in range(len(self.cfg.tasks))]
