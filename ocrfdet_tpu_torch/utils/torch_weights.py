"""torchvision ResNet -> the port's image backbone (counterpart of
ocrfdet_tpu/utils/torch_weights.py).

The reference initialises its image backbone from torchvision's
pretrained weights (`torchvision://resnet50`). `convert_resnet` maps a
torchvision state_dict (read from a local .pth file: nothing is
downloaded) onto `models/resnet.py::ResNet`, whose submodules carry the
JAX package's flax scope names:
  conv1 / bn1                       -> stem.Conv_0 / stem.BatchNorm_0
  layer{i}.{j}.conv{k} / bn{k}      -> layer{i}_{j}.ConvBN_{k-1}.Conv_0 /
                                       .BatchNorm_0
  layer{i}.{j}.downsample.0 / .1    -> layer{i}_{j}.downsample.Conv_0 /
                                       .BatchNorm_0
Both sides keep convolutions as OIHW, so the tensors are copied as they
are. The classifier (`fc.*`) and the `num_batches_tracked` counters are
not read; any other key left over, and any key missing, raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn

# depth -> (blocks per stage, convs per block)
_LAYERS = {18: ((2, 2, 2, 2), 2), 34: ((3, 4, 6, 3), 2),
           50: ((3, 4, 6, 3), 3), 101: ((3, 4, 23, 3), 3)}
_BN = ("weight", "bias", "running_mean", "running_var")


def _ignored(key: str) -> bool:
    return key.startswith("fc.") or key.endswith("num_batches_tracked")


def convert_resnet(state_dict: Mapping[str, torch.Tensor],
                   depth: int = 50) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-`depth` state_dict -> the state_dict of
    `ResNet(depth)` (every parameter and BatchNorm buffer; the counters
    `num_batches_tracked` at 0)."""
    if depth not in _LAYERS:
        raise ValueError(f"depth {depth}: one of {sorted(_LAYERS)}")
    layers, n_convs = _LAYERS[depth]
    src = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(key):
        if key not in src:
            raise KeyError(f"the torchvision state_dict lacks {key}")
        used.add(key)
        return src[key].detach().float().clone()

    def convbn(dst, conv, bn):
        out[f"{dst}.Conv_0.weight"] = take(f"{conv}.weight")
        for leaf in _BN:
            out[f"{dst}.BatchNorm_0.{leaf}"] = take(f"{bn}.{leaf}")
        out[f"{dst}.BatchNorm_0.num_batches_tracked"] = torch.tensor(0)

    convbn("stem", "conv1", "bn1")
    for i, n_blocks in enumerate(layers):
        for j in range(n_blocks):
            t, f = f"layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for c in range(n_convs):
                convbn(f"{f}.ConvBN_{c}", f"{t}.conv{c + 1}", f"{t}.bn{c + 1}")
            if f"{t}.downsample.0.weight" in src:
                convbn(f"{f}.downsample", f"{t}.downsample.0",
                       f"{t}.downsample.1")
    left = sorted(k for k in src if k not in used and not _ignored(k))
    if left:
        raise KeyError(f"{len(left)} torchvision keys left over for a "
                       f"ResNet-{depth}: {left[:8]}")
    return out


def load_torchvision_resnet(path: str, depth: int = 50
                            ) -> Dict[str, torch.Tensor]:
    """Read a local torchvision .pth checkpoint (a state_dict, or a dict
    holding one under "state_dict") and convert it."""
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_resnet({k: v for k, v in sd.items()
                           if isinstance(v, torch.Tensor)}, depth)


@torch.no_grad()
def apply_backbone_weights(detector: nn.Module,
                           sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy `convert_resnet`'s output into `detector.img_backbone`: every
    key of the backbone must be there with its shape, and no other."""
    dst = detector.img_backbone.state_dict()
    missing, extra = set(dst) - set(sd), set(sd) - set(dst)
    if missing or extra:
        raise KeyError(f"backbone keys missing {sorted(missing)[:8]}, "
                       f"unexpected {sorted(extra)[:8]}")
    for k, t in dst.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"img_backbone.{k}: {tuple(t.shape)} vs "
                             f"{tuple(sd[k].shape)}")
        t.copy_(sd[k])
    return detector
