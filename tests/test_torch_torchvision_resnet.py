"""The torchvision ResNet loader of the port
(ocrfdet_tpu_torch/utils/torch_weights.py) against the JAX package's
(ocrfdet_tpu/utils/torch_weights.py), on fake torchvision-layout state
dicts made from a seed (torchvision is not installed and its released
weights are on no machine), as tests/test_torch_weights.py makes them.

* ResNet-18: the port's converter gives the bits of the JAX converter's
  tree passed through the weight bridge; the port's backbone with it
  gives the stage outputs of the JAX converter + flax ResNet (rtol 3e-3,
  atol 1e-3, tests/test_torch_weights.py's tolerance for fp32 sums in
  another order) and of the torchvision-layout reference ops of
  tests/test_torch_weights.py (rtol 1e-5: the same convolutions).
* ResNet-50 (bottleneck blocks, conv3/bn3): the same bits as the JAX
  converter, and a strict load into `ResNet(50)`.
* A key left over or missing raises; the classifier `fc.*` and the
  `num_batches_tracked` counters are not read. A .pth file holding the
  state dict under "state_dict" loads. `apply_backbone_weights` grafts
  it into a detector's backbone and refuses a wrong shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_weights import _fake_resnet18_sd, _torch_forward

from ocrfdet_tpu.models.resnet import ResNet as JaxResNet
from ocrfdet_tpu.utils import torch_weights as jtw
from ocrfdet_tpu_torch import config as tconfig
from ocrfdet_tpu_torch.models.detector import OcRFDet
from ocrfdet_tpu_torch.models.resnet import ResNet
from ocrfdet_tpu_torch.utils import torch_weights as ttw
from ocrfdet_tpu_torch.utils.weights import flax_to_state_dict


def _fake_resnet50_sd(rng):
    """A torchvision-resnet50-layout state_dict (random), with the
    classifier and the BatchNorm counters a real checkpoint holds."""
    sd = {}

    def convbn(conv, bn, cout, cin, k):
        sd[f"{conv}.weight"] = rng.normal(0, 0.05, (cout, cin, k, k)) \
            .astype(np.float32)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{bn}.{leaf}"] = rng.uniform(0.5, 1.5, cout).astype(
                np.float32)
        sd[f"{bn}.num_batches_tracked"] = np.array(7)

    convbn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for i, n in enumerate((3, 4, 6, 3)):
        w = 64 * 2 ** i
        for j in range(n):
            t = f"layer{i + 1}.{j}"
            convbn(f"{t}.conv1", f"{t}.bn1", w, cin, 1)
            convbn(f"{t}.conv2", f"{t}.bn2", w, w, 3)
            convbn(f"{t}.conv3", f"{t}.bn3", 4 * w, w, 1)
            if j == 0:
                convbn(f"{t}.downsample.0", f"{t}.downsample.1", 4 * w, cin,
                       1)
            cin = 4 * w
    sd["fc.weight"] = rng.normal(size=(1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def _jax_converted(sd, depth):
    params, stats = jtw.convert_resnet(sd, depth=depth)
    return flax_to_state_dict({"params": jax.tree.map(np.asarray, params),
                               "batch_stats": jax.tree.map(np.asarray,
                                                           stats)})


def _torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def test_resnet18_matches_the_jax_converter_and_torchvision_ops():
    rng = np.random.default_rng(0)
    sd = _fake_resnet18_sd(rng)
    got = ttw.convert_resnet(_torch_sd(sd), depth=18)
    want = _jax_converted(sd, 18)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

    model = ResNet(18, out_indices=(0, 1, 2, 3)).eval()
    model.load_state_dict(got, strict=True)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    params, stats = jtw.convert_resnet(sd, depth=18)
    jouts = JaxResNet(depth=18, out_indices=(0, 1, 2, 3)).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        outs = model(xt)
        refs = _torch_forward(sd, xt)
    assert len(outs) == len(jouts) == len(refs) == 4
    for i, (o, j, r) in enumerate(zip(outs, jouts, refs)):
        np.testing.assert_allclose(
            o.numpy(), np.asarray(j).transpose(0, 3, 1, 2), rtol=3e-3,
            atol=1e-3, err_msg=f"stage {i} vs JAX")
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=f"stage {i} vs torchvision ops")


def test_resnet50_matches_the_jax_converter(tmp_path):
    sd = _fake_resnet50_sd(np.random.default_rng(1))
    want = _jax_converted(sd, 50)
    path = tmp_path / "resnet50.pth"
    torch.save({"state_dict": _torch_sd(sd), "meta": {"epoch": 90}}, path)
    got = ttw.load_torchvision_resnet(str(path), depth=50)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ResNet(50).load_state_dict(got, strict=True)


def test_left_over_or_missing_keys_raise():
    sd = _torch_sd(_fake_resnet18_sd(np.random.default_rng(0)))
    with pytest.raises(KeyError, match="left over"):
        ttw.convert_resnet(dict(sd, **{"layer4.2.conv1.weight":
                                       torch.zeros(1)}), depth=18)
    with pytest.raises(KeyError, match="lacks"):        # too few blocks
        ttw.convert_resnet(sd, depth=34)
    with pytest.raises(KeyError, match="lacks"):        # basic blocks
        ttw.convert_resnet(sd, depth=50)
    del sd["layer2.0.downsample.1.running_var"]
    with pytest.raises(KeyError, match="lacks"):
        ttw.convert_resnet(sd, depth=18)


def test_apply_backbone_weights_grafts_and_checks_shapes():
    cfg = tconfig.tiny_config(with_ocrf=False)
    assert cfg.backbone.depth == 18
    model = OcRFDet(cfg)
    sd = ttw.convert_resnet(_torch_sd(_fake_resnet18_sd(
        np.random.default_rng(2))), depth=18)
    ttw.apply_backbone_weights(model, sd)
    for k, t in model.img_backbone.state_dict().items():
        assert torch.equal(t, sd[k]), k
    sd["stem.Conv_0.weight"] = torch.zeros(64, 3, 3, 3)
    with pytest.raises(ValueError, match="stem.Conv_0.weight"):
        ttw.apply_backbone_weights(model, sd)
    del sd["stem.Conv_0.weight"]
    with pytest.raises(KeyError, match="missing"):
        ttw.apply_backbone_weights(model, sd)
