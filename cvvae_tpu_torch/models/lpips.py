"""LPIPS perceptual metric: VGG16 features and learned linear heads.

Port of ``cvvae_tpu/models/lpips.py``: scale the input, take VGG16's
relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 features, normalise each over channels,
square the difference, weight the channels by the 1x1 "lin" head, average
over space, add the layers.  torchvision is not installed, so the VGG16
trunk is plain ``F.conv2d`` / ``F.max_pool2d`` over weights in torch's
(O, I, kH, kW) layout: the module paths ``vgg.{i}`` and ``lins.{k}``
follow the JAX params tree, and ``load_lpips_params`` reads torchvision's
``vgg16().features`` and the LPIPS heads' state dicts.

Images are channels-last, (B, H, W, 3) in [-1, 1]; a video folds T into B
(``losses/vae_loss.perceptual_per_frame``).  The pretrained weights are
not in the repository: without them the training engine refuses to run
unless the caller opts in to a random LPIPS.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv plan: (out_channels, pool_before); relu after every conv;
# feature taps after convs 2, 4, 7, 10, 13 (relu1_2 ... 5_3)
_VGG_PLAN: List[Tuple[int, bool]] = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_TAPS = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
#: torchvision's vgg16().features indices of the 13 convs
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# ImageNet scaling, channels-last
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Conv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 3, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None


class LPIPS(nn.Module):
    """``vgg``: the 13 VGG16 convs; ``lins``: the five 1x1 heads, weight
    (1, C, 1, 1), no bias."""

    def __init__(self):
        super().__init__()
        convs, c_in = [], 3
        for c_out, _ in _VGG_PLAN:
            convs.append(_Conv2d(c_in, c_out))
            c_in = c_out
        self.vgg = nn.ModuleList(convs)
        self.lins = nn.ModuleList([_Conv2d(c, 1, 1, bias=False)
                                   for c in LPIPS_CHANNELS])


def init_lpips(generator: Optional[torch.Generator] = None) -> LPIPS:
    """A random LPIPS, drawn as the JAX package draws its placeholder:
    He-normal convs, zero biases, |N(0, 1)| / C heads."""
    net = LPIPS()
    with torch.no_grad():
        for conv in net.vgg:
            c_in = conv.weight.shape[1]
            conv.weight.normal_(0.0, (2.0 / (9 * c_in)) ** 0.5,
                                generator=generator)
        for lin in net.lins:
            c = lin.weight.shape[1]
            lin.weight.normal_(generator=generator).abs_().div_(c)
    return net


def _vgg_features(net: LPIPS, x: torch.Tensor):
    """x (B, 3, H, W) -> the five tapped feature maps, NCHW."""
    feats = []
    h = x
    for i, ((_, pool), conv) in enumerate(zip(_VGG_PLAN, net.vgg)):
        if pool:
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(F.conv2d(h, conv.weight.to(h.dtype),
                            conv.bias.to(h.dtype), padding=1))
        if i in _TAPS:
            feats.append(h)
    return feats


def _normalize_channels(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(x.square().sum(dim=1, keepdim=True) + eps)
    return x / (norm + eps)


def lpips_distance(net: LPIPS, x: torch.Tensor, y: torch.Tensor
                   ) -> torch.Tensor:
    """Per-sample LPIPS in fp32: x, y (B, H, W, 3) in [-1, 1] -> (B, 1, 1,
    1)."""
    shift = torch.tensor(_SHIFT, device=x.device)
    scale = torch.tensor(_SCALE, device=x.device)
    xf = ((x.float() - shift) / scale).permute(0, 3, 1, 2)
    yf = ((y.float() - shift) / scale).permute(0, 3, 1, 2)
    n = x.shape[0]
    # one VGG pass over both images
    feats = _vgg_features(net, torch.cat([xf, yf], dim=0))
    total = 0.0
    for f, lin in zip(feats, net.lins):
        d = (_normalize_channels(f[:n]) - _normalize_channels(f[n:])).square()
        val = (d * lin.weight.to(d.dtype)).sum(dim=1, keepdim=True)
        total = total + val.mean(dim=(2, 3), keepdim=True)
    return total.permute(0, 2, 3, 1)


def load_lpips_params(vgg_state: Dict, lin_state: Dict) -> Dict[str, torch.Tensor]:
    """The LPIPS module's state dict from torchvision's vgg16().features
    state dict (keys '0.weight', '2.weight', ...) and the LPIPS heads'
    (keys 'lin{k}.model.1.weight'); both are in torch's layout already."""
    out = {}
    for i, idx in enumerate(VGG_CONV_INDICES):
        out[f"vgg.{i}.weight"] = torch.as_tensor(vgg_state[f"{idx}.weight"])
        out[f"vgg.{i}.bias"] = torch.as_tensor(vgg_state[f"{idx}.bias"])
    for k in range(5):
        out[f"lins.{k}.weight"] = torch.as_tensor(
            lin_state[f"lin{k}.model.1.weight"])
    return {k: v.float().contiguous() for k, v in out.items()}
