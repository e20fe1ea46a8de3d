"""ENet, the 2D network of the multiview feature chain, in NCHW on cuDNN.

Counterpart of ``instancerefer_tpu/models/enet.py``: the reference's live
network (``lib/enet.py:130-693``, whose decoder is commented out), the
initial block (16 channels), stage 1 (5 bottlenecks, 64 channels at 1/4),
stages 2 and 3 (17 bottlenecks, 128 channels at 1/8) and a bias-free 1x1
classifier.  There is no Pallas kernel here: its convolutions run on
cuDNN.

The module tree is the reference's ``nn.Sequential``, so its state-dict
keys are the reference's and ``scannetv2_enet.pth`` loads with a strict
``load_state_dict``:

* ``0.0.*`` the initial 3x3/2 conv (pad 1, bias), ``2.*`` its BatchNorm,
  ``3.weight`` its PReLU (``0.1`` is the max-pool beside the conv, ``1``
  the concatenation);
* ``{4..25}.0.0.{i}.*`` the extension branch of each bottleneck of
  ``BOTTLENECK_PLAN``, ``{idx}.0.1`` its main branch (max-pool and zero
  channels when it downsamples), ``{idx}.1`` the sum, ``{idx}.2.weight``
  the output PReLU;
* ``26.0.weight`` the classifier.

Parity details of the JAX docstring, kept: per-channel PReLU; the
asymmetric blocks apply a bias-free (1, 5) conv, then a (5, 1) conv with
bias; the Torch-Lua dropout scales the branch by (1 - p) also at eval;
BatchNorm eps 1e-3, momentum 0.1; the initial conv pads (1, 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (name, kwargs) of the 22 bottlenecks, as the JAX package's BOTTLENECK_PLAN
BOTTLENECK_PLAN = (
    [("b1_0", dict(out_ch=64, internal=16, downsample=True, dropout_rate=0.01))]
    + [(f"b1_{i}", dict(out_ch=64, internal=16, dropout_rate=0.01)) for i in range(1, 5)]
    + [("b2_0", dict(out_ch=128, internal=32, downsample=True))]
    + [
        (f"b{s}_{i}", dict(out_ch=128, internal=32, **kw))
        for s in (2, 3)
        for i, kw in [
            (1, {}),
            (2, dict(dilation=2)),
            (3, dict(kernel=5, asymmetric=True)),
            (4, dict(dilation=4)),
            (5, {}),
            (6, dict(dilation=8)),
            (7, dict(kernel=5, asymmetric=True)),
            (8, dict(dilation=16)),
        ]
    ]
)
FIRST_BOTTLENECK_INDEX = 4  # the Sequential's indices: 0-3 initial block, 4-25, 26 classifier
NUM_CLASSES = 41  # nyu40 + unannotated

# the multiview pipeline's frame normalisation (JAX models/enet.py:209-210)
ENET_MEAN = (0.496342, 0.466664, 0.440796)
ENET_STD = (0.277856, 0.28623, 0.291129)


def normalize_frame(rgb01: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float in [0, 1] -> (x - ENET_MEAN) / ENET_STD."""
    mean = rgb01.new_tensor(ENET_MEAN)
    std = rgb01.new_tensor(ENET_STD)
    return (rgb01 - mean) / std


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-3, momentum=0.1)


class _Map(nn.Module):
    """The reference's LambdaMap: each child applied to the same input."""

    def __init__(self, *branches: nn.Module):
        super().__init__()
        for i, b in enumerate(branches):
            self.add_module(str(i), b)

    def forward(self, x):
        return [branch(x) for branch in self.children()]


class _Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class _Sum(nn.Module):
    def forward(self, xs):
        return xs[0] + xs[1]


class TorchLuaDropout(nn.Module):
    """``lib/enet.py:81-96``: the branch times (1 - p) always, then the
    usual (rescaling) dropout in training; at eval the pretrained weights
    expect the (1 - p) scale."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x * (1.0 - self.p), self.p, self.training)


class _Downsample(nn.Module):
    """The main branch of a downsampling bottleneck: 2x2/2 max-pool, then
    zero channels up to ``out_ch``."""

    def __init__(self, out_ch: int):
        super().__init__()
        self.out_ch = out_ch

    def forward(self, x):
        x = F.max_pool2d(x, 2, 2)
        return F.pad(x, (0, 0, 0, 0, 0, self.out_ch - x.shape[1]))


def bottleneck(cin: int, out_ch: int, internal: int, kernel: int = 3, dilation: int = 1,
               asymmetric: bool = False, downsample: bool = False,
               dropout_rate: float = 0.1) -> nn.Sequential:
    """One bottleneck as the reference's Sequential: ``0`` = (extension
    branch, main branch), ``1`` = their sum, ``2`` = the output PReLU."""
    if downsample:
        ext = [nn.Conv2d(cin, internal, 2, stride=2, bias=False)]
        main = _Downsample(out_ch)
    else:
        ext = [nn.Conv2d(cin, internal, 1, bias=False)]
        main = nn.Identity()
    ext += [_bn(internal), nn.PReLU(internal)]
    if asymmetric:
        p = kernel // 2
        ext += [nn.Conv2d(internal, internal, (1, kernel), padding=(0, p), bias=False),
                nn.Conv2d(internal, internal, (kernel, 1), padding=(p, 0), bias=True)]
    else:
        p = dilation * (kernel // 2)
        ext += [nn.Conv2d(internal, internal, kernel, padding=p, dilation=dilation, bias=True)]
    ext += [_bn(internal), nn.PReLU(internal), nn.Conv2d(internal, out_ch, 1, bias=False),
            _bn(out_ch), TorchLuaDropout(dropout_rate)]
    return nn.Sequential(_Map(nn.Sequential(*ext), main), _Sum(), nn.PReLU(out_ch))


class Enet(nn.Sequential):
    """The full network, as the reference's Sequential.  ``forward`` takes
    [B, 3, H, W] normalised frames and returns (logits [B, 41, H/8, W/8],
    features [B, 128, H/8, W/8]) as the JAX ``Enet`` does (there in NHWC);
    ``features`` alone is the multiview extractor (the reference's
    ``model_fixed`` + ``model_trainable``, ``lib/enet.py:697-716``)."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        layers = [
            _Map(nn.Conv2d(3, 13, 3, stride=2, padding=1, bias=True), nn.MaxPool2d(2, 2)),
            _Concat(), _bn(16), nn.PReLU(16),
        ]
        cin = 16
        for _, kw in BOTTLENECK_PLAN:
            layers.append(bottleneck(cin, **kw))
            cin = kw["out_ch"]
        layers.append(nn.Sequential(nn.Conv2d(cin, num_classes, 1, bias=False)))
        super().__init__(*layers)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        for layer in list(self)[:-1]:
            x = layer(x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.features(x)
        return self[-1](feats), feats
