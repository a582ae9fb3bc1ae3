"""ResNet-18 audio/visual backbones (port of ``mla_tpu/models/resnet.py``).

Reference: models/backbone.py:1-213 — torchvision-style ResNet-18 without
fc/avgpool, a 1-channel stem for audio spectrograms and a 3-channel one for
visual frames; the visual forward folds T frames into the batch axis.
Submodule names follow the reference state_dict (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv1/bn1/conv2/bn2/downsample.0/downsample.1``).

Activations run in ``torch.channels_last`` (physically NHWC, the JAX
package's layout): the hand-written 3x3 kernel reads it, and cuDNN prefers
it for the convs that stay on ``F.conv2d``. Each parameter is cast per op to
the compute type (the input's type after the stem's cast), as flax's
``promote_dtype`` does; no ``autocast``. BatchNorm follows the module mode
(``train()``/``eval()``), the JAX package's ``train`` argument.

``pallas_conv`` routes the stride-1 3x3 convs with C == F (``conv2`` of
every block, ``conv1`` where the stride is 1: 13 of the 16 body convs at
stages 2,2,2,2) through ``ops.conv3x3.Conv3x3``, whose CUDA path is the
hand-written kernel B3. Strided, 1x1 and stem convs stay on ``F.conv2d``.

Weights are created uninitialised; ``reset_parameters(gen)`` draws the
convs kaiming-normal (fan_out, relu) from an explicit generator and sets the
BatchNorms to 1/0 (reference utils/utils.py:106-114).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mla_tpu_torch.models.norm import BatchNorm
from mla_tpu_torch.ops.conv3x3 import conv3x3_vjp, eligible

CL = torch.channels_last


@torch.no_grad()
def kaiming_out_(conv: nn.Conv2d, gen: torch.Generator):
    """kaiming_normal_(mode='fan_out', nonlinearity='relu')."""
    fan_out = conv.out_channels * conv.kernel_size[0] * conv.kernel_size[1]
    conv.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)


def conv2d(conv: nn.Conv2d, x, pallas: bool = False):
    """``conv`` in x's type. ``pallas``: a stride-1 3x3 site, which goes
    through the B3 autograd Function when the shapes are in its scope (the
    JAX package's ``conv3x3`` takes ``lax.conv`` outside it)."""
    w = conv.weight.to(x.dtype)
    if pallas and conv.stride == (1, 1) and eligible(x, w):
        return conv3x3_vjp(x, w)
    return F.conv2d(x, w, stride=conv.stride, padding=conv.padding)


def _conv(cin, cout, k, stride):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 pallas_conv: bool = False):
        super().__init__()
        self.pallas_conv = pallas_conv
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, 1)
        self.bn2 = BatchNorm(filters)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride),
                                            BatchNorm(filters))

    def forward(self, x, valid=None):
        y = torch.relu(self.bn1(conv2d(self.conv1, x, self.pallas_conv),
                                valid))
        y = self.bn2(conv2d(self.conv2, y, self.pallas_conv), valid)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv2d(self.downsample[0], x),
                                          valid)
        return torch.relu(y + residual)


class ResNet18(nn.Module):
    """Returns the pre-pool (B, 512, H', W') feature map, like backbone.py."""

    def __init__(self, in_channels: int, stages: Sequence[int] = (2, 2, 2, 2),
                 pallas_conv: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for stage, n_blocks in enumerate(stages):
            filters = 64 * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(BasicBlock(cin, filters, stride, pallas_conv))
                cin = filters
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = cin
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def blocks(self):
        return [blk for name, layer in self.named_children()
                if name.startswith("layer") for blk in layer]

    def reset_parameters(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_out_(m, gen)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x, valid=None):
        """x: (B, C, H, W) float; valid: (B,) masks padded rows out of the
        training-mode statistics (None: every row counts)."""
        dt = self.compute_dtype or self.conv1.weight.dtype
        x = x.to(dt).contiguous(memory_format=CL)
        x = torch.relu(self.bn1(conv2d(self.conv1, x), valid))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for blk in self.blocks:
            x = blk(x, valid)
        return x


def fold_frames(image):
    """(B, C, T, H, W) -> (B*T, C, H, W): the reference's frame fold
    (backbone.py:142-147)."""
    b, c, t, h, w = image.shape
    return image.transpose(1, 2).reshape(b * t, c, h, w)


def pool_audio(feat):
    """adaptive_avg_pool2d(., 1) + flatten (basic_model.py:61-65):
    (B, C, H, W) -> (B, C)."""
    return feat.mean(dim=(2, 3))


def pool_visual(feat, batch: int):
    """Unfold frames then adaptive_avg_pool3d: (B*T, C, H, W) -> (B, C)."""
    bt, c, h, w = feat.shape
    return feat.reshape(batch, bt // batch, c, h, w).mean(dim=(1, 3, 4))
