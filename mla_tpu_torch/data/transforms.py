"""Per-dataset device-side batch transforms (port of
``mla_tpu/data/transforms.py``).

Host workers only decode (JPEG -> uint8 canonical-size HWC) and sample crop
geometry; the pixel math (crop + resize + flip + normalize + color jitter)
runs on the device per batch (``mla_tpu_torch/ops/image.py``).

Crops are sampled in ORIGINAL image coordinates with torchvision's parameter
laws, then mapped into the canonical decode size — one extra resample vs
cropping the original, traded for a static-shape device pipeline.

The JAX package computes in (H, W, C); the port in (C, H, W), which is the
layout the convolutions take. The values are the same: every step after the
resample is elementwise or per channel. ``cav_fbank_transform`` is the
CAV-MAE fbank path (SpecAug, normalisation, noise and roll on the device).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch.ops import image as im
from mla_tpu_torch.ops import specaug as sa
from mla_tpu_torch.ops.fbank import normalize_fbank

CANONICAL = {224: 256, 256: 288,
             32: 48, 64: 96}   # host decode size per target crop (small
                               # entries: test/CI-sized adapters)


def scale_box(box, orig_hw, canon: int):
    """Map an (i, j, h, w) box from original to canonical coordinates."""
    i, j, h, w = box
    oh, ow = orig_hw
    return (i * canon / oh, j * canon / ow, h * canon / oh, w * canon / ow)


def host_decode(path: str, canon) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG -> uint8 (h, w, 3) RGB + original size; canon is int (square) or
    (h, w). Raises on a missing/corrupt file — the caller decides the
    zero-slot policy (native_loader.decode_jpeg_batch)."""
    import cv2
    h, w = (canon, canon) if isinstance(canon, int) else canon
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        from PIL import Image
        pil = Image.open(path).convert("RGB")
        img = np.asarray(pil)[:, :, ::-1]
    hw = img.shape[:2]
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    return np.ascontiguousarray(img[:, :, ::-1]), hw   # BGR->RGB


# ---------------------------------------------------------------------------
# color jitter (timm create_transform(color_jitter=True) => torchvision
# ColorJitter(0.4, 0.4, 0.4) applied in random order — dataset.py:401-412)
# ---------------------------------------------------------------------------

_GRAY = (0.299, 0.587, 0.114)


def apply_jitter(x: torch.Tensor, f: torch.Tensor, order: torch.Tensor
                 ) -> torch.Tensor:
    """x: (B, 3, H, W) float in [0, 1]; f: (B, 3) brightness, contrast and
    saturation factors; order: (B, 3) a permutation of (0, 1, 2) per sample,
    the order the three ops apply in. The JAX package's ``_jitter_one`` with
    its draws given."""
    gray_w = torch.tensor(_GRAY, dtype=x.dtype, device=x.device
                          ).view(1, 3, 1, 1)
    fb, fc, fs = (f[:, k].to(x.dtype).view(-1, 1, 1, 1) for k in range(3))
    for pos in range(3):
        gray = torch.sum(x * gray_w, dim=1, keepdim=True)
        mean = torch.mean(gray, dim=(1, 2, 3), keepdim=True)
        ops = (x * fb,                              # brightness
               x * fc + (1 - fc) * mean,            # contrast
               x * fs + (1 - fs) * gray)            # saturation
        which = order[:, pos].view(-1, 1, 1, 1)
        x = torch.where(which == 0, ops[0],
                        torch.where(which == 1, ops[1], ops[2]))
    return torch.clamp(x, 0.0, 1.0)


def color_jitter_batch(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Per sample: factors uniform in [0.6, 1.4] and a random op order, drawn
    from ``gen`` (on x's device), then ``apply_jitter``."""
    b = x.shape[0]
    f = torch.rand((b, 3), generator=gen, device=x.device) * 0.8 + 0.6
    order = torch.argsort(torch.rand((b, 3), generator=gen, device=x.device),
                          dim=1)
    return apply_jitter(x, f, order)


# ---------------------------------------------------------------------------
# fused batch transforms
# ---------------------------------------------------------------------------

def image_batch_transform(images_u8, boxes, flip, gen: Optional[torch.Generator],
                          mean, std, out: int = 224, method: str = "linear",
                          jitter: bool = False, out_dtype=None):
    """(B, H, W, 3) uint8 -> normalized (B, 3, out, out), in JAX's order:
    resample, clip to [0, 1], jitter (only where asked), flip the width
    axis, (x - mean)/std, cast to ``out_dtype`` (emitting the model's
    compute type halves the transform's largest write)."""
    crops = im.crop_resize_unit(images_u8, boxes, (out, out), method)
    if jitter:
        crops = color_jitter_batch(gen, crops)
    crops = torch.where(flip.to(crops.device)[:, None, None, None],
                        crops.flip(-1), crops)
    crops = (crops - im.per_channel(mean, crops)) / im.per_channel(std, crops)
    if out_dtype is not None:
        crops = crops.to(out_dtype)
    return crops


def av_frames_transform(frames_u8, boxes, flip, gen=None, out: int = 224,
                        out_dtype=None):
    """AVDataset 3-frame stack: (B, T, H, W, 3) uint8 with per-frame
    independent crops (dataset.py:142-155) -> (B, 3, T, out, out), a view
    whose frames fold back to (B*T, 3, out, out) without a copy."""
    b, t = frames_u8.shape[:2]
    flat = frames_u8.reshape((b * t,) + tuple(frames_u8.shape[2:]))
    x = image_batch_transform(flat, boxes.reshape(b * t, 4),
                              flip.reshape(b * t), gen, im.IMAGENET_MEAN,
                              im.IMAGENET_STD, out=out, out_dtype=out_dtype)
    return x.reshape(b, t, 3, out, out).transpose(1, 2)


def cav_fbank_transform(fbank, gen: Optional[torch.Generator], train: bool,
                        augnois: bool):
    """CAVDataset fbank path (dataset.py:281-321): in training under
    --cav_augnois, SpecAug, then the normalisation, then noise and roll,
    drawn from ``gen`` in that order; otherwise the normalisation only.
    fp32 (B, T, 128)."""
    x = fbank.to(torch.float32)
    if not (train and augnois):
        return normalize_fbank(x)
    b, t, f = x.shape
    x = normalize_fbank(sa.specaug(x, sa.specaug_draws(gen, b, t, f,
                                                       x.device)))
    return sa.noise_roll(x, sa.noise_roll_draws(gen, b, t, f, x.device))
