"""Image ops for the port (``mla_tpu/ops/image.py``): crop-box sampling on
the host, the fused crop + resize + flip + normalize on the device, and the
M3AE patchify.

The host decodes JPEGs to uint8 HWC and samples crop boxes and flips with
numpy generators keyed by (seed, epoch, sample), so both packages draw the
same boxes; the device does the pixel math for a whole batch at once.

The resize is ``jax.image.scale_and_translate`` with ``antialias=True`` over
a fractional box per sample, with the triangle kernel ('linear', the AV
frames) or the Keys cubic ('cubic', the M3AE images), which none of torch's
resizes computes (``F.interpolate`` neither widens the kernel when it scales
down nor normalises it the same way). ``resample_matrix`` builds each
sample's (out, in) weights by JAX's rule (``compute_weight_mat`` in
``jax/_src/image/scale.py``) in float32, and ``crop_resize`` applies them as
two batched matmuls, over H first and W second.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
# CAV path uses the 4-decimal variants (dataset.py:253-255) — numerically equal
# at float32 for mean, std differs in the 4th decimal (0.2250 vs 0.225 for B).
CAV_MEAN = np.array([0.4850, 0.4560, 0.4060], dtype=np.float32)
CAV_STD = np.array([0.2290, 0.2240, 0.2250], dtype=np.float32)

_EPS_F32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Host-side crop-parameter sampling (numpy, so both packages draw the same)
# ---------------------------------------------------------------------------

def random_resized_crop_params(rng: np.random.Generator, height: int, width: int,
                               scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.)):
    """One (i, j, h, w) crop box, torchvision RandomResizedCrop.get_params."""
    area = height * width
    log_ratio = np.log(np.array(ratio))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect_ratio = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(np.sqrt(target_area * aspect_ratio)))
        h = int(round(np.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.integers(0, height - h + 1))
            j = int(rng.integers(0, width - w + 1))
            return i, j, h, w
    # fallback: center crop clamped to ratio
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w = width
        h = height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


def resize_center_crop_box(height: int, width: int, resize_short: int,
                           crop: int) -> Tuple[float, float, float, float]:
    """Resize(short side)=resize_short then CenterCrop(crop), as one source box.

    Returns a float (i, j, h, w) box in source pixels whose resize to
    (crop, crop) reproduces the two-stage transform.
    """
    short = min(height, width)
    scale = resize_short / short
    h = crop / scale
    w = crop / scale
    i = (height - h) / 2.0
    j = (width - w) / 2.0
    return i, j, h, w


# ---------------------------------------------------------------------------
# Device-side resample
# ---------------------------------------------------------------------------

def triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fill_triangle_kernel``: max(0, 1 - |x|)."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fill_keys_cubic_kernel`` (Keys, a = -0.5, support 2) on
    x >= 0, in its Horner form and order of operations."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


KERNELS = {"linear": triangle_kernel, "cubic": keys_cubic_kernel}


def resample_matrix(start: torch.Tensor, length: torch.Tensor, out_size: int,
                    in_size: int, kernel=triangle_kernel) -> torch.Tensor:
    """(B, out_size, in_size) float32 weights that resample the window
    [start, start + length) of an axis of ``in_size`` pixels to ``out_size``
    pixels, one row per output pixel: JAX's ``compute_weight_mat`` for
    ``kernel`` (``KERNELS``) with antialias, at scale out/length and
    translation -start*out/length, in float32.

    The sample positions round as the JAX package's compiled transform
    rounds them: XLA folds 1/scale into length * (1/out) and fuses the
    product and the difference of ``(o + 0.5)*inv - translation*inv`` into
    one fma. At 256 input pixels the eager rounding would move a weight by
    up to 1.5e-5 (an ulp of the position)."""
    start = start.to(torch.float32)[:, None, None]
    length = length.to(torch.float32)[:, None, None]
    translation = (-start * out_size) / length
    inv_scale = length * (1.0 / out_size)
    # widen the kernel when scaling down (low-pass), not when scaling up
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    dev = start.device
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :]
    # fma(o + 0.5, inv, -(translation * inv)): the float64 product is exact
    sample_f = ((out_pos + 0.5).double() * inv_scale.double()
                - (translation * inv_scale).double()).float() - 0.5
    weights = kernel(torch.abs(sample_f - in_pos) / kernel_scale)
    total = torch.sum(weights, dim=-1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _EPS_F32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    # zero the rows whose sample lies wholly outside the input
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def crop_resize(x: torch.Tensor, boxes: torch.Tensor,
                out_hw: Tuple[int, int], method: str = "linear"
                ) -> torch.Tensor:
    """x: (B, C, H, W) float32; boxes: (B, 4) float (i, j, h, w) in pixels
    -> (B, C, oh, ow) float32: each sample's box resampled to out_hw (the
    JAX package's ``_crop_resize_one`` with ``method``, 'linear' or
    'cubic', per sample)."""
    if method not in KERNELS:
        raise NotImplementedError(
            f"resize method {method!r}: the port has {sorted(KERNELS)}, the "
            "kernels every dataset uses")
    kernel = KERNELS[method]
    oh, ow = out_hw
    wh = resample_matrix(boxes[:, 0], boxes[:, 2], oh, x.shape[2], kernel)
    ww = resample_matrix(boxes[:, 1], boxes[:, 3], ow, x.shape[3], kernel)
    y = torch.matmul(wh[:, None], x)                    # (B, C, oh, W)
    return torch.matmul(y, ww.transpose(1, 2)[:, None])  # (B, C, oh, ow)


def crop_resize_unit(images_u8, boxes, out_hw, method):
    """uint8 (B, H, W, C) -> (B, C, oh, ow) float32 in [0, 1], resampled
    and clipped (the cubic kernel's negative lobes overshoot the range)."""
    x = images_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    return torch.clamp(crop_resize(x, boxes.to(x.device), out_hw, method),
                       0.0, 1.0)


def crop_resize_normalize(images_u8: torch.Tensor, boxes: torch.Tensor,
                          flip: torch.Tensor, mean, std,
                          out_hw: Tuple[int, int] = (224, 224),
                          method: str = "linear",
                          to_chw: bool = True) -> torch.Tensor:
    """Fused per batch: uint8 HWC -> crop + resize -> clip -> flip ->
    (x/255 - mean)/std.

    images_u8: (B, H, W, C) uint8; boxes: (B, 4) float32 (i, j, h, w);
    flip: (B,) bool. Returns (B, C, oh, ow) if to_chw else (B, oh, ow, C),
    float32. The clip matches the dataset path, as PIL clamps resampling
    overshoot to the uint8 range."""
    out = crop_resize_unit(images_u8, boxes, out_hw, method)
    out = torch.where(flip.to(out.device)[:, None, None, None],
                      out.flip(-1), out)
    out = (out - per_channel(mean, out)) / per_channel(std, out)
    return out if to_chw else out.permute(0, 2, 3, 1)


def per_channel(v, like: torch.Tensor) -> torch.Tensor:
    """A per-channel constant as (1, C, 1, 1) float32 on like's device."""
    return torch.as_tensor(np.asarray(v, np.float32), device=like.device
                           ).view(1, -1, 1, 1)


def patchify(images: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """(B, C, H, W) -> (B, h*w, C*p*p) — einops 'b c (h p1)(w p2)->b (h w)(c p1 p2)'
    as in the reference M3AE classifier (basic_model.py:184-186)."""
    b, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # b gh gw c p1 p2
    return x.reshape(b, gh * gw, c * patch * patch)
