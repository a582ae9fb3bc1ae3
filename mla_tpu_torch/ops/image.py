"""Image ops for the port (``mla_tpu/ops/image.py``): the M3AE patchify."""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """(B, C, H, W) -> (B, h*w, C*p*p) — einops 'b c (h p1)(w p2)->b (h w)(c p1 p2)'
    as in the reference M3AE classifier (basic_model.py:184-186)."""
    b, c, h, w = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # b gh gw c p1 p2
    return x.reshape(b, gh * gw, c * patch * patch)
