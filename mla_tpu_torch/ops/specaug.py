"""SpecAugment and noise/roll fbank augmentation on the device (port of
``mla_tpu/ops/specaug.py``).

Reference: dataset/dataset.py:281-294 (torchaudio FrequencyMasking(48) and
TimeMasking(192), mask value 0) and dataset.py:319-321 (uniform noise
scaled by a per-sample uniform / 10, then a circular roll of the time axis
by an integer in [-1024, 1024)). Each function is split into its draws,
taken from a ``torch.Generator`` on the batch's device, and a law that
takes the draws, so a test can feed the JAX package's ``jax.random``
draws to the same law.

torchaudio 0.8.1's mask law is kept: the width ``value`` ~ U[0, max_width)
and the start ``min`` ~ U[0, size - value) are both truncated to integers,
mask = [int(min), int(min) + int(value)); so the width is 0 with
probability 1/max_width and the mean width is (max_width - 1) / 2.
"""

from __future__ import annotations

from typing import Dict

import torch

FREQM, TIMEM = 48, 192     # dataset.py:281-282
ROLL = 1024                # dataset.py:321


def _uniform(gen, shape, device, low=0.0, high=1.0):
    return torch.rand(shape, generator=gen, device=device) * (high - low) + low


def axis_mask_draws(gen: torch.Generator, b: int, size: int, max_width: int,
                    device) -> Dict[str, torch.Tensor]:
    """Per sample: the width ``value`` ~ U[0, max_width) and the start
    ``start`` ~ U[0, size - value), both fp32 (B,)."""
    value = _uniform(gen, (b,), device, 0.0, float(max_width))
    start = torch.rand((b,), generator=gen, device=device) * (size - value)
    return {"value": value, "start": start}


def _axis_mask(d: Dict[str, torch.Tensor], size: int) -> torch.Tensor:
    """(B, size) bool, True where masked: [floor(start), floor(start) +
    floor(value))."""
    start = torch.floor(d["start"])[:, None]
    end = start + torch.floor(d["value"])[:, None]
    idx = torch.arange(size, dtype=torch.float32, device=start.device)[None]
    return (idx >= start) & (idx < end)


def specaug_draws(gen: torch.Generator, b: int, t: int, f: int, device,
                  freqm: int = FREQM, timem: int = TIMEM):
    """The draws of ``specaug``: a mel band, then a time band, per
    sample."""
    return {"f": axis_mask_draws(gen, b, f, freqm, device),
            "t": axis_mask_draws(gen, b, t, timem, device)}


def specaug(fbank: torch.Tensor, draws) -> torch.Tensor:
    """(B, T, F): zero each sample's mel band, then its time band
    (``specaug_single`` over the batch)."""
    b, t, f = fbank.shape
    fmask = _axis_mask(draws["f"], f)[:, None, :]
    tmask = _axis_mask(draws["t"], t)[:, :, None]
    out = torch.where(fmask, torch.zeros((), dtype=fbank.dtype,
                                         device=fbank.device), fbank)
    return torch.where(tmask, torch.zeros((), dtype=fbank.dtype,
                                          device=fbank.device), out)


def noise_roll_draws(gen: torch.Generator, b: int, t: int, f: int, device):
    """The draws of ``noise_roll``: noise (B, T, F) ~ U[0, 1), its scale
    (B,) ~ U[0, 1) and the roll (B,) int64 ~ U{-1024, ..., 1023}."""
    return {"noise": torch.rand((b, t, f), generator=gen, device=device),
            "scale": torch.rand((b,), generator=gen, device=device),
            "shift": torch.randint(-ROLL, ROLL, (b,), generator=gen,
                                   device=device)}


def noise_roll(fbank: torch.Tensor, draws) -> torch.Tensor:
    """(B, T, F): fbank + noise * scale / 10, rolled along T by each
    sample's shift (``noise_roll_single`` over the batch, as jnp.roll)."""
    b, t, _ = fbank.shape
    x = fbank + draws["noise"] * draws["scale"][:, None, None] / 10.0
    src = torch.remainder(torch.arange(t, device=fbank.device)[None]
                          - draws["shift"][:, None], t)       # (B, T)
    return torch.gather(x, 1, src[..., None].expand_as(x))


def augment_fbank_batch(gen: torch.Generator, fbanks: torch.Tensor,
                        freqm: int = FREQM, timem: int = TIMEM,
                        noise: bool = True) -> torch.Tensor:
    """(B, T, F) train-time fbank augmentation (--cav_augnois): SpecAug,
    then (``noise``) the noise and roll, each from ``gen``."""
    b, t, f = fbanks.shape
    out = specaug(fbanks, specaug_draws(gen, b, t, f, fbanks.device, freqm,
                                        timem))
    if noise:
        out = noise_roll(out, noise_roll_draws(gen, b, t, f, fbanks.device))
    return out
