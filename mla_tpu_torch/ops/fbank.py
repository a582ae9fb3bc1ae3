"""Kaldi-compatible log-mel filterbank and the CAV-MAE fbank helpers (port
of ``mla_tpu/ops/fbank.py``).

``kaldi_fbank`` replaces the reference's offline
``torchaudio.compliance.kaldi.fbank`` call (reference:
data/extract_fbank.py:35-37: htk_compat=True, hanning window,
num_mel_bins=128, dither=0.0, frame_shift=10, use_energy=False) and runs
on the input's device: the offline ETL (``data/etl/cli.py``:
``extract-fbank``, ``preprocess-iemo``) computes it on the card unless the
CPU is asked for. Its product is a (frames, 257) x (257, 128) fp32 matmul,
run with TF32 off (``device.set_matmul_precision``, which the ETL sets).

Kaldi semantics replicated (defaults of torchaudio.compliance.kaldi.fbank):
frame_length 25 ms (400 samples @ 16 kHz), frame_shift 10 ms (160
samples), snip_edges=True, remove_dc_offset=True, pre-emphasis 0.97 (first
sample pre-emphasized against itself), Kaldi 'hanning' window (denominator
N-1), round_to_power_of_two=True (FFT size 512), power spectrum, mel scale
1127*ln(1+f/700) with low_freq=20 / high_freq=nyquist, triangular banks
laid out on the *mel* axis, floor at float32 eps before log. A waveform
shorter than one frame gives no frames, so ``wav2fbank`` returns zeros.

``normalize_fbank`` is the CAV dataset's fixed normalisation
(dataset.py:259-260) and ``pad_or_trim_frames`` its frame cut / zero pad
(extract_fbank.py:42-52), used by the training-side fbank transform.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mla_tpu_torch.ops.stft import frame_signal

_FLT_EPS = float(np.finfo(np.float32).eps)

CAV_NORM_MEAN = -5.081   # dataset.py:259-260
CAV_NORM_STD = 4.4849


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def kaldi_mel_banks(num_bins: int, window_length_padded: int,
                    sample_freq: float, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """(num_fft_bins + 1, num_bins) triangular mel weights, Kaldi layout
    (float64 arithmetic, float32 result)."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_freq / window_length_padded
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_fft_bins, dtype=np.float64)
    mel = _mel(fft_bin_width * bin_idx)  # (F,)

    left = mel_low + np.arange(num_bins, dtype=np.float64) * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    up = (mel[:, None] - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - mel[:, None]) / (right - center)[None, :]
    weights = np.where(
        (mel[:, None] > left[None, :]) & (mel[:, None] <= center[None, :]),
        up,
        np.where((mel[:, None] > center[None, :])
                 & (mel[:, None] < right[None, :]), down, 0.0))
    # Kaldi computes banks over bins [0, num_fft_bins); the nyquist bin
    # gets 0
    full = np.zeros((num_fft_bins + 1, num_bins), dtype=np.float64)
    full[:num_fft_bins] = weights
    return full.astype(np.float32)


def _kaldi_hanning(n: int) -> np.ndarray:
    a = 2.0 * np.pi / (n - 1)
    return (0.5 - 0.5 * np.cos(a * np.arange(n, dtype=np.float64))
            ).astype(np.float32)


def kaldi_fbank(waveform: torch.Tensor, sample_frequency: int = 16000,
                num_mel_bins: int = 128, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, preemphasis: float = 0.97,
                remove_dc_offset: bool = True) -> torch.Tensor:
    """(..., T) waveform -> (..., n_frames, num_mel_bins) log-mel fbank."""
    window_size = int(sample_frequency * frame_length_ms * 0.001)
    window_shift = int(sample_frequency * frame_shift_ms * 0.001)
    padded = 1 << (window_size - 1).bit_length()  # round_to_power_of_two

    x = waveform.float()
    frames = frame_signal(x, window_size, window_shift)  # snip_edges
    if frames.shape[-2] == 0:   # the FFT of no frames: CPU FFTs raise
        return x.new_zeros((*x.shape[:-1], 0, num_mel_bins))
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    dev = x.device
    frames = frames * torch.from_numpy(_kaldi_hanning(window_size)).to(dev)
    frames = F.pad(frames, (0, padded - window_size))
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2   # (..., M, padded//2+1)
    banks = torch.from_numpy(kaldi_mel_banks(
        num_mel_bins, padded, float(sample_frequency))).to(dev)
    mel = torch.matmul(power, banks)
    return torch.log(torch.clamp_min(mel, _FLT_EPS))


def pad_or_trim_frames(fbank: torch.Tensor,
                       target_length: int = 1024) -> torch.Tensor:
    """Zero-pad or cut the frame axis (-2) to ``target_length``."""
    n = fbank.shape[-2]
    if n >= target_length:
        return fbank[..., :target_length, :]
    return F.pad(fbank, (0, 0, 0, target_length - n))


def mix_waveforms(w1: torch.Tensor, w2: torch.Tensor,
                  mix_lambda: float) -> torch.Tensor:
    """Waveform mixup (extract_fbank.py:14-32): mean-center both waveforms,
    zero-pad or cut w2 to w1's length, lambda-blend, re-center the mix."""
    w1 = w1 - w1.mean(dim=-1, keepdim=True)
    w2 = w2 - w2.mean(dim=-1, keepdim=True)
    n1, n2 = w1.shape[-1], w2.shape[-1]
    if n2 < n1:
        w2 = F.pad(w2, (0, n1 - n2))
    elif n2 > n1:
        w2 = w2[..., :n1]
    mix = mix_lambda * w1 + (1.0 - mix_lambda) * w2
    return mix - mix.mean(dim=-1, keepdim=True)


def wav2fbank(waveform: torch.Tensor, target_length: int = 1024,
              waveform2: Optional[torch.Tensor] = None,
              mix_lambda: float = -1.0) -> torch.Tensor:
    """Full extract_fbank.py::wav2fbank path: mean-subtract (or, with a
    second waveform, mix_lambda-blend per mix_waveforms), fbank, pad to
    ``target_length`` frames (extract_fbank.py:8-52)."""
    if waveform2 is not None:
        waveform = mix_waveforms(waveform, waveform2, mix_lambda)
    else:
        waveform = waveform - waveform.mean(dim=-1, keepdim=True)
    return pad_or_trim_frames(kaldi_fbank(waveform), target_length)


def normalize_fbank(fbank: torch.Tensor) -> torch.Tensor:
    return (fbank - CAV_NORM_MEAN) / CAV_NORM_STD
