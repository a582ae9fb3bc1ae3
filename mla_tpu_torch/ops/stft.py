"""Log-magnitude STFT, librosa-compatible (port of ``mla_tpu/ops/stft.py``).

The reference computes spectrograms offline with librosa
(reference: data/extract_spec.py:21-22 — ``librosa.stft(x, n_fft=256,
hop_length=128)`` then ``log(|S| + 1e-7)``). Here the transform runs on the
input's device: center ZERO-padding of n_fft/2, periodic Hann window,
``torch.fft.rfft`` (cuFFT on the card, as ``jnp.fft.rfft`` is XLA's FFT in
the JAX package).

librosa defaults replicated: win_length = n_fft, window='hann' (periodic),
center=True, pad_mode='constant' (the pinned librosa==0.10.0.post2 pads
with zeros).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int
                 ) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames = 1 + (T -
    frame_length) // hop; a signal shorter than one frame gives no frames
    (the JAX gather's empty index), where ``Tensor.unfold`` would raise."""
    if x.shape[-1] < frame_length:
        return x.new_zeros((*x.shape[:-1], 0, frame_length))
    return x.unfold(-1, frame_length, hop)


def log_stft(x: torch.Tensor, n_fft: int = 256, hop_length: int = 128
             ) -> torch.Tensor:
    """log(|STFT(x)| + 1e-7). x: (..., T) -> (..., n_fft//2+1, n_frames)."""
    x = x.float()
    pad = n_fft // 2
    x = F.pad(x, (pad, pad))   # zeros, as librosa>=0.10
    frames = frame_signal(x, n_fft, hop_length)
    if frames.shape[-2] == 0:   # the FFT of no frames: CPU FFTs raise
        return x.new_zeros((*x.shape[:-1], n_fft // 2 + 1, 0))
    window = torch.as_tensor(_hann_periodic(n_fft), dtype=torch.float32,
                             device=x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)  # (..., frames, freq)
    out = torch.log(spec.abs() + 1e-7)
    return out.transpose(-1, -2)    # (..., freq, time) like librosa


def crema_spectrogram(wave_5s: torch.Tensor) -> torch.Tensor:
    """CREMA-D base-path spectrogram: 5 s @ 16 kHz -> (129, 626)
    (extract_spec.py:21-22 on the 5-second crop; the tile, random crop and
    clip happen in the ETL, ``data/etl/cli.py``)."""
    return log_stft(wave_5s, n_fft=256, hop_length=128)
