"""Fbank helpers of the CAV-MAE input path (port of the training-side part
of ``mla_tpu/ops/fbank.py``).

``normalize_fbank`` is the CAV dataset's fixed normalisation
(dataset.py:259-260) and ``pad_or_trim_frames`` its frame cut / zero pad
(extract_fbank.py:42-52). The Kaldi filterbank itself (``kaldi_fbank``,
``wav2fbank``, ``mix_waveforms``) belongs to the offline ETL and comes with
it (ROADMAP queue A, item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CAV_NORM_MEAN = -5.081   # dataset.py:259-260
CAV_NORM_STD = 4.4849


def normalize_fbank(fbank: torch.Tensor) -> torch.Tensor:
    return (fbank - CAV_NORM_MEAN) / CAV_NORM_STD


def pad_or_trim_frames(fbank: torch.Tensor,
                       target_length: int = 1024) -> torch.Tensor:
    """Zero-pad or cut the frame axis (-2) to ``target_length``."""
    n = fbank.shape[-2]
    if n >= target_length:
        return fbank[..., :target_length, :]
    return F.pad(fbank, (0, 0, 0, target_length - n))
