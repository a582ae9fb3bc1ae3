"""Seeding utilities (port of ``mla_tpu/utils/seed.py``; reference:
utils/utils.py:98-114).

``setup_seed`` mirrors the reference's global-seed call and returns an
explicit ``torch.Generator`` for code that draws; the data's randomness
flows through numpy generators keyed by (seed, epoch, sample), and no
ported transform draws from torch (the AV path has no color jitter). The
weight laws of the reference's ``weight_init`` are the modules'
``reset_parameters``.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int) -> torch.Generator:
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)

