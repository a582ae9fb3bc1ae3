"""Seeding utilities (port of ``mla_tpu/utils/seed.py``; reference:
utils/utils.py:98-114).

``setup_seed`` mirrors the reference's global-seed call and returns an
explicit ``torch.Generator`` for code that draws. The data's randomness is
explicit too: crop boxes and flips come from numpy generators keyed by
(seed, epoch, sample), and each batch's device draws (the M3AE images'
color jitter) from ``batch_generator(seed, epoch, step)``, where the JAX
loader hands ``finish_batch`` the key ``fold_in(fold_in(key(seed), epoch),
step)``. ``jax.random`` streams cannot be reproduced in torch, so the port
keys the same triple, not the same bits. The weight laws of the
reference's ``weight_init`` are the modules' ``reset_parameters``.
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


def batch_generator(seed: int, epoch: int, step: int,
                    device="cpu") -> torch.Generator:
    """The generator of one batch's device draws, on ``device``: seeded
    from (seed, epoch, step) through ``np.random.SeedSequence``, so a
    resumed run draws what an uninterrupted one does and two steps never
    share a stream."""
    state = np.random.SeedSequence((seed, epoch, step)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)
