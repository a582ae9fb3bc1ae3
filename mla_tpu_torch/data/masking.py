"""Missing-modality simulation (modality fault injection).

The PyTorch port's own copy of ``mla_tpu/data/masking.py`` (the port imports
nothing of the JAX package).

Two mechanisms from the reference (SURVEY.md §5.3):
  - QMF file-fraction masking: the last mask_percent of the datalist has one
    modality zeroed (dataset.py:98-104,118-119,156-157)
  - CPM-Net-style random view-preserving mask matrix for IEMOCAP
    (dataset.py:596-640): every sample keeps >=1 view; overall kept-view rate
    converges to 1 - missing_rate.
"""

from __future__ import annotations

import numpy as np


def random_mask(view_num: int, alldata_len: int, missing_rate: float,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """(alldata_len, view_num) 0/1 keep-matrix, dataset.py:596-640 semantics."""
    rng = rng or np.random.default_rng(0)
    one_rate = 1.0 - missing_rate

    def one_hot_rows():
        picks = rng.integers(0, view_num, size=alldata_len)
        m = np.zeros((alldata_len, view_num), dtype=int)
        m[np.arange(alldata_len), picks] = 1
        return m

    if one_rate <= 1.0 / view_num:
        return one_hot_rows()       # exactly one view preserved per sample
    if one_rate == 1:
        return np.ones((alldata_len, view_num), dtype=int)

    # The reference loops until |rate - target| < 0.005 (dataset.py:621),
    # which can never converge for small datasets (achievable rates are
    # multiples of 1/(view_num*alldata_len)); cap iterations and keep the
    # best matrix seen.
    error = 1.0
    matrix = best = None
    best_err = np.inf
    for _ in range(1000):
        if error < 0.005:
            break
        view_preserve = one_hot_rows()
        one_num = view_num * alldata_len * one_rate - alldata_len
        ratio = one_num / (view_num * alldata_len)
        matrix_iter = (rng.integers(0, 100, size=(alldata_len, view_num))
                       < int(ratio * 100)).astype(int)
        a = np.sum(((matrix_iter + view_preserve) > 1).astype(int))
        if a >= one_num:
            # degenerate draw on tiny datasets: every target cell collided
            # with the preserved view; the reference's correction
            # one_num/(1 - a/one_num) (dataset.py:625) is infinite/negative
            # here — redraw instead of overflowing
            continue
        one_num_iter = one_num / (1 - a / one_num)
        ratio = one_num_iter / (view_num * alldata_len)
        matrix_iter = (rng.integers(0, 100, size=(alldata_len, view_num))
                       < int(ratio * 100)).astype(int)
        matrix = ((matrix_iter + view_preserve) > 0).astype(int)
        ratio = np.sum(matrix) / (view_num * alldata_len)
        error = abs(one_rate - ratio)
        if error < best_err:
            best_err, best = error, matrix
    # every draw degenerate (possible only for a handful of samples):
    # fall back to one preserved view per row — the invariant that matters
    return best if best is not None else one_hot_rows()


def qmf_mask_set(names, mask_percent: float) -> set:
    """Suffix fraction of the datalist whose modality gets zeroed
    (dataset.py:98-104)."""
    if mask_percent <= 0:
        return set()
    mask_start = int(len(names) * (1 - mask_percent))
    return set(names[mask_start:])
