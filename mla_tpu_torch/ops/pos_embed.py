"""Sin-cos positional embedding tables (port of ``mla_tpu/ops/pos_embed.py``).

Numerical parity with both reference variants: the M3AE square-grid form
(reference: models/m3ae.py:181-223) and the CAV-MAE rectangular form with
the reference's grid reshape quirk (reference: models/cav_mae.py:19-67).
Tables are built in numpy; the model turns them into tensors on its device
once (M3AE) or initialises its trainable tables from them (CAV-MAE).
"""

from __future__ import annotations

import numpy as np


def _sincos_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """(1, length, embed_dim) — reference: m3ae.py:197-203."""
    emb = _sincos_from_grid(embed_dim, np.arange(length, dtype=np.float64))
    return emb[None].astype(np.float32)


def get_2d_sincos_pos_embed_square(embed_dim: int, length: int) -> np.ndarray:
    """(1, length, embed_dim) for a square grid — reference: m3ae.py:206-223."""
    grid_size = int(length ** 0.5)
    assert grid_size * grid_size == length, "2-D pos embed needs a square token grid"
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first, as in reference
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = _sincos_from_grid(embed_dim // 2, grid[0])
    emb_w = _sincos_from_grid(embed_dim // 2, grid[1])
    emb = np.concatenate([emb_h, emb_w], axis=1)
    return emb[None].astype(np.float32)


def get_2d_sincos_pos_embed_rect(embed_dim: int, grid_h_size: int,
                                 grid_w_size: int,
                                 cls_token: bool = False) -> np.ndarray:
    """(N[, +1], embed_dim) for a rectangular grid — reference:
    cav_mae.py:51-67. Keeps the reference's reshape([2, 1, grid_w, grid_h])
    (cav_mae.py:63), which transposes the two axes against the meshgrid
    layout on a non-square grid (CAV-MAE's 8 x (L/8) audio grid), so
    imported checkpoints line up."""
    grid_h = np.arange(grid_h_size, dtype=np.float64)
    grid_w = np.arange(grid_w_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, grid_w_size, grid_h_size])
    emb_h = _sincos_from_grid(embed_dim // 2, grid[0])
    emb_w = _sincos_from_grid(embed_dim // 2, grid[1])
    emb = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    return emb.astype(np.float32)
