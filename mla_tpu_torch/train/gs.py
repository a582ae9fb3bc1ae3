"""GS plugin: orthogonal gradient correction on the MLA shared head (port of
``mla_tpu/train/gs.py``).

Reference: utils/utils.py:12-41. Per sub-step, a recursive-least-squares-style
projector ``Pl`` (head_width x head_width, init = I) is updated from the mean
batch feature and the shared-head weight gradient is projected through it.

Two modes:
  - rls_active=False (default, shipped parity): the reference's guard
    ``n == "module.weight"`` (utils.py:32) never matches an nn.Linear's
    parameter name, so the projection is dead code. Pl untouched, grads
    untouched; only the sub-step count advances.
  - rls_active=True (--gs_rls, the intended algorithm), skipped while
    exp_count == 0 (utils.py:29):
      lamda = batch_index/len_dataloader + 1 ; alpha = 0.1**lamda
      r = mean(feats, 0, keepdims)              # (1, D)
      k = Pl @ r.T                              # (D, 1)
      Pl = Pl - (k k^T) / (alpha + k r)         # ELEMENTWISE over the outer
                                                # products, as written
      Pl = Pl / ||Pl||_F
    The head weight's gradient is (C, D) here and (D, C) as a flax kernel:
    the JAX package's ``Pl @ g_flax`` is ``g_torch @ Pl^T``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GSState:
    Pl: torch.Tensor   # (D, D) float32
    exp_count: int     # sub-steps taken


def init_gs_state(head_dim: int, device=None) -> GSState:
    return GSState(Pl=torch.eye(head_dim, dtype=torch.float32, device=device),
                   exp_count=0)


@torch.no_grad()
def gs_before_update(gs: GSState, feats: torch.Tensor,
                     head_weight_grad: torch.Tensor, batch_index: int,
                     len_dataloader: int, rls_active: bool):
    """-> (new GSState, the head weight's gradient (C, D), projected in RLS
    mode once a sub-step has been taken)."""
    if not rls_active or gs.exp_count == 0:
        return GSState(gs.Pl, gs.exp_count + 1), head_weight_grad
    # the JAX package computes lamda and alpha in fp32
    lamda = np.float32(batch_index) / np.float32(len_dataloader) + \
        np.float32(1.0)
    alpha = float(np.float32(0.1) ** lamda)
    Pl = gs.Pl
    r = feats.float().mean(dim=0, keepdim=True)          # (1, D)
    k = Pl @ r.T                                         # (D, 1)
    Pl = Pl - (k @ k.T) / (alpha + k @ r)
    Pl = Pl / torch.linalg.norm(Pl)
    grad = (head_weight_grad.float() @ Pl.T).to(head_weight_grad.dtype)
    return GSState(Pl, gs.exp_count + 1), grad
