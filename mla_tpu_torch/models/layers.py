"""Transformer building blocks of the M3AE encoder (port of the float path of
``mla_tpu/models/layers.py``: MultiHeadAttention, Mlp, M3AEBlock).

Pre-LN block with qkv bias and -1e7 padding-mask attention (reference:
models/m3ae.py:86-160). Submodule names follow the reference state_dict
(``layer_norm1``, ``attention.qkv_linear``, ``attention.fc``,
``layer_norm2``, ``transformer_mlp.fc1/fc2``), so a reference ``.pth``
loads with ``strict=True``.

Weights are created uninitialised; ``reset_parameters(gen)`` fills them from
an explicit ``torch.Generator`` (xavier-uniform linears, zero biases, unit
LayerNorms — the JAX package's initialisers).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mla_tpu_torch.ops.attention import fused_attention_qkv


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, gen: torch.Generator):
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    weight.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def reset_xavier_linear(lin: nn.Linear, gen: torch.Generator):
    xavier_uniform_(lin.weight, gen)
    if lin.bias is not None:
        lin.bias.zero_()


@torch.no_grad()
def reset_layer_norm(ln: nn.LayerNorm):
    ln.weight.fill_(1.0)
    ln.bias.zero_()


class MultiHeadAttention(nn.Module):
    """Fused qkv projection -> masked attention -> output projection
    (m3ae.Attention, m3ae.py:88-127); scale = head_dim**-0.5."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv_linear = nn.Linear(dim, 3 * dim)
        self.fc = nn.Linear(dim, dim)

    def reset_parameters(self, gen: torch.Generator):
        reset_xavier_linear(self.qkv_linear, gen)
        reset_xavier_linear(self.fc, gen)

    def forward(self, x, padding_mask: Optional[torch.Tensor] = None):
        # the fused projection's (B, S, 3C) output feeds the flat kernel
        # directly; its (B, S, C) result is already in fc's layout
        qkv = self.qkv_linear(x)
        return self.fc(fused_attention_qkv(qkv, padding_mask, self.num_heads))


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> fc2, hidden = mlp_ratio * dim."""

    def __init__(self, dim: int, out_dim: int, mlp_ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.fc2 = nn.Linear(mlp_ratio * dim, out_dim)

    def reset_parameters(self, gen: torch.Generator):
        reset_xavier_linear(self.fc1, gen)
        reset_xavier_linear(self.fc2, gen)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class M3AEBlock(nn.Module):
    """Pre-LN block (m3ae.py:131-160), LayerNorm eps 1e-5."""

    def __init__(self, emb_dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(emb_dim, eps=1e-5)
        self.attention = MultiHeadAttention(emb_dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(emb_dim, eps=1e-5)
        self.transformer_mlp = Mlp(emb_dim, emb_dim, mlp_ratio)

    def reset_parameters(self, gen: torch.Generator):
        reset_layer_norm(self.layer_norm1)
        self.attention.reset_parameters(gen)
        reset_layer_norm(self.layer_norm2)
        self.transformer_mlp.reset_parameters(gen)

    def forward(self, x, padding_mask=None):
        x = x + self.attention(self.layer_norm1(x), padding_mask)
        return x + self.transformer_mlp(self.layer_norm2(x))
