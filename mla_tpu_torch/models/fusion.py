"""Fusion heads (port of ``mla_tpu/models/fusion.py``). Reference:
models/fusion_modules.py:1-99.

ConcatFusion's single ``fc_out`` Linear is the *shared head* MLA trains
per-modality (feature-width input when gs_flag — basic_model.py:31-34).
The M3AE family keeps torch nn.Linear's default init: weight and bias both
U(+-1/sqrt(fan_in)), drawn here from an explicit generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def reset_torch_default(lin: nn.Linear, gen: torch.Generator):
    """torch nn.Linear's default init in closed form: kaiming_uniform(a=sqrt(5))
    weight and U(+-1/sqrt(fan_in)) bias are both U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(lin.in_features)
    lin.weight.uniform_(-bound, bound, generator=gen)
    lin.bias.uniform_(-bound, bound, generator=gen)


class SumFusion(nn.Module):
    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc_x = nn.Linear(input_dim, output_dim)
        self.fc_y = nn.Linear(input_dim, output_dim)

    def reset_parameters(self, gen):
        reset_torch_default(self.fc_x, gen)
        reset_torch_default(self.fc_y, gen)

    def forward(self, x, y):
        return x, y, self.fc_x(x) + self.fc_y(y)


class ConcatFusion(nn.Module):
    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc_out = nn.Linear(2 * input_dim, output_dim)

    def reset_parameters(self, gen):
        reset_torch_default(self.fc_out, gen)

    def forward(self, x, y):
        return x, y, self.fc_out(torch.cat([x, y], dim=1))


class ConcatFusion3(nn.Module):
    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc_out = nn.Linear(3 * input_dim, output_dim)

    def reset_parameters(self, gen):
        reset_torch_default(self.fc_out, gen)

    def forward(self, x, y, z):
        return x, y, z, self.fc_out(torch.cat([x, y, z], dim=1))


class SharedHead(nn.Module):
    """The MLA shared head: one Linear applied to a single modality's features
    (reference: main.py:432,445 — fusion_module.fc_out(a) / (v))."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc_out = nn.Linear(input_dim, output_dim)

    def reset_parameters(self, gen):
        reset_torch_default(self.fc_out, gen)

    def forward(self, feat):
        return self.fc_out(feat)
