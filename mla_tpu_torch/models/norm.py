"""BatchNorm as the JAX package's ResNet-18 runs it (port of flax
``nn.BatchNorm`` as ``BasicBlock`` uses it and of
``mla_tpu/models/norm.py`` ``MaskedBatchNorm``).

Parameters ``weight``/``bias`` and buffers ``running_mean``/``running_var``/
``num_batches_tracked`` carry the reference ``BatchNorm2d`` names, so a
reference state_dict loads with ``strict=True``; ``num_batches_tracked`` is
kept for that layout only (the JAX package writes 0 and nothing reads it).
The running statistics are float32 in every mode and device.

Training mode (``self.training``) normalises with the batch statistics and
updates the running ones in place; eval mode normalises with the running
ones and changes nothing. Statistics and normalisation run in at least
float32 (the input's type promoted to float32, as flax promotes it; the
masked path in float32, as ``MaskedBatchNorm`` casts), and the result
returns in the input's type:

- plain (``valid`` None), flax ``nn.BatchNorm``: fast variance
  E[x^2] - E[x]^2 clipped at 0; running update with flax momentum 0.9
  (torch's 0.1) and the BIASED batch variance; y = (x - mean) *
  (rsqrt(var + eps) * weight) + bias.
- masked (``valid`` (N,) given), ``MaskedBatchNorm``: statistics over the
  valid rows only, two-pass variance; the running variance takes the
  UNBIASED estimate n/(n-1); a batch with no valid row leaves the running
  statistics unchanged; y = (x - mean) * rsqrt(var + eps) * weight + bias.

``F.batch_norm``'s own running update (unbiased, torch momentum) is not
used: it is neither of these.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

MOMENTUM = 0.9          # flax convention: running = 0.9*running + 0.1*batch
EPS = 1e-5


class BatchNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x, valid: Optional[torch.Tensor] = None):
        """x: (N, C, ...) in the compute type; valid: (N,) 1.0 = real row,
        read in training mode only."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = (0,) + tuple(range(2, x.dim()))
        masked = self.training and valid is not None
        ct = torch.float32 if masked else torch.promote_types(x.dtype,
                                                              torch.float32)
        xf, weight = x.to(ct), self.weight.to(ct)
        if not self.training:
            mean, var = self.running_mean.to(ct), self.running_var.to(ct)
            mul = torch.rsqrt(var + EPS) * weight
            y = (xf - mean.view(shape)) * mul.view(shape)
        elif not masked:
            mean = xf.mean(axes)
            var = torch.clamp(torch.square(xf).mean(axes) - torch.square(mean),
                              min=0.0)
            self._update(mean, var)
            mul = torch.rsqrt(var + EPS) * weight
            y = (xf - mean.view(shape)) * mul.view(shape)
        else:
            w = valid.to(ct).view((-1,) + (1,) * (x.dim() - 1))
            per_row = float(x[0, 0].numel())
            n = torch.clamp(valid.to(ct).sum(), min=1.0) * per_row
            mean = (xf * w).sum(axes) / n
            var = (torch.square(xf - mean.view(shape)) * w).sum(axes) / n
            has_rows = valid.sum() > 0
            self._update(mean, var * n / torch.clamp(n - 1.0, min=1.0),
                         has_rows)
            y = (xf - mean.view(shape)) * torch.rsqrt(var + EPS).view(shape) \
                * weight.view(shape)
        return (y + self.bias.to(ct).view(shape)).to(x.dtype)

    @torch.no_grad()
    def _update(self, mean, var, keep=None):
        """Running statistics <- 0.9 * running + 0.1 * batch, stored in
        float32."""
        new_mean = MOMENTUM * self.running_mean + (1.0 - MOMENTUM) * mean
        new_var = MOMENTUM * self.running_var + (1.0 - MOMENTUM) * var
        if keep is not None:
            new_mean = torch.where(keep, new_mean, self.running_mean)
            new_var = torch.where(keep, new_var, self.running_var)
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)
