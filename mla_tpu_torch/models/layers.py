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

Mixed precision follows the JAX package's flax modules, not ``autocast``:
the blocks run in the type of their input (the encoder's compute type) and
cast each parameter to it per op (``linear``); LayerNorm computes in fp32
and returns the input's type (``layer_norm``). With fp32 master weights and
bf16 compute the casts' backward hands fp32 gradients to the fp32 weights;
with weights already in the compute type the casts do nothing.

int8 serving (``q8`` = "unrolled" or "stacked", the port of ``QDense`` and
the Mlp's fused route): each Linear site becomes a ``Q8Linear`` whose int8
weight goes through the B4 kernel (``ops/q8_matmul.py:q8_matmul``) or, in
the stacked layout, whose weight is a layer of the encoder's (L, N, K)
stack, read in place by B5 (``q8_matmul_stacked``) with the layer id on the
device. The bias is added in bf16 after the GEMM, then the result takes the
input's type (``mla_tpu/models/layers.py:129-131``). In the stacked layout
the Mlp runs fused through B6 (``q8_mlp_stacked``): always for int8, and
for W8A8 when neither of its sites is skipped; otherwise site by site
(``mla_tpu/models/layers.py:182-207``). ``configure_q8`` sets each site's
W8A8 switch from the artifact's skip set, by the JAX package's site names.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mla_tpu_torch.ops.attention import fused_attention_qkv
from mla_tpu_torch.ops.q8_matmul import (q8_matmul, q8_matmul_a8_reference,
                                         q8_matmul_reference,
                                         q8_matmul_stacked, q8_mlp_stacked,
                                         quantize_rows)


def linear(lin: nn.Linear, x):
    """``lin`` in x's type: weight and bias cast per op (flax Dense with
    ``dtype``, whose ``promote_dtype`` casts inputs and parameters)."""
    dt = x.dtype
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x, lin.weight.to(dt), bias)


def layer_norm(ln: nn.LayerNorm, x):
    """``ln`` with fp32 statistics and affine, returned in x's type (flax
    LayerNorm with ``dtype``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


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


# ------------------------------------------------------------------ int8

# A stacked site's weights: (int8 stack (L, N, K), fp32 scales (L, N), the
# layer id, an int32 scalar tensor on the stack's device).
Stacked = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# The W8A8 calibration recorder (runtime/export.py:calibrate_a8), which
# ``configure_q8`` sets on a calibration model's sites: each W8A8 site
# reports (site, the worst row's relative L2 error of its activations' row
# quantization) to it.
Recorder = Callable[[str, float], None]


def a8_rel_err(x2) -> float:
    """The worst row's relative L2 error that row quantization (W8A8) makes
    in (rows, K) activations (``_report_a8_relerr``)."""
    x2 = x2.float()
    xq, xs = quantize_rows(x2)
    err = torch.linalg.norm(xq.float() * xs[:, None] - x2, dim=-1)
    return float(torch.max(err / torch.clamp(torch.linalg.norm(x2, dim=-1),
                                             min=1e-9)))


def q8_product(x, w, scale, layer=None, a8: bool = False, site: str = "",
               record: Optional[Recorder] = None):
    """x (..., K) @ an int8 weight (N, K) with per-output-channel scale, or
    layer ``layer`` of a stack -> (..., N) bf16: B4 or B5 (W8A8 when
    ``a8``); with ``record`` (a calibration forward) the JAX package's
    reference laws, a W8A8 site reporting its error to ``record``."""
    if record is None:
        if layer is None:
            return q8_matmul(x, w, scale, a8)
        return q8_matmul_stacked(x, w, scale, layer, a8)
    if layer is not None:
        i = min(max(int(layer), 0), w.shape[0] - 1)
        w, scale = w[i], scale[i]
    x2 = x.reshape(-1, x.shape[-1])
    if a8:
        record(site, a8_rel_err(x2))
        y = q8_matmul_a8_reference(x2, w, scale)
    else:
        y = q8_matmul_reference(x2, w, scale)
    return y.reshape(*x.shape[:-1], w.shape[0])


class Q8Linear(nn.Module):
    """An int8 serving site: the int8 weight (N, K) and its fp32
    per-output-channel scale ``weight_scale`` (N,) as buffers (none in the
    stacked layout, where the encoder's stack holds them), the bias a
    parameter. ``site`` is the JAX package's name of the site, ``a8`` its
    W8A8 switch and ``record`` the calibration recorder, None when serving
    (``configure_q8``)."""

    def __init__(self, in_features: int, out_features: int,
                 stacked: bool = False):
        super().__init__()
        if not stacked:
            self.register_buffer("weight", torch.empty(
                (out_features, in_features), dtype=torch.int8))
            self.register_buffer("weight_scale", torch.empty(
                out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.site, self.a8 = "", False
        self.record: Optional[Recorder] = None

    def forward(self, x, stacked: Optional[Stacked] = None):
        w, s, layer = (self.weight, self.weight_scale, None) \
            if stacked is None else stacked
        y = q8_product(x, w, s, layer, self.a8, self.site, self.record)
        return (y + self.bias.to(torch.bfloat16)).to(x.dtype)


def _site(lin, x, q8w: Optional[Dict[str, Stacked]], name: str):
    """``lin`` on x: a float Linear per op in x's type, or an int8 site
    (with its layer of the stack ``name`` in the stacked layout)."""
    if isinstance(lin, Q8Linear):
        return lin(x, None if q8w is None else q8w[name])
    return linear(lin, x)


def _linear_or_q8(in_f: int, out_f: int, q8: Optional[str]):
    return nn.Linear(in_f, out_f) if q8 is None else \
        Q8Linear(in_f, out_f, stacked=q8 == "stacked")


class MultiHeadAttention(nn.Module):
    """Fused qkv projection -> masked attention -> output projection
    (m3ae.Attention, m3ae.py:88-127); scale = head_dim**-0.5."""

    def __init__(self, dim: int, num_heads: int, q8: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv_linear = _linear_or_q8(dim, 3 * dim, q8)
        self.fc = _linear_or_q8(dim, dim, q8)

    def reset_parameters(self, gen: torch.Generator):
        reset_xavier_linear(self.qkv_linear, gen)
        reset_xavier_linear(self.fc, gen)

    def forward(self, x, padding_mask: Optional[torch.Tensor] = None,
                q8w: Optional[Dict[str, Stacked]] = None):
        # the fused projection's (B, S, 3C) output feeds the flat kernel
        # directly; its (B, S, C) result is already in fc's layout
        qkv = _site(self.qkv_linear, x, q8w, "qkv")
        return _site(self.fc, fused_attention_qkv(qkv, padding_mask,
                                                  self.num_heads), q8w, "proj")


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> fc2, hidden = mlp_ratio * dim. In the int8
    stacked layout ``fused`` sends the pair through B6 (W8A8 when
    ``fused_a8``)."""

    def __init__(self, dim: int, out_dim: int, mlp_ratio: int = 4,
                 q8: Optional[str] = None):
        super().__init__()
        self.fc1 = _linear_or_q8(dim, mlp_ratio * dim, q8)
        self.fc2 = _linear_or_q8(mlp_ratio * dim, out_dim, q8)
        self.fused, self.fused_a8 = False, False

    def reset_parameters(self, gen: torch.Generator):
        reset_xavier_linear(self.fc1, gen)
        reset_xavier_linear(self.fc2, gen)

    def forward(self, x, q8w: Optional[Dict[str, Stacked]] = None):
        if self.fused and q8w is not None:
            (w1, s1, layer), (w2, s2, _) = q8w["fc1"], q8w["fc2"]
            return q8_mlp_stacked(x, w1, s1, self.fc1.bias, w2, s2,
                                  self.fc2.bias, layer,
                                  self.fused_a8).to(x.dtype)
        h = _site(self.fc1, x, q8w, "fc1")
        return _site(self.fc2, F.gelu(h, approximate="none"), q8w, "fc2")


class M3AEBlock(nn.Module):
    """Pre-LN block (m3ae.py:131-160), LayerNorm eps 1e-5."""

    def __init__(self, emb_dim: int, num_heads: int, mlp_ratio: int = 4,
                 q8: Optional[str] = None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(emb_dim, eps=1e-5)
        self.attention = MultiHeadAttention(emb_dim, num_heads, q8)
        self.layer_norm2 = nn.LayerNorm(emb_dim, eps=1e-5)
        self.transformer_mlp = Mlp(emb_dim, emb_dim, mlp_ratio, q8)

    def reset_parameters(self, gen: torch.Generator):
        reset_layer_norm(self.layer_norm1)
        self.attention.reset_parameters(gen)
        reset_layer_norm(self.layer_norm2)
        self.transformer_mlp.reset_parameters(gen)

    def forward(self, x, padding_mask=None,
                q8w: Optional[Dict[str, Stacked]] = None):
        x = x + self.attention(layer_norm(self.layer_norm1, x), padding_mask,
                               q8w)
        return x + self.transformer_mlp(layer_norm(self.layer_norm2, x), q8w)


# an encoder block's int8 sites: port module path in the block -> (the
# stacked layout's site, the JAX package's site name)
BLOCK_SITES = {"attention.qkv_linear": ("qkv", "attn/qkv"),
               "attention.fc": ("proj", "attn/proj"),
               "transformer_mlp.fc1": ("fc1", "mlp/fc1"),
               "transformer_mlp.fc2": ("fc2", "mlp/fc2")}
_BLOCK_SITE = re.compile(r"^(.*)\.encoder\.blocks\.(\d+)\.("
                         + "|".join(map(re.escape, BLOCK_SITES)) + r")$")


def block_site(path: str) -> Optional[Tuple[str, int, str]]:
    """The module path of an encoder block's int8 site -> (encoder path,
    block index, its ``BLOCK_SITES`` key); None for any other path."""
    m = _BLOCK_SITE.match(path)
    return None if m is None else (m.group(1), int(m.group(2)), m.group(3))


def jax_site_name(path: str, stacked: bool) -> Optional[str]:
    """The JAX package's W8A8 site name of the Linear at module ``path``:
    ``mae_a/block_0/attn/qkv`` unrolled; in the stacked layout the block is
    a detached template (``mla_tpu/models/m3ae.py:224``), so one name,
    ``attn/qkv``, covers that site in every layer of both encoders. None
    for a site that never runs W8A8 (the image-patch GEMM)."""
    site = block_site(path)
    if site is None:
        return None
    enc, i, sub = site
    name = BLOCK_SITES[sub][1]
    return name if stacked else f"{enc}/block_{i}/{name}"


def configure_q8(model: nn.Module, a8: bool, skip=frozenset(),
                 stacked: bool = False, record: Optional[Recorder] = None):
    """Set every int8 site's W8A8 switch (on under ``a8`` unless its JAX
    site name is in ``skip``) and every stacked Mlp's route: fused through
    B6 for int8, and for W8A8 only when neither of its sites is skipped.
    With ``record`` the model is a calibration forward: every site takes
    the reference laws and reports to it, and no Mlp is fused (the JAX
    package's calibration forces both)."""
    for path, mod in model.named_modules():
        if isinstance(mod, Q8Linear):
            site = jax_site_name(path, stacked)
            mod.site = site or ""
            mod.a8 = a8 and site is not None and site not in skip
            mod.record = record
    for mod in model.modules():          # after every site's switch is set
        if isinstance(mod, Mlp) and isinstance(mod.fc1, Q8Linear):
            both = mod.fc1.a8 and mod.fc2.a8
            mod.fused = stacked and record is None and (not a8 or both)
            mod.fused_a8 = a8 and both
