"""CAV-MAE fine-tuned audio-visual encoder (CAVMAEFT), PyTorch port of
``mla_tpu/models/cav_mae.py``.

Reference: models/cav_mae.py:116-364 — per-modality 16x16 PatchEmbeds
(audio 1 channel over the (128, T) transposed fbank -> an 8 x T/16 grid,
512 patches at T = 1024; visual 3 channels, 224x224 -> 196 patches),
learnable modality embeddings and trainable sin-cos-initialised position
embeddings, ``modality_specific_depth`` blocks per modality, then
``depth - modality_specific_depth`` shared blocks with per-modality
LayerNorms, final ``norm_a`` / ``norm_v``. Parameter names are the
reference's (``models/torch_export.py:export_cavmae``).

``modalities`` says which modality paths exist: the JAX package creates a
flax submodule's parameters only when it runs, so a classifier's audio
encoder has ``patch_embed_a``, ``blocks_a`` and ``norm_a`` and no visual
path (its ``modality_v`` and ``pos_embed_v`` exist, as ``self.param``
calls in setup); ``with_head`` adds the shared ``norm`` and the
``mlp_head`` (LayerNorm, Linear) of the five classification modes.

Types follow the JAX module: the patch conv runs in the compute type, and
adding the fp32 ``pos_embed`` and ``modality`` parameters promotes the
tokens to fp32, so the residual stream stays fp32 through every block
under bf16 compute; each block's LayerNorm hands its attention and MLP the
compute type (``layers.CAVBlock``); the final norms return the compute
type (flax ``nn.LayerNorm(dtype=...)``). The patch conv stays
``F.conv2d``: the JAX package computes it with ``nn.Conv``, outside any
Pallas kernel. Attention runs through ``fused_attention_qkv`` with no
mask (B1f/B1b on the card).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mla_tpu_torch.models.layers import (CAVBlock, layer_norm,
                                         reset_layer_norm,
                                         reset_xavier_linear)
from mla_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed_rect

N_MEL = 128      # fbank mel bins (cav_mae.py:129)


class PatchEmbed(nn.Module):
    """16x16 stride-16 conv patchify: (B, C, H, W) -> (B, N, D) row-major
    tokens, in the compute type."""

    def __init__(self, in_chans: int, embed_dim: int = 768, patch: int = 16):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_chans, embed_dim, patch, stride=patch)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        # flax xavier_uniform over the receptive field, zero bias
        f, c, kh, kw = self.proj.weight.shape
        bound = math.sqrt(6.0 / (c * kh * kw + f * kh * kw))
        self.proj.weight.uniform_(-bound, bound, generator=gen)
        self.proj.bias.zero_()

    def forward(self, x, dtype):
        w = self.proj.weight
        y = F.conv2d(x.to(dtype), w.to(dtype), self.proj.bias.to(dtype),
                     stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class CAVMAEFT(nn.Module):
    def __init__(self, label_dim: int = 6, img_size: int = 224,
                 audio_length: int = 1024, embed_dim: int = 768,
                 modality_specific_depth: int = 11, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4,
                 with_head: bool = False, modalities: Sequence[str] = ("a",
                                                                       "v"),
                 q8: Optional[str] = None):
        super().__init__()
        d = embed_dim
        self.modalities = tuple(modalities)
        self.with_head = with_head
        self.grid_a = (8, audio_length * N_MEL // 256 // 8)
        self.grid_v = (img_size // 16, img_size // 16)
        self.modality_a = nn.Parameter(torch.empty(1, 1, d))
        self.modality_v = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed_a = nn.Parameter(torch.empty(1, math.prod(self.grid_a),
                                                    d))
        self.pos_embed_v = nn.Parameter(torch.empty(1, math.prod(self.grid_v),
                                                    d))
        blocks = lambda n: nn.ModuleList(
            CAVBlock(d, num_heads, mlp_ratio, q8) for _ in range(n))
        if "a" in self.modalities:
            self.patch_embed_a = PatchEmbed(1, d)
            self.blocks_a = blocks(modality_specific_depth)
            self.norm_a = nn.LayerNorm(d, eps=1e-5)
        if "v" in self.modalities:
            self.patch_embed_v = PatchEmbed(3, d)
            self.blocks_v = blocks(modality_specific_depth)
            self.norm_v = nn.LayerNorm(d, eps=1e-5)
        self.blocks_u = blocks(depth - modality_specific_depth)
        if with_head:
            self.norm = nn.LayerNorm(d, eps=1e-5)
            self.mlp_head = nn.Sequential(nn.LayerNorm(d, eps=1e-5),
                                          nn.Linear(d, label_dim))
        # None: the weights' type (as M3AEEncoder.compute_dtype)
        self.compute_dtype: Optional[torch.dtype] = None

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.modality_a.normal_(0.0, 0.02, generator=gen)
        self.modality_v.normal_(0.0, 0.02, generator=gen)
        d = self.pos_embed_a.shape[-1]
        for p, grid in ((self.pos_embed_a, self.grid_a),
                        (self.pos_embed_v, self.grid_v)):
            p.copy_(torch.from_numpy(get_2d_sincos_pos_embed_rect(
                d, *grid))[None])
        for m in self.modalities:
            getattr(self, f"patch_embed_{m}").reset_parameters(gen)
            for blk in getattr(self, f"blocks_{m}"):
                blk.reset_parameters(gen)
            reset_layer_norm(getattr(self, f"norm_{m}"))
        for blk in self.blocks_u:
            blk.reset_parameters(gen)
        if self.with_head:
            reset_layer_norm(self.norm)
            reset_layer_norm(self.mlp_head[0])
            reset_xavier_linear(self.mlp_head[1], gen)

    def _dtype(self):
        return self.compute_dtype or self.pos_embed_a.dtype

    # -- embedding helpers -----------------------------------------------
    def _embed_a(self, a):
        """a: (B, T, 128) fbank -> (B, 1, 128, T) (the reference's
        unsqueeze(1).transpose(2, 3), cav_mae.py:190-193) -> tokens."""
        x = self.patch_embed_a(a.transpose(1, 2)[:, None], self._dtype())
        return x + self.pos_embed_a + self.modality_a

    def _embed_v(self, v):
        """v: (B, 3, H, W)."""
        x = self.patch_embed_v(v, self._dtype())
        return x + self.pos_embed_v + self.modality_v

    def _specific(self, x, m):
        dt = self._dtype()
        for blk in getattr(self, f"blocks_{m}"):
            x = blk(x, None, dt)
        return x

    def _unified(self, x, modality):
        dt = self._dtype()
        for blk in self.blocks_u:
            x = blk(x, modality, dt)
        return x

    def _norm(self, ln, x):
        return layer_norm(ln, x).to(self._dtype())

    def _feat(self, m, x):
        embed = self._embed_a if m == "a" else self._embed_v
        x = self._unified(self._specific(embed(x), m), m)
        return self._norm(getattr(self, f"norm_{m}"), x)

    # -- public API --------------------------------------------------------
    def forward_feat(self, a: Optional[torch.Tensor],
                     v: Optional[torch.Tensor], mode: str = "av"):
        """Token features per modality (cav_mae.py:307-364)."""
        if mode == "a":
            return self._feat("a", a)
        if mode == "v":
            return self._feat("v", v)
        if mode == "av":
            return self._feat("a", a), self._feat("v", v)
        raise ValueError(f"unknown mode {mode}")

    def forward(self, a, v, mode: str = "multimodal"):
        """The classification forward (cav_mae.py:187-304, made runnable
        as in the JAX package)."""
        assert self.with_head, "build CAVMAEFT(with_head=True) for forward()"
        if mode == "multimodal":
            xa = self._specific(self._embed_a(a), "a")
            xv = self._specific(self._embed_v(v), "v")
            x = self._unified(torch.cat([xa, xv], dim=1), None)
            x = self._norm(self.norm, x).mean(dim=1)
        elif mode == "audioonly":
            x = self._feat("a", a).mean(dim=1)
        elif mode == "videoonly":
            x = self._feat("v", v).mean(dim=1)
        elif mode in ("missingaudioonly", "missingvideoonly"):
            m = "a" if mode == "missingaudioonly" else "v"
            embed = self._embed_a if m == "a" else self._embed_v
            feat = self._specific(embed(a if m == "a" else v), m)
            u = self._norm(self.norm, self._unified(feat, None)).mean(dim=1)
            s = self._norm(getattr(self, f"norm_{m}"),
                           self._unified(feat, m)).mean(dim=1)
            x = (u + s) / 2.0
        else:
            raise ValueError(f"unknown mode {mode}")
        ln, head = self.mlp_head
        return F.linear(self._norm(ln, x), head.weight.to(x.dtype),
                        head.bias.to(x.dtype))
