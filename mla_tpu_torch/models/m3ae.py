"""M3AE (Masked Multimodal Autoencoder) encoder, PyTorch port of
``mla_tpu/models/m3ae.py``.

Reference: models/m3ae.py:271-370 — BERT-vocab (30522) text embedding,
linear image-patch embedding (768 -> emb_dim), per-modality type embeddings,
CLS token, pre-LN Transformer with -1e7 padding-mask attention, final LN.
``forward`` concatenates [CLS, image tokens, text tokens]; either modality may
be absent. Size configs small/base/large/huge/debug (m3ae.py:226-268). Blocks
are unrolled; parameter names are the reference state_dict's.

Init parity quirks kept: text embedding ~ N(0, 1) (m3ae.py:317); cls/type
embeddings use torch ``.normal_(0.02)`` which is mean=0.02, std=1.0
(m3ae.py:322-330) — NOT std=0.02.

Types follow the JAX module: the embeddings are summed in fp32 with the
sin-cos tables and cast once to the compute type; the blocks run in that
type, casting each parameter per op (``layers.linear``). The compute type is
``compute_dtype`` when set (training: fp32 master weights, bf16 compute),
else the weights' type (serving casts the weights themselves).

int8 serving (``q8`` = "unrolled" or "stacked", ``mla_tpu/models/m3ae.py:
197-300``): the image-patch projection is an int8 site through B4 (weight
only, then ``+ bias`` in the compute type and ``+ pos`` in fp32), the text
table an int8 gather scaled per row in fp32. The stacked layout keeps each
block site's kernels of all layers in one (L, N, K) stack (``Q8Stack``),
which B5 and B6 read in place given the layer id; the blocks keep their
small float parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mla_tpu_torch.models.layers import (M3AEBlock, Q8Linear, Stacked,
                                         layer_norm, q8_product,
                                         reset_layer_norm, reset_xavier_linear)
from mla_tpu_torch.ops.pos_embed import (get_1d_sincos_pos_embed,
                                         get_2d_sincos_pos_embed_square)

# model_type -> (emb_dim, depth, num_heads, mlp_ratio)  (m3ae.py:226-268)
M3AE_CONFIGS = {
    "small": (384, 12, 6, 4),
    "base": (768, 12, 12, 4),
    "base1": (768, 1, 12, 4),    # base width at depth 1 (a CI knob)
    "large": (1024, 24, 16, 4),
    "huge": (1280, 32, 16, 4),
    "debug": (1024, 2, 16, 4),
}

PATCH_DIM = 768  # 3 x 16 x 16 pixels per image patch


@dataclasses.dataclass(frozen=True)
class M3AEConfig:
    model_type: str = "base"
    text_vocab_size: int = 30522
    use_type_embedding: bool = True

    @property
    def emb_dim(self):
        return M3AE_CONFIGS[self.model_type][0]

    @property
    def depth(self):
        return M3AE_CONFIGS[self.model_type][1]

    @property
    def num_heads(self):
        return M3AE_CONFIGS[self.model_type][2]

    @property
    def mlp_ratio(self):
        return M3AE_CONFIGS[self.model_type][3]


class Q8Embedding(nn.Module):
    """An int8 embedding table (V, C) with fp32 per-row scales (V,)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.register_buffer("weight", torch.empty((num, dim),
                                                   dtype=torch.int8))
        self.register_buffer("weight_scale", torch.empty(num,
                                                         dtype=torch.float32))

    def forward(self, ids):
        """(B, L) ids -> (B, L, C) fp32: the gathered int8 rows times their
        scales; the table never materializes in float."""
        ids = ids.long()
        return self.weight[ids].float() * self.weight_scale[ids][..., None]


# a block's int8 sites and their (out, in) widths by emb_dim C, ratio r
_Q8_SITES = {"qkv": lambda c, r: (3 * c, c), "proj": lambda c, r: (c, c),
             "fc1": lambda c, r: (r * c, c), "fc2": lambda c, r: (c, r * c)}


class Q8Stack(nn.Module):
    """The stacked int8 layout's kernels: per block site an (L, N, K) int8
    stack ``<site>_weight`` and its (L, N) fp32 scales ``<site>_scale``."""

    def __init__(self, c: M3AEConfig):
        super().__init__()
        for site, shape in _Q8_SITES.items():
            n, k = shape(c.emb_dim, c.mlp_ratio)
            self.register_buffer(f"{site}_weight", torch.empty(
                (c.depth, n, k), dtype=torch.int8))
            self.register_buffer(f"{site}_scale", torch.empty(
                (c.depth, n), dtype=torch.float32))
        self._ids: Dict[torch.device, torch.Tensor] = {}

    def layer(self, i: int) -> Dict[str, Stacked]:
        """Block ``i``'s view of the stacks: {site: (stack, scales, id)},
        the id an int32 scalar on the stacks' device (made once per
        device), so the kernels read the layer without a host copy."""
        dev = self.qkv_weight.device
        ids = self._ids.get(dev)
        if ids is None:
            ids = self._ids[dev] = torch.arange(
                self.qkv_weight.shape[0], dtype=torch.int32, device=dev)
        return {site: (getattr(self, f"{site}_weight"),
                       getattr(self, f"{site}_scale"), ids[i])
                for site in _Q8_SITES}


class _Transformer(nn.Module):
    """The reference's ``encoder`` submodule: the block stack + final LN
    (and, in the stacked int8 layout, the blocks' int8 kernels)."""

    def __init__(self, c: M3AEConfig, q8: Optional[str] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            M3AEBlock(c.emb_dim, c.num_heads, c.mlp_ratio, q8)
            for _ in range(c.depth))
        self.layer_norm = nn.LayerNorm(c.emb_dim, eps=1e-5)
        self.stack = Q8Stack(c) if q8 == "stacked" else None


class M3AEEncoder(nn.Module):
    def __init__(self, config: M3AEConfig = M3AEConfig(),
                 q8: Optional[str] = None):
        super().__init__()
        c = self.config = config
        if q8 is None:
            self.text_embedding = nn.Embedding(c.text_vocab_size, c.emb_dim)
            self.image_embedding = nn.Linear(PATCH_DIM, c.emb_dim)
        else:
            self.text_embedding = Q8Embedding(c.text_vocab_size, c.emb_dim)
            self.image_embedding = Q8Linear(PATCH_DIM, c.emb_dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.emb_dim))
        if c.use_type_embedding:
            self.encoder_image_type_embedding = nn.Parameter(
                torch.empty(1, 1, c.emb_dim))
            self.encoder_text_type_embedding = nn.Parameter(
                torch.empty(1, 1, c.emb_dim))
        self.encoder = _Transformer(c, q8)
        # None: the weights' type (see the module docstring)
        self.compute_dtype: Optional[torch.dtype] = None
        # sin-cos tables by (kind, length, device): constants, not weights
        self._pos: Dict[Tuple[str, int, torch.device], torch.Tensor] = {}

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.text_embedding.weight.normal_(0.0, 1.0, generator=gen)
        reset_xavier_linear(self.image_embedding, gen)
        self.cls_token.normal_(0.02, 1.0, generator=gen)
        if self.config.use_type_embedding:
            self.encoder_image_type_embedding.normal_(0.02, 1.0, generator=gen)
            self.encoder_text_type_embedding.normal_(0.02, 1.0, generator=gen)
        for blk in self.encoder.blocks:
            blk.reset_parameters(gen)
        reset_layer_norm(self.encoder.layer_norm)

    def _table(self, kind: str, length: int, device) -> torch.Tensor:
        key = (kind, length, torch.device(device))
        t = self._pos.get(key)
        if t is None:
            make = (get_2d_sincos_pos_embed_square if kind == "image"
                    else get_1d_sincos_pos_embed)
            t = torch.from_numpy(make(self.config.emb_dim, length)).to(device)
            self._pos[key] = t
        return t

    def forward(self, image: Optional[torch.Tensor],
                text: Optional[torch.Tensor],
                text_padding_mask: Optional[torch.Tensor] = None):
        """forward_representation (m3ae.py:342-370).

        image: (B, N_img, 768) pre-patchified pixels or None
        text:  (B, L) int token ids or None
        text_padding_mask: (B, L) float, 1 = padded
        returns (B, 1 + N_img + L, emb_dim) token features."""
        x, padding_mask = self.embed(image, text, text_padding_mask)
        stack = self.encoder.stack
        for i, blk in enumerate(self.encoder.blocks):
            x = blk(x, padding_mask, None if stack is None else stack.layer(i))
        return self.finalize(x)

    def embed(self, image, text, text_padding_mask=None):
        c = self.config
        assert image is not None or text is not None
        ref = image if image is not None else text
        batch, dev = ref.shape[0], ref.device
        dt = self.compute_dtype or self.cls_token.dtype
        parts = [self.cls_token.to(dt).expand(batch, 1, c.emb_dim)]
        masks = [torch.zeros((batch, 1), dtype=torch.float32, device=dev)]
        if image is not None:
            emb = self.image_embedding
            if isinstance(emb, Q8Linear):
                proj = q8_product(image, emb.weight, emb.weight_scale,
                                  record=emb.record).to(dt)
            else:
                proj = F.linear(image.to(dt), emb.weight.to(dt))
            proj = proj + emb.bias.to(dt)
            x = proj.float() + self._table("image", image.shape[1], dev)
            if c.use_type_embedding:
                x = x + self.encoder_image_type_embedding.float()
            parts.append(x.to(dt))
            masks.append(torch.zeros((batch, image.shape[1]),
                                     dtype=torch.float32, device=dev))
        if text is not None:
            if isinstance(self.text_embedding, Q8Embedding):
                emb = self.text_embedding(text)
            else:
                emb = F.embedding(text.long(), self.text_embedding.weight)
            x = emb.float() + self._table("text", text.shape[1], dev)
            if c.use_type_embedding:
                x = x + self.encoder_text_type_embedding.float()
            parts.append(x.to(dt))
            if text_padding_mask is None:
                text_padding_mask = torch.zeros(text.shape, dtype=torch.float32,
                                                device=dev)
            masks.append(text_padding_mask.to(torch.float32))
        return torch.cat(parts, dim=1), torch.cat(masks, dim=1)

    def finalize(self, x):
        return layer_norm(self.encoder.layer_norm, x)
