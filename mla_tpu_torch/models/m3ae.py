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
sin-cos tables and cast once to the weights' (compute) type; the blocks run
in that type.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mla_tpu_torch.models.layers import (M3AEBlock, reset_layer_norm,
                                         reset_xavier_linear)
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


class _Transformer(nn.Module):
    """The reference's ``encoder`` submodule: the block stack + final LN."""

    def __init__(self, c: M3AEConfig):
        super().__init__()
        self.blocks = nn.ModuleList(
            M3AEBlock(c.emb_dim, c.num_heads, c.mlp_ratio)
            for _ in range(c.depth))
        self.layer_norm = nn.LayerNorm(c.emb_dim, eps=1e-5)


class M3AEEncoder(nn.Module):
    def __init__(self, config: M3AEConfig = M3AEConfig()):
        super().__init__()
        c = self.config = config
        self.text_embedding = nn.Embedding(c.text_vocab_size, c.emb_dim)
        self.image_embedding = nn.Linear(PATCH_DIM, c.emb_dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.emb_dim))
        if c.use_type_embedding:
            self.encoder_image_type_embedding = nn.Parameter(
                torch.empty(1, 1, c.emb_dim))
            self.encoder_text_type_embedding = nn.Parameter(
                torch.empty(1, 1, c.emb_dim))
        self.encoder = _Transformer(c)
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
        for blk in self.encoder.blocks:
            x = blk(x, padding_mask)
        return self.finalize(x)

    def embed(self, image, text, text_padding_mask=None):
        c = self.config
        assert image is not None or text is not None
        ref = image if image is not None else text
        batch, dev = ref.shape[0], ref.device
        dt = self.cls_token.dtype
        parts = [self.cls_token.expand(batch, 1, c.emb_dim)]
        masks = [torch.zeros((batch, 1), dtype=torch.float32, device=dev)]
        if image is not None:
            w = self.image_embedding.weight
            proj = F.linear(image.to(w.dtype), w) + self.image_embedding.bias
            x = proj.float() + self._table("image", image.shape[1], dev)
            if c.use_type_embedding:
                x = x + self.encoder_image_type_embedding.float()
            parts.append(x.to(dt))
            masks.append(torch.zeros((batch, image.shape[1]),
                                     dtype=torch.float32, device=dev))
        if text is not None:
            x = (F.embedding(text.long(), self.text_embedding.weight).float()
                 + self._table("text", text.shape[1], dev))
            if c.use_type_embedding:
                x = x + self.encoder_text_type_embedding.float()
            parts.append(x.to(dt))
            if text_padding_mask is None:
                text_padding_mask = torch.zeros(text.shape, dtype=torch.float32,
                                                device=dev)
            masks.append(text_padding_mask.to(torch.float32))
        return torch.cat(parts, dim=1), torch.cat(masks, dim=1)

    def finalize(self, x):
        return self.encoder.layer_norm(x)
