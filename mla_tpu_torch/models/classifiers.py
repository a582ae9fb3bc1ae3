"""Classifier composition (port of ``mla_tpu/models/classifiers.py``).

Reference: models/basic_model.py:127-200. The port has the M3AE family so
far; ``build_classifier`` names the ROADMAP item that brings each other one.

Each classifier exposes the JAX package's interface:

  encode(batch, modality) -> (B, feat_dim) pooled features for one modality
                             ('a' | 'v'; reference naming: for --lorb m3ae,
                             'a' is TEXT)
  head(feat)              -> shared-head logits (MLA/gs path)
  forward(batch)          -> {'a','v','out_a','out_v'} under gs_flag,
                             {'a','v','out'} for joint fusion

``batch`` holds token (B, L) int, padding_mask (B, L) float (1 = padded) and
image (B, 3, H, W) float.
"""

from __future__ import annotations

import torch
from torch import nn

from mla_tpu_torch.core.config import MLAConfig
from mla_tpu_torch.models import fusion as fusion_lib
from mla_tpu_torch.models.m3ae import M3AEConfig, M3AEEncoder
from mla_tpu_torch.ops.image import patchify


def _make_fusion(fusion_method: str, gs_flag: bool, n_classes: int,
                 n_modalities: int, feat_dim: int) -> nn.Module:
    """fusion_module per basic_model.py:28-40 composition rules."""
    if fusion_method == "sum":
        return fusion_lib.SumFusion(feat_dim, n_classes)
    if fusion_method != "concat":
        raise NotImplementedError(
            f"fusion {fusion_method} declared but never constructed in the reference")
    if gs_flag:
        return fusion_lib.SharedHead(feat_dim, n_classes)
    if n_modalities == 3:
        return fusion_lib.ConcatFusion3(feat_dim, n_classes)
    return fusion_lib.ConcatFusion(feat_dim, n_classes)


class M3AEClassifier(nn.Module):
    """2x M3AE: text-only + image-only — basic_model.py:127-200.

    Reference naming quirk kept: 'a' is the TEXT branch, 'v' the image branch.
    """

    def __init__(self, n_classes: int = 101, fusion_method: str = "concat",
                 gs_flag: bool = False,
                 model_type: str = "base", text_vocab_size: int = 30522):
        super().__init__()
        self.gs_flag = gs_flag
        cfg = M3AEConfig(model_type=model_type, text_vocab_size=text_vocab_size)
        self.mae_a = M3AEEncoder(cfg)
        self.mae_v = M3AEEncoder(cfg)
        self.fusion_module = _make_fusion(fusion_method, gs_flag, n_classes, 2,
                                          cfg.emb_dim)

    def reset_parameters(self, gen: torch.Generator):
        self.mae_a.reset_parameters(gen)
        self.mae_v.reset_parameters(gen)
        self.fusion_module.reset_parameters(gen)

    def encode(self, batch, modality: str):
        if modality == "a":
            token = batch["token"].reshape(batch["token"].shape[0], -1)
            pm = batch["padding_mask"].reshape(token.shape)
            return self.mae_a(None, token, pm).mean(dim=1)
        if modality == "v":
            patches = patchify(batch["image"], 16)   # basic_model.py:184-186
            return self.mae_v(patches, None, None).mean(dim=1)
        raise ValueError(modality)

    def head(self, feat):
        return self.fusion_module(feat)

    def forward(self, batch):
        a = self.encode(batch, "a")
        v = self.encode(batch, "v")
        if self.gs_flag:
            return {"a": a, "v": v, "out_a": self.fusion_module(a),
                    "out_v": self.fusion_module(v)}
        _, _, out = self.fusion_module(a, v)
        return {"a": a, "v": v, "out": out}


def classifier_kwargs(cfg: MLAConfig) -> dict:
    """Constructor arguments of the classifier ``cfg`` selects (main.py:706-718).

    Only ``--lorb m3ae`` without ``--modal3`` is ported, without the QMF
    heads; the rest raises with the ROADMAP item that brings it."""
    if cfg.lorb == "m3ae" and cfg.modal3:
        raise NotImplementedError("--modal3 (CAV-MAE + 2x M3AE) is not ported "
                                  "yet: ROADMAP queue A, item 8")
    if cfg.lorb == "large":
        raise NotImplementedError("--lorb large (CAV-MAE) is not ported yet: "
                                  "ROADMAP queue A, item 8")
    if cfg.lorb == "base" and cfg.clip:
        raise NotImplementedError("--clip is not ported yet: ROADMAP queue A, "
                                  "item 8")
    if cfg.lorb == "base":
        raise NotImplementedError("--lorb base (ResNet-18) is not ported yet: "
                                  "ROADMAP queue A, item 3")
    if cfg.regime == "qmf":
        raise NotImplementedError("the QMF heads come with the training "
                                  "slice: ROADMAP queue A, item 2")
    return dict(n_classes=cfg.n_classes, fusion_method=cfg.fusion_method,
                gs_flag=cfg.gs_flag, model_type=cfg.m3ae_size)


def build_classifier(cfg: MLAConfig, seed: int = 0,
                     text_vocab_size: int = 30522) -> nn.Module:
    """The classifier ``cfg`` selects, on the CPU in float32, with weights
    drawn from ``torch.Generator().manual_seed(seed)``. Move it with
    ``.to(device, dtype)``."""
    kw = classifier_kwargs(cfg)
    with torch.device("meta"):
        model = M3AEClassifier(text_vocab_size=text_vocab_size, **kw)
    model = model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def modalities_of(cfg: MLAConfig):
    return ("a", "v", "t") if cfg.modal3 else ("a", "v")
