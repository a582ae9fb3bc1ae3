"""Classifier composition (port of ``mla_tpu/models/classifiers.py``).

Reference: models/basic_model.py:14-77 (AVClassifier, 2x ResNet-18) and
127-200 (M3AEClassifier). The port has these two families so far;
``build_classifier`` names the ROADMAP item that brings each other one.

Each classifier exposes the JAX package's interface:

  encode(batch, modality) -> (B, feat_dim) pooled features for one modality
                             ('a' | 'v'; reference naming: for --lorb m3ae,
                             'a' is TEXT). The JAX package's ``train``
                             argument is the module mode: ``train()`` uses
                             and updates BatchNorm's batch statistics,
                             ``eval()`` its running ones (M3AE has no
                             mode-dependent layer).
  head(feat)              -> shared-head logits (MLA/gs path)
  forward(batch)          -> {'a','v','out_a','out_v'} under gs_flag,
                             {'a','v'} per-modality logits under QMF,
                             {'a','v','out'} for joint fusion
  set_compute_dtype(dt)   -> run the encoders and heads in ``dt`` whatever
                             the weights' type (training: fp32 weights, bf16
                             compute); None = the weights' type

``batch`` holds, for M3AE, token (B, L) int, padding_mask (B, L) float
(1 = padded) and image (B, 3, H, W) float; for AV, spec (B, 1, F, T) and
image (B, 3, T, H, W) float, and under ``--masked_bn`` valid (B,) float.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mla_tpu_torch.core.config import MLAConfig
from mla_tpu_torch.models import fusion as fusion_lib
from mla_tpu_torch.models.layers import linear
from mla_tpu_torch.models.m3ae import M3AEConfig, M3AEEncoder
from mla_tpu_torch.models.resnet import (ResNet18, fold_frames, pool_audio,
                                         pool_visual)
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
                 gs_flag: bool = False, qmf: bool = False,
                 model_type: str = "base", text_vocab_size: int = 30522,
                 q8: Optional[str] = None):
        super().__init__()
        self.gs_flag = gs_flag
        self.qmf = qmf
        cfg = M3AEConfig(model_type=model_type, text_vocab_size=text_vocab_size)
        self.mae_a = M3AEEncoder(cfg, q8)
        self.mae_v = M3AEEncoder(cfg, q8)
        if qmf:
            # per-modality QMF heads (the JAX package's _qmf_head with torch
            # nn.Linear's default init, classifiers.py:227-232). The QMF
            # forward never reaches the fusion head, so the JAX package's
            # parameters have none, and neither do the port's.
            self.audio_fc = nn.Linear(cfg.emb_dim, n_classes)
            self.visual_fc = nn.Linear(cfg.emb_dim, n_classes)
        else:
            self.fusion_module = _make_fusion(fusion_method, gs_flag,
                                              n_classes, 2, cfg.emb_dim)

    def reset_parameters(self, gen: torch.Generator):
        self.mae_a.reset_parameters(gen)
        self.mae_v.reset_parameters(gen)
        if not self.qmf:
            self.fusion_module.reset_parameters(gen)
        else:
            fusion_lib.reset_torch_default(self.audio_fc, gen)
            fusion_lib.reset_torch_default(self.visual_fc, gen)

    def set_compute_dtype(self, dtype):
        self.mae_a.compute_dtype = dtype
        self.mae_v.compute_dtype = dtype
        return self

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
        if self.qmf:
            return {"a": linear(self.audio_fc, a), "v": linear(self.visual_fc, v)}
        if self.gs_flag:
            return {"a": a, "v": v, "out_a": self.fusion_module(a),
                    "out_v": self.fusion_module(v)}
        _, _, out = self.fusion_module(a, v)
        return {"a": a, "v": v, "out": out}


class AVClassifier(nn.Module):
    """2x ResNet-18 (audio spectrogram / visual frames) — basic_model.py:14-77.

    Heads are xavier-normal with zero bias: the reference's weight_init
    reaches the non-CLIP AVClassifier (main.py:717-719)."""

    def __init__(self, n_classes: int = 6, fusion_method: str = "concat",
                 gs_flag: bool = False, qmf: bool = False,
                 masked_bn: bool = False, stages=(2, 2, 2, 2),
                 pallas_conv: bool = False):
        super().__init__()
        self.gs_flag = gs_flag
        self.qmf = qmf
        self.masked_bn = masked_bn
        self.stages = tuple(stages)
        self.audio_net = ResNet18(1, self.stages, pallas_conv)
        self.visual_net = ResNet18(3, self.stages, pallas_conv)
        dim = self.audio_net.out_channels
        if qmf:
            # as for M3AE: the QMF forward never reaches the fusion head
            self.audio_fc = nn.Linear(dim, n_classes)
            self.visual_fc = nn.Linear(dim, n_classes)
        else:
            self.fusion_module = _make_fusion(fusion_method, gs_flag,
                                              n_classes, 2, dim)

    def reset_parameters(self, gen: torch.Generator):
        self.audio_net.reset_parameters(gen)
        self.visual_net.reset_parameters(gen)
        if self.qmf:
            fusion_lib.reset_xavier_normal(self.audio_fc, gen)
            fusion_lib.reset_xavier_normal(self.visual_fc, gen)
        else:
            self.fusion_module.reset_parameters(
                gen, init=fusion_lib.reset_xavier_normal)

    def set_compute_dtype(self, dtype):
        self.audio_net.compute_dtype = dtype
        self.visual_net.compute_dtype = dtype
        return self

    def encode(self, batch, modality: str):
        valid = batch.get("valid") if (self.training and self.masked_bn) \
            else None
        if modality == "a":
            return pool_audio(self.audio_net(batch["spec"], valid))
        if modality == "v":
            image = batch["image"]                  # (B, 3, T, H, W)
            b, t = image.shape[0], image.shape[2]
            fvalid = None if valid is None else valid.repeat_interleave(t)
            return pool_visual(self.visual_net(fold_frames(image), fvalid), b)
        raise ValueError(modality)

    def head(self, feat):
        return self.fusion_module(feat)

    def forward(self, batch):
        a = self.encode(batch, "a")
        v = self.encode(batch, "v")
        if self.qmf:
            return {"a": linear(self.audio_fc, a), "v": linear(self.visual_fc, v)}
        if self.gs_flag:
            return {"a": a, "v": v, "out_a": self.fusion_module(a),
                    "out_v": self.fusion_module(v)}
        _, _, out = self.fusion_module(a, v)
        return {"a": a, "v": v, "out": out}


def resolve_pallas_conv(cfg: MLAConfig) -> bool:
    """Whether the ResNet's stride-1 3x3 convs take the B3 kernel. 'auto'
    resolves to off, as in the JAX package. On an H100 B3's device time is
    at or under cuDNN's at most of the 8 CREMA-D sites and within 8% at the
    rest, and the AV MLA step runs within the host's spread of the cuDNN
    step (PERF.md section 6)."""
    return cfg.pallas_conv == "on"


def classifier_kwargs(cfg: MLAConfig) -> dict:
    """Constructor arguments of the classifier ``cfg`` selects (main.py:706-718).

    Ported: ``--lorb m3ae`` without ``--modal3`` (M3AEClassifier) and
    ``--lorb base`` without ``--clip`` (AVClassifier); the rest raises with
    the ROADMAP item that brings it. ``gs_flag`` takes precedence over
    ``--modulation QMF``: the reference's gs branch never touches the QMF
    heads (main.py:419-485, 617-639)."""
    if cfg.lorb == "m3ae" and cfg.modal3:
        raise NotImplementedError("--modal3 (CAV-MAE + 2x M3AE) is not ported "
                                  "yet: ROADMAP queue A, item 8")
    if cfg.lorb == "large":
        raise NotImplementedError("--lorb large (CAV-MAE) is not ported yet: "
                                  "ROADMAP queue A, item 8")
    if cfg.lorb == "base" and cfg.clip:
        raise NotImplementedError("--clip is not ported yet: ROADMAP queue A, "
                                  "item 8")
    kw = dict(n_classes=cfg.n_classes, fusion_method=cfg.fusion_method,
              gs_flag=cfg.gs_flag,
              qmf=cfg.modulation == "QMF" and not cfg.gs_flag)
    if cfg.lorb == "base":
        return dict(kw, masked_bn=cfg.masked_bn,
                    stages=tuple(cfg.resnet_stages),
                    pallas_conv=resolve_pallas_conv(cfg))
    return dict(kw, model_type=cfg.m3ae_size)


def make_classifier(cfg: MLAConfig, text_vocab_size: int = 30522,
                    q8: Optional[str] = None) -> nn.Module:
    """The classifier ``cfg`` selects, on the meta device (no storage): load
    a state_dict into it with ``assign=True``, or ``to_empty`` it. ``q8``
    ("unrolled" or "stacked") builds the M3AE family's int8 serving sites
    (``models/layers.py``); the AV family has none (an int8 artifact
    dequantizes its weights at load)."""
    kw = classifier_kwargs(cfg)
    with torch.device("meta"):
        if cfg.lorb == "base":
            return AVClassifier(**kw)
        return M3AEClassifier(text_vocab_size=text_vocab_size, q8=q8, **kw)


def build_classifier(cfg: MLAConfig, seed: int = 0,
                     text_vocab_size: int = 30522) -> nn.Module:
    """The classifier ``cfg`` selects, on the CPU in float32, with weights
    drawn from ``torch.Generator().manual_seed(seed)``. Move it with
    ``.to(device)``."""
    model = make_classifier(cfg, text_vocab_size).to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


@torch.no_grad()
def cast_parameters_(model: nn.Module, dtype) -> nn.Module:
    """The parameters to ``dtype`` in place. Buffers keep their types:
    BatchNorm's running statistics stay float32 (the JAX package's export
    keeps ``batch_stats`` in float32 under bf16 weights)."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


def modalities_of(cfg: MLAConfig):
    return ("a", "v", "t") if cfg.modal3 else ("a", "v")
