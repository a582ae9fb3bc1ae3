"""Per-class accuracy and the inference forward (port of
``mla_tpu/evals/metrics.py``).

Ported: the gs_flag (MLA) branch of ``eval_logits``, fixed-alpha and
``--dynamic``; ``top1_accuracy``; ``per_class_counts``. The QMF and joint
branches need the training slice's energy confidence and sliced modality
logits (ROADMAP queue A, item 2) and raise until then.
"""

from __future__ import annotations

import torch

from mla_tpu_torch.evals.fusion_eval import fuse_outputs
from mla_tpu_torch.models.classifiers import modalities_of


def top1_accuracy(logits, label, valid=None):
    """Plain top-1 accuracy (reference: utils/evaluation.py:4-15
    obtain_top1_accuracy — defined but unused there)."""
    pred = torch.argmax(logits.float(), dim=1)
    correct = (pred == label).float()
    if valid is None:
        return correct.mean()
    return (correct * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def per_class_counts(logits, label, valid, n_classes):
    """Correct predictions per true class, over valid rows."""
    pred = torch.argmax(logits.float(), dim=1)
    correct = (pred == label).float() * valid
    return torch.zeros(n_classes, dtype=correct.dtype,
                       device=correct.device).index_add_(0, label.long(),
                                                         correct)


def eval_logits(model, cfg, batch, valid):
    """Inference forward -> (out_m: {modality: (B, n_classes)}, fused:
    (B, n_classes)) with the regime's eval-time fusion (valid() fusion
    branches, main.py:617-651). ``valid`` (B,) masks padded rows out of the
    batch-axis gating."""
    if not cfg.gs_flag:
        raise NotImplementedError(
            "the QMF and joint eval fusion branches come with the training "
            "slice (ROADMAP queue A, item 2); the port serves --gs_flag")
    out = model(batch)
    out_m = {m: out[f"out_{m}"] for m in modalities_of(cfg)}
    return out_m, fuse_outputs(out_m, valid, cfg)
