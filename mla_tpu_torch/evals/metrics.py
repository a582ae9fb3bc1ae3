"""Per-class accuracy, the inference forward and the eval step (port of
``mla_tpu/evals/metrics.py``).

Replaces the reference's per-sample argmax loop (main.py:659-676) with one
scatter-add per batch on the device; the caller only pulls (n_classes,)
count vectors.
"""

from __future__ import annotations

from typing import Dict

import torch

from mla_tpu_torch.evals.fusion_eval import fuse_outputs
from mla_tpu_torch.models.classifiers import modalities_of
from mla_tpu_torch.train.steps import _energy_conf, sliced_modality_logits


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
    modalities = modalities_of(cfg)
    out = model(batch)
    if cfg.gs_flag:
        out_m = {m: out[f"out_{m}"] for m in modalities}
        return out_m, fuse_outputs(out_m, valid, cfg)
    if cfg.modulation == "QMF" and cfg.lorb != "large":
        # lorb=large has no QMF heads and the reference's branch order makes
        # QMF inert for it (main.py:166-170): it takes the joint branch
        out_m = {m: out[m] for m in modalities}
        fused = sum(out_m[m] * _energy_conf(out_m[m])[:, None]
                    for m in modalities)
        return out_m, fused
    out_m = sliced_modality_logits(
        {m: out[m] for m in modalities}, model.fusion_module,
        cfg.fusion_method, cfg.modal3, bias_div=True)
    return out_m, out["out"]


def make_eval_step(model, cfg):
    """Returns step(batch) -> dict of (n_classes,) counts
    {'num','acc','acc_a','acc_v'[,'acc_t']} for the caller to accumulate
    (valid() semantics, main.py:486-679). ``batch`` holds the model's inputs,
    ``label`` and ``valid``; the model (with its weights) runs under
    ``torch.inference_mode`` in eval mode (BatchNorm on its running
    statistics, which it leaves unchanged, the JAX package's
    ``train=False``), and is put back in the mode it was found in."""
    modalities = modalities_of(cfg)
    n_classes = cfg.n_classes

    def step(batch):
        was_training = model.training
        model.eval()
        try:
            return _counts(batch)
        finally:
            model.train(was_training)

    def _counts(batch):
        with torch.inference_mode():
            valid, label = batch["valid"], batch["label"].long()
            out_m, fused = eval_logits(model, cfg, batch, valid)
            counts = {
                "num": torch.zeros(n_classes, dtype=valid.dtype,
                                   device=valid.device).index_add_(
                                       0, label, valid),
                "acc": per_class_counts(fused, label, valid, n_classes),
            }
            for m in modalities:
                counts[f"acc_{m}"] = per_class_counts(out_m[m], label, valid,
                                                      n_classes)
            return counts

    return step


def summarize_counts(totals: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """sum(acc)/sum(num) per head (main.py:677-679)."""
    num = float(torch.sum(totals["num"]))
    return {k: float(torch.sum(v)) / max(num, 1.0)
            for k, v in totals.items() if k != "num"}
