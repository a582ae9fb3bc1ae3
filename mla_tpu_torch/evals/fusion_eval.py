"""Test-time fusion: fixed-alpha and entropy-gated dynamic weighting.

Port of ``mla_tpu/evals/fusion_eval.py``. Reference: main.py:65-106
(calculate_entropy / calculate_gating_weights{,3}) and the valid() gs branch
(main.py:622-651). Parity quirk preserved: the softmax runs over dim=0 — the
BATCH axis — so each modality gets ONE scalar weight per eval batch, not per
sample (SURVEY.md §7 hard-parts #3; results depend on eval batch size/order).
A per-sample variant is provided behind ``per_sample=True`` as the documented
improvement.
"""

from __future__ import annotations

from typing import Dict

import torch


def calculate_entropy(output: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """-sum(p log p) with p = softmax over the batch axis (main.py:65-70),
    restricted to valid rows (padding exclusion == reference's ragged batch)."""
    x = output.float()
    x = torch.where(valid[:, None] > 0, x, torch.full_like(x, -torch.inf))
    p = torch.softmax(x, dim=0)
    logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)),
                       torch.zeros_like(p))
    return -torch.sum(p * logp)


def gating_weights(outputs: Dict[str, torch.Tensor], valid: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """softmax(max_entropy - entropy_m) over modalities (main.py:72-106)."""
    ents = {m: calculate_entropy(o, valid) for m, o in outputs.items()}
    max_ent = torch.max(torch.stack(list(ents.values())))
    ws = {m: torch.exp(max_ent - e) for m, e in ents.items()}
    total = sum(ws.values())
    return {m: w / total for m, w in ws.items()}


def per_sample_gating_weights(outputs: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """Per-sample entropy gating (improvement, not parity): entropy of
    softmax over classes per row."""
    ents = {}
    for m, o in outputs.items():
        p = torch.softmax(o.float(), dim=1)
        ents[m] = -torch.sum(p * torch.log(torch.clamp(p, min=1e-38)), dim=1)
    max_ent = torch.max(torch.stack(list(ents.values()), dim=0), dim=0).values
    ws = {m: torch.exp(max_ent - e) for m, e in ents.items()}
    total = sum(ws.values())
    return {m: (w / total)[:, None] for m, w in ws.items()}


def fuse_outputs(outputs: Dict[str, torch.Tensor], valid, cfg,
                 per_sample: bool = False) -> torch.Tensor:
    """Dynamic or fixed-alpha fusion of per-modality logits (main.py:640-651).

    Types follow the JAX package: the gated sum is float32 (float32 weights
    promote the logits there), the fixed-alpha sum stays in the logits'
    dtype (a Python float is weakly typed in JAX)."""
    if cfg.dynamic:
        ws = per_sample_gating_weights(outputs) if per_sample else \
            gating_weights(outputs, valid)
        return sum(outputs[m].float() * ws[m] for m in outputs)
    if cfg.modal3:
        return (cfg.a_alpha * outputs["a"] + cfg.v_alpha * outputs["v"] +
                cfg.t_alpha * outputs["t"])
    return cfg.av_alpha * outputs["a"] + (1 - cfg.av_alpha) * outputs["v"]
