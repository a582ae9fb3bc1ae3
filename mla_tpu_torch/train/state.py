"""Train state (port of ``mla_tpu/train/state.py``): the model (which holds
the parameters), optimizer state, GS projector, QMF history, random
generator and step count.

The JAX package's state is an immutable pytree; here the parameters live in
the model and the steps update them, the moment buffers and the stores in
place. The JAX PRNG key becomes a ``torch.Generator`` on the state's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from mla_tpu_torch.device import resolve_device, set_matmul_precision
from mla_tpu_torch.models.classifiers import modalities_of
from mla_tpu_torch.train.gs import GSState, init_gs_state
from mla_tpu_torch.train.optim import OptimizerSpec, init_opt_state


@dataclasses.dataclass
class QMFState:
    """Per-sample cumulative-loss + confidence stores, one per modality
    (reference: utils/utils.py:44-95 History). Slot n_data is a scratch slot
    for padded batch rows."""
    correctness: Dict[str, torch.Tensor]
    confidence: Dict[str, torch.Tensor]


def init_qmf_state(n_data: int, modalities, device=None) -> QMFState:
    def z():
        return torch.zeros(n_data + 1, dtype=torch.float32, device=device)
    return QMFState(correctness={m: z() for m in modalities},
                    confidence={m: z() for m in modalities})


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: Dict[str, dict]
    gs: Optional[GSState]
    qmf: Optional[QMFState]
    rng: torch.Generator
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, cfg, spec: OptimizerSpec,
                       n_data: int = 0, seed: int = 0,
                       device=None) -> TrainState:
    """Train state around ``model`` (built with its weights, e.g. by
    ``build_classifier``), on ``device`` (the card unless 'cpu' is asked
    for). The weights become float32 master weights; the model computes in
    ``cfg.compute_dtype``, casting them per op (the M3AE encoders and the
    ResNets alike), and is put in training mode. BatchNorm's running
    statistics, the JAX state's ``batch_stats``, are the model's float32
    buffers on the same device."""
    dev = resolve_device(device)
    set_matmul_precision()
    model.to(dev, torch.float32).train()
    model.set_compute_dtype(getattr(torch, cfg.compute_dtype))
    params = dict(model.named_parameters())
    gs = None
    if cfg.gs_flag:
        # Pl sized to the actual shared-head width (the head weight is
        # (n_classes, width))
        gs = init_gs_state(params["fusion_module.fc_out.weight"].shape[1],
                           device=dev)
    qmf = None
    if cfg.modulation == "QMF":
        qmf = init_qmf_state(n_data, modalities_of(cfg), device=dev)
    return TrainState(model=model, opt_state=init_opt_state(spec, params),
                      gs=gs, qmf=qmf,
                      rng=torch.Generator(device=dev).manual_seed(seed))


# Top-level module -> modality label ('a'/'v'/'t'/'head'/'other').
# Mirrors the reference's name-substring matching: 'audio'/'visual'
# (main.py:396-407) and 'mae_a'/'mae_v'/'mae_t' (main.py:348-368).
TOP_LEVEL_LABELS = {
    "audio_net": "a", "visual_net": "v",
    "mae_a": "a", "mae_v": "v", "mae_t": "t",
    "fusion_module": "head",
    "audio_fc": "a", "visual_fc": "v", "txtual_fc": "t",
}


def modality_of_path(path) -> str:
    """path: a parameter name's dot-separated parts."""
    if not path:
        return "other"
    return TOP_LEVEL_LABELS.get(path[0], "other")
