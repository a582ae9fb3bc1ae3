"""Reference-loadable ``.pth`` export (port of
``mla_tpu/models/torch_export.py:save_torch_checkpoint``).

The port's modules already carry the reference's parameter and buffer names
(``models/convert.py``), so the export is the model's state_dict in float32
on the CPU, written in the reference's ``saved_dict`` layout (reference
main.py:915-927): metadata plus the DataParallel ``module.``-prefixed
``model`` state_dict, which the reference's eval branch (main.py:946-953)
and warm-start branch (main.py:721-728) both load unchanged.
``convert.load_reference_checkpoint`` reads it back.
"""

from __future__ import annotations

import torch


def reference_state_dict(model: torch.nn.Module):
    """The model's state_dict as the reference saves it: float entries in
    float32, integer ones (BatchNorm's batch counters) as they are, on the
    CPU, each owning its storage."""
    return {k: (v.detach().to("cpu", torch.float32) if v.is_floating_point()
                else v.detach().cpu()).clone()
            for k, v in model.state_dict().items()}


def save_torch_checkpoint(path: str, model: torch.nn.Module, cfg,
                          epoch: int = 0, acc: float = 0.0) -> str:
    """Write ``model``'s weights to ``path`` in the reference's saved_dict
    layout, with the DataParallel ``module.`` prefix its own training loop
    produces."""
    sd = reference_state_dict(model)
    torch.save({"saved_epoch": int(epoch),
                "modulation": cfg.modulation,
                "alpha": cfg.alpha,
                "fusion": cfg.fusion_method,
                "acc": float(acc),
                "model": {"module." + k: v for k, v in sd.items()}}, path)
    return path
