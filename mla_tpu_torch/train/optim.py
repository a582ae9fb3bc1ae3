"""Optimizers with torch-exact semantics and per-leaf modes (port of
``mla_tpu/train/optim.py``).

The reference uses torch.optim.SGD(lr, momentum .9, wd 1e-4) and, for
``--cav_opti``, Adam with split lr groups (reference: main.py:735-760).
MLA's alternating sub-steps need per-sub-step masked updates with three
per-leaf modes that the reference's torch-1.8.1 behaviour implies:

  REAL : normal update (grad present)
  GHOST: grad zeroed by optimizer.zero_grad() but still present — momentum
         decay + weight-decay-only update (encoders stepped earlier in the
         same batch keep being updated — main.py:439-440,452-453)
  SKIP : grad is None — untouched (main.py:468-470)

``torch.optim`` skips a parameter whose ``grad`` is None, so it would lose
the GHOST updates; the update is written out here instead, with
``torch._foreach_*`` over the leaves that share a mode, an lr scale and (for
Adam) a step count. SGD is d = g + wd*p; buf = mu*buf + d; p -= lr*buf
(coupled weight decay before momentum); Adam is the coupled-wd variant with
bias correction and a per-leaf step count that only advances when the leaf
is updated.

Trees are flat dicts keyed by the port's parameter names
(``model.named_parameters()``). Parameters and moment buffers are updated in
place (the JAX package returns new trees); a gradient of None is the JAX
package's zero gradient of a leaf the loss does not reach.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

REAL, GHOST, SKIP = 0, 1, 2

HEAD_WEIGHT = "fusion_module.fc_out.weight"


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    kind: str = "sgd"              # 'sgd' | 'adam'
    momentum: float = 0.9
    weight_decay: float = 1e-4     # coupled (torch-style)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # per-parameter lr multiplier by name (cav_opti: head 1.0, rest 0.1 —
    # main.py:739-746); None = 1.0 everywhere
    lr_scales: Optional[Mapping[str, float]] = None
    # moment-buffer storage dtype (--opt_dtype). Math runs in the param
    # dtype; the stored (rounded) moment drives the param update.
    state_dtype: str = "float32"


def init_opt_state(spec: OptimizerSpec, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, dict]:
    sd = getattr(torch, spec.state_dtype)

    def zeros():
        return {n: torch.zeros_like(p, dtype=sd) for n, p in params.items()}

    if spec.kind == "sgd":
        return {"momentum": zeros()}
    if spec.kind == "adam":
        return {"m": zeros(), "v": zeros(), "t": {n: 0 for n in params}}
    raise ValueError(spec.kind)


def _f32(x: float) -> float:
    return float(np.float32(x))


@torch.no_grad()
def apply_updates(spec: OptimizerSpec, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, Optional[torch.Tensor]],
                  opt_state: Dict[str, dict], lr: float,
                  modes: Optional[Mapping[str, int]] = None) -> None:
    """One optimizer step, in place on ``params`` and ``opt_state``.

    ``modes``: per-parameter REAL/GHOST/SKIP (None = REAL everywhere). A
    GHOST leaf's gradient is ignored; a REAL leaf with no gradient (None or
    absent) steps with a zero gradient."""
    if spec.kind not in ("sgd", "adam"):
        raise ValueError(spec.kind)
    scales = spec.lr_scales or {}
    adam = spec.kind == "adam"
    groups: Dict[tuple, list] = {}
    for n in params:
        mode = REAL if modes is None else modes[n]
        if mode == SKIP:
            continue
        g = grads.get(n) if mode == REAL else None
        t = opt_state["t"][n] if adam else 0
        key = (g is not None, scales.get(n, 1.0), t)
        groups.setdefault(key, []).append(n)
    for (has_grad, scale, t), names in groups.items():
        ps = [params[n] for n in names]
        d = torch._foreach_mul(ps, spec.weight_decay)
        if has_grad:
            torch._foreach_add_(d, [grads[n] for n in names])
        step = lr * scale
        if adam:
            _adam(spec, ps, d, [opt_state["m"][n] for n in names],
                  [opt_state["v"][n] for n in names], t + 1, step)
            for n in names:
                opt_state["t"][n] = t + 1
        else:
            _sgd(spec, ps, d, [opt_state["momentum"][n] for n in names],
                 step)


def _in_param_type(bufs, ps):
    return [b.to(p.dtype) for b, p in zip(bufs, ps)]


def _store(bufs, new):
    """Write the new moments into their buffers (rounding to the storage
    type) and return what drives the update: the stored values in the
    parameters' type."""
    if bufs[0].dtype == new[0].dtype:
        return new
    torch._foreach_copy_(bufs, new)
    return _in_param_type(bufs, new)


def _sgd(spec, ps, d, bufs, step):
    if bufs[0].dtype == ps[0].dtype:
        torch._foreach_mul_(bufs, spec.momentum)
        torch._foreach_add_(bufs, d)
        new = bufs
    else:
        new = torch._foreach_mul(_in_param_type(bufs, ps), spec.momentum)
        torch._foreach_add_(new, d)
        new = _store(bufs, new)
    torch._foreach_add_(ps, new, alpha=-step)


def _adam(spec, ps, d, ms, vs, t, step):
    same = ms[0].dtype == ps[0].dtype
    new_m = ms if same else _in_param_type(ms, ps)
    new_v = vs if same else _in_param_type(vs, ps)
    if same:
        torch._foreach_mul_(new_m, spec.b1)
        torch._foreach_mul_(new_v, spec.b2)
    else:
        new_m = torch._foreach_mul(new_m, spec.b1)
        new_v = torch._foreach_mul(new_v, spec.b2)
    torch._foreach_add_(new_m, torch._foreach_mul(d, 1 - spec.b1))
    torch._foreach_add_(new_v, torch._foreach_mul(
        torch._foreach_mul(d, d), 1 - spec.b2))
    if not same:
        new_m, new_v = _store(ms, new_m), _store(vs, new_v)
    # bias corrections in fp32, as the JAX package computes them
    tf = np.float32(t)
    bc1 = _f32(np.float32(1) - np.float32(spec.b1) ** tf)
    bc2 = _f32(np.float32(1) - np.float32(spec.b2) ** tf)
    denom = torch._foreach_sqrt(torch._foreach_div(new_v, bc2))
    torch._foreach_add_(denom, spec.eps)
    upd = torch._foreach_div(torch._foreach_div(new_m, bc1), denom)
    torch._foreach_add_(ps, upd, alpha=-step)


# ---------------------------------------------------------------------------
# Epoch LR schedules (reference: main.py:749-760)
# ---------------------------------------------------------------------------

def step_lr(lr0: float, decay_step: int, decay_ratio: float, epoch: int) -> float:
    """torch StepLR: lr0 * ratio**(epoch // step)."""
    return lr0 * (decay_ratio ** (epoch // decay_step))


def cav_multistep_lr(lr0: float, epoch: int, start: int = 2, step: int = 1,
                     gamma: float = 0.5) -> float:
    """torch MultiStepLR(range(2, 1000, 1), 0.5) — main.py:752-757."""
    n_milestones = max(0, min(epoch, 999) - start + 1) if epoch >= start else 0
    return lr0 * (gamma ** n_milestones)


def lr_for_epoch(cfg, epoch: int) -> float:
    if cfg.lorb == "large" and cfg.cav_lrs:
        return cav_multistep_lr(cfg.learning_rate, epoch)
    return step_lr(cfg.learning_rate, cfg.lr_decay_step, cfg.lr_decay_ratio, epoch)


def make_spec(cfg, params: Optional[Iterable[str]] = None) -> OptimizerSpec:
    """Optimizer selection mirroring main.py:735-751; ``params``: the
    parameter names (or a name-keyed dict) the lr scales are keyed on."""
    sd = cfg.opt_dtype
    if cfg.lorb == "large" and cfg.cav_opti:
        scales = None
        if params is not None:
            # Full lr applies ONLY to fusion_module.fc_out.weight: the
            # reference's mlp_list second entry carries a stray 'module.'
            # prefix ('module.fusion_module.fc_out.bias', main.py:738) that
            # never matches model.module.named_parameters(), so the bias —
            # like everything else — trains at lr/10.
            scales = {n: 1.0 if n == HEAD_WEIGHT else 0.1 for n in params}
        return OptimizerSpec(kind="adam", weight_decay=5e-7, b1=0.95, b2=0.999,
                             lr_scales=scales, state_dtype=sd)
    if cfg.optimizer == "adam":
        return OptimizerSpec(kind="adam", weight_decay=0.0, b1=0.9, b2=0.999,
                             state_dtype=sd)
    return OptimizerSpec(kind="sgd", momentum=0.9, weight_decay=1e-4,
                         state_dtype=sd)


def modality_mode_tree(names: Iterable[str], modality_of_path, current: str,
                       already_stepped, ghost_updates: bool) -> Dict[str, int]:
    """REAL/GHOST/SKIP per parameter name for one MLA sub-step.

    modality_of_path(path) -> 'a'|'v'|'t'|'head'|'other', path = the name's
    dot-separated parts. REAL for the current modality's encoder + head;
    GHOST for encoders already stepped this batch (torch-1.8.1 parity); SKIP
    otherwise."""
    def mode(name):
        lbl = modality_of_path(tuple(name.split(".")))
        if lbl == current or lbl == "head":
            return REAL
        if ghost_updates and lbl in already_stepped:
            return GHOST
        return SKIP
    return {n: mode(n) for n in names}
