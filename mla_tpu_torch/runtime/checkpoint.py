"""Checkpoint / resume / weight averaging (port of
``mla_tpu/runtime/checkpoint.py``).

Reference behaviour replicated (main.py:682-694, 721-728, 900-953): best-acc
checkpoint with metadata, warm-start load that drops the shared-head
output layer, eval-only load, offline weight averaging; plus full mid-run
resume.

Layout, as the JAX package's: a checkpoint is a DIRECTORY
``<ckpt_dir>/<name>/`` holding ``state.pt`` (``torch.save``, in place of
Orbax), with ``<name>.meta.json`` beside it. A directory name never ends in
``.pt``/``.pth``/``.pkl``, which the eval-only branch reads as a reference
checkpoint. ``state.pt`` holds everything the train state holds: the
model's state_dict (parameters and BatchNorm buffers), the optimizer state,
the GS projector ``Pl`` and its counter, the QMF history, the generator's
state and the step.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional

import torch

from mla_tpu_torch.train.gs import GSState
from mla_tpu_torch.train.state import QMFState, TrainState

STATE_FILE = "state.pt"


def _host(x):
    """A snapshot on the host: tensors copied to the CPU (and off the
    device's later in-place updates), nested dicts and ints as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _to_saveable(state: TrainState) -> Dict[str, Any]:
    d = {"model": state.model.state_dict(), "opt_state": state.opt_state,
         "rng": state.rng.get_state(), "step": int(state.step)}
    if state.gs is not None:
        d["gs"] = {"Pl": state.gs.Pl, "exp_count": int(state.gs.exp_count)}
    if state.qmf is not None:
        d["qmf"] = {"correctness": state.qmf.correctness,
                    "confidence": state.qmf.confidence}
    return _host(d)


def _write(path: str, saveable: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(saveable, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def _write_meta(path: str, meta: Dict[str, Any]) -> None:
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def save_checkpoint(ckpt_dir: str, state: TrainState, meta: Dict[str, Any],
                    name: str = "best") -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    _write(path, _to_saveable(state))
    _write_meta(path, meta)
    return path


# -- async saves -------------------------------------------------------------
# The reference blocks the epoch loop on torch.save of the best model
# (main.py:684-694). Here the snapshot to the host is taken synchronously
# (it must see a consistent state), the file write runs on a background
# thread, so the next epoch's device work overlaps the disk I/O. One save is
# in flight per process; a new save (or the end of the run) first waits for
# it. meta.json is written only after the data has committed.

_PENDING: Optional[tuple] = None     # (thread, path, meta, [error])
_PENDING_LOCK = threading.Lock()


def save_checkpoint_async(ckpt_dir: str, state: TrainState,
                          meta: Dict[str, Any], name: str = "best") -> str:
    global _PENDING
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    saveable = _to_saveable(state)          # synchronous D2H snapshot
    wait_for_async_saves()                  # flush the previous save + meta
    errors: list = []

    def write():
        try:
            _write(path, saveable)
        except Exception as e:   # noqa: BLE001 — re-raised by the waiter
            errors.append(e)

    t = threading.Thread(target=write, daemon=False)
    t.start()
    with _PENDING_LOCK:
        _PENDING = (t, path, meta, errors)
    return path


def wait_for_async_saves() -> None:
    """Block until the in-flight async write has committed, then write its
    meta.json (call before reading the checkpoint back or ending the run).
    Raises the write's error, if it had one."""
    global _PENDING
    with _PENDING_LOCK:
        pending, _PENDING = _PENDING, None
    if pending is None:
        return
    t, path, meta, errors = pending
    t.join()
    if errors:
        raise errors[0]
    _write_meta(path, meta)


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore into an existing (template) TrainState, in place; tensors go
    to the device the template's live on."""
    raw = _load(path)
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(raw["model"], strict=True)
    state.opt_state = {
        k: {n: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for n, v in tree.items()}
        for k, tree in raw["opt_state"].items()}
    state.rng.set_state(raw["rng"])
    state.step = int(raw["step"])
    if state.gs is not None and "gs" in raw:
        state.gs = GSState(Pl=raw["gs"]["Pl"].to(dev),
                           exp_count=int(raw["gs"]["exp_count"]))
    if state.qmf is not None and "qmf" in raw:
        state.qmf = QMFState(
            correctness={k: v.to(dev)
                         for k, v in raw["qmf"]["correctness"].items()},
            confidence={k: v.to(dev)
                        for k, v in raw["qmf"]["confidence"].items()})
    return state


def load_meta(path: str) -> Dict[str, Any]:
    """Checkpoint metadata. A crash between the async data commit and the
    deferred meta.json write can leave a committed checkpoint with no meta
    file — the weights are valid, so rebuild what the directory name
    encodes instead of failing."""
    path = os.path.abspath(path)
    try:
        with open(path + ".meta.json") as f:
            return json.load(f)
    except FileNotFoundError:
        if not os.path.isdir(path):
            raise
        meta: Dict[str, Any] = {"reconstructed": True}
        # best-ckpt names embed epoch/acc (the driver's name template)
        m = re.search(r"epoch_(\d+)_acc_([\d.]+)$", os.path.basename(path))
        if m:
            meta["saved_epoch"] = int(m.group(1))
            meta["acc"] = float(m.group(2).rstrip("."))
        return meta


def warm_start_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint's parameters into ``model`` (in place), dropping
    only the shared head's output layer, as the reference warm start does
    (main.py:721-728 deletes fusion_module.fc_out.weight/.bias — other
    fusion parameters, e.g. SumFusion's fc_x/fc_y, ARE loaded). BatchNorm's
    running statistics keep the model's, as the JAX package loads params
    only."""
    loaded = _load(path)["model"]
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in loaded.items():
            if name in params and not name.startswith("fusion_module.fc_out."):
                params[name].copy_(value)
    return model


def wa_params(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """Average every checkpoint's state_dict in a directory, INCLUDING the
    BatchNorm running statistics — the reference's wa_model averages the
    full state_dict (main.py:682-694). Integer entries (BatchNorm's batch
    counters) keep the first checkpoint's."""
    names = [n for n in sorted(os.listdir(ckpt_dir))
             if os.path.isdir(os.path.join(ckpt_dir, n))]
    if not names:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    acc: Dict[str, torch.Tensor] = {}
    for n in names:
        sd = _load(os.path.join(ckpt_dir, n))["model"]
        for k, v in sd.items():
            if k not in acc:
                acc[k] = v.clone()
            elif v.is_floating_point():
                acc[k] += v
    k = float(len(names))
    return {n: (v / k if v.is_floating_point() else v)
            for n, v in acc.items()}
