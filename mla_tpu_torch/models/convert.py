"""The weight bridge into the port.

``state_dict_from_jax`` is the port's own counterpart of the JAX package's
``export_classifier``: it turns a Flax parameter tree (nested dicts of numpy
arrays) into the reference PyTorch state_dict that the port's modules use
(Dense kernel (in, out) -> Linear weight (out, in); LayerNorm scale/bias ->
weight/bias; a ``--scan_blocks`` tree's stacked ``blocks`` -> per-block
entries). ``load_reference_checkpoint`` reads a reference ``saved_dict``
``.pth`` (reference main.py:915-927, as written by ``main.py --export_torch``)
and strips the DataParallel ``module.`` prefix.

The train state crosses the same way: ``opt_state_from_jax`` maps the JAX
optimizer state (SGD ``momentum``, Adam ``m``/``v``/``t``, trees shaped
like the params) onto the port's parameter names with the same key mapping,
and ``gs_state_from_jax`` / ``qmf_state_from_jax`` carry the GS projector
and the QMF history. They read plain attributes and arrays, so the port
needs none of the JAX package to take them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from mla_tpu_torch.train.gs import GSState
from mla_tpu_torch.train.state import QMFState


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _linear(sd, node, name):
    sd[name + ".weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[name + ".bias"] = _t(node["bias"])


def _layer_norm(sd, node, name):
    sd[name + ".weight"] = _t(node["scale"])
    sd[name + ".bias"] = _t(node["bias"])


def _unstack_blocks(params: Mapping) -> Dict:
    """A scan-blocks encoder tree ({'blocks': leaves with a leading depth
    axis}) -> the unrolled {'block_0', ..., 'block_{L-1}'} layout."""
    if "blocks" not in params:
        return dict(params)

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    def depth(tree):
        if isinstance(tree, Mapping):
            return depth(next(iter(tree.values())))
        return np.asarray(tree).shape[0]

    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(depth(params["blocks"])):
        out[f"block_{i}"] = take(params["blocks"], i)
    return out


def m3ae_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """M3AEEncoder params -> reference models/m3ae.py state_dict names."""
    params = _unstack_blocks(params)
    sd: Dict[str, torch.Tensor] = {}
    sd[prefix + "text_embedding.weight"] = _t(params["text_embedding"])
    sd[prefix + "image_embedding.weight"] = _t(
        np.asarray(params["image_kernel"]).T)
    sd[prefix + "image_embedding.bias"] = _t(params["image_bias"])
    sd[prefix + "cls_token"] = _t(params["cls_token"])
    for t in ("encoder_image_type_embedding", "encoder_text_type_embedding"):
        if t in params:
            sd[prefix + t] = _t(params[t])
    depth = sum(1 for k in params if k.startswith("block_"))
    for i in range(depth):
        blk = params[f"block_{i}"]
        t = f"{prefix}encoder.blocks.{i}"
        _layer_norm(sd, blk["norm1"], f"{t}.layer_norm1")
        _layer_norm(sd, blk["norm2"], f"{t}.layer_norm2")
        _linear(sd, blk["attn"]["qkv"], f"{t}.attention.qkv_linear")
        _linear(sd, blk["attn"]["proj"], f"{t}.attention.fc")
        _linear(sd, blk["mlp"]["fc1"], f"{t}.transformer_mlp.fc1")
        _linear(sd, blk["mlp"]["fc2"], f"{t}.transformer_mlp.fc2")
    _layer_norm(sd, params["final_norm"], prefix + "encoder.layer_norm")
    return sd


def state_dict_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Full Flax classifier params -> the reference classifier state_dict
    (float32 tensors, no ``module.`` prefix). Ported family: ``--lorb m3ae``
    without ``--modal3``."""
    if cfg.lorb != "m3ae" or cfg.modal3:
        raise NotImplementedError(
            "state_dict_from_jax covers the ported M3AE classifier "
            "(--lorb m3ae without --modal3); see ROADMAP queue A")
    sd = m3ae_state_dict(params["mae_a"], "mae_a.")
    sd.update(m3ae_state_dict(params["mae_v"], "mae_v."))
    for fc in ("audio_fc", "visual_fc"):
        if fc in params:
            _linear(sd, params[fc], fc)
    for fc in ("fc_out", "fc_x", "fc_y", "fc"):
        if fc in params.get("fusion_module", {}):
            _linear(sd, params["fusion_module"][fc], f"fusion_module.{fc}")
    return sd


def _tree_f32(tree):
    """Nested dicts of arrays (any float type, bf16 included) -> float32
    numpy, the form ``state_dict_from_jax`` reads."""
    if isinstance(tree, Mapping):
        return {k: _tree_f32(v) for k, v in tree.items()}
    return np.asarray(tree).astype(np.float32)


def opt_state_from_jax(opt_state: Mapping, cfg) -> Dict[str, dict]:
    """JAX optimizer state -> the port's (``train/optim.py``): moment trees
    keyed by parameter name (kernels transposed), in their storage type
    (``--opt_dtype``); Adam's per-leaf step counts as ints."""
    dt = getattr(torch, cfg.opt_dtype)
    out = {}
    for key in ("momentum", "m", "v"):
        if key in opt_state:
            out[key] = {n: t.to(dt) for n, t in state_dict_from_jax(
                _tree_f32(opt_state[key]), cfg).items()}
    if "t" in opt_state:
        out["t"] = {n: int(t) for n, t in state_dict_from_jax(
            _tree_f32(opt_state["t"]), cfg).items()}
    return out


def gs_state_from_jax(gs):
    """A JAX ``GSState`` (``Pl``, ``exp_count``) -> the port's."""
    return GSState(Pl=_t(gs.Pl), exp_count=int(np.asarray(gs.exp_count)))


def qmf_state_from_jax(qmf):
    """A JAX ``QMFState`` (per-modality ``correctness`` and ``confidence``,
    n_data + 1 slots) -> the port's."""
    return QMFState(correctness={m: _t(v) for m, v in qmf.correctness.items()},
                    confidence={m: _t(v) for m, v in qmf.confidence.items()})


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``saved_dict`` ``.pth`` (or a bare state_dict) -> its model
    state_dict with the DataParallel ``module.`` prefix stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["model"] if isinstance(obj, dict) and "model" in obj else obj
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}
