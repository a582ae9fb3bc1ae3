"""The weight bridge into the port.

``state_dict_from_jax`` is the port's own counterpart of the JAX package's
``export_classifier``: it turns a Flax parameter tree (nested dicts of numpy
arrays) into the reference PyTorch state_dict that the port's modules use
(Dense kernel (in, out) -> Linear weight (out, in); Conv kernel HWIO ->
OIHW; LayerNorm and BatchNorm scale/bias -> weight/bias, and flax
``batch_stats`` mean/var -> BatchNorm ``running_mean``/``running_var`` with
``num_batches_tracked`` 0; a ``--scan_blocks`` tree's stacked ``blocks`` ->
per-block entries). An int8 tree (``_quantize_int8``'s ``{'q8', 'scale'}``
nodes, unrolled or stacked) maps the same way: each quantized weight becomes
its int8 tensor under the weight's name and its fp32 scale under the name
plus ``_scale``, both in the port's layout (``runtime/export.py:
quantize_int8`` writes the same dict); ``q8_state_dict`` turns that dict
into the state_dict of the int8 serving model. ``load_reference_checkpoint`` reads a reference ``saved_dict``
``.pth`` (reference main.py:915-927, as written by ``main.py --export_torch``)
and strips the DataParallel ``module.`` prefix.

The train state crosses the same way: ``opt_state_from_jax`` maps the JAX
optimizer state (SGD ``momentum``, Adam ``m``/``v``/``t``, trees shaped
like the params) onto the port's parameter names with the same key mapping,
and ``gs_state_from_jax`` / ``qmf_state_from_jax`` carry the GS projector
and the QMF history; ``batch_stats_from_jax`` the BatchNorm running
statistics. They read plain attributes and arrays, so the port needs none
of the JAX package to take them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from mla_tpu_torch.models.layers import BLOCK_SITES, block_site
from mla_tpu_torch.train.gs import GSState
from mla_tpu_torch.train.state import QMFState


def _t(x) -> torch.Tensor:
    """An array -> a tensor: integers keep their type, floats (bf16
    included) become float32."""
    a = np.asarray(x)
    if not (np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_):
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _is_q8(node) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q8", "scale"}


def _weight(sd, leaf, name, layout=lambda a: a):
    """A kernel or table leaf -> ``name`` (in the port's layout, via
    ``layout``); an int8 node also -> ``name + '_scale'``, laid out alike."""
    if _is_q8(leaf):
        sd[name] = _t(layout(np.asarray(leaf["q8"])))
        sd[name + "_scale"] = _t(layout(np.asarray(leaf["scale"])))
    else:
        sd[name] = _t(layout(np.asarray(leaf)))


def _linear(sd, node, name):
    _weight(sd, node["kernel"], name + ".weight", np.transpose)
    if "bias" in node:
        sd[name + ".bias"] = _t(node["bias"])


def _layer_norm(sd, node, name):
    sd[name + ".weight"] = _t(node["scale"])
    sd[name + ".bias"] = _t(node["bias"])


def _conv(sd, node, name):
    _weight(sd, node["kernel"], name + ".weight",
            lambda a: a.transpose(3, 2, 0, 1))


# a flax ResNet block's submodules -> the reference BasicBlock's
_BLOCK = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
          "downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _resnet_nodes(tree: Mapping, prefix: str):
    """(flax node, torch name, kind) over a ResNet18 tree (params or
    batch_stats), kind 'conv' or 'bn'. Iterates the blocks present, so
    --resnet_stages variants map too (``export_resnet18``)."""
    if "conv1" in tree:
        yield tree["conv1"], prefix + "conv1", "conv"
    if "bn1" in tree:
        yield tree["bn1"], prefix + "bn1", "bn"
    for name in sorted(tree):
        if not name.startswith("layer"):
            continue
        stage, blk = name[len("layer"):].split("_")
        for sub, torch_name in _BLOCK.items():
            if sub in tree[name]:
                yield (tree[name][sub],
                       f"{prefix}layer{stage}.{blk}.{torch_name}",
                       "conv" if "conv" in sub else "bn")


def resnet_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """ResNet18 params -> reference models/backbone.py parameter names."""
    sd: Dict[str, torch.Tensor] = {}
    for node, name, kind in _resnet_nodes(params, prefix):
        (_conv if kind == "conv" else _layer_norm)(sd, node, name)
    return sd


def batch_stats_from_jax(batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``batch_stats`` ({'audio_net': {...}, 'visual_net': {...}}) ->
    the BatchNorm buffers: ``running_mean``/``running_var`` (float32) and
    ``num_batches_tracked`` 0, under the reference names."""
    sd: Dict[str, torch.Tensor] = {}
    for net in ("audio_net", "visual_net"):
        for node, name, _ in _resnet_nodes(batch_stats.get(net, {}),
                                           f"{net}."):
            sd[name + ".running_mean"] = _t(node["mean"])
            sd[name + ".running_var"] = _t(node["var"])
            sd[name + ".num_batches_tracked"] = torch.zeros((),
                                                            dtype=torch.long)
    return sd


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
    _weight(sd, params["text_embedding"], prefix + "text_embedding.weight")
    _weight(sd, params["image_kernel"], prefix + "image_embedding.weight",
            np.transpose)
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


def state_dict_from_jax(params: Mapping, cfg, batch_stats=None
                        ) -> Dict[str, torch.Tensor]:
    """Full Flax classifier params -> the reference classifier state_dict
    (float32 tensors, no ``module.`` prefix). Ported families: ``--lorb
    m3ae`` without ``--modal3`` and ``--lorb base`` without ``--clip``.
    ``batch_stats`` (the AV family's) adds the BatchNorm buffers; without it
    the dict holds parameters only, the shape of an optimizer moment tree."""
    if cfg.lorb == "base" and not cfg.clip:
        sd = resnet_state_dict(params["audio_net"], "audio_net.")
        sd.update(resnet_state_dict(params["visual_net"], "visual_net."))
        if batch_stats is not None:
            sd.update(batch_stats_from_jax(batch_stats))
    elif cfg.lorb == "m3ae" and not cfg.modal3:
        sd = m3ae_state_dict(params["mae_a"], "mae_a.")
        sd.update(m3ae_state_dict(params["mae_v"], "mae_v."))
    else:
        raise NotImplementedError(
            "state_dict_from_jax covers the ported classifiers (--lorb m3ae "
            "without --modal3, --lorb base without --clip); see ROADMAP "
            "queue A")
    for fc in ("audio_fc", "visual_fc"):
        if fc in params:
            _linear(sd, params[fc], fc)
    for fc in ("fc_out", "fc_x", "fc_y", "fc"):
        if fc in params.get("fusion_module", {}):
            _linear(sd, params["fusion_module"][fc], f"fusion_module.{fc}")
    return sd


def q8_state_dict(sd: Mapping[str, torch.Tensor], model: torch.nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """An int8 artifact's dict (int8 weights with ``_scale`` entries, block
    sites per block) -> the state_dict ``model`` loads with ``strict=True``.

    Where the model streams int8 (its tensor of that name is int8: the M3AE
    block sites, the image-patch projection, the text table) the weight
    stays int8 and its scale takes the model's shape; in the stacked layout
    the block sites' weights and scales are stacked over the blocks. Every
    other quantized weight (heads, the AV family's convs) is dequantized as
    ``q8.bf16 * scale.bf16`` in bf16 (``split_q8``)."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, t in sd.items():
        path, _, leaf = name.rpartition(".")
        site = block_site(path) if leaf in ("weight", "weight_scale") \
            else None
        key = None if site is None else \
            f"{site[0]}.encoder.stack.{BLOCK_SITES[site[2]][0]}_" \
            f"{'scale' if leaf == 'weight_scale' else 'weight'}"
        if key is not None and key in want:
            stacks.setdefault(key, {})[site[1]] = t
        elif name.endswith("_scale") and name[:-len("_scale")] in sd:
            if name in want:
                out[name] = t.reshape(want[name].shape)
        elif name + "_scale" in sd and not (name in want and
                                            want[name].dtype == torch.int8):
            out[name] = t.to(torch.bfloat16) * sd[name + "_scale"].to(
                torch.bfloat16)
        else:
            out[name] = t
    for key, layers in stacks.items():
        out[key] = torch.stack([layers[i] for i in range(len(layers))]
                               ).reshape(want[key].shape)
    return out


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
