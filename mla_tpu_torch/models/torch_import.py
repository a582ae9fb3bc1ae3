"""Pretrained encoder weights into the port's classifiers (port of
``load_pretrained_encoders``, ``mla_tpu/models/torch_import.py:220-261``).

``--pretrained_a/v/t PATH`` warm-loads a reference encoder checkpoint into
one encoder of the classifier, as the reference hardcodes at
basic_model.py:160-168 (M3AE) with ``strict=False``. The port's module names
are the reference's (``text_embedding``, ``image_embedding``,
``encoder.blocks.{i}.layer_norm1``, ``attention.qkv_linear``,
``transformer_mlp.fc1``, ...), so a file's ``state_dict`` merges over the
encoder's own entries with no re-layout: the DataParallel ``module.``
prefix is stripped, each key is prefixed with the encoder (``mae_a.``,
``mae_v.``), and

- a key the model lacks is skipped with a printed line (a finetuned
  file's head, the autoencoder's decoder); nothing is inserted;
- a key whose shape differs is skipped with a printed line;
- every other value is copied into the parameter or buffer in place, in
  its type and on its device.

Which encoders take a file follows the JAX package's ``ENCODER_KIND``:
``--lorb m3ae`` loads ``mae_a`` (text) and ``mae_v`` (image) from M3AE
files; ``--lorb large`` both CAV-MAE encoders from CAV-MAE files; ``--lorb
m3ae --modal3`` ``mae_a`` (audio) from a CAV-MAE file and ``mae_v``
(image), ``mae_t`` (text) from M3AE files. The CAV-MAE encoders carry the
reference's names too (``patch_embed_a.proj``, ``blocks_a.{i}.norm1_a``,
``attn.qkv``, ``mlp.fc1``, ...): a CAV-MAE file's other modality's path
and its head are skipped, as the JAX package skips them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

# (lorb, modal3) -> {encoder: kind of the file it loads}
ENCODER_KIND = {
    ("large", False): {"mae_a": "cav", "mae_v": "cav"},
    ("m3ae", False): {"mae_a": "m3ae", "mae_v": "m3ae"},
    ("m3ae", True): {"mae_a": "cav", "mae_v": "m3ae", "mae_t": "m3ae"},
}


def strip_module_prefix(sd: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


@torch.no_grad()
def merge_encoder(model: nn.Module, net: str,
                  sd: Mapping[str, torch.Tensor]) -> None:
    """Copy ``sd`` (one encoder's reference state_dict) into ``model``'s
    ``net`` entries with strict=False semantics."""
    own = model.state_dict()
    for k, v in sd.items():
        name = f"{net}.{k}"
        if name not in own or not isinstance(v, torch.Tensor):
            print(f"  skip {name}: not in the model")
        elif tuple(v.shape) != tuple(own[name].shape):
            print(f"  skip {name}: shape {tuple(v.shape)} != "
                  f"{tuple(own[name].shape)}")
        else:
            own[name].copy_(v)


def load_pretrained_encoders(cfg, model: nn.Module) -> None:
    """Load ``cfg.pretrained_a/v/t`` into ``model``'s encoders in place
    (after the train state is built, before a warm start, as the JAX
    driver does)."""
    kinds = ENCODER_KIND.get((cfg.lorb, cfg.modal3))
    if kinds is None:
        return
    paths = {"mae_a": cfg.pretrained_a, "mae_v": cfg.pretrained_v,
             "mae_t": cfg.pretrained_t}
    for net, path in paths.items():
        if not path or net not in kinds:
            continue
        sd = strip_module_prefix(torch.load(path, map_location="cpu",
                                            weights_only=True))
        merge_encoder(model, net, sd)
        print(f"Loaded pretrained {net} from {path}")
