"""Serving artifacts for the port: export the eval forward's weights, load
them device-resident, answer requests.

Layout of an export directory:
    meta.json    input specs, batch sizes, config summary (the JAX artifact's
                 keys, with ``torch_version`` in place of ``jax_version``)
    weights.pt   the classifier's state_dict in the reference's names

This is not the JAX package's artifact (StableHLO + flax msgpack), which the
port cannot read without JAX. The port's artifact holds weights and rebuilds
the model from ``meta.json``; the forward is the port's own code, with the
hand-written attention kernel on the card.

Batch handling follows the JAX artifact: a ladder of batch sizes (default
1/8/64); ``ServingModel`` pads a request to the smallest rung that holds it
and slices the result. Padded rows get valid=0, which the dynamic-fusion
gating masks out, so padding never changes real rows' outputs.

Run as a module to export from a reference-layout ``.pth``:
    python -m mla_tpu_torch.runtime.export --checkpoint model.pth \
        --dataset Food101 --lorb m3ae --gs_flag -dynamic \
        --export_dir DIR [--export_dtype bfloat16] [--export_batch_sizes 1,8,64]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mla_tpu_torch.core.config import MLAConfig, config_from_args
from mla_tpu_torch.device import resolve_device, set_matmul_precision
from mla_tpu_torch.evals.metrics import eval_logits
from mla_tpu_torch.models.classifiers import (M3AEClassifier,
                                              classifier_kwargs, modalities_of)
from mla_tpu_torch.models.convert import load_reference_checkpoint

# Per-sample input tensors each ported classifier family reads.
FEATURE_KEYS: Dict[str, Tuple[str, ...]] = {
    "M3AEClassifier": ("token", "padding_mask", "image"),
}

TEXT_LEN = 256    # the reference's BERT token length (max_length 256)

_META = "meta.json"
_WEIGHTS = "weights.pt"


def feature_keys(model) -> Tuple[str, ...]:
    return FEATURE_KEYS[type(model).__name__]


def reference_feature_specs(cfg: MLAConfig) -> Dict[str, dict]:
    """Per-sample feature shapes of the reference M3AE inputs: 256 tokens,
    3 x image_size^2 pixels (256 unless --image_size)."""
    side = cfg.image_size or 256
    return {"token": {"shape": [TEXT_LEN], "dtype": "int32"},
            "padding_mask": {"shape": [TEXT_LEN], "dtype": "float32"},
            "image": {"shape": [3, side, side], "dtype": "float32"}}


def _boundary_dtype(dt) -> str:
    """Float features cross the serving boundary as float32 (the model casts
    to its compute type inside), integer features keep their type."""
    dt = np.dtype(dt)
    return "float32" if np.issubdtype(dt, np.floating) else str(dt)


def export_serving(cfg: MLAConfig, model, out_dir: str,
                   batch_sizes: Sequence[int] = (1, 8, 64),
                   weights_dtype: str = "float32",
                   example_batch: Optional[Mapping] = None) -> str:
    """Write ``model``'s weights and the serving meta to ``out_dir``.

    weights_dtype 'bfloat16' stores bf16 weights (half the bytes); the
    compute path is the config's compute dtype either way. Feature shapes
    come from ``example_batch`` (any batch dict) or, without one, from the
    reference inputs (``reference_feature_specs``)."""
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(
            f"batch_sizes must be positive ints, got {batch_sizes}")
    if weights_dtype in ("int8", "int8_a8"):
        raise NotImplementedError(
            "int8 serving needs the int8 GEMM kernels B4-B6 (ROADMAP queue A, "
            "item 4)")
    if weights_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"export weights_dtype must be float32 or bfloat16, "
                         f"got {weights_dtype!r}")
    keys = feature_keys(model)
    if example_batch is None:
        specs = reference_feature_specs(cfg)
    else:
        specs = {k: {"shape": list(np.asarray(example_batch[k]).shape[1:]),
                     "dtype": _boundary_dtype(np.asarray(example_batch[k]).dtype)}
                 for k in keys}
    wdt = getattr(torch, weights_dtype)
    sd = {k: (v.detach().to("cpu", wdt) if v.is_floating_point()
              else v.detach().cpu()).contiguous()
          for k, v in model.state_dict().items()}
    os.makedirs(out_dir, exist_ok=True)
    torch.save(sd, os.path.join(out_dir, _WEIGHTS))
    enc = model.mae_a.config
    meta = {
        "family": type(model).__name__,
        "modalities": list(modalities_of(cfg)),
        "n_classes": cfg.n_classes,
        "batch_sizes": batch_sizes,
        "weights_dtype": weights_dtype,
        "a8_skip": [],
        "a8_site_rel_err": {},
        "platforms": ["cuda", "cpu"],
        "feature_specs": {k: specs[k] for k in keys},
        "config": {"dataset": cfg.dataset, "lorb": cfg.lorb,
                   "modal3": cfg.modal3, "clip": cfg.clip,
                   "gs_flag": cfg.gs_flag, "modulation": cfg.modulation,
                   "dynamic": cfg.dynamic,
                   "fusion_method": cfg.fusion_method,
                   # what the port needs to rebuild the forward; the JAX
                   # artifact bakes these into its graph instead
                   "m3ae_size": enc.model_type,
                   "text_vocab_size": enc.text_vocab_size,
                   "compute_dtype": cfg.compute_dtype,
                   "av_alpha": cfg.av_alpha, "a_alpha": cfg.a_alpha,
                   "v_alpha": cfg.v_alpha, "t_alpha": cfg.t_alpha},
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ServingModel:
    """A loaded artifact: __call__(features) -> numpy logits dict.

    Weights live on ``device`` in the compute dtype (meta's, unless
    ``compute_dtype`` is given), cast once at load. Pads each request to the
    smallest exported batch rung (valid=0 rows) and slices the result back.
    """

    def __init__(self, out_dir: str, device=None,
                 compute_dtype: Optional[str] = None):
        self.device = resolve_device(device)
        set_matmul_precision()
        with open(os.path.join(out_dir, _META)) as f:
            self.meta = json.load(f)
        c = self.meta["config"]
        self.compute_dtype = compute_dtype or c["compute_dtype"]
        self.cfg = MLAConfig(
            dataset=c["dataset"], lorb=c["lorb"], modal3=c["modal3"],
            clip=c["clip"], gs_flag=c["gs_flag"], modulation=c["modulation"],
            dynamic=c["dynamic"], fusion_method=c["fusion_method"],
            m3ae_size=c["m3ae_size"], compute_dtype=self.compute_dtype,
            av_alpha=c["av_alpha"], a_alpha=c["a_alpha"],
            v_alpha=c["v_alpha"], t_alpha=c["t_alpha"]).validate()
        self.text_vocab_size = c["text_vocab_size"]
        with torch.device("meta"):
            model = M3AEClassifier(text_vocab_size=self.text_vocab_size,
                                   **classifier_kwargs(self.cfg))
        sd = torch.load(os.path.join(out_dir, _WEIGHTS),
                        map_location=self.device, weights_only=True)
        model.load_state_dict(sd, strict=True, assign=True)
        self.model = model.to(self.device, getattr(torch, self.compute_dtype))
        self.model.eval().requires_grad_(False)
        self.batch_sizes = self.meta["batch_sizes"]

    @property
    def feature_names(self):
        return list(self.meta["feature_specs"])

    def _rung(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise ValueError(
            f"request batch {n} exceeds the largest exported batch size "
            f"{self.batch_sizes[-1]}; re-export with a larger ladder")

    def validate_request(self, features: Dict[str, np.ndarray]) -> int:
        """Name, per-sample-shape and token-range checks for one request;
        returns its row count. Shared by pad_request and the coalescing
        batcher, which must reject a malformed request before merging it
        with other clients' rows."""
        names = self.feature_names
        missing = [k for k in names if k not in features]
        if missing:
            raise KeyError(f"serving request missing features {missing}")
        n = int(np.asarray(features[names[0]]).shape[0])
        if n < 1:
            raise ValueError("serving request has 0 rows")
        for k in names:
            a = np.asarray(features[k])
            want = tuple(self.meta["feature_specs"][k]["shape"])
            if tuple(a.shape[1:]) != want:
                raise ValueError(
                    f"feature '{k}' per-sample shape {tuple(a.shape[1:])} != "
                    f"exported {want}")
            if a.shape[0] != n:
                raise ValueError(
                    f"feature '{k}' has {a.shape[0]} rows, expected {n}")
        # an out-of-range id would fault the embedding gather on the device
        token = np.asarray(features["token"])
        if token.min() < 0 or token.max() >= self.text_vocab_size:
            raise ValueError(f"token ids must lie in [0, "
                             f"{self.text_vocab_size}), got [{token.min()}, "
                             f"{token.max()}]")
        return n

    def pad_request(self, features: Dict[str, np.ndarray]):
        """Validate + pad a request to a ladder rung: -> (padded, n, rung).
        Padded rows carry valid=0 (masked by the gating)."""
        names = self.feature_names
        n = self.validate_request(features)
        b = self._rung(n)
        padded = {}
        for k in names:
            a = np.asarray(features[k])
            spec = self.meta["feature_specs"][k]
            pad = np.zeros((b - n,) + tuple(spec["shape"]), dtype=spec["dtype"])
            padded[k] = np.concatenate([a.astype(spec["dtype"]), pad], axis=0)
        padded["valid"] = np.concatenate(
            [np.ones(n, np.float32), np.zeros(b - n, np.float32)])
        return padded, n, b

    def __call__(self, features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        padded, n, _ = self.pad_request(features)
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in padded.items()}
            out_m, fused = eval_logits(self.model, self.cfg, batch,
                                       batch["valid"])
            result = {"fused": fused.float()}
            for m, logits in out_m.items():
                result[f"logits_{m}"] = logits.float()
            return {k: v[:n].cpu().numpy() for k, v in result.items()}


def load_serving(out_dir: str, device=None,
                 compute_dtype: Optional[str] = None) -> ServingModel:
    return ServingModel(out_dir, device, compute_dtype)


def main(argv=None):
    """Export a serving artifact from a reference-layout ``.pth``."""
    p = argparse.ArgumentParser(
        description="export an mla_tpu_torch serving artifact from a "
                    "reference-layout .pth (any MLA-TPU CLI flag also applies)")
    p.add_argument("--checkpoint", required=True,
                   help=".pth in the reference saved_dict layout, e.g. from "
                        "main.py --export_torch")
    ns, rest = p.parse_known_args(argv)
    cfg = config_from_args(rest)
    if not cfg.export_dir:
        raise SystemExit("--export_dir is required")
    sd = load_reference_checkpoint(ns.checkpoint)
    vocab = int(sd["mae_a.text_embedding.weight"].shape[0])
    with torch.device("meta"):
        model = M3AEClassifier(text_vocab_size=vocab, **classifier_kwargs(cfg))
    model.load_state_dict(sd, strict=True, assign=True)
    sizes = cfg.export_batch_sizes or (1, 8, cfg.batch_size)
    path = export_serving(cfg, model, cfg.export_dir, batch_sizes=sizes,
                          weights_dtype=cfg.export_dtype)
    print(json.dumps({"artifact": path,
                      "batch_sizes": sorted(set(int(b) for b in sizes)),
                      "weights_dtype": cfg.export_dtype}))


if __name__ == "__main__":
    main()
