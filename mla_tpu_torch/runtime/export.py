"""Serving artifacts for the port: export the eval forward's weights, load
them device-resident, answer requests.

Layout of an export directory:
    meta.json    input specs, batch sizes, config summary (the JAX artifact's
                 keys, with ``torch_version`` in place of ``jax_version``)
    weights.pt   the classifier's state_dict in the reference's names

This is not the JAX package's artifact (StableHLO + flax msgpack), which the
port cannot read without JAX. The port's artifact holds weights (and, for
the AV family, BatchNorm's float32 running statistics) and rebuilds the
model from ``meta.json``; the forward is the port's own code in eval mode,
with the hand-written kernels on the card (attention for M3AE; the 3x3 conv
for AV under ``--pallas_conv on``; the int8 GEMMs and MLP for int8 M3AE).

int8 artifacts (``--export_dtype int8`` / ``int8_a8``, ``mla_tpu/runtime/
export.py:163-332``): ``quantize_int8`` stores the big weights as int8 with
fp32 per-output-channel scales and every other parameter in bf16. At load
the M3AE block sites, image-patch projection and text table stay int8 and
stream through the kernels (in the stacked layout when meta's config says
``scan_blocks``); every other int8 weight is dequantized once
(``models/convert.py:q8_state_dict``). ``int8_a8`` also quantizes the
activations of each block site per row (W8A8), except at the sites that
``calibrate_a8`` finds above 5% relative error on the example batch; meta
records them (``a8_skip``) with every site's error (``a8_site_rel_err``).

Batch handling follows the JAX artifact: a ladder of batch sizes (default
1/8/64); ``ServingModel`` pads a request to the smallest rung that holds it
and slices the result. Padded rows get valid=0, which the dynamic-fusion
gating masks out, so padding never changes real rows' outputs.

Run as a module to export from a reference-layout ``.pth``:
    python -m mla_tpu_torch.runtime.export --checkpoint model.pth \
        --dataset Food101 --lorb m3ae --gs_flag -dynamic \
        --export_dir DIR [--export_dtype bfloat16|int8|int8_a8] \
        [--scan_blocks] [--calibration feats.npz] [--export_batch_sizes 1,8,64]
        [--device cuda|cpu]
    (or --dataset CREMAD --lorb base [--pallas_conv on] for the AV family;
    int8_a8 calibrates on the first 4 rows of --calibration's features, on
    --device)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mla_tpu_torch.core.config import MLAConfig, config_from_args
from mla_tpu_torch.device import resolve_device, set_matmul_precision
from mla_tpu_torch.evals.metrics import eval_logits
from mla_tpu_torch.models.classifiers import (cast_parameters_,
                                              make_classifier, modalities_of)
from mla_tpu_torch.models.convert import (load_reference_checkpoint,
                                          q8_state_dict)
from mla_tpu_torch.models.layers import Recorder, configure_q8
from mla_tpu_torch.ops.attention import flat_attention_route

# Per-sample input tensors each ported classifier family reads.
FEATURE_KEYS: Dict[str, Tuple[str, ...]] = {
    "M3AEClassifier": ("token", "padding_mask", "image"),
    "AVClassifier": ("spec", "image"),
}

TEXT_LEN = 256    # the reference's BERT token length (max_length 256)
SPEC_HW = (129, 626)   # CREMA-D log-spectrogram (benchmarks/profile_step.py)
N_FRAMES = 3           # CREMA-D frames per clip

_META = "meta.json"
_WEIGHTS = "weights.pt"


def feature_keys(model) -> Tuple[str, ...]:
    return FEATURE_KEYS[type(model).__name__]


def reference_feature_specs(cfg: MLAConfig) -> Dict[str, dict]:
    """Per-sample feature shapes of the reference inputs. M3AE: 256 tokens,
    3 x image_size^2 pixels (256 unless --image_size). AV (CREMA-D): a
    (1, 129, 626) spectrogram and 3 frames of 3 x image_size^2 (224)."""
    if cfg.lorb == "base":
        side = cfg.image_size or 224
        return {"spec": {"shape": [1, *SPEC_HW], "dtype": "float32"},
                "image": {"shape": [3, N_FRAMES, side, side],
                          "dtype": "float32"}}
    side = cfg.image_size or 256
    return {"token": {"shape": [TEXT_LEN], "dtype": "int32"},
            "padding_mask": {"shape": [TEXT_LEN], "dtype": "float32"},
            "image": {"shape": [3, side, side], "dtype": "float32"}}


def _boundary_dtype(dt) -> str:
    """Float features cross the serving boundary as float32 (the model casts
    to its compute type inside), integer features keep their type."""
    dt = np.dtype(dt)
    return "float32" if np.issubdtype(dt, np.floating) else str(dt)


# -- int8 ----------------------------------------------------------------
# Symmetric int8 for the big weights (mla_tpu/runtime/export.py:163-209):
# every ``*.weight`` of >= 2 dims and >= _Q8_MIN_SIZE elements, with fp32
# scales per output channel (the first axis of PyTorch's layouts), per kh
# too for a conv weight (F, C, kh, kw), per row for an embedding table;
# every other parameter in bf16.

_Q8_MIN_SIZE = 4096
A8_REL_THRESHOLD = 0.05   # a W8A8 site above it keeps the weight-only GEMM
_CALIBRATION_ROWS = 4


def _q8_axes(ndim: int):
    """Axes of the per-channel max: all but the output channel, and for a
    conv weight also all but kh (the JAX package's ``_q8_axes``)."""
    return (1, 3) if ndim == 4 else tuple(range(1, ndim))


def quantize_int8(params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Float parameters by name -> the int8 artifact's: each quantized
    weight int8 under its name, its fp32 scale (the max's shape, kept
    broadcastable) under the name + '_scale'; every other float tensor
    bf16. The arithmetic is the JAX package's ``_quantize_int8`` in numpy:
    scale = max(max|w| / 127, 1e-12), q = clip(round-half-even(w / scale),
    -127, 127)."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if not t.is_floating_point():
            out[name] = t
            continue
        if name.endswith(".weight") and t.dim() in (2, 4) and \
                t.numel() >= _Q8_MIN_SIZE:
            a = t.float().numpy()
            amax = np.max(np.abs(a), axis=_q8_axes(a.ndim), keepdims=True)
            scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
            q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
            out[name] = torch.from_numpy(q)
            out[name + "_scale"] = torch.from_numpy(scale)
        else:
            out[name] = t.to(torch.bfloat16).contiguous()
    return out


def _q8_layout(meta) -> Optional[str]:
    """The int8 model layout an artifact's meta asks for, or None (the AV
    family has no int8 site: either layout loads it dequantized)."""
    if meta["weights_dtype"] not in ("int8", "int8_a8"):
        return None
    return "stacked" if meta["config"].get("scan_blocks") else "unrolled"


def _serving_model(cfg: MLAConfig, vocab: int, sd, q8: Optional[str],
                   device, dtype, a8: bool = False, a8_skip=(),
                   record: Optional[Recorder] = None):
    """The classifier with ``sd`` loaded (strict), on ``device``, its
    parameters in ``dtype``, in eval mode without gradients. For an int8
    ``sd`` (``q8`` the layout), int8 sites configured for W8A8 (``a8``,
    minus ``a8_skip``; a calibration forward with ``record``) and every
    other weight dequantized."""
    model = make_classifier(cfg, vocab, q8=q8)
    if q8 is not None:
        sd = q8_state_dict(sd, model)
    model.load_state_dict(sd, strict=True, assign=True)
    model = cast_parameters_(model.to(device), dtype)
    model.set_compute_dtype(dtype)
    if q8 is not None:
        configure_q8(model, a8, frozenset(a8_skip), stacked=q8 == "stacked",
                     record=record)
    return model.eval().requires_grad_(False)


def calibrate_a8(cfg: MLAConfig, sd, features: Mapping, device=None,
                 threshold: Optional[float] = None):
    """The W8A8 outlier guard (``mla_tpu/runtime/export.py:calibrate_a8``):
    one forward of the W8A8 model (``cfg``'s size, layout and compute type;
    ``sd`` an int8 artifact's weights) on ``device`` (cuda unless 'cpu')
    over at most 4 rows of ``features``, with every int8 GEMM on the JAX
    package's reference law and the Mlp site by site, records each W8A8
    site's worst-row relative L2 error of row quantization (over every
    layer that shares the site's name). -> (errs, skip): the sites above
    ``threshold`` (default 5%)."""
    threshold = A8_REL_THRESHOLD if threshold is None else threshold
    dev = resolve_device(device)
    errs: Dict[str, float] = {}

    def record(site, rel):
        errs[site] = max(rel, errs.get(site, 0.0))

    model = _serving_model(
        cfg, sd["mae_a.text_embedding.weight"].shape[0], sd,
        "stacked" if cfg.scan_blocks else "unrolled", dev,
        getattr(torch, cfg.compute_dtype), a8=True, record=record)
    rows = min(_CALIBRATION_ROWS, len(next(iter(features.values()))))
    batch = {k: torch.from_numpy(np.asarray(features[k])[:rows]).to(dev)
             for k in feature_keys(model)}
    with torch.inference_mode(), flat_attention_route(True):
        model(batch)
    return errs, frozenset(s for s, e in errs.items() if e > threshold)


def export_serving(cfg: MLAConfig, model, out_dir: str,
                   batch_sizes: Sequence[int] = (1, 8, 64),
                   weights_dtype: str = "float32",
                   example_batch: Optional[Mapping] = None,
                   device=None) -> str:
    """Write ``model``'s weights and the serving meta to ``out_dir``.

    weights_dtype 'bfloat16' stores bf16 weights (half the bytes; buffers,
    BatchNorm's running statistics, stay float32); the compute path is the
    config's compute dtype either way. 'int8' quantizes the big weights
    (``quantize_int8``); 'int8_a8' also runs ``calibrate_a8`` on
    ``example_batch`` (required), on ``device`` (cuda unless 'cpu'; no
    other export touches a device). Feature shapes
    come from ``example_batch`` (any batch dict) or, without one, from the
    reference inputs (``reference_feature_specs``). ``cfg.scan_blocks``
    selects the stacked int8 layout at load."""
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(
            f"batch_sizes must be positive ints, got {batch_sizes}")
    if weights_dtype not in ("float32", "bfloat16", "int8", "int8_a8"):
        raise ValueError(f"export weights_dtype must be float32, bfloat16, "
                         f"int8 or int8_a8, got {weights_dtype!r}")
    keys = feature_keys(model)
    if example_batch is None:
        if weights_dtype == "int8_a8":
            raise ValueError("int8_a8 calibrates on example_batch; pass one")
        specs = reference_feature_specs(cfg)
    else:
        specs = {k: {"shape": list(np.asarray(example_batch[k]).shape[1:]),
                     "dtype": _boundary_dtype(np.asarray(example_batch[k]).dtype)}
                 for k in keys}
    params = dict(model.named_parameters())
    if weights_dtype.startswith("int8"):
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
              if k not in params}
        sd.update(quantize_int8(params))
    else:
        wdt = getattr(torch, weights_dtype)
        sd = {k: (v.detach().to("cpu", wdt) if k in params
                  else v.detach().cpu()).contiguous()
              for k, v in model.state_dict().items()}
    a8_errs, a8_skip = {}, frozenset()
    if type(model).__name__ == "AVClassifier":
        # what the port needs to rebuild the forward; the JAX artifact
        # bakes these into its graph instead
        family = {"resnet_stages": list(model.stages),
                  "pallas_conv": cfg.pallas_conv}
    else:
        enc = model.mae_a.config
        family = {"m3ae_size": enc.model_type,
                  "text_vocab_size": enc.text_vocab_size,
                  "scan_blocks": cfg.scan_blocks}
        if weights_dtype == "int8_a8":      # the model's size, as at load
            a8_errs, a8_skip = calibrate_a8(
                dataclasses.replace(cfg, m3ae_size=enc.model_type), sd,
                example_batch, device)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(sd, os.path.join(out_dir, _WEIGHTS))
    meta = {
        "family": type(model).__name__,
        "modalities": list(modalities_of(cfg)),
        "n_classes": cfg.n_classes,
        "batch_sizes": batch_sizes,
        "weights_dtype": weights_dtype,
        "a8_skip": sorted(a8_skip),
        "a8_site_rel_err": {k: round(v, 6)
                            for k, v in sorted(a8_errs.items())},
        "platforms": ["cuda", "cpu"],
        "feature_specs": {k: specs[k] for k in keys},
        "config": {"dataset": cfg.dataset, "lorb": cfg.lorb,
                   "modal3": cfg.modal3, "clip": cfg.clip,
                   "gs_flag": cfg.gs_flag, "modulation": cfg.modulation,
                   "dynamic": cfg.dynamic,
                   "fusion_method": cfg.fusion_method, **family,
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
    ``compute_dtype`` is given), cast once at load; BatchNorm's running
    statistics stay float32. The model is in eval mode with no gradients,
    so a request never changes a running statistic. Every request takes
    the flat attention route (``flat_attention_route``), whatever the
    process's switch says. Pads each request to
    the smallest exported batch rung (valid=0 rows) and slices the result
    back.
    """

    def __init__(self, out_dir: str, device=None,
                 compute_dtype: Optional[str] = None):
        self.device = resolve_device(device)
        set_matmul_precision()
        with open(os.path.join(out_dir, _META)) as f:
            self.meta = json.load(f)
        c = self.meta["config"]
        family = {k: c[k] for k in ("m3ae_size", "pallas_conv", "scan_blocks")
                  if k in c}
        if "resnet_stages" in c:
            family["resnet_stages"] = tuple(c["resnet_stages"])
        self.compute_dtype = compute_dtype or c["compute_dtype"]
        self.cfg = MLAConfig(
            dataset=c["dataset"], lorb=c["lorb"], modal3=c["modal3"],
            clip=c["clip"], gs_flag=c["gs_flag"], modulation=c["modulation"],
            dynamic=c["dynamic"], fusion_method=c["fusion_method"],
            compute_dtype=self.compute_dtype,
            av_alpha=c["av_alpha"], a_alpha=c["a_alpha"],
            v_alpha=c["v_alpha"], t_alpha=c["t_alpha"], **family).validate()
        self.text_vocab_size = c.get("text_vocab_size")
        sd = torch.load(os.path.join(out_dir, _WEIGHTS),
                        map_location=self.device, weights_only=True)
        self.model = _serving_model(
            self.cfg, self.text_vocab_size or 30522, sd,
            _q8_layout(self.meta), self.device,
            getattr(torch, self.compute_dtype),
            a8=self.meta["weights_dtype"] == "int8_a8",
            a8_skip=self.meta.get("a8_skip", ()))
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
        if "token" not in names:
            return n
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
        # the flat attention route whatever the caller's switch says, as the
        # JAX package traces its serving graph (mla_tpu/runtime/export.py
        # export_from_driver); the caller's setting comes back afterwards
        with torch.inference_mode(), flat_attention_route(True):
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
    p.add_argument("--calibration", default=None,
                   help=".npz of features (the serving names): the example "
                        "batch; int8_a8 calibrates on its first 4 rows")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where int8_a8 runs its calibration forward; "
                        "'cuda' raises without a card")
    ns, rest = p.parse_known_args(argv)
    cfg = config_from_args(rest)
    if not cfg.export_dir:
        raise SystemExit("--export_dir is required")
    if cfg.export_dtype == "int8_a8" and not ns.calibration:
        raise SystemExit("--export_dtype int8_a8 needs --calibration NPZ")
    example = None
    if ns.calibration:
        with np.load(ns.calibration) as z:
            example = {k: z[k] for k in z.files}
    sd = load_reference_checkpoint(ns.checkpoint)
    emb = sd.get("mae_a.text_embedding.weight")
    model = make_classifier(cfg, 30522 if emb is None else int(emb.shape[0]))
    model.load_state_dict(sd, strict=True, assign=True)
    sizes = cfg.export_batch_sizes or (1, 8, cfg.batch_size)
    path = export_serving(cfg, model, cfg.export_dir, batch_sizes=sizes,
                          weights_dtype=cfg.export_dtype,
                          example_batch=example, device=ns.device)
    print(json.dumps({"artifact": path,
                      "batch_sizes": sorted(set(int(b) for b in sizes)),
                      "weights_dtype": cfg.export_dtype}))


if __name__ == "__main__":
    main()
