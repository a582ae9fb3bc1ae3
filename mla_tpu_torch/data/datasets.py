"""Dataset adapters: host IO + geometry sampling, device batch finishing
(port of ``mla_tpu/data/datasets.py``).

Split design: ``sample_host(i, rng)`` does file IO and augmentation-geometry
sampling on the host (numpy, deterministic per-epoch generators keyed by
(seed, epoch, i), the same draws as the JAX package's); ``batch_host`` does
it for a batch through the C++ loader when it is built; ``finish_batch``
runs the fused transform on the device and returns the batch dict the
classifiers and steps consume ({spec, image, label, idx, valid}).

Ported: the CREMA-D audio-visual adapter (``--lorb base``). The others
raise in ``build_adapter`` with the ROADMAP item that brings them.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from mla_tpu_torch.core.config import MLAConfig
from mla_tpu_torch.data import transforms as T
from mla_tpu_torch.data.datalists import build_index
from mla_tpu_torch.data.masking import qmf_mask_set
from mla_tpu_torch.ops import image as im


def _image_dtype(cfg) -> torch.dtype:
    """Emit images in the model compute dtype: the convs cast to it anyway,
    so this halves the transform's write with identical results."""
    return getattr(torch, cfg.compute_dtype)


def _frame_files(dir_path: str) -> List[str]:
    # reference uses os.listdir order (FS-dependent); sorted for determinism
    return sorted(os.listdir(dir_path))


_NATIVE_WARNED = set()


def _warn_native_fallback(adapter_name: str) -> None:
    """Log (once per adapter class) when the C++ batch loader is unavailable
    and the per-sample Python path engages."""
    if adapter_name not in _NATIVE_WARNED:
        _NATIVE_WARNED.add(adapter_name)
        print(f"WARNING: native loader unavailable — {adapter_name} using "
              "the per-sample Python IO path (a C++ compiler and the "
              "libjpeg headers build it)")


def stack_samples(samples) -> Dict:
    """Stack per-sample dicts into one host batch."""
    return {k: np.stack([np.asarray(s[k]) for s in samples])
            for k in samples[0]}


class AVAdapter:
    """CREMA-D audio-visual, --lorb base (dataset.py:18-161).

    Sample: log-STFT spectrogram .npy + 3 evenly-spaced frames; train-time
    RandomResizedCrop(224)+HFlip per frame, eval Resize((224,224)); QMF
    modality masking on a datalist suffix."""
    spec_shape = (129, 626)   # n_fft=256 -> 129 bins (extract_spec.py:21);
                              # shaped from the on-disk artifact at first load
    out = 224

    def __init__(self, cfg: MLAConfig, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.out = cfg.image_size or type(self).out
        self.index = build_index(cfg.dataset, cfg.data_root, mode,
                                 required=("audio", "visual"))
        self.mask_files = qmf_mask_set(self.index.names, cfg.mask_percent) \
            if (cfg.modulation == "QMF" and mode == "train") else set()
        self.canon = T.CANONICAL[self.out]

    def __len__(self):
        return len(self.index)

    def sample_host(self, i: int, rng: np.random.Generator) -> Dict:
        name = self.index.names[i]
        spec = np.load(os.path.join(self.index.dir("audio"), name + ".npy"))
        if name in self.mask_files and self.cfg.mask_m == "audio":
            spec = spec * 0
        vdir = os.path.join(self.index.dir("visual"), name)
        files = _frame_files(vdir)
        seg = int(len(files) / 3)
        frames, boxes, flips = [], [], []
        for k in range(3):
            img, hw = T.host_decode(os.path.join(vdir, files[seg * k]),
                                    self.canon)
            frames.append(img)
            if self.mode == "train":
                box = im.random_resized_crop_params(rng, *hw)
                flips.append(rng.random() < 0.5)
            else:
                box = (0.0, 0.0, float(hw[0]), float(hw[1]))
                flips.append(False)
            boxes.append(T.scale_box(box, hw, self.canon))
        frames = np.stack(frames)
        if name in self.mask_files and self.cfg.mask_m == "visual":
            frames = frames * 0
        return {"spec": spec.astype(np.float32),
                "frames": frames,
                "boxes": np.asarray(boxes, np.float32),
                "flip": np.asarray(flips, bool),
                "label": self.index.labels[i], "idx": i}

    def batch_host(self, indices, rngs, map_fn=map) -> Dict:
        """One host batch. Native path: C++ thread-pool npy reads + JPEG
        decode (``native_loader.py``), geometry sampled in numpy with the
        same per-sample generator stream as ``sample_host``. Without the
        library: ``sample_host`` over ``map_fn`` (the loader passes its
        worker pool's ``map``; cv2 releases the GIL while it decodes)."""
        from mla_tpu_torch.data import native_loader as nl
        if not nl.available():
            _warn_native_fallback(type(self).__name__)
            return stack_samples(list(map_fn(self.sample_host, indices,
                                             rngs)))
        if not hasattr(self, "_spec_shape"):
            probe = np.load(os.path.join(self.index.dir("audio"),
                                         self.index.names[indices[0]] + ".npy"))
            self._spec_shape = probe.shape
        names = [self.index.names[i] for i in indices]
        spec = nl.load_npy_batch(
            [os.path.join(self.index.dir("audio"), n + ".npy") for n in names],
            self._spec_shape)
        frame_paths = []
        for n in names:
            vdir = os.path.join(self.index.dir("visual"), n)
            files = _frame_files(vdir)
            seg = int(len(files) / 3)
            frame_paths += [os.path.join(vdir, files[seg * k])
                            for k in range(3)]
        flat, hw = nl.decode_jpeg_batch(frame_paths, (self.canon, self.canon))
        b = len(names)
        frames = flat.reshape(b, 3, self.canon, self.canon, 3)
        boxes = np.zeros((b, 3, 4), np.float32)
        flips = np.zeros((b, 3), bool)
        for i, (n, rng) in enumerate(zip(names, rngs)):
            for k in range(3):
                oh, ow = int(hw[i * 3 + k, 0]), int(hw[i * 3 + k, 1])
                oh, ow = max(oh, 1), max(ow, 1)
                if self.mode == "train":
                    box = im.random_resized_crop_params(rng, oh, ow)
                    flips[i, k] = rng.random() < 0.5
                else:
                    box = (0.0, 0.0, float(oh), float(ow))
                boxes[i, k] = T.scale_box(box, (oh, ow), self.canon)
            if n in self.mask_files:
                if self.cfg.mask_m == "audio":
                    spec[i] = 0
                elif self.cfg.mask_m == "visual":
                    frames[i] = 0
        return {"spec": spec.astype(np.float32), "frames": frames,
                "boxes": boxes, "flip": flips,
                "label": np.asarray([self.index.labels[i] for i in indices]),
                "idx": np.asarray(indices)}

    def finish_batch(self, host: Dict[str, torch.Tensor]) -> Dict:
        """``host``: the padded host batch's tensors, already on the device
        (uint8 frames (B, 3, H, W, 3), boxes, flip, spec, label, idx,
        valid) -> the model's batch: spec (B, 1, F, T) float32 and image
        (B, 3, T, out, out) in the compute type (no color jitter)."""
        image = T.av_frames_transform(host["frames"], host["boxes"],
                                      host["flip"], out=self.out,
                                      out_dtype=_image_dtype(self.cfg))
        return {"spec": host["spec"].to(torch.float32)[:, None],
                "image": image,
                "label": host["label"].to(torch.int32),
                "idx": host["idx"].to(torch.int32),
                "valid": host["valid"].to(torch.float32)}


def build_adapter(cfg: MLAConfig, mode: str):
    """Dataset selection mirroring main.py:762-810. Only the CREMA-D
    audio-visual adapter is ported."""
    if cfg.modal3 or cfg.dataset == "IEMOCAP":
        raise NotImplementedError("the IEMOCAP 3-modal adapter is not ported "
                                  "yet: ROADMAP queue A, item 8")
    if cfg.clip:
        raise NotImplementedError("the CLIP feature adapter is not ported "
                                  "yet: ROADMAP queue A, item 7b")
    if cfg.lorb == "large":
        raise NotImplementedError("the CAV-MAE fbank adapter (--lorb large) "
                                  "is not ported yet: ROADMAP queue A, "
                                  "item 8")
    if cfg.lorb == "m3ae" or cfg.dataset == "MVSA":
        raise NotImplementedError("the M3AE image-text adapters (Food-101, "
                                  "MVSA) are not ported yet: ROADMAP queue "
                                  "A, item 7b")
    return AVAdapter(cfg, mode)
