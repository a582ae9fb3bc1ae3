"""Dataset adapters: host IO + geometry sampling, device batch finishing
(port of ``mla_tpu/data/datasets.py``).

Split design: ``sample_host(i, rng)`` does file IO and augmentation-geometry
sampling on the host (numpy, deterministic per-epoch generators keyed by
(seed, epoch, i), the same draws as the JAX package's); ``batch_host`` does
it for a batch through the C++ loader when it is built; ``finish_batch``
runs the fused transform on the device, drawing from the batch's
generator where it draws (``utils.seed.batch_generator``), and returns the
batch dict the classifiers and steps consume ({spec | fbank | token,
padding_mask | token_feat, image_feat; image, label, idx, valid}).

The six adapters of the JAX package: CREMA-D audio-visual (``--lorb
base``), CREMA-D CAV-MAE (``--lorb large``), M3AE image-text (``--lorb
m3ae``: Food-101, MVSA), the MVSA text-visual one of the other families,
IEMOCAP 3-modal (``--modal3``) and the precomputed CLIP features
(``--clip``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from mla_tpu_torch.core.config import MLAConfig
from mla_tpu_torch.data import transforms as T
from mla_tpu_torch.data.datalists import build_index
from mla_tpu_torch.data.masking import qmf_mask_set, random_mask
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

    def finish_batch(self, host: Dict[str, torch.Tensor],
                     gen: Optional[torch.Generator] = None) -> Dict:
        """``host``: the padded host batch's tensors, already on the device
        (uint8 frames (B, 3, H, W, 3), boxes, flip, spec, label, idx,
        valid) -> the model's batch: spec (B, 1, F, T) float32 and image
        (B, 3, T, out, out) in the compute type (no color jitter, so
        ``gen`` is not drawn from)."""
        image = T.av_frames_transform(host["frames"], host["boxes"],
                                      host["flip"], out=self.out,
                                      out_dtype=_image_dtype(self.cfg))
        return {"spec": host["spec"].to(torch.float32)[:, None],
                "image": image,
                "label": host["label"].to(torch.int32),
                "idx": host["idx"].to(torch.int32),
                "valid": host["valid"].to(torch.float32)}


class CAVAdapter:
    """CREMA-D --lorb large (dataset.py:163-325): the (audio_length, 128)
    fbank (normalised; SpecAug, noise and roll under --cav_augnois in
    training) and the middle frame, resized and center-cropped to
    ``image_size`` (224) by the cubic kernel, CAV-MAE's mean/std, no flip,
    no jitter. The reference returns a 3-tuple here that main.py:159
    unpacks as 4; the JAX package, and this port, emit the standard
    dict."""
    out = 224

    def __init__(self, cfg: MLAConfig, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.out = cfg.image_size or type(self).out
        self.index = build_index(cfg.dataset, cfg.data_root, mode,
                                 required=("audio", "visual"))
        self.canon = T.CANONICAL[self.out]

    def __len__(self):
        return len(self.index)

    def _frame_path(self, name):
        vdir = os.path.join(self.index.dir("visual"), name)
        files = _frame_files(vdir)
        return os.path.join(vdir, files[int(len(files) / 2)])

    def sample_host(self, i: int, rng: np.random.Generator) -> Dict:
        name = self.index.names[i]
        fbank = np.load(os.path.join(self.index.dir("audio"), name + ".npy"))
        img, hw = T.host_decode(self._frame_path(name), self.canon)
        box = T.scale_box(im.resize_center_crop_box(*hw, self.out, self.out),
                          hw, self.canon)
        return {"fbank": fbank.astype(np.float32), "image_u8": img,
                "boxes": np.asarray(box, np.float32),
                "label": self.index.labels[i], "idx": i}

    def batch_host(self, indices, rngs, map_fn=map) -> Dict:
        """One host batch. Native path: the fbank npys, cut and padded to
        (audio_length, 128) (the length the model is built for), and the
        middle frames through the C++ thread pool. Without the library:
        ``sample_host`` over ``map_fn``."""
        from mla_tpu_torch.data import native_loader as nl
        if not nl.available():
            _warn_native_fallback(type(self).__name__)
            return stack_samples(list(map_fn(self.sample_host, indices,
                                             rngs)))
        names = [self.index.names[i] for i in indices]
        fbank = nl.load_npy_batch(
            [os.path.join(self.index.dir("audio"), n + ".npy") for n in names],
            (self.cfg.audio_length, 128))
        imgs, hw = nl.decode_jpeg_batch([self._frame_path(n) for n in names],
                                        (self.canon, self.canon))
        boxes = np.zeros((len(names), 4), np.float32)
        for i in range(len(names)):
            oh, ow = max(int(hw[i, 0]), 1), max(int(hw[i, 1]), 1)
            boxes[i] = T.scale_box(
                im.resize_center_crop_box(oh, ow, self.out, self.out),
                (oh, ow), self.canon)
        return {"fbank": fbank, "image_u8": imgs, "boxes": boxes,
                "label": np.asarray([self.index.labels[i] for i in indices]),
                "idx": np.asarray(indices)}

    def finish_batch(self, host: Dict[str, torch.Tensor],
                     gen: Optional[torch.Generator] = None) -> Dict:
        """fbank (B, T, 128) float32 and image (B, 3, out, out) in the
        compute type. The image draws nothing; the fbank's augmentation
        draws from ``gen`` (the JAX package splits its key: the image's
        half, then the fbank's)."""
        b = host["image_u8"].shape[0]
        image = T.image_batch_transform(
            host["image_u8"], host["boxes"],
            torch.zeros(b, dtype=torch.bool, device=host["image_u8"].device),
            gen, im.CAV_MEAN, im.CAV_STD, out=self.out, method="cubic",
            out_dtype=_image_dtype(self.cfg))
        fbank = T.cav_fbank_transform(host["fbank"], gen,
                                      self.mode == "train",
                                      self.cfg.cav_augnois)
        return {"fbank": fbank, "image": image,
                "label": host["label"].to(torch.int32),
                "idx": host["idx"].to(torch.int32),
                "valid": host["valid"].to(torch.float32)}


class M3AEAdapter:
    """Food-101 / MVSA image-text (dataset.py:327-480): cached BERT tokens +
    jpg; train = timm create_transform(256, color_jitter) (RRC bicubic +
    flip + jitter), eval = Resize(256) + CenterCrop(256)."""
    out = 256

    def __init__(self, cfg: MLAConfig, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.out = cfg.image_size or type(self).out
        self.index = build_index(cfg.dataset, cfg.data_root, mode,
                                 required=("text", "visual"))
        self.canon = T.CANONICAL[self.out]

    def __len__(self):
        return len(self.index)

    def _image_path(self, name):
        return os.path.join(self.index.dir("visual"), name + ".jpg")

    def sample_host(self, i: int, rng: np.random.Generator) -> Dict:
        name = self.index.names[i]
        tdir = self.index.dir("text")
        token = np.load(os.path.join(tdir, name + "_token.npy")).reshape(-1)
        pm = np.load(os.path.join(tdir, name + "_pm.npy")).reshape(-1)
        img, hw = T.host_decode(self._image_path(name), self.canon)
        if self.mode == "train":
            box = im.random_resized_crop_params(rng, *hw)
            flip = rng.random() < 0.5
        else:
            box = im.resize_center_crop_box(*hw, self.out, self.out)
            flip = False
        return {"token": token.astype(np.int32), "pm": pm.astype(np.float32),
                "image_u8": img,
                "boxes": np.asarray(T.scale_box(box, hw, self.canon),
                                    np.float32),
                "flip": flip, "label": self.index.labels[i], "idx": i}

    def batch_host(self, indices, rngs, map_fn=map,
                   keep_hw: bool = False) -> Dict:
        """One host batch. Native path: token/pm npys (int32 / float32) and
        JPEGs through the C++ thread pool, crop geometry sampled per sample
        with the same generator stream as ``sample_host``. Without the
        library: ``sample_host`` over ``map_fn``, as ``AVAdapter``. The TV
        subclass extends it (``keep_hw``: the original sizes, host-only)."""
        from mla_tpu_torch.data import native_loader as nl
        if not nl.available():
            _warn_native_fallback(type(self).__name__)
            return stack_samples(list(map_fn(self.sample_host, indices,
                                             rngs)))
        names = [self.index.names[i] for i in indices]
        tdir = self.index.dir("text")
        if not hasattr(self, "_token_len"):
            # fixture trees carry shorter token caches than the reference's
            # 256: probe instead of hardcoding
            self._token_len = int(np.load(os.path.join(
                tdir, names[0] + "_token.npy")).size)
        token = nl.load_npy_batch(
            [os.path.join(tdir, n + "_token.npy") for n in names],
            (self._token_len,), dtype=np.int32)
        pm = nl.load_npy_batch(
            [os.path.join(tdir, n + "_pm.npy") for n in names],
            (self._token_len,))
        imgs, hw = nl.decode_jpeg_batch([self._image_path(n) for n in names],
                                        (self.canon, self.canon))
        b = len(names)
        boxes = np.zeros((b, 4), np.float32)
        flips = np.zeros((b,), bool)
        for i, rng in enumerate(rngs):
            oh, ow = max(int(hw[i, 0]), 1), max(int(hw[i, 1]), 1)
            if self.mode == "train":
                box = im.random_resized_crop_params(rng, oh, ow)
                flips[i] = rng.random() < 0.5
            else:
                box = im.resize_center_crop_box(oh, ow, self.out, self.out)
            boxes[i] = T.scale_box(box, (oh, ow), self.canon)
        out = {"token": token, "pm": pm, "image_u8": imgs, "boxes": boxes,
               "flip": flips,
               "label": np.asarray([self.index.labels[i] for i in indices]),
               "idx": np.asarray(indices)}
        if keep_hw:
            out["_hw"] = hw
        return out

    def finish_batch(self, host: Dict[str, torch.Tensor],
                     gen: Optional[torch.Generator] = None) -> Dict:
        """The device batch: token (B, L) int32, padding_mask (B, L)
        float32 and image (B, 3, out, out) in the compute type, resampled
        with the cubic kernel and, in training, color-jittered from
        ``gen``."""
        image = T.image_batch_transform(
            host["image_u8"], host["boxes"], host["flip"], gen,
            im.IMAGENET_MEAN, im.IMAGENET_STD, out=self.out, method="cubic",
            jitter=self.mode == "train", out_dtype=_image_dtype(self.cfg))
        return {"token": host["token"].to(torch.int32),
                "padding_mask": host["pm"].to(torch.float32),
                "image": image,
                "label": host["label"].to(torch.int32),
                "idx": host["idx"].to(torch.int32),
                "valid": host["valid"].to(torch.float32)}


class TVAdapter(M3AEAdapter):
    """MVSA text-visual for non-m3ae runs (dataset.py:482-592): BERT tokens
    + the SAME image stacked 3x as pseudo-frames (dataset.py:559-574),
    AVDataset transforms (224 crop). The reference pairs this dataset with
    AVClassifier, which rejects MVSA (basic_model.py:20-26), so no run
    reaches it; kept for parity of the adapter."""
    out = 224

    def sample_host(self, i: int, rng: np.random.Generator) -> Dict:
        out = super().sample_host(i, rng)
        # 3 copies of one image, each with the train-time transform geometry
        if self.mode == "train":
            img_path = self._image_path(self.index.names[i])
            _, hw = T.host_decode(img_path, self.canon)
            boxes, flips = [out["boxes"]], [out["flip"]]
            for _ in range(2):
                box = im.random_resized_crop_params(rng, *hw)
                boxes.append(np.asarray(T.scale_box(box, hw, self.canon),
                                        np.float32))
                flips.append(rng.random() < 0.5)
            out["boxes"] = np.stack(boxes)
            out["flip"] = np.asarray(flips, bool)
        else:
            out["boxes"] = np.stack([out["boxes"]] * 3)
            out["flip"] = np.asarray([False] * 3)
        out["frames"] = np.stack([out.pop("image_u8")] * 3)
        return out

    def batch_host(self, indices, rngs, map_fn=map) -> Dict:
        """Native path: tokens/pm/JPEG through the parent (same per-sample
        generator order, box 1 and flip 1 first), then the two extra
        train-time crop draws and the 3x pseudo-frame stack."""
        hb = super().batch_host(indices, rngs, map_fn, keep_hw=True)
        if "frames" in hb:          # the parent took sample_host
            return hb
        b = len(indices)
        hws = hb.pop("_hw")
        if self.mode == "train":
            boxes = np.zeros((b, 3, 4), np.float32)
            flips = np.zeros((b, 3), bool)
            boxes[:, 0] = hb["boxes"]
            flips[:, 0] = hb["flip"]
            for i, rng in enumerate(rngs):
                hw = (max(int(hws[i, 0]), 1), max(int(hws[i, 1]), 1))
                for k in (1, 2):
                    box = im.random_resized_crop_params(rng, *hw)
                    boxes[i, k] = T.scale_box(box, hw, self.canon)
                    flips[i, k] = rng.random() < 0.5
            hb["boxes"], hb["flip"] = boxes, flips
        else:
            hb["boxes"] = np.stack([hb["boxes"]] * 3, axis=1)
            hb["flip"] = np.zeros((b, 3), bool)
        hb["frames"] = np.stack([hb.pop("image_u8")] * 3, axis=1)
        return hb

    def finish_batch(self, host: Dict[str, torch.Tensor],
                     gen: Optional[torch.Generator] = None) -> Dict:
        image = T.av_frames_transform(host["frames"], host["boxes"],
                                      host["flip"], gen, out=self.out,
                                      out_dtype=_image_dtype(self.cfg))
        return {"token": host["token"].to(torch.int32),
                "padding_mask": host["pm"].to(torch.float32),
                "image": image,
                "label": host["label"].to(torch.int32),
                "idx": host["idx"].to(torch.int32),
                "valid": host["valid"].to(torch.float32)}


class Modal3Adapter(M3AEAdapter):
    """IEMOCAP 3-modality (dataset.py:642-803): tokens, the middle
    face-crop frame and the (audio_length, 128) fbank (NOT normalised in
    the reference's 3-modal path), with the CPM-Net missing-view mask
    (``random_mask(3, n, mask_percent, default_rng(random_seed))``)
    multiplying each modality by 0/1. The per-sample path keeps each
    array's type (the JAX package's numpy promotes the masked arrays to
    int64 / float64 there; the values are the same)."""

    def __init__(self, cfg: MLAConfig, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.out = cfg.image_size or type(self).out
        self.index = build_index(cfg.dataset, cfg.data_root, mode,
                                 required=("text", "visual", "audio"))
        self.canon = T.CANONICAL[self.out]
        self.maskmatrix = random_mask(
            3, len(self.index), cfg.mask_percent,
            np.random.default_rng(cfg.random_seed))

    def _image_path(self, name):
        vdir = os.path.join(self.index.dir("visual"), name)
        files = _frame_files(vdir)
        return os.path.join(vdir, files[int(len(files) / 2)])

    def sample_host(self, i: int, rng: np.random.Generator) -> Dict:
        out = super().sample_host(i, rng)
        name = self.index.names[i]
        fbank = np.load(os.path.join(self.index.dir("audio"), name + ".npy"))
        keep = self.maskmatrix[i]
        out["fbank"] = fbank.astype(np.float32) * np.float32(keep[0])
        out["image_u8"] = out["image_u8"] * np.uint8(keep[1])
        out["token"] = out["token"] * np.int32(keep[2])
        out["pm"] = out["pm"] * np.float32(keep[2])
        return out

    def batch_host(self, indices, rngs, map_fn=map) -> Dict:
        """Native path: tokens, pm and the middle frames through the parent,
        the fbank npys through the C++ pool, then the mask (multiply by
        0/1 as ``sample_host``, dataset.py:721-728)."""
        hb = super().batch_host(indices, rngs, map_fn)
        if "fbank" in hb:           # the parent took sample_host
            return hb
        from mla_tpu_torch.data import native_loader as nl
        adir = self.index.dir("audio")
        names = [self.index.names[i] for i in indices]
        fbank = nl.load_npy_batch(
            [os.path.join(adir, n + ".npy") for n in names],
            (self.cfg.audio_length, 128))
        keep = self.maskmatrix[np.asarray(indices)]   # (B, 3) 0/1
        hb["fbank"] = fbank * keep[:, 0].reshape(-1, 1, 1)
        hb["image_u8"] = hb["image_u8"] * keep[:, 1].reshape(
            -1, 1, 1, 1).astype(np.uint8)
        hb["token"] = hb["token"] * keep[:, 2].reshape(-1, 1).astype(np.int32)
        hb["pm"] = hb["pm"] * keep[:, 2].reshape(-1, 1).astype(np.float32)
        return hb

    def finish_batch(self, host: Dict[str, torch.Tensor],
                     gen: Optional[torch.Generator] = None) -> Dict:
        batch = super().finish_batch(host, gen)
        batch["fbank"] = host["fbank"].to(torch.float32)
        return batch


class CLIPAdapter:
    """Precomputed 512-d CLIP features (dataset.py:806-877), under
    ``clip_feature/{text,image}/{mode}``; names whose two npys are missing
    are dropped."""

    def __init__(self, cfg: MLAConfig, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.index = build_index(cfg.dataset, cfg.data_root, mode)
        self.tdir = os.path.join(cfg.data_root, "clip_feature/text", mode)
        self.vdir = os.path.join(cfg.data_root, "clip_feature/image", mode)
        keep = [k for k, n in enumerate(self.index.names)
                if os.path.exists(os.path.join(self.tdir, n + ".npy"))
                and os.path.exists(os.path.join(self.vdir, n + ".npy"))]
        self.index.names = [self.index.names[k] for k in keep]
        self.index.labels = [self.index.labels[k] for k in keep]

    def __len__(self):
        return len(self.index)

    def sample_host(self, i: int, rng) -> Dict:
        name = self.index.names[i]
        return {"token_feat": np.load(os.path.join(
                    self.tdir, name + ".npy")).reshape(-1).astype(np.float32),
                "image_feat": np.load(os.path.join(
                    self.vdir, name + ".npy")).reshape(-1).astype(np.float32),
                "label": self.index.labels[i], "idx": i}

    def batch_host(self, indices, rngs, map_fn=map) -> Dict:
        """Native path: both feature npys through the C++ thread pool, their
        length probed from the first file."""
        from mla_tpu_torch.data import native_loader as nl
        if not nl.available():
            _warn_native_fallback(type(self).__name__)
            return stack_samples(list(map_fn(self.sample_host, indices,
                                             rngs)))
        names = [self.index.names[i] for i in indices]
        if not hasattr(self, "_feat_len"):
            self._feat_len = int(np.load(os.path.join(
                self.tdir, names[0] + ".npy")).size)
        return {"token_feat": nl.load_npy_batch(
                    [os.path.join(self.tdir, n + ".npy") for n in names],
                    (self._feat_len,)),
                "image_feat": nl.load_npy_batch(
                    [os.path.join(self.vdir, n + ".npy") for n in names],
                    (self._feat_len,)),
                "label": np.asarray([self.index.labels[i] for i in indices]),
                "idx": np.asarray(indices)}

    def finish_batch(self, host: Dict[str, torch.Tensor],
                     gen: Optional[torch.Generator] = None) -> Dict:
        return {"token_feat": host["token_feat"].to(torch.float32),
                "image_feat": host["image_feat"].to(torch.float32),
                "label": host["label"].to(torch.int32),
                "idx": host["idx"].to(torch.int32),
                "valid": host["valid"].to(torch.float32)}


def build_adapter(cfg: MLAConfig, mode: str):
    """Dataset selection mirroring main.py:762-810."""
    if cfg.modal3 or cfg.dataset == "IEMOCAP":
        return Modal3Adapter(cfg, mode)
    if cfg.clip:
        return CLIPAdapter(cfg, mode)
    if cfg.lorb == "large":
        return CAVAdapter(cfg, mode)
    if cfg.lorb == "m3ae":
        return M3AEAdapter(cfg, mode)
    if cfg.dataset == "MVSA":
        return TVAdapter(cfg, mode)   # main.py:770-772
    return AVAdapter(cfg, mode)
