"""Synthetic on-disk fixtures mirroring the reference artifact layouts.

The PyTorch port's own copy of ``mla_tpu/data/synthetic.py`` (the port
imports nothing of the JAX package): the same seed writes the same files.

Used by tests and the benchmark harness (SURVEY.md §4: "tiny synthetic on-disk
fixture trees mirroring dataset.py path layouts") so every adapter exercises
the exact file formats without the real datasets.
"""

from __future__ import annotations

import os

import numpy as np

CREMAD_CLASSES = ["ANG", "DIS", "FEA", "HAP", "NEU", "SAD"]
MVSA_CLASSES = ["negative", "neutral", "positive"]
IEMO_CLASSES = ["ang", "hap", "neu", "sad"]


def _write_jpg(path, rng, hw=(48, 64)):
    import cv2
    img = rng.integers(0, 255, (hw[0], hw[1], 3), dtype=np.uint8)
    cv2.imwrite(path, img)


def _write_lists(root, tag, names_labels):
    os.makedirs(os.path.join(root, "lists"), exist_ok=True)
    classes = sorted({lb for _, lb in names_labels["train"] +
                      names_labels["test"]})
    with open(os.path.join(root, "lists", f"stat_{tag}.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    sep = {"cre": ".flv ", "food": ".jpg ", "mvsa": ".jpg ",
           "iemo": " [split|sign] "}[tag]
    for mode in ("train", "test"):
        with open(os.path.join(root, "lists", f"my_{mode}_{tag}.txt"), "w") as f:
            for name, label in names_labels[mode]:
                if tag == "iemo":
                    f.write(f"{name}.mp4 [split|sign] {label}\n")
                else:
                    f.write(f"{name}{sep}{label}\n")


def make_cremad(root: str, n_train=8, n_test=4, seed=0,
                spec_shape=(129, 626), fbank=False, learnable=False,
                fbank_len=1024, frame_hw=(48, 64)):
    """CREMA-D tree for AVAdapter (spectrograms) or CAVAdapter (fbank=True).

    learnable=True injects a class-dependent pattern into both modalities
    (a band in the spectrogram, a colored stripe in the frames) so a real
    training run can be asserted to converge. ``frame_hw``: the JPEG
    frames' (height, width); the default writes the JAX package's files,
    (360, 480) is CREMA-D's video size."""
    rng = np.random.default_rng(seed)
    nl = {m: [(f"clip{m}{i:03d}", CREMAD_CLASSES[i % 6])
              for i in range(n_train if m == "train" else n_test)]
          for m in ("train", "test")}
    _write_lists(root, "cre", nl)
    for mode in ("train", "test"):
        adir = os.path.join(root, f"audio/{mode}_fbank")
        os.makedirs(adir, exist_ok=True)
        for name, label in nl[mode]:
            arr = rng.standard_normal((fbank_len, 128) if fbank else spec_shape
                                      ).astype(np.float32)
            cls = CREMAD_CLASSES.index(label)
            if learnable:
                band = arr.shape[0] // 6
                arr[cls * band:(cls + 1) * band] += 4.0
            np.save(os.path.join(adir, name + ".npy"), arr)
            vdir = os.path.join(root, f"visual/{mode}_imgs/Image-01-FPS", name)
            os.makedirs(vdir, exist_ok=True)
            for k in range(4):
                if learnable:
                    import cv2
                    img = rng.integers(0, 80, (*frame_hw, 3), dtype=np.uint8)
                    stripe = frame_hw[0] // 6
                    img[cls * stripe:(cls + 1) * stripe] = 230
                    cv2.imwrite(os.path.join(vdir, f"0000{k}.jpg"), img)
                else:
                    _write_jpg(os.path.join(vdir, f"0000{k}.jpg"), rng,
                               hw=frame_hw)
    return nl


def make_m3ae(root: str, dataset="MVSA", n_train=8, n_test=4, seed=0,
              token_len=256, img_hw=(48, 64)):
    rng = np.random.default_rng(seed)
    classes = MVSA_CLASSES if dataset == "MVSA" else \
        [f"class_{i:03d}" for i in range(8)]
    tag = "mvsa" if dataset == "MVSA" else "food"
    nl = {m: [(f"img{m}{i:03d}", classes[i % len(classes)])
              for i in range(n_train if m == "train" else n_test)]
          for m in ("train", "test")}
    _write_lists(root, tag, nl)
    for mode in ("train", "test"):
        vdir = os.path.join(root, f"visual/{mode}_imgs")
        tdir = os.path.join(root, f"text_token/{mode}_token")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(tdir, exist_ok=True)
        for name, _ in nl[mode]:
            _write_jpg(os.path.join(vdir, name + ".jpg"), rng, hw=img_hw)
            tok = rng.integers(0, 30522, (1, token_len)).astype(np.int64)
            pm = np.zeros((1, token_len), np.float32)
            pm[0, token_len // 2:] = 1.0
            np.save(os.path.join(tdir, name + "_token.npy"), tok)
            np.save(os.path.join(tdir, name + "_pm.npy"), pm)
    return nl


def make_iemocap(root: str, n_train=8, n_test=4, seed=0, token_len=256,
                 fbank_len=1024, frame_hw=(48, 64)):
    """IEMOCAP tree for Modal3Adapter: 3 frames, an fbank and a token cache
    per utterance. ``frame_hw``: the JPEG frames' (height, width); the
    default writes the JAX package's files."""
    rng = np.random.default_rng(seed)
    nl = {m: [(f"ses{m}{i:03d}", IEMO_CLASSES[i % 4])
              for i in range(n_train if m == "train" else n_test)]
          for m in ("train", "test")}
    _write_lists(root, "iemo", nl)
    for mode in ("train", "test"):
        vroot = os.path.join(root, f"visual/{mode}_imgs")
        tdir = os.path.join(root, f"text_token/{mode}_token")
        adir = os.path.join(root, f"audio/{mode}_fbank")
        for d in (vroot, tdir, adir):
            os.makedirs(d, exist_ok=True)
        for name, _ in nl[mode]:
            vdir = os.path.join(vroot, name)
            os.makedirs(vdir, exist_ok=True)
            for k in range(3):
                _write_jpg(os.path.join(vdir, f"f{k}.jpg"), rng, hw=frame_hw)
            np.save(os.path.join(adir, name + ".npy"),
                    rng.standard_normal((fbank_len, 128)).astype(np.float32))
            tok = rng.integers(0, 30522, (1, token_len)).astype(np.int64)
            np.save(os.path.join(tdir, name + "_token.npy"), tok)
            np.save(os.path.join(tdir, name + "_pm.npy"),
                    np.zeros((1, token_len), np.float32))
    return nl


def make_clip(root: str, n_train=8, n_test=4, seed=0):
    """Food-101 CLIP feature tree (dataset.py:813-816). Also writes the m3ae
    image/token tree since build_index parses the food datalists."""
    make_m3ae(root, dataset="Food101", n_train=n_train, n_test=n_test,
              seed=seed)
    rng = np.random.default_rng(seed + 1)
    nl = {"train": [f"imgtrain{i:03d}" for i in range(n_train)],
          "test": [f"imgtest{i:03d}" for i in range(n_test)]}
    for mode in ("train", "test"):
        tdir = os.path.join(root, "clip_feature/text", mode)
        vdir = os.path.join(root, "clip_feature/image", mode)
        os.makedirs(tdir, exist_ok=True)
        os.makedirs(vdir, exist_ok=True)
        for name in nl[mode]:
            np.save(os.path.join(tdir, name + ".npy"),
                    rng.standard_normal((1, 512)).astype(np.float32))
            np.save(os.path.join(vdir, name + ".npy"),
                    rng.standard_normal((1, 512)).astype(np.float32))
