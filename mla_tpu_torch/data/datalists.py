"""Datalist / class-list parsing + artifact path layout.

The PyTorch port's own copy of ``mla_tpu/data/datalists.py`` (the port
imports nothing of the JAX package).

Reference: dataset/dataset.py — every Dataset class reads a class list from
``data/stat_*.txt``, ``name label`` lines from ``data/my_{train,test}_*.txt``
(separators vary by dataset), resolves preprocessed artifacts under hardcoded
``/data1/zhangxiaohui/...`` roots, and drops entries whose files are missing
(dataset.py:74-89). Here the same formats are parsed against a configurable
``data_root``; the artifact directory layout is preserved verbatim so
reference-preprocessed trees mount directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetPaths:
    """Artifact layout per dataset (dataset.py path blocks)."""
    name: str
    list_tag: str            # stat_{tag}.txt / my_{mode}_{tag}.txt
    sep: str                 # datalist 'name label' separator
    audio_dir: Optional[str] = None      # {mode} formatted
    visual_dir: Optional[str] = None
    text_dir: Optional[str] = None


LAYOUTS: Dict[str, DatasetPaths] = {
    # CREMA-D AV (dataset.py:48-55): .flv sep; spectrogram .npy per clip +
    # frame dirs. Reference-faithful hazard (dataset.py:44,188): the SAME
    # audio dir serves the base path's log-STFT spectrograms AND the large
    # path's 1024x128 fbanks; adapters probe shapes from disk, so a tree
    # preprocessed for the other path trains on wrong features with no
    # error — keep spec and fbank trees in separate data_roots.
    "CREMAD": DatasetPaths("CREMAD", "cre", ".flv ",
                           audio_dir="audio/{mode}_fbank",
                           visual_dir="visual/{mode}_imgs/Image-01-FPS"),
    # Food-101 / MVSA m3ae (dataset.py:336-351): .jpg sep; token npys + jpgs
    "Food101": DatasetPaths("Food101", "food", ".jpg ",
                            visual_dir="visual/{mode}_imgs",
                            text_dir="text_token/{mode}_token"),
    "MVSA": DatasetPaths("MVSA", "mvsa", ".jpg ",
                         visual_dir="visual/{mode}_imgs",
                         text_dir="text_token/{mode}_token"),
    # IEMOCAP 3-modal (dataset.py:652-663): ' [split|sign] ' separator
    "IEMOCAP": DatasetPaths("IEMOCAP", "iemo", " [split|sign] ",
                            audio_dir="audio/{mode}_fbank",
                            visual_dir="visual/{mode}_imgs",
                            text_dir="text_token/{mode}_token"),
}


def read_classes(stat_path: str) -> List[str]:
    with open(stat_path) as f:
        classes = [line.strip() for line in f if line.strip()]
    return sorted(classes)


def read_datalist(list_path: str, sep: str) -> List[Tuple[str, str]]:
    """Returns [(name, label_str)] per my_*_*.txt line format."""
    out = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = line.split(sep)
            name = item[0]
            if sep == " [split|sign] ":
                name = name.split(".mp4")[0]           # dataset.py:674
            out.append((name, item[-1]))
    return out


@dataclasses.dataclass
class DataIndex:
    """Resolved, existence-filtered dataset index (static shapes downstream)."""
    names: List[str]
    labels: List[int]
    classes: List[str]
    paths: DatasetPaths
    data_root: str
    mode: str

    def __len__(self):
        return len(self.names)

    def dir(self, kind: str) -> str:
        tpl = getattr(self.paths, f"{kind}_dir")
        return os.path.join(self.data_root, tpl.format(mode=self.mode))


def build_index(dataset: str, data_root: str, mode: str,
                required: Tuple[str, ...] = (),
                lists_dir: Optional[str] = None) -> DataIndex:
    """Parse stat + datalist, filter to samples whose artifacts exist.

    required: subset of ('audio','visual','text') whose artifact must exist
    (mirrors dataset.py:85-89 filtering; empty = keep all listed)."""
    paths = LAYOUTS[dataset]
    lists_dir = lists_dir or os.path.join(data_root, "lists")
    classes = read_classes(os.path.join(lists_dir, f"stat_{paths.list_tag}.txt"))
    entries = read_datalist(
        os.path.join(lists_dir, f"my_{mode}_{paths.list_tag}.txt"), paths.sep)

    names, labels = [], []
    for name, label in entries:
        ok = True
        for kind in required:
            d = os.path.join(data_root,
                             getattr(paths, f"{kind}_dir").format(mode=mode))
            if kind == "visual" and dataset in ("Food101", "MVSA"):
                p = os.path.join(d, name + ".jpg")
            elif kind == "visual":
                p = os.path.join(d, name)       # frame directory
            elif kind == "text":
                p = os.path.join(d, name + "_token.npy")
            else:
                p = os.path.join(d, name + ".npy")
            if not os.path.exists(p):
                ok = False
                break
        if ok:
            names.append(name)
            labels.append(classes.index(label))
    return DataIndex(names=names, labels=labels, classes=classes, paths=paths,
                     data_root=data_root, mode=mode)
