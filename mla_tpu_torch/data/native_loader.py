"""ctypes binding for the C++ loader core (``native/mla_native.cc``), the
port's own (port of ``mla_tpu/data/native_loader.py``).

The library is built at first use from ``native/mla_native.cc`` with the
flags of ``native/Makefile`` into the port's build directory
(``mla_tpu_torch.ops._build.build_dir()``, ``build/mla_tpu_torch/`` in a
checkout), named by a hash of the source and flags; ``native/`` itself is
never written. Where it cannot be built (no compiler, no libjpeg headers),
``available()`` is false and the adapters take the per-sample cv2 path.

Resampling note: the native JPEG path uses area-weighted sampling that is
statistically, not bitwise, equivalent to the fallback's cv2.INTER_AREA, so
two runs compare bit for bit only on the same decode path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mla_tpu_torch.ops._build import build_dir

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mla_native.cc"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LINK_FLAGS = ("-ljpeg", "-lpthread")

_lib = None
_tried = False
_LOCK = threading.Lock()          # train+test Loader producers race first use
_warned: set = set()


def _warn_once(tag: str, msg: str) -> None:
    if tag not in _warned:
        _warned.add(tag)
        warnings.warn(msg, stacklevel=3)


def library_path(source: Path = SOURCE, link=LINK_FLAGS) -> Path:
    """``build/mla_tpu_torch/lib<stem>-<hash of source and flags>.so`` for
    a C++ source of ``native/`` (its stem without a ``lib`` prefix)."""
    flags = " ".join(CXX_FLAGS + tuple(link)).encode()
    digest = hashlib.sha256(source.read_bytes() + flags).hexdigest()[:16]
    stem = source.stem if source.stem.startswith("lib") else \
        "lib" + source.stem
    return build_dir() / f"{stem}-{digest}.so"


def build(source: Path = SOURCE, link=LINK_FLAGS) -> Path:
    """Compile ``source`` with ``native/Makefile``'s flags unless its
    library exists; raises on failure."""
    out = library_path(source, link)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(source),
                           *link], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {source.name}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)     # concurrent builds never share a file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.mla_load_npy_batch.restype = ctypes.c_int
        lib.mla_load_npy_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.mla_decode_jpeg_batch.restype = ctypes.c_int
        lib.mla_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mla_native_version.restype = ctypes.c_int
        if lib.mla_native_version() < 1:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _paths_array(paths: List[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def load_npy_batch(paths: List[str], item_shape: Tuple[int, ...],
                   dtype=np.float32) -> np.ndarray:
    """(len(paths),) + item_shape array; short files zero-padded, long files
    truncated (cut-and-pad, extract_fbank.py:42-52). Falls back to np.load."""
    lib = _load()
    n = len(paths)
    per_item = int(np.prod(item_shape))
    as_int = 1 if np.issubdtype(dtype, np.integer) else 0
    out_dtype = np.int32 if as_int else np.float32
    if lib is not None:
        out = np.empty((n, per_item), dtype=out_dtype)
        fails = lib.mla_load_npy_batch(
            _paths_array(paths), n, out.ctypes.data_as(ctypes.c_void_p),
            per_item, as_int)
        if fails == 0:
            return out.reshape((n,) + item_shape)
        # the C++ reader handles <f4/<f8/<i4/<i8 C-order only
        _warn_once("npy", f"native npy reader failed for {fails}/{n} items "
                          "(unsupported dtype/fortran_order?); using the "
                          "serial np.load fallback for this and similar "
                          "batches")
    out = np.zeros((n, per_item), dtype=out_dtype)
    for i, p in enumerate(paths):
        a = np.load(p).reshape(-1)[:per_item]
        out[i, :a.size] = a.astype(out_dtype)
    return out.reshape((n,) + item_shape)


def decode_jpeg_batch(paths: List[str], out_hw: Tuple[int, int]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """((n, H, W, 3) uint8 RGB, (n, 2) original sizes).

    Failed slots are zeroed with hw=(0,0) — modality-dropout-safe (mirrors
    the reference's decode-error fallbacks) — on BOTH the native and the
    cv2/PIL fallback path; 100% failure warns loudly (it is
    indistinguishable from success in the output arrays)."""
    lib = _load()
    n = len(paths)
    h, w = out_hw
    if lib is not None:
        out = np.empty((n, h, w, 3), dtype=np.uint8)
        hw = np.empty((n, 2), dtype=np.int32)
        fails = lib.mla_decode_jpeg_batch(
            _paths_array(paths), n, out.ctypes.data_as(ctypes.c_void_p),
            h, w, hw.ctypes.data_as(ctypes.c_void_p))
    else:
        from mla_tpu_torch.data.transforms import host_decode
        out = np.zeros((n, h, w, 3), dtype=np.uint8)
        hw = np.zeros((n, 2), dtype=np.int32)
        fails = 0
        for i, p in enumerate(paths):
            try:
                out[i], hw[i] = host_decode(p, (h, w))
            except Exception:   # noqa: BLE001 — cv2/PIL raise many types
                fails += 1      # slot stays zeroed, hw=(0,0)
    if fails == n and n > 0:
        _warn_once("jpeg_all",
                   "EVERY jpeg decode in the batch failed (first path: "
                   f"{paths[0]}); images are all-zero — check the visual "
                   "root / file extensions")
    return out, hw
