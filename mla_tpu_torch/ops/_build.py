"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` (with the headers ``csrc/*.cuh``) is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to ``$MLA_TPU_TORCH_BUILD_DIR`` when it is set, else
to ``build/mla_tpu_torch/`` in the checkout the package runs from, else (an
installed package, whose sources ship as package data) to
``$XDG_CACHE_HOME/mla_tpu_torch`` (default ``~/.cache``). Each is named by a
hash of the source and flags, so an edited source is rebuilt and concurrent
builds never share a file. ``-Xptxas -v`` is always on; its report
(registers, shared memory, spills) is kept beside the library as ``.log``.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``. ``stream`` and ``on_card`` are the wrappers'
launch context.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin);"
                       " the port's CUDA kernels are built from source at first use")


def build_dir() -> Path:
    env = os.environ.get("MLA_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    if (_CHECKOUT / "pyproject.toml").exists():
        return _CHECKOUT / "build" / "mla_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "mla_tpu_torch"


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds its users
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; returns
    the library's path. Raises with the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def stream(x) -> int:
    """The raw handle of the current stream on x's card (what
    ``torch.cuda.current_stream(dev).cuda_stream`` returns, without
    building a Stream object on every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def on_card(x):
    """The context of a launch on x's card: nothing to do when it is the
    current device (the models' case), else ``torch.cuda.device``."""
    import torch
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)
