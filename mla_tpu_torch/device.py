"""Device selection for the PyTorch port.

Entry points run on the card unless the caller asks for the CPU. There is no
fallback: asking for ``cuda`` on a machine without a card raises, so a run
that was meant for the GPU never quietly measures the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """'cuda' (the default) or 'cpu' -> torch.device; raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but no CUDA device is available; "
                "pass device='cpu' (--device cpu) to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    return dev


def set_matmul_precision() -> None:
    """State the float32 matmul rules explicitly: full float32 for matrix
    products and convolutions (no TF32), so float32 runs compare with the
    JAX package at its 'highest' precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
