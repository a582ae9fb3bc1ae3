"""Masked attention for the ViT encoders (port of ``mla_tpu/ops/attention.py``).

The reference materializes (B, H, S, S) scores and applies the padding mask
by overwriting masked columns with -1e7 before the softmax (reference:
models/m3ae.py:95-127). Mask semantics kept exactly: where mask > 0 the
*scaled* score is replaced by -1e7 (not added), then softmax.

On a CUDA tensor, attention on the fused qkv projection runs through the
hand-written kernel ``csrc/flat_attention.cu`` (the port of the TPU kernel
``_attn_kernel_flat``). On a CPU tensor it runs the plain version below. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mla_tpu_torch.ops import _build

_NEG = -1e7
HEAD_DIMS = (16, 64, 80)   # the kernel's instantiations: tests, base, huge


def attention_reference(q, k, v, padding_mask=None, scale=None):
    """Plain reference. q,k,v: (B, H, S, D); padding_mask: (B, S) 1=padded.

    Products in fp32 (bf16 products are exact there), softmax in fp32, the
    probabilities rounded to v's type before the PV product, output in q's
    type — the JAX reference's arithmetic."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if padding_mask is not None:
        m = padding_mask[:, None, None, :] > 0
        scores = torch.where(m, torch.full_like(scores, _NEG), scores)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flat_attention_reference(qkv, padding_mask, num_heads: int):
    """Plain version of the flat kernel: qkv (B, S, 3C), thirds ordered
    [q | k | v], each H heads x D; padding_mask (B, S) or None -> (B, S, C)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    parts = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    out = attention_reference(parts[0], parts[1], parts[2], padding_mask)
    return out.permute(0, 2, 1, 3).reshape(b, s, c)


def flash_attention_flat(qkv, padding_mask, num_heads: int):
    """Launch the flat attention kernel on a CUDA tensor.

    qkv: (B, S, 3C) contiguous bf16 or fp32 on the card; padding_mask: (B, S),
    1 = padded, or None. Returns (B, S, C). Raises on anything the kernel does
    not take, and when the launch is refused. ``flash_attention_flat.launches``
    counts the launches."""
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_flat needs a CUDA tensor, got "
                         f"{qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flat attention takes bf16 or fp32, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, S, 3C) with C divisible by "
                         f"{num_heads} heads, got {tuple(qkv.shape)}")
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes {HEAD_DIMS}")
    if not (1 <= b <= 65535 and s >= 1):
        raise ValueError(f"batch {b} / sequence {s} out of the kernel's grid")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if padding_mask is None:
        mask = torch.zeros((b, s), dtype=torch.float32, device=qkv.device)
    else:
        if tuple(padding_mask.shape) != (b, s):
            raise ValueError(f"padding_mask {tuple(padding_mask.shape)} != "
                             f"{(b, s)}")
        if padding_mask.device != qkv.device:
            raise ValueError("padding_mask must be on qkv's device")
        mask = padding_mask.to(torch.float32).contiguous()
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    lib = _flat_lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.mla_flat_attention_fwd(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), b, s, num_heads,
            d, int(qkv.dtype == torch.bfloat16), float(d ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flat attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention_flat.launches += 1
    return out


flash_attention_flat.launches = 0


def _flat_lib() -> ctypes.CDLL:
    lib = _build.load("flat_attention")
    fn = lib.mla_flat_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_attention_qkv(qkv, padding_mask: Optional[torch.Tensor],
                        num_heads: int):
    """Attention on the raw fused-qkv projection (B, S, 3C) -> (B, S, C).

    A CUDA tensor goes to the hand-written kernel (or the kernel's wrapper
    raises); a CPU tensor goes to the plain version."""
    if qkv.device.type == "cpu":
        return flat_attention_reference(qkv, padding_mask, num_heads)
    return flash_attention_flat(qkv, padding_mask, num_heads)
