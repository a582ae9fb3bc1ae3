"""Masked attention for the ViT encoders (port of ``mla_tpu/ops/attention.py``).

The reference materializes (B, H, S, S) scores and applies the padding mask
by overwriting masked columns with -1e7 before the softmax (reference:
models/m3ae.py:95-127). Mask semantics kept exactly: where mask > 0 the
*scaled* score is replaced by -1e7 (not added), then softmax.

Two routes, as in the JAX package, picked by ``set_flat_attention`` (on by
default; the JAX driver turns it off for a whole run whose mesh has a model
axis):

- flat (on): attention on the fused qkv projection runs through
  ``FlatAttention``, the counterpart of the JAX package's ``_flat_mha``
  custom VJP. On a CUDA tensor its forward is the hand-written kernel
  ``csrc/flat_attention.cu`` (``mla_flat_attention_fwd``, the port of the
  TPU kernel ``_attn_kernel_flat``) and its backward
  ``csrc/flat_attention_bwd.cu`` (``mla_flat_attention_bwd``, the port of
  ``_attn_bwd_kernel_flat``).
- head layout (off): the projection is laid out as (3, B, H, S, D) and
  ``HeadAttention``, the counterpart of ``_flash_mha``, runs the same
  sources' (B, H, S, D) entry points (``mla_head_attention_fwd`` /
  ``_bwd``, the ports of ``_attn_kernel_heads`` / ``_attn_kernel`` and
  ``_attn_bwd_kernel_heads``).

On a CPU tensor both routes take the plain versions below. There is no
fallback from a kernel to its plain version. The TPU's VMEM routing
(``flat_attention_fits``, the head chunks, the q-blockwise kernel for long
sequences and the S <= 1024 limit of the Pallas backward) is not ported:
the card's kernels stream key tiles at every S, so each route keeps one law
at every length.
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


def attention_bwd_reference(q, k, v, do, padding_mask=None, scale=None):
    """Plain version of the backward kernels: the VJP of
    ``attention_reference`` with the TPU kernel's arithmetic
    (``_attn_bwd_kernel_heads``, ``_attn_bwd_kernel_flat``): scores, P,
    ``dp = do.v^T`` and ``delta = sum(p * dp)`` in fp32;
    ``ds = p * (dp - delta)`` rounded to the input type before the dq/dk
    products and P rounded to it before the dv product; fp32 accumulation.
    ``ds`` is 0 at a masked key, as in the VJP of the reference, whose mask
    replaces the score. q, k, v, do (B, H, S, D) -> (dq, dk, dv) in q's
    type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    q, k, v, g = q.float(), k.float(), v.float(), do.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    masked = None
    if padding_mask is not None:
        masked = padding_mask[:, None, None, :] > 0
        scores = torch.where(masked, torch.full_like(scores, _NEG), scores)
    p = torch.softmax(scores, dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if masked is not None:
        ds = torch.where(masked, torch.zeros_like(ds), ds)
    ds = ds.to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), g)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flat_attention_bwd_reference(qkv, do, padding_mask, num_heads: int):
    """Plain version of the flat backward kernel: ``attention_bwd_reference``
    on the flat layout. qkv (B, S, 3C), do (B, S, C) -> d(qkv) (B, S, 3C) in
    qkv's type, in the forward's column layout."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    q, k, v = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    g = do.reshape(b, s, num_heads, d).permute(0, 2, 1, 3)
    out = torch.stack(attention_bwd_reference(q, k, v, g, padding_mask))
    return out.permute(1, 3, 0, 2, 4).reshape(b, s, c3)   # from (3, B, H, S, D)


def _check_qkv(qkv, num_heads: int, who: str):
    """The checks both kernel wrappers make on qkv -> (B, S, C, D)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {qkv.device}")
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
    return b, s, c, d


def _check_heads(q, k, v, who: str):
    """The checks both head-layout wrappers make on q, k, v -> (B, H, S, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention takes bf16 or fp32, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes {HEAD_DIMS}")
    if not (1 <= b <= 65535 and 1 <= h <= 65535 and s >= 1):
        raise ValueError(f"batch {b} / heads {h} / sequence {s} out of the "
                         f"kernel's grid")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte "
                             "aligned")
    return b, h, s, d


def _kernel_mask(padding_mask, x, b: int, s: int):
    """The (B, S) fp32 mask the kernels read, 1 = padded; zeros for None."""
    if padding_mask is None:
        return torch.zeros((b, s), dtype=torch.float32, device=x.device)
    if tuple(padding_mask.shape) != (b, s):
        raise ValueError(f"padding_mask {tuple(padding_mask.shape)} != "
                         f"{(b, s)}")
    if padding_mask.device != x.device:
        raise ValueError("padding_mask must be on the operands' device")
    return padding_mask.to(torch.float32).contiguous()


def flash_attention_flat(qkv, padding_mask, num_heads: int):
    """Launch the flat attention kernel on a CUDA tensor.

    qkv: (B, S, 3C) contiguous bf16 or fp32 on the card; padding_mask: (B, S),
    1 = padded, or None. Returns (B, S, C). Raises on anything the kernel does
    not take, and when the launch is refused. ``flash_attention_flat.launches``
    counts the launches."""
    b, s, c, d = _check_qkv(qkv, num_heads, "flash_attention_flat")
    mask = _kernel_mask(padding_mask, qkv, b, s)
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


def flash_attention_flat_bwd(qkv, do, padding_mask, num_heads: int):
    """Launch the flat attention backward kernel on CUDA tensors.

    qkv: (B, S, 3C) as the forward took it; do: (B, S, C), the gradient of the
    forward's output, of qkv's type; padding_mask: (B, S), 1 = padded, or
    None. Returns d(qkv) (B, S, 3C) in the forward's column layout (q at
    column h*D, k at C + h*D, v at 2C + h*D). Raises on anything the kernel
    does not take, and when a launch is refused.
    ``flash_attention_flat_bwd.launches`` counts the launches."""
    b, s, c, d = _check_qkv(qkv, num_heads, "flash_attention_flat_bwd")
    if tuple(do.shape) != (b, s, c) or do.dtype != qkv.dtype or \
            do.device != qkv.device:
        raise ValueError(f"do must be {(b, s, c)} {qkv.dtype} on "
                         f"{qkv.device}, got {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("do must be contiguous and 16-byte aligned")
    mask = _kernel_mask(padding_mask, qkv, b, s)
    dqkv = torch.empty_like(qkv)
    # per (b, head, query): row max, row sum and delta = sum_j p_ij dp_ij,
    # written by the first pass and read by the second
    stats = torch.empty(3 * b * num_heads * s, dtype=torch.float32,
                        device=qkv.device)
    lib = _bwd_lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.mla_flat_attention_bwd(
            qkv.data_ptr(), do.data_ptr(), mask.data_ptr(), dqkv.data_ptr(),
            stats.data_ptr(), b, s, num_heads, d,
            int(qkv.dtype == torch.bfloat16), float(d ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(f"flat attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_flat_bwd.launches += 1
    return dqkv


flash_attention_flat_bwd.launches = 0


def flash_attention(q, k, v, padding_mask=None, scale=None):
    """Launch the head-layout attention kernel on CUDA tensors.

    q, k, v: (B, H, S, D) contiguous bf16 or fp32 on the card, of one type;
    padding_mask: (B, S), 1 = padded, or None; scale: default D**-0.5.
    Returns (B, H, S, D). Raises on anything the kernel does not take, and
    when the launch is refused. ``flash_attention.launches`` counts the
    launches."""
    b, h, s, d = _check_heads(q, k, v, "flash_attention")
    mask = _kernel_mask(padding_mask, q, b, s)
    out = torch.empty_like(q)
    lib = _flat_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mla_head_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, s, h, d, int(q.dtype == torch.bfloat16),
            float(d ** -0.5 if scale is None else scale), stream)
    if rc != 0:
        raise RuntimeError(f"head attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, do, padding_mask, scale=None):
    """Launch the head-layout attention backward kernel on CUDA tensors.

    q, k, v: (B, H, S, D) as the forward took them; do: the gradient of the
    forward's output, of q's shape and type; padding_mask: (B, S), 1 =
    padded, or None. Returns (dq, dk, dv), each (B, H, S, D) in q's type.
    Raises on anything the kernel does not take, and when a launch is
    refused. ``flash_attention_bwd.launches`` counts the launches."""
    b, h, s, d = _check_heads(q, k, v, "flash_attention_bwd")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, got {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("do must be contiguous and 16-byte aligned")
    mask = _kernel_mask(padding_mask, q, b, s)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # per (b, head, query): row max, row sum and delta, as in the flat kernel
    stats = torch.empty(3 * b * h * s, dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mla_head_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), b, s, h, d, int(q.dtype == torch.bfloat16),
            float(d ** -0.5 if scale is None else scale), stream)
    if rc != 0:
        raise RuntimeError(f"head attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _bind(fn, n_ptrs: int):
    """ctypes signature of an entry point: n_ptrs pointers, then B, S, H, D,
    bf16, the scale and the stream."""
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _flat_lib() -> ctypes.CDLL:
    """The forward source: the flat and the head-layout entry points."""
    lib = _build.load("flat_attention")
    _bind(lib.mla_flat_attention_fwd, 3)
    _bind(lib.mla_head_attention_fwd, 5)
    return lib


def _bwd_lib() -> ctypes.CDLL:
    """The backward source: the flat and the head-layout entry points."""
    lib = _build.load("flat_attention_bwd")
    _bind(lib.mla_flat_attention_bwd, 5)
    _bind(lib.mla_head_attention_bwd, 9)
    return lib


class FlatAttention(torch.autograd.Function):
    """Attention on the fused qkv projection with its own backward (the
    counterpart of the JAX package's ``_flat_mha`` custom VJP). The forward
    saves qkv and the mask; the backward recomputes P and returns d(qkv) as
    one (B, S, 3C) tensor. CUDA tensors go to the kernels, CPU tensors to
    the plain versions."""

    @staticmethod
    def forward(ctx, qkv, padding_mask, num_heads: int):
        ctx.num_heads = num_heads
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(qkv, padding_mask)
        if qkv.device.type == "cpu":
            return flat_attention_reference(qkv, padding_mask, num_heads)
        return flash_attention_flat(qkv, padding_mask, num_heads)

    @staticmethod
    def backward(ctx, do):
        qkv, padding_mask = ctx.saved_tensors
        if qkv.device.type == "cpu":
            dqkv = flat_attention_bwd_reference(qkv, do, padding_mask,
                                                ctx.num_heads)
        else:
            dqkv = flash_attention_flat_bwd(qkv, do.contiguous(),
                                            padding_mask, ctx.num_heads)
        return dqkv, None, None


class HeadAttention(torch.autograd.Function):
    """Attention on (B, H, S, D) with its own backward (the counterpart of
    the JAX package's ``_flash_mha`` custom VJP). The forward saves q, k, v
    and the mask when a gradient is wanted; the backward recomputes P. CUDA
    tensors go to the kernels, CPU tensors to the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, scale):
        ctx.scale = scale
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, padding_mask)
        if q.device.type == "cpu":
            return attention_reference(q, k, v, padding_mask, scale)
        return flash_attention(q, k, v, padding_mask, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, padding_mask = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_bwd_reference(q, k, v, do, padding_mask,
                                            ctx.scale)
        else:
            grads = flash_attention_bwd(q, k, v, do.contiguous(),
                                        padding_mask, ctx.scale)
        return (*grads, None, None)


def fused_attention(q, k, v, padding_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """Attention on (B, H, S, D) through ``HeadAttention`` on every device: a
    CUDA tensor goes to the hand-written kernels (or their wrappers raise), a
    CPU tensor to the plain versions."""
    return HeadAttention.apply(q, k, v, padding_mask, scale)


# The route of ``fused_attention_qkv``: flat (on, the default) or the head
# layout. One setting holds for a whole run, training and eval alike; the
# JAX driver turns it off when the mesh has a model axis.
_FLAT_ENABLED = True


def set_flat_attention(enabled: bool):
    global _FLAT_ENABLED
    _FLAT_ENABLED = bool(enabled)


def fused_attention_qkv(qkv, padding_mask: Optional[torch.Tensor],
                        num_heads: int):
    """Attention on the raw fused-qkv projection (B, S, 3C) -> (B, S, C).

    Flat route (``set_flat_attention(True)``, the default): ``FlatAttention``
    on the projection as it is. Head route: the projection is laid out as
    (3, B, H, S, D) by PyTorch's permute and copy, ``fused_attention`` runs,
    and its result is laid back as (B, S, C), as the JAX package does. Both
    record nothing where no gradient is wanted. A CUDA tensor goes to the
    hand-written kernels (or their wrappers raise); a CPU tensor to the
    plain versions."""
    if _FLAT_ENABLED:
        return FlatAttention.apply(qkv, padding_mask, num_heads)
    b, s, c3 = qkv.shape
    c = c3 // 3
    # unbind, not indexing: its backward stacks dq, dk, dv in one copy
    q, k, v = qkv.reshape(b, s, 3, num_heads, c // num_heads).permute(
        2, 0, 3, 1, 4).contiguous().unbind(0)
    out = fused_attention(q, k, v, padding_mask)
    return out.permute(0, 2, 1, 3).reshape(b, s, c)
