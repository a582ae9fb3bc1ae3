"""LayerNorm fused with the next Dense (port of ``mla_tpu/ops/fused_block.py``).

Every M3AE block runs a LayerNorm straight into a Dense twice (norm1 -> qkv,
norm2 -> fc1). The fused op computes the row-wise LayerNorm on the way into
the GEMM so the normalized activations never go to device memory. On a CUDA
tensor, ``LnDense`` (the counterpart of the JAX package's ``_ln_dense_fused``
custom VJP) runs the hand-written kernels of ``csrc/ln_dense.cu``: B7f, the
port of the TPU kernel ``_ln_dense_kernel``, and B7b, the port of
``_ln_dense_bwd_dx_kernel`` + ``_ln_dense_bwd_dw_kernel``. On a CPU tensor it
runs the plain versions below. There is no fallback from a kernel to its
plain version.

The op is opt-in (``set_fused_ln_dense``, off by default, as in the JAX
package), and no model of the port calls ``ln_dense``, as none of the JAX
package's does. The TPU's VMEM fit check (``ln_dense_fits``) is not ported:
the card's kernels tile rows and columns at any size.

Numerics (flax.linen's LayerNorm and Dense): LayerNorm statistics in fp32 on
the raw input with the fast variance ``max(E[x^2] - E[x]^2, 0)``, the affine
``(x - m) * (rsqrt(v + eps) * scale) + bias`` in fp32, cast to the compute
type; the Dense with operands in the compute type, fp32 accumulation, and
its bias added after the product in the compute type. Weights take the
port's ``nn.Linear`` layout (F, C); the JAX kernel's is (C, F).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mla_tpu_torch.ops import _build

# The backward's row pass keeps 4 x 2 x C fp32 column sums in shared
# memory, 48 KB at C = 1536, the most a block gets without opting in; the
# wgmma GEMMs tile C and take any multiple of 32.
MAX_C = 1536


def ln_reference(x, scale, bias, eps: float = 1e-5, dtype=None):
    """flax's ``nn.LayerNorm(epsilon=eps, dtype=dtype)`` with fp32 params:
    statistics in fp32 on the raw input, the fast variance, this op order,
    the result cast to ``dtype`` (default x's)."""
    dtype = dtype or x.dtype
    xf = x.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - m * m, 0.0)
    y = (xf - m) * (torch.rsqrt(v + eps) * scale) + bias
    return y.to(dtype)


def dense_reference(x, weight, bias, dtype=None):
    """flax's ``nn.Dense(dtype=dtype)`` on a (F, C) weight: operands rounded
    to ``dtype``, their products summed in fp32 and the sum rounded to
    ``dtype``, then the bias added in ``dtype``."""
    dtype = dtype or x.dtype
    y = torch.matmul(x.to(dtype).float(),
                     weight.to(dtype).float().t()).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def ln_dense_reference(x2, scale, bias, weight, dbias, eps: float = 1e-5,
                       dtype=None):
    """Plain version of B7f: ``dense_reference(ln_reference(x2))``."""
    return dense_reference(ln_reference(x2, scale, bias, eps, dtype),
                           weight, dbias, dtype)


def ln_dense_bwd_reference(x2, scale, bias, weight, dy, eps: float = 1e-5,
                           dtype=None):
    """Plain version of B7b, the TPU kernels' explicit law
    (``_ln_dense_bwd_dx_kernel``, ``_ln_dense_bwd_dw_kernel``): with
    ``dh = dy . W`` (operands in ``dtype``, fp32 sums), ``ds = sum dh * xhat``,
    ``db = sum dh``, ``dx = r * (dxh - mean(dxh) - xhat * mean(dxh * xhat))``
    where ``dxh = dh * scale``; ``dW = dy^T . h`` with h rounded to dy's
    type, fp32 sums; ``dc = sum dy`` in fp32. x2 (N, C), weight (F, C), dy
    (N, F) -> dx (N, C) in x2's type and ds, db (C,), dW (F, C), dc (F,) in
    fp32."""
    dtype = dtype or x2.dtype
    xf = x2.float()
    m = xf.mean(dim=-1, keepdim=True)
    v = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - m * m, 0.0)
    r = torch.rsqrt(v + eps)
    xhat = (xf - m) * r
    g = dy.to(dtype).float()
    dh = torch.matmul(g, weight.to(dtype).float())
    ds = (dh * xhat).sum(dim=0)
    db = dh.sum(dim=0)
    dxh = dh * scale
    dx = r * (dxh - dxh.mean(dim=-1, keepdim=True)
              - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    h = ((xf - m) * (r * scale) + bias).to(dy.dtype).float()
    dw = torch.matmul(dy.float().t(), h)
    dc = dy.float().sum(dim=0)
    return dx.to(x2.dtype), ds, db, dw, dc


def _check(x2, scale, bias, weight, dtype, who: str):
    """The checks both kernel wrappers make -> (N, C, F, compute type)."""
    if x2.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {x2.device}")
    dtype = dtype or x2.dtype
    types = (torch.bfloat16, torch.float32)
    if x2.dtype not in types or dtype not in types:
        raise TypeError(f"{who} takes bf16 or fp32, got x {x2.dtype} and "
                        f"compute type {dtype}")
    if x2.dim() != 2 or weight.dim() != 2 or weight.shape[1] != x2.shape[1]:
        raise ValueError(f"x must be (N, C) and the weight (F, C), got "
                         f"{tuple(x2.shape)} and {tuple(weight.shape)}")
    n, c = x2.shape
    f = weight.shape[0]
    if c % 32 or f % 32 or not 1 <= n or c > MAX_C:
        raise ValueError(f"the kernels take C and F multiples of 32, "
                         f"C <= {MAX_C} and N >= 1, got N={n} C={c} F={f}")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale and bias must be ({c},)")
    for t in (scale, bias, weight):
        if t.device != x2.device:
            raise ValueError("every operand must be on x's device")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    return n, c, f, dtype


def _f32(t):
    return t.to(torch.float32).contiguous()


def ln_dense_fwd(x2, scale, bias, weight, dbias, eps: float = 1e-5,
                 dtype=None):
    """Launch B7f: LN(x2) . weight^T + dbias on CUDA tensors.

    x2: (N, C) contiguous bf16 or fp32; scale, bias: (C,); weight: (F, C);
    dbias: (F,); dtype: the compute type (default x2's). Returns (N, F) in
    dtype. Raises on anything the kernel does not take, and when the launch
    is refused. ``ln_dense_fwd.launches`` counts the launches."""
    n, c, f, dtype = _check(x2, scale, bias, weight, dtype, "ln_dense_fwd")
    if tuple(dbias.shape) != (f,) or dbias.device != x2.device:
        raise ValueError(f"dbias must be ({f},) on x's device")
    w = weight.to(dtype).contiguous()
    s, b, d = _f32(scale), _f32(bias), _f32(dbias)
    out = torch.empty((n, f), dtype=dtype, device=x2.device)
    bf16 = dtype == torch.bfloat16
    # scratch (bf16 compute): each row's mean and rstd, computed once
    stats = torch.empty(2 * n if bf16 else 0, dtype=torch.float32,
                        device=x2.device)
    lib = _lib()
    with _build.on_card(x2):
        rc = lib.mla_ln_dense_fwd(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(),
            d.data_ptr(), out.data_ptr(), stats.data_ptr(), n, c, f,
            int(x2.dtype == torch.bfloat16), int(bf16), float(eps),
            _build.stream(x2))
    if rc != 0:
        raise RuntimeError(f"ln_dense kernel launch failed: CUDA error {rc}")
    ln_dense_fwd.launches += 1
    return out


ln_dense_fwd.launches = 0


def ln_dense_bwd(x2, scale, bias, weight, dy, eps: float = 1e-5,
                 dtype=None):
    """Launch B7b on CUDA tensors: the forward's operands and dy (N, F) in
    the compute type -> dx (N, C) in x2's type and, in fp32, dscale, dbias
    (C,), dW (F, C), dc (F,). Four kernels on the stream (dh GEMM, row pass,
    dW GEMM, column sums; under bf16 compute a fifth sums dW's and dc's
    split partials; ``csrc/ln_dense.cu`` says why), no atomics. Raises on
    anything the kernels do not take, and when a launch is refused.
    ``ln_dense_bwd.launches`` counts its calls."""
    n, c, f, dtype = _check(x2, scale, bias, weight, dtype, "ln_dense_bwd")
    if tuple(dy.shape) != (n, f) or dy.dtype != dtype or \
            dy.device != x2.device:
        raise ValueError(f"dy must be {(n, f)} {dtype} on {x2.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("dy must be contiguous and 16-byte aligned")
    w = weight.to(dtype).contiguous()
    s, b = _f32(scale), _f32(bias)
    dev = x2.device
    dx = torch.empty_like(x2)
    ds, db = (torch.empty(c, dtype=torch.float32, device=dev)
              for _ in range(2))
    dw = torch.empty((f, c), dtype=torch.float32, device=dev)
    dc = torch.empty(f, dtype=torch.float32, device=dev)
    bf16 = int(dtype == torch.bfloat16)
    lib = _lib()
    with _build.on_card(x2):
        # scratch: dh, the rows' statistics, the row pass's sums per block
        # of 32 rows, and dW's split partials, sized by the kernels for
        # this card (bf16 compute)
        splits, floats = _dw_scratch(lib, n, c, f, bf16)
        dh = torch.empty((n, c), dtype=torch.float32, device=dev)
        stats = torch.empty(2 * n, dtype=torch.float32, device=dev)
        part = torch.empty(2 * c * -(-n // 32), dtype=torch.float32,
                           device=dev)
        wpart = torch.empty(floats, dtype=torch.float32, device=dev)
        rc = lib.mla_ln_dense_bwd(
            x2.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), ds.data_ptr(), db.data_ptr(),
            dw.data_ptr(), dc.data_ptr(), dh.data_ptr(), stats.data_ptr(),
            part.data_ptr(), wpart.data_ptr(), splits, n, c, f,
            int(x2.dtype == torch.bfloat16), bf16, float(eps),
            _build.stream(x2))
    if rc != 0:
        raise RuntimeError(f"ln_dense backward kernel launch failed: CUDA "
                           f"error {rc}")
    ln_dense_bwd.launches += 1
    return dx, ds, db, dw, dc


ln_dense_bwd.launches = 0


def _dw_scratch(lib, n: int, c: int, f: int, bf16: int):
    """(row splits, fp32 values of their partials) of B7b's dW GEMM on the
    current card, as ``csrc/ln_dense.cu`` chooses them."""
    splits = ctypes.c_int(0)
    floats = lib.mla_ln_dense_bwd_scratch(n, c, f, bf16, ctypes.byref(splits))
    return splits.value, floats


def ln_dense_bwd_splits(n: int, c: int, f: int, dtype) -> int:
    """The row splits B7b's dW GEMM takes at (N, C, F) in ``dtype`` on the
    current card (1 under fp32 compute)."""
    return _dw_scratch(_lib(), n, c, f, int(dtype == torch.bfloat16))[0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("ln_dense")
    fwd = lib.mla_ln_dense_fwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    scratch = lib.mla_ln_dense_bwd_scratch
    scratch.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    scratch.restype = ctypes.c_longlong
    bwd = lib.mla_ln_dense_bwd
    bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib


class LnDense(torch.autograd.Function):
    """LN(x2) . weight^T + dbias with its own backward (the counterpart of
    the JAX package's ``_ln_dense_fused`` custom VJP). The forward saves its
    operands when a gradient is wanted; the backward recomputes the
    statistics. Gradients come back in the parameters' types. CUDA tensors
    go to the kernels, CPU tensors to the plain versions."""

    @staticmethod
    def forward(ctx, x2, scale, bias, weight, dbias, eps, dtype):
        ctx.eps, ctx.dtype = eps, dtype
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x2, scale, bias, weight, dbias)
        if x2.device.type == "cpu":
            return ln_dense_reference(x2, scale, bias, weight, dbias, eps,
                                      dtype)
        return ln_dense_fwd(x2, scale, bias, weight, dbias, eps, dtype)

    @staticmethod
    def backward(ctx, dy):
        x2, scale, bias, weight, dbias = ctx.saved_tensors
        bwd = ln_dense_bwd_reference if x2.device.type == "cpu" \
            else ln_dense_bwd
        dx, ds, db, dw, dc = bwd(x2, scale, bias, weight, dy.contiguous(),
                                 ctx.eps, ctx.dtype)
        return (dx, ds.to(scale.dtype), db.to(bias.dtype),
                dw.to(weight.dtype), dc.to(dbias.dtype), None, None)


# Opt-in, as in the JAX package (measured slower than XLA's own fusion on a
# TPU, so left off there).
_FUSED_ENABLED = False


def set_fused_ln_dense(enabled: bool):
    global _FUSED_ENABLED
    _FUSED_ENABLED = bool(enabled)


def ln_dense(x, scale, bias, weight, dbias, eps: float = 1e-5,
             dtype: Optional[torch.dtype] = None):
    """LayerNorm(x) . weight^T + dbias over the last axis of ``x``.

    x: (..., C); scale, bias: (C,) fp32; weight: (F, C); dbias: (F,) fp32;
    ``dtype``: the compute type (default x's). With ``set_fused_ln_dense``
    on, ``LnDense`` (the kernels on a CUDA tensor, or their wrappers raise;
    the plain versions on a CPU tensor); off, the LayerNorm and Dense
    composition."""
    c = x.shape[-1]
    dtype = dtype or x.dtype
    x2 = x.reshape(-1, c).contiguous()
    if _FUSED_ENABLED:
        out = LnDense.apply(x2, scale, bias, weight, dbias, eps, dtype)
    else:
        out = ln_dense_reference(x2, scale, bias, weight, dbias, eps, dtype)
    return out.reshape(*x.shape[:-1], weight.shape[0])
