"""The stride-1 SAME 3x3 convolution of the ResNet-18 body, C == F (port of
``mla_tpu/ops/conv3x3.py``).

Layouts follow PyTorch: activations (B, C, H, W) stored ``channels_last``
(physically NHWC, what the kernel reads and what cuDNN prefers for the convs
that stay on ``F.conv2d``), weights (F, C, 3, 3) as ``nn.Conv2d`` keeps
them. The JAX package's NHWC x HWIO is the same arithmetic.

``Conv3x3`` is the counterpart of ``conv3x3_vjp``: on a CUDA tensor its
forward is the hand-written kernel ``csrc/conv3x3.cu`` (the port of the TPU
kernel ``_kernel_flat``), and its backward computes dx with the same kernel
on the 180-degree rotated, channel-swapped weight and dw with PyTorch's conv
weight-gradient (the JAX package leaves dw to XLA's conv-grad, outside any
Pallas kernel). On a CPU tensor both run the plain version. There is no
fallback from one to the other.

The kernel. bf16: an implicit GEMM on Hopper's wgmma (M = B*H*W pixels,
N = F, K = 9*C, computed as W . X^T), fed by TMA: each k-stage is one tap
and 64 channels, the pixel tile one im2col load that runs flat over B*H*W
(TMA's out-of-bounds fill is the zero padding), the weight tile a tiled
load of the K-major weight ``pack_weight`` makes; one producer thread, a
ring of 4-6 shared-memory stages, two consumer warpgroups with fp32
accumulators, one rounding to bf16 in a TMA-store epilogue. fp32: the FMA
pipes. ``tests/test_torch_port_conv3x3_law.py`` writes the bf16 operand law
in torch.

Compute type. The TPU path of the JAX package rounds the operands to bf16
even in a float32 model (``conv3x3_vjp``'s default ``compute_dtype``); off
the TPU it computes exactly in float32. The port follows the latter: the
kernel computes in its input's type, bf16 or fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mla_tpu_torch.ops import _build

CHANNELS = (64, 128, 256, 512)    # the kernel's scope: C == F in these


def conv3x3_reference(x, w, compute_dtype=None):
    """Plain version: ``F.conv2d`` with padding 1 and stride 1 on the
    operands cast to ``compute_dtype`` (default: their own types)."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    return F.conv2d(x, w, padding=1)


def eligible(x, w) -> bool:
    """The kernel's scope (the JAX package's ``_eligible``): a 4-D input and
    a (C, C, 3, 3) weight with C in 64/128/256/512. Stride 1 and SAME
    padding are the caller's part."""
    return (x.dim() == 4 and w.dim() == 4 and tuple(w.shape[2:]) == (3, 3)
            and w.shape[0] == w.shape[1] == x.shape[1]
            and w.shape[0] in CHANNELS)


def pack_weight(w, dtype, rotated: bool = False):
    """(F, C, 3, 3) -> the K-major matrix the kernel reads (wgmma's A
    operand): (F, 9*C), row f holding filter f's taps, column (ky*3 + kx)*C
    + c. ``rotated``: the dx weight ``rot180_swap(w)`` without its rotation,
    (C, 9*F) with row c, column (ky*3 + kx)*F + f holding w[f, c, ky, kx];
    the kernel reads its taps in reverse. One copy, made per call on the
    weight's device, since the weights change every step."""
    src = w.permute(1, 2, 3, 0) if rotated else w.permute(0, 2, 3, 1)
    out = torch.empty(src.shape, dtype=dtype, device=w.device)
    out.copy_(src)
    return out.view(src.shape[0], -1)


def rot180_swap(w):
    """(F, C, 3, 3) -> (C, F, 3, 3): the dx-conv weight, taps rotated 180
    degrees and input and output channels swapped (``_rot180_swap``)."""
    return w.flip(2, 3).transpose(0, 1)


def conv3x3(x, w, rotated: bool = False):
    """Launch the 3x3 conv kernel on CUDA tensors.

    x: (B, C, H, W) bf16 or fp32, ``channels_last``-contiguous, on the card;
    w: (C, C, 3, 3) on the same card (any float type; cast to x's). Returns
    (B, C, H, W) ``channels_last`` in x's type: the conv of x with w, or
    with ``rot180_swap(w)`` when ``rotated`` (dx). Raises on anything the
    kernel does not take and when the launch is refused.
    ``conv3x3.launches`` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3 takes bf16 or fp32, got {x.dtype}")
    if not eligible(x, w):
        raise ValueError(f"conv3x3 takes (B, C, H, W) x (C, C, 3, 3) with C "
                         f"in {CHANNELS}, got {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("the weight must be on x's device")
    if not x.is_contiguous(memory_format=torch.channels_last) or \
            x.data_ptr() % 16:
        raise ValueError("x must be channels_last-contiguous and 16-byte "
                         "aligned")
    b, c, h, wd = x.shape
    if not (b >= 1 and b * h * wd < 2 ** 31 - 256):     # int tile counts
        raise ValueError(f"{b}x{h}x{wd} pixels out of the kernel's range")
    wp = pack_weight(w, x.dtype, rotated)
    out = torch.empty((b, c, h, wd), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    with _build.on_card(x):
        rc = _lib().mla_conv3x3_fwd(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(), b, h, wd, c, c,
            int(rotated), int(x.dtype == torch.bfloat16), _build.stream(x))
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {rc}")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The conv library, its argument types set once."""
    lib = _build.load("conv3x3")
    fn = lib.mla_conv3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _forward(x, w, rotated=False):
    if x.device.type == "cpu":
        return conv3x3_reference(x, rot180_swap(w) if rotated else w)
    return conv3x3(x.contiguous(memory_format=torch.channels_last), w,
                   rotated)


class Conv3x3(torch.autograd.Function):
    """The 3x3 conv with its own backward (the counterpart of
    ``conv3x3_vjp``): dx is the same conv on ``rot180_swap(w)``; dw is
    PyTorch's conv weight-gradient. x and w arrive in the compute type."""

    @staticmethod
    def forward(ctx, x, w):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _forward(g, w, rotated=True)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1), (1, 1), (1, 1), False, (0, 0), 1,
                (False, True, False))[1]
        return dx, dw


def conv3x3_vjp(x, w):
    """The stride-1 SAME 3x3 conv through ``Conv3x3`` on every device and
    under every grad mode. x: (B, C, H, W); w: (C, C, 3, 3) in x's type and
    in the kernel's scope (``eligible``)."""
    return Conv3x3.apply(x, w)
