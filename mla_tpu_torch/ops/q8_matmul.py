"""int8 GEMMs and the fused int8 MLP of int8 and W8A8 serving (port of
``mla_tpu/ops/q8_matmul.py``).

Layouts follow PyTorch: an int8 weight is (N, K) like ``nn.Linear.weight``
(a stack of them (L, N, K)), its per-output-channel scale (N,) (or (L, N))
in float32. The JAX package's (K, N) is the same arithmetic.

Three laws, each with a plain version here and a hand-written kernel:

- ``q8_matmul`` (B4, ``csrc/q8_matmul.cu``): x @ (q8 * scale). Weight-only:
  x rounded to bf16, bf16 x int8 products accumulated in fp32, the scale
  applied once, the result rounded to bf16 (``_kernel``). W8A8 (``a8``): x
  quantized per row (``quantize_rows``), exact int32 accumulation, then
  ``bf16(bf16(acc * scale) * xs)`` - the two roundings of the JAX kernel's
  flush and of its wrapper (``_kernel_a8`` and :211-213).
- ``q8_matmul_stacked`` (B5, the same source): B4 on layer ``l`` of an
  (L, N, K) stack, ``l`` clamped to [0, L-1]. On the card the layer id is an
  int32 scalar on the device, read and clamped inside the kernel.
- ``q8_mlp_stacked`` (B6, ``csrc/q8_mlp.cu``): fc1 -> scale + bias -> exact
  GELU -> fc2 -> scale + bias on layer ``l`` of both stacks. Weight-only:
  the GELU output rounds to bf16 before fc2, fc2 accumulates in fp32 and
  adds its bias in fp32 before the one rounding to bf16
  (``_kernel_mlp_stacked``). W8A8: the fp32 GELU output is re-quantized per
  (row, group of ``bh`` columns) and each group's int32 partial product
  enters the fp32 sum times its scale (``_kernel_mlp_stacked_a8``).

The group width ``bh`` is part of what the W8A8 MLP computes, not a tuning
knob: the JAX package takes it from its TPU block chooser (``_mlp_bm_a8``),
which depends on the row count through a VMEM budget. ``mlp_group_width``
is a copy of that chooser, kept as the group-width law so that the port
computes the JAX package's numbers at every row count.

The exact GELU uses ``erf``; the TPU kernel carries a polynomial erf
(|error| < 1.5e-7), which the port does not copy.

On a CPU tensor each entry point runs its plain version; on a CUDA tensor it
launches its kernel, or raises. There is no fallback from one to the other.
The TPU package's routing constants (the 4-row-block crossover above which
a weight-only GEMM took the dequantizing reference, and the fused MLP's
rows <= 512 rule) are dropped: the kernels serve every row count.

The reference laws (``q8_matmul_reference``, ``q8_matmul_a8_reference``)
are what the JAX package computes off the TPU; the port uses them only for
the W8A8 calibration forward (``runtime/export.py:calibrate_a8``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mla_tpu_torch.ops import _build

_SQRT1_2 = 0.7071067811865476

# The JAX chooser's per-step VMEM budget (mla_tpu/ops/q8_matmul.py:92); here
# it only decides the W8A8 MLP's group width.
_VMEM_BUDGET = 10 * 2 ** 20

# what the kernels tile: K a multiple of 64 (one int8 k-stage), N of 128
K_MULT, N_MULT = 64, 128


# ---------------------------------------------------------------- laws

def quantize_rows(x):
    """Symmetric per-row int8 quantization of a (rows, K) float tensor ->
    ((rows, K) int8, (rows,) fp32): xs = max(max|x|, 1e-12) / 127, then
    round-half-even(x / xs) clipped to +-127 (a division, as in JAX)."""
    x32 = x.float()
    amax = torch.clamp(x32.abs().amax(dim=-1), min=1e-12)
    # a tensor divisor: PyTorch multiplies by the reciprocal of a scalar one
    xs = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(x32 / xs[:, None]), -127, 127).to(torch.int8)
    return xq, xs


def _int_dot(a, w):
    """Exact int32 dot of int8 (M, K) rows with int8 (N, K) rows as float64
    (|products| <= 127^2 and sums stay far below 2^53), on any device."""
    return a.double() @ w.double().t()


def gelu_erf(t):
    """Exact (erf) GELU in t's type: 0.5 t (1 + erf(t / sqrt 2))."""
    return 0.5 * t * (1.0 + torch.erf(t * _SQRT1_2))


def q8_matmul_plain(x, w, scale, a8: bool = False):
    """The kernel law of B4 on (M, K) x: -> (M, N) bf16 (module notes)."""
    if a8:
        xq, xs = quantize_rows(x)
        y = (_int_dot(xq, w).float() * scale).to(torch.bfloat16)
        return (y.float() * xs[:, None]).to(torch.bfloat16)
    acc = x.to(torch.bfloat16).float() @ w.float().t()
    return (acc * scale).to(torch.bfloat16)


def q8_matmul_reference(x, w, scale):
    """The JAX package's weight-only law off the TPU: the weight dequantized
    in bf16 (q8.bf16 * scale.bf16), then a bf16 dot."""
    wd = w.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None]
    return x.to(torch.bfloat16) @ wd.t()


def q8_matmul_a8_reference(x, w, scale):
    """The JAX package's W8A8 law off the TPU: exact int32 accumulation,
    then row x column scales in fp32 and one rounding to bf16."""
    xq, xs = quantize_rows(x)
    return (_int_dot(xq, w).float() * scale * xs[:, None]).to(torch.bfloat16)


def _clamp_layer(layer, depth: int) -> int:
    return min(max(int(layer), 0), depth - 1)


def q8_matmul_stacked_plain(x, w, scale, layer, a8: bool = False):
    """B5's law: B4 on layer clamp(layer, 0, L-1) of the stack."""
    i = _clamp_layer(layer, w.shape[0])
    return q8_matmul_plain(x, w[i], scale[i], a8)


def q8_mlp_plain(x, w1, s1, b1, w2, s2, b2, layer, a8: bool = False):
    """B6's law on (M, C) x, layer clamp(layer, 0, L-1) of w1 (L, H, C) and
    w2 (L, C, H); b1 (H,) and b2 (C,) are that layer's biases. -> (M, C)
    bf16 (module notes)."""
    i = _clamp_layer(layer, w1.shape[0])
    w1, s1, w2, s2 = w1[i], s1[i], w2[i], s2[i]
    b1, b2 = b1.float(), b2.float()
    if not a8:
        t = (x.to(torch.bfloat16).float() @ w1.float().t()) * s1 + b1
        g = gelu_erf(t).to(torch.bfloat16)
        acc = g.float() @ w2.float().t()
        return (acc * s2 + b2).to(torch.bfloat16)
    xq, xs = quantize_rows(x)
    t = _int_dot(xq, w1).float() * xs[:, None] * s1 + b1
    g = gelu_erf(t)
    bh = mlp_group_width(x.shape[0], w1.shape[1], w1.shape[0])
    acc = torch.zeros((x.shape[0], w2.shape[0]), dtype=torch.float32,
                      device=x.device)
    for j in range(0, g.shape[1], bh):
        gq, sg = quantize_rows(g[:, j:j + bh])
        acc = acc + _int_dot(gq, w2[:, j:j + bh]).float() * sg[:, None]
    return (acc * s2 + b2).to(torch.bfloat16)


# ---------------------------------------------------------------- chooser

def _divisors_desc(dim: int, cap: int, mult: int = 128):
    """Divisors of ``dim`` that are multiples of ``mult``, <= cap,
    descending (mla_tpu/ops/q8_matmul.py:_divisors_desc)."""
    out = []
    d = (min(dim, cap) // mult) * mult
    while d >= mult:
        if dim % d == 0:
            out.append(d)
        d -= mult
    return out


def _mlp_bh(rows: int, c: int, h: int, cap: int = 2048, a8: bool = False):
    """The JAX chooser's hidden block width for ``rows`` rows (``_mlp_bh``)."""
    for bh in _divisors_desc(h, cap):
        vmem = (rows * c * (1 if a8 else 2) + 2 * (c * bh) + 2 * (bh * c)
                + rows * bh * 4 + rows * c * 6)
        if a8:
            vmem += rows * 128 * 4 + rows * bh
        if vmem <= _VMEM_BUDGET:
            return bh
    return None


def _mlp_bm_a8(rows: int, c: int, h: int, cap: int = 1024):
    """The JAX chooser's (row block, hidden block) of the W8A8 MLP
    (``_mlp_bm_a8``): fewest row passes, then least padding, then the
    largest row block; None when nothing fits."""
    best = None
    top = min(cap, -(-rows // 32) * 32)
    for bm in range(top, 31, -32):
        steps = -(-rows // bm)
        pad = steps * bm - rows
        if pad > max(rows // 16, 32):
            continue
        bh = _mlp_bh(bm, c, h, a8=True)
        if bh is None:
            continue
        key = (steps, pad, -bm)
        if best is None or key < best[0]:
            best = (key, (bm, bh))
    return best[1] if best else None


@functools.lru_cache(maxsize=None)
def mlp_group_width(rows: int, c: int, h: int) -> int:
    """The W8A8 MLP's re-quantization group width for ``rows`` rows of
    width ``c`` and hidden width ``h``: the ``bh`` of the JAX chooser
    (base width: 1536 at 257 rows, 768 at 2056, 512 at 16448)."""
    choice = _mlp_bm_a8(rows, c, h) if c % 128 == 0 else None
    if choice is None:
        raise ValueError(f"no W8A8 MLP group width for rows={rows}, C={c}, "
                         f"H={h} (C must be a multiple of 128)")
    return choice[1]


# ---------------------------------------------------------------- kernels

def _flat(x):
    return x.reshape(-1, x.shape[-1])


def _check_cuda(who: str, x, *tensors):
    if x.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {x.device}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{who}: every operand must be on {x.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{who}: operands must be contiguous and "
                             f"16-byte aligned")


def _check_weight(who: str, w, scale, k: int, stacked: bool):
    if w.dtype != torch.int8 or w.dim() != (3 if stacked else 2):
        raise TypeError(f"{who} takes an int8 {'(L, N, K)' if stacked else '(N, K)'}"
                        f" weight, got {w.dtype} {tuple(w.shape)}")
    n, kw = w.shape[-2:]
    if kw != k:
        raise ValueError(f"{who}: x has K={k}, the weight {kw}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != tuple(
            w.shape[:-1]):
        raise ValueError(f"{who}: scale must be fp32 {tuple(w.shape[:-1])}, "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if k % K_MULT or n % N_MULT:
        raise ValueError(f"{who}: the kernel takes K % {K_MULT} == 0 and "
                         f"N % {N_MULT} == 0, got K={k}, N={n}")
    return n


def _layer_id(layer, x):
    if not (torch.is_tensor(layer) and layer.dtype == torch.int32
            and layer.numel() == 1 and layer.device == x.device):
        raise ValueError("the layer id must be an int32 scalar tensor on "
                         f"{x.device}")
    return layer


def _fp32(b):
    """A bias as the kernel reads it, fp32: itself when it already is, as
    the serving model's biases are (``_check_cuda`` has made sure it is
    contiguous)."""
    return b if b.dtype == torch.float32 else b.float()


def quantize_rows_cuda(x2):
    """Launch the row-quantization kernel on (M, K) bf16 or fp32 rows on the
    card -> (xq int8 (M, K), xs fp32 (M,)); ``quantize_rows``'s law."""
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rows takes bf16 or fp32, got {x2.dtype}")
    x2 = x2.contiguous()
    _check_cuda("quantize_rows", x2, x2)
    m, k = x2.shape
    if k % K_MULT:
        raise ValueError(f"quantize_rows takes K % {K_MULT} == 0, got {k}")
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
    with _build.on_card(x2):
        rc = _gemm_lib().mla_q8_quantize_rows(
            x2.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
            int(x2.dtype == torch.float32), _build.stream(x2))
    if rc != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: CUDA error "
                           f"{rc}")
    return xq, xs


def _launch_gemm(x2, w, scale, layer, a8: bool):
    """One B4/B5 launch on (M, K) rows -> (M, N) bf16."""
    m, k = x2.shape
    if a8:
        xa, xs = quantize_rows_cuda(x2)
    else:
        xa, xs = x2.to(torch.bfloat16).contiguous(), None
    out = torch.empty((m, w.shape[-2]), dtype=torch.bfloat16,
                      device=x2.device)
    with _build.on_card(x2):
        rc = _gemm_lib().mla_q8_matmul(
            xa.data_ptr(), None if xs is None else xs.data_ptr(),
            w.data_ptr(), scale.data_ptr(),
            None if layer is None else layer.data_ptr(),
            w.shape[0] if w.dim() == 3 else 1, out.data_ptr(), m, k,
            w.shape[-2], int(a8), _build.stream(x2))
    if rc != 0:
        raise RuntimeError(f"q8 GEMM kernel launch failed: CUDA error {rc}")
    return out


def q8_matmul(x, w, scale, a8: bool = False):
    """x (..., K) float @ the int8 weight w (N, K) with its per-output-channel
    scale (N,) -> (..., N) bf16 (B4; W8A8 when ``a8``). A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (or raises).
    ``q8_matmul.launches`` counts the launches."""
    x2 = _flat(x)
    if x.device.type == "cpu":
        out = q8_matmul_plain(x2, w, scale, a8)
    else:
        _check_cuda("q8_matmul", x, w, scale)
        _check_weight("q8_matmul", w, scale, x.shape[-1], stacked=False)
        out = _launch_gemm(x2, w, scale, None, a8)
        q8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], w.shape[0])


q8_matmul.launches = 0


def q8_matmul_stacked(x, w, scale, layer, a8: bool = False):
    """x (..., K) @ layer ``layer`` (clamped to [0, L-1]) of the int8 stack
    w (L, N, K) with scales (L, N) -> (..., N) bf16 (B5; W8A8 when ``a8``).
    On the card ``layer`` is an int32 scalar tensor there, read by the
    kernel. A CPU tensor runs the plain version.
    ``q8_matmul_stacked.launches`` counts the launches."""
    x2 = _flat(x)
    if x.device.type == "cpu":
        out = q8_matmul_stacked_plain(x2, w, scale, layer, a8)
    else:
        _check_cuda("q8_matmul_stacked", x, w, scale)
        _check_weight("q8_matmul_stacked", w, scale, x.shape[-1],
                      stacked=True)
        out = _launch_gemm(x2, w, scale, _layer_id(layer, x), a8)
        q8_matmul_stacked.launches += 1
    return out.reshape(*x.shape[:-1], w.shape[1])


q8_matmul_stacked.launches = 0


def q8_mlp_stacked(x, w1, s1, b1, w2, s2, b2, layer, a8: bool = False):
    """GELU(x @ W1s + b1) @ W2s + b2 on layer ``layer`` (clamped) of the int8
    stacks w1 (L, H, C) and w2 (L, C, H), scales (L, H) and (L, C); b1 (H,)
    and b2 (C,) that layer's biases -> (..., C) bf16 (B6; W8A8 when ``a8``,
    with ``mlp_group_width``'s group width). A CPU tensor runs the plain
    version. ``q8_mlp_stacked.launches`` counts the launches."""
    x2 = _flat(x)
    m, c = x2.shape
    if x.device.type == "cpu":
        out = q8_mlp_plain(x2, w1, s1, b1, w2, s2, b2, layer, a8)
        return out.reshape(*x.shape[:-1], c)
    _check_cuda("q8_mlp_stacked", x, w1, s1, w2, s2, b1, b2)
    h = _check_weight("q8_mlp_stacked", w1, s1, c, stacked=True)
    _check_weight("q8_mlp_stacked", w2, s2, h, stacked=True)
    if w2.shape[1] != c or w2.shape[0] != w1.shape[0]:
        raise ValueError(f"q8_mlp_stacked: w2 {tuple(w2.shape)} does not "
                         f"match w1 {tuple(w1.shape)}")
    if tuple(b1.shape) != (h,) or tuple(b2.shape) != (c,):
        raise ValueError(f"q8_mlp_stacked: biases must be ({h},) and ({c},)")
    layer = _layer_id(layer, x)
    bh = mlp_group_width(m, c, h) if a8 else h
    hq = hs = None
    if a8:
        # route (i): fc1 writes the fp32 hidden, the row quantizer turns
        # each (row, group) into int8 and a scale, fc2 multiplies int8
        xa, xs = quantize_rows_cuda(x2)
        hidden = torch.empty((m, h), dtype=torch.float32, device=x.device)
        hq = torch.empty((m, h), dtype=torch.int8, device=x.device)
        hs = torch.empty((m, h // bh), dtype=torch.float32, device=x.device)
    else:
        xa, xs = x2.to(torch.bfloat16).contiguous(), None
        hidden = torch.empty((m, h), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    f1, f2 = _fp32(b1), _fp32(b2)
    with _build.on_card(x):
        rc = _mlp_lib().mla_q8_mlp(
            xa.data_ptr(), None if xs is None else xs.data_ptr(),
            w1.data_ptr(), s1.data_ptr(), f1.data_ptr(), w2.data_ptr(),
            s2.data_ptr(), f2.data_ptr(), layer.data_ptr(), w1.shape[0],
            hidden.data_ptr(), None if hq is None else hq.data_ptr(),
            None if hs is None else hs.data_ptr(),
            out.data_ptr(), m, c, h, bh, int(a8), _build.stream(x))
    if rc != 0:
        raise RuntimeError(f"q8 MLP kernel launch failed: CUDA error {rc}")
    q8_mlp_stacked.launches += 1
    return out.reshape(*x.shape[:-1], c)


q8_mlp_stacked.launches = 0


@functools.cache
def _gemm_lib() -> ctypes.CDLL:
    """The int8 GEMM library, its argument types set once."""
    lib = _build.load("q8_matmul")
    fn = lib.mla_q8_quantize_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mla_q8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _mlp_lib() -> ctypes.CDLL:
    """The int8 MLP library, its argument types set once."""
    lib = _build.load("q8_mlp")
    fn = lib.mla_q8_mlp
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
