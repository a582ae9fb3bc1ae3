"""The bf16 3x3 conv kernel's operand law (mla_tpu_torch/ops/csrc/
conv3x3.cu, conv3x3_wgmma_kernel, behind B3), written here in plain torch,
against the JAX package: its Pallas kernel in interpret mode
(mla_tpu.ops.conv3x3.conv3x3(..., interpret=True)) and conv3x3_reference.

The law. The weight packed K-major, (F, 9*C) with column (ky*3 + kx)*C + c
(``pack_weight``). The output pixels run flat over B*H*W in tiles of TP
pixels (the kernel's tile width for the shape on a 132-SM card, as its
pick_bx chooses), across image rows and images; the last tile is ragged.
For each tile, k-stages in the kernel's order, tap-major then 64 channels at
a time: the operand tile is TP rows of 64 channels, row j the input pixel
(h + ky - 1, w + kx - 1) of output pixel m0 + j = (b, h, w), zero where the
tap leaves the image or m0 + j >= B*H*W (TMA's out-of-bounds fill); the
products with the weight's 64-column block are exact, summed in fp32;
after the last stage each sum is rounded once to the output type and rows
past B*H*W are dropped.

Tolerances: fp32 atol 1e-5 + rtol 1e-5 (exact products, sums over 9*C <=
1152 terms in another order); bf16 atol 1e-2 + rtol 1e-2, the card's
CONV_TOL (tests/test_torch_port_gpu.py): both sides round one fp32 sum
once, so a sum near a rounding boundary may round the other way (one bf16
ulp). Torch is imported inside the tests (ROADMAP.md C, Torch import at
collection).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import conv3x3 as jconv

KC = 64                      # channels per k-stage
SMS = 132                    # an H100 SXM's SMs
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
CASES = [(3, 1, 1, 64), (2, 5, 6, 64), (3, 9, 10, 64), (1, 3, 1, 64),
         (2, 1, 1, 128), (3, 5, 6, 128), (1, 9, 10, 128), (3, 3, 1, 128)]


def _tile_pixels(m, f, sms=SMS):
    """The kernel's pixels per tile (conv3x3.cu pick_bx): 256 at F = 64 (two
    warpgroups' 128); at F >= 128 256 or 128, whichever gives fewer waves
    x (tile + 16) over the SMs, the wider on a tie."""
    if f == 64:
        return 256

    def cost(tp):
        return -(-(-(-m // tp) * (f // 128)) // sms) * (tp + 16)
    return 128 if cost(128) < cost(256) else 256


def _inputs(b, h, w, c, dtype, seed):
    """x (B, H, W, C) and the HWIO kernel (3, 3, C, C), fp32 numpy arrays
    whose values are exact in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) / np.sqrt(9 * c)).astype(
        np.float32)
    if dtype == "bfloat16":
        x, k = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (x, k))
    return x, k


def _operand_tile(torch, xp, m0, tp, ky, kx, c0, hw):
    """Rows j < tp: the input pixel (h + ky - 1, w + kx - 1), channels c0 ..
    c0 + 63, of output pixel m0 + j = (b, h, w); xp is x zero-padded by one
    on H and W with one more all-zero image at index B."""
    bsz = xp.shape[0] - 1
    h, w = hw
    m = torch.arange(m0, m0 + tp)
    b = torch.clamp(m // (h * w), max=bsz)          # past M: the zero image
    rem = m % (h * w)
    return xp[b, rem // w + ky, rem % w + kx, c0:c0 + KC]


def _law(torch, x, k, dtype):
    """The kernel's law on x (B, H, W, C) and the HWIO kernel -> (B, H, W, F)
    fp32 numpy, rounded once to ``dtype``."""
    b, h, w, c = x.shape
    f = k.shape[-1]
    xt = torch.from_numpy(x)
    # the port's packing: (F, C, 3, 3) -> (F, 9*C), K-major
    from mla_tpu_torch.ops.conv3x3 import pack_weight
    wp = pack_weight(torch.from_numpy(k).permute(3, 2, 0, 1), torch.float32)
    xp = torch.zeros((b + 1, h + 2, w + 2, c))
    xp[:b, 1:h + 1, 1:w + 1] = xt
    m = b * h * w
    tp = _tile_pixels(m, f)
    rows = []
    for m0 in range(0, m, tp):
        acc = torch.zeros((tp, f), dtype=torch.float32)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for c0 in range(0, c, KC):
                a = _operand_tile(torch, xp, m0, tp, ky, kx, c0, (h, w))
                wk = wp[:, tap * c + c0:tap * c + c0 + KC]
                acc = acc + a @ wk.t()
        rows.append(acc)
    out = torch.cat(rows)[:m].to(getattr(torch, dtype)).float()
    return out.reshape(b, h, w, f).numpy()


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    diff = np.abs(got - want)
    assert np.all(diff <= atol + rtol * np.abs(want)), diff.max()


def _jdt(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_law_matches_pallas_interpret(b, h, w, c, dtype):
    import torch

    x, k = _inputs(b, h, w, c, dtype, seed=b + h + w + c)
    got = _law(torch, x, k, dtype)
    jdt = _jdt(dtype)
    want = jconv.conv3x3(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                         interpret=True, compute_dtype=jdt)
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", CASES)
def test_law_matches_conv3x3_reference(b, h, w, c, dtype):
    import torch

    x, k = _inputs(b, h, w, c, dtype, seed=10 * (b + h + w) + c)
    got = _law(torch, x, k, dtype)
    want = jconv.conv3x3_reference(jnp.asarray(x), jnp.asarray(k))
    want = np.asarray(want.astype(_jdt(dtype)).astype(jnp.float32))
    _close(got, want, dtype)


def test_tiles_cross_rows_and_images_and_the_last_is_ragged():
    """At the law's shapes a tile holds several images (H*W < TP), so rows
    cross image rows and images, and the last tile runs past B*H*W: those
    rows and every tap that leaves an image read zeros."""
    import torch

    b, h, w, c = 3, 5, 6, 128
    tp = _tile_pixels(b * h * w, c)
    assert h * w < tp and (b * h * w) % tp
    x, _ = _inputs(b, h, w, c, "float32", seed=1)
    xp = torch.zeros((b + 1, h + 2, w + 2, c))
    xp[:b, 1:h + 1, 1:w + 1] = torch.from_numpy(x)
    m0 = (b * h * w) // tp * tp                      # the ragged last tile
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        a = _operand_tile(torch, xp, m0, tp, ky, kx, 0, (h, w))
        for j in range(tp):
            bb, rem = divmod(m0 + j, h * w)
            hh, ww = divmod(rem, w)
            ih, iw = hh + ky - 1, ww + kx - 1
            if bb >= b or not (0 <= ih < h and 0 <= iw < w):
                assert not a[j].any(), (tap, j)
            else:
                assert torch.equal(a[j], torch.from_numpy(x[bb, ih, iw, :KC]))


def test_tile_pixels_at_the_crema_d_shapes():
    """The tile widths the kernel picks on a 132-SM card at the 8 CREMA-D
    body shapes (B*H*W pixels, F): the widths that ran fastest on the card
    (PERF.md)."""
    shapes = {"vis_l1": (192 * 56 * 56, 64), "vis_l2": (192 * 28 * 28, 128),
              "vis_l3": (192 * 14 * 14, 256), "vis_l4": (192 * 7 * 7, 512),
              "aud_l1": (64 * 33 * 157, 64), "aud_l2": (64 * 17 * 79, 128),
              "aud_l3": (64 * 9 * 40, 256), "aud_l4": (64 * 5 * 20, 512)}
    got = {k: _tile_pixels(*v) for k, v in shapes.items()}
    assert got == {"vis_l1": 256, "vis_l2": 128, "vis_l3": 128,
                   "vis_l4": 128, "aud_l1": 256, "aud_l2": 256,
                   "aud_l3": 128, "aud_l4": 256}


def test_pack_weight_is_k_major_tap_then_channel():
    import torch
    from mla_tpu_torch.ops.conv3x3 import pack_weight

    f, c = 64, 128
    w = torch.randn(f, c, 3, 3)
    wp = pack_weight(w, torch.bfloat16)
    assert wp.shape == (f, 9 * c) and wp.is_contiguous()
    for fi, ky, kx, ci in ((0, 0, 0, 0), (5, 1, 2, 77), (63, 2, 1, 127)):
        assert wp[fi, (ky * 3 + kx) * c + ci] == w[fi, ci, ky, kx].to(
            torch.bfloat16)


def test_rotated_pack_reversed_is_the_dx_weight_packed():
    """dx runs the kernel on ``pack_weight(w, rotated=True)`` with its taps
    read in reverse: that is ``pack_weight(rot180_swap(w))``, the dx weight
    the forward's law takes, with no flip copied."""
    import torch
    from mla_tpu_torch.ops.conv3x3 import pack_weight, rot180_swap

    c = 64
    w = torch.randn(c, c, 3, 3)
    rot = pack_weight(w, torch.float32, rotated=True)
    assert rot.shape == (c, 9 * c) and rot.is_contiguous()
    as_read = rot.view(c, 9, c).flip(1).reshape(c, 9 * c)
    assert torch.equal(as_read, pack_weight(rot180_swap(w), torch.float32))
