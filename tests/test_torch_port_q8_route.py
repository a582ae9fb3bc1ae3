"""The host-side pieces of the int8 kernels' routes (mla_tpu_torch/ops/
q8_matmul.py), on the CPU.

The W8A8 MLP's kernels (csrc/q8_mlp.cu) re-quantize the fp32 hidden per
(row, group of ``bh`` columns) by running the row quantizer over the hidden
viewed as (rows * H / bh, bh) rows, and fc2 flushes its int32 group sums
times those scales in group order. Here that route's law, written with the
plain pieces, is bit-equal to ``q8_mlp_plain`` and agrees with the JAX
kernel it copies (``_q8_mlp_pallas`` in interpret mode) at the chooser's
group width and at 512, the width at 16448 rows. The kernels themselves
run only on the card: tests/test_torch_port_gpu.py holds them bit for bit
against ``q8_mlp_plain``. The bias helper hands fp32 biases to the kernel
as they are, with no copy. Every array comes from a numpy seed.
"""

import numpy as np
import pytest


def _torch():
    import torch
    torch.set_num_threads(1)
    return torch


def _q8(rng, *shape):
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[-1])
    amax = np.abs(w).max(axis=-1, keepdims=True)
    s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s[..., 0]


@pytest.mark.parametrize("rows,h,bh", [(257, 3072, None), (2056, 3072, None),
                                       (96, 2048, 512)])
def test_group_view_quantizes_each_row_group(rows, h, bh):
    """quantize_rows over the (rows * H / bh, bh) view gives, for every
    (row, group), the int8 values and the scale of that group alone (the
    law of the kernel route, which the card tests check)."""
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import mlp_group_width, quantize_rows

    bh = bh or mlp_group_width(rows, 768, h)
    rng = np.random.default_rng(rows)
    g = torch.from_numpy(rng.standard_normal((rows, h)).astype(np.float32))
    g[0, :bh] = 0.0                            # an all-zero group: 1e-12 floor
    hq, hs = quantize_rows(g.reshape(-1, bh))
    hq, hs = hq.reshape(rows, h), hs.reshape(rows, h // bh)
    for j in range(h // bh):
        q, s = quantize_rows(g[:, j * bh:(j + 1) * bh])
        assert torch.equal(hq[:, j * bh:(j + 1) * bh], q)
        assert torch.equal(hs[:, j], s)


def _assert_ulp(got, want, atol):
    """Within one bf16 ulp of the larger output plus ``atol``."""
    diff = np.abs(got - want)
    bad = diff > atol + 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert not bad.any(), (diff.max(), int(bad.sum()))


@pytest.mark.parametrize("rows", [33, 257])
def test_route_i_is_the_plain_w8a8_mlp(rows):
    """fc1 -> fp32 GELU -> group view quantization -> int32 group sums times
    their scales, summed in group order -> scale + bias, on layer 1 of a
    2-layer base-width stack: at the chooser's group width bit-equal to
    q8_mlp_plain; at that width and at 512 within one bf16 ulp plus 4e-3 of
    the JAX kernel (its polynomial erf may move a hidden value one
    quantization step, as in tests/test_torch_port_q8.py)."""
    torch = _torch()
    import jax.numpy as jnp
    from mla_tpu.ops import q8_matmul as jq
    from mla_tpu_torch.ops.q8_matmul import (_int_dot, gelu_erf,
                                             mlp_group_width, q8_mlp_plain,
                                             quantize_rows)

    c, h = 768, 3072
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    q1, s1 = _q8(rng, 2, h, c)
    q2, s2 = _q8(rng, 2, c, h)
    w1, s1, w2, s2 = (torch.from_numpy(a) for a in (q1, s1, q2, s2))
    b1 = torch.from_numpy(rng.standard_normal(h).astype(np.float32) * 0.1)
    b2 = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    xq, xs = quantize_rows(x)
    g = gelu_erf(_int_dot(xq, w1[1]).float() * xs[:, None] * s1[1] + b1)

    def route(bh):
        hq, hs = quantize_rows(g.reshape(-1, bh))
        hq, hs = hq.reshape(rows, h), hs.reshape(rows, h // bh)
        acc = torch.zeros((rows, c), dtype=torch.float32)
        for j in range(h // bh):
            part = _int_dot(hq[:, j * bh:(j + 1) * bh],
                            w2[1][:, j * bh:(j + 1) * bh])
            acc = acc + part.float() * hs[:, j:j + 1]
        return (acc * s2[1] + b2).to(torch.bfloat16)

    bh = mlp_group_width(rows, c, h)
    assert torch.equal(route(bh), q8_mlp_plain(x, w1, s1, b1, w2, s2, b2, 1,
                                               a8=True))
    bm = jq._mlp_bm_a8(rows, c, h)[0]
    for width in (bh, 512):
        want = jq._q8_mlp_pallas(
            jnp.asarray(x.numpy()), jnp.asarray(q1.transpose(0, 2, 1)),
            jnp.asarray(s1.numpy()), jnp.asarray(b1.numpy()),
            jnp.asarray(q2.transpose(0, 2, 1)), jnp.asarray(s2.numpy()),
            jnp.asarray(b2.numpy()), jnp.asarray(1), bm=bm, bh=width,
            interpret=True, a8=True)
        _assert_ulp(route(width).float().numpy(),
                    np.asarray(want, np.float32), 4e-3)


def test_bias_helper_copies_only_what_the_kernel_cannot_read():
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import _fp32

    b = torch.arange(8, dtype=torch.float32)
    assert _fp32(b) is b                       # fp32: itself
    got = _fp32(b.to(torch.bfloat16))
    assert got.dtype == torch.float32 and torch.equal(got, b)
