"""The int8 laws of the port (mla_tpu_torch/ops/q8_matmul.py and
runtime/export.py:quantize_int8) against the JAX package's
(mla_tpu/ops/q8_matmul.py, runtime/export.py:_quantize_int8), on the CPU.

The JAX kernels run as the JAX package's own tests run them, in Pallas
interpret mode; the port's CPU entry points run their plain versions, which
are the kernels' laws. Every array comes from a numpy seed.

Tolerances. Quantization (``quantize_rows``, ``quantize_int8``): bit-equal.
The kernel laws: one bf16 ulp of the larger of the two outputs (2^-7
relative; a value just below a power of 2 may round up to it): weight-only
sums of exact bf16 x int8 products in fp32 are taken in another order and a
sum near a rounding boundary may round the other way; W8A8 sums are exact
int32 and the W8A8 GEMM is bit-equal. The fused MLP adds an absolute 4e-3: its weight-only hidden rounds to
bf16 (which may round the other way), and the port's GELU uses erf where
the TPU kernel carries a polynomial (|error| < 1.5e-7), which moves a W8A8
hidden value lying that close to a quantization boundary one step over; one
step changes an output by |W2 s2| sg, up to ~3e-3 at these widths (600
rows: one such value in 1.2M, two outputs off by 2 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import q8_matmul as jq
from mla_tpu.runtime.export import _quantize_int8

ULP = 2.0 ** -7


def _torch():
    import torch
    torch.set_num_threads(1)
    return torch


def _quant(w, axis):
    """Per-channel int8 of w along ``axis`` (the JAX export law)."""
    amax = np.max(np.abs(w), axis=axis, keepdims=True)
    s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _case(rows, k, n, seed, layers=None):
    """x (rows, k) and a JAX-layout int8 weight (k, n) or stack (L, k, n)
    with its (1, n) / (L, 1, n) scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    shape = (k, n) if layers is None else (layers, k, n)
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(k)
    q, s = _quant(w, -2)
    return x, q, s


def _port(torch, q, s):
    """JAX (.., K, N) int8 and (.., 1, N) scale -> the port's (.., N, K) and
    (.., N)."""
    qt = np.ascontiguousarray(np.swapaxes(q, -1, -2))
    return torch.from_numpy(qt), torch.from_numpy(np.ascontiguousarray(
        s[..., 0, :]))


def _assert_ulp(got, want, atol=1e-6):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    bad = diff > atol + ULP * np.maximum(np.abs(want), np.abs(got))
    assert not bad.any(), (diff.max(), int(bad.sum()))


@pytest.mark.parametrize("rows,k", [(1, 64), (37, 768), (64, 3072)])
def test_quantize_rows_bit_equal(rows, k):
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import quantize_rows

    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, k)).astype(np.float32) * 3.0
    x[0, :] = 0.0                               # the 1e-12 floor
    jx, js = jq.quantize_rows(jnp.asarray(x))
    px, ps = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    bx = torch.from_numpy(x).to(torch.bfloat16)  # a bf16 activation
    jx, js = jq.quantize_rows(jnp.asarray(bx.float().numpy(), jnp.bfloat16))
    px, ps = quantize_rows(bx)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_quantize_int8_bit_equal():
    """The port's export quantization on its layouts equals JAX's on its
    own: a Dense kernel, a stacked (scan_blocks) kernel, a conv kernel (per
    kh), an embedding table (per row); small and 1-D leaves to bf16."""
    torch = _torch()
    from mla_tpu_torch.runtime.export import quantize_int8

    rng = np.random.default_rng(0)
    dense = rng.standard_normal((128, 96)).astype(np.float32) * 0.07
    stack = rng.standard_normal((3, 64, 96)).astype(np.float32)
    conv = rng.standard_normal((3, 3, 32, 64)).astype(np.float32) * 0.2
    table = rng.standard_normal((512, 32)).astype(np.float32) * 3.0
    small = rng.standard_normal((16, 16)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jtree = _quantize_int8({
        "d": {"kernel": dense, "bias": bias}, "blocks": {"kernel": stack},
        "c": {"kernel": conv}, "text_embedding": table,
        "s": {"kernel": small}})
    port = {"d.weight": dense.T, "d.bias": bias, "c.weight":
            conv.transpose(3, 2, 0, 1), "text_embedding.weight": table,
            "s.weight": small.T}
    for i in range(3):
        port[f"blocks.{i}.weight"] = stack[i].T
    got = quantize_int8({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in port.items()})

    def eq(name, q8node, layout):
        np.testing.assert_array_equal(got[name].numpy(),
                                      layout(np.asarray(q8node["q8"])))
        np.testing.assert_array_equal(got[name + "_scale"].numpy(),
                                      layout(np.asarray(q8node["scale"])))
        assert got[name].dtype == torch.int8
        assert got[name + "_scale"].dtype == torch.float32

    eq("d.weight", jtree["d"]["kernel"], np.transpose)
    eq("c.weight", jtree["c"]["kernel"], lambda a: a.transpose(3, 2, 0, 1))
    eq("text_embedding.weight", jtree["text_embedding"], lambda a: a)
    assert got["text_embedding.weight_scale"].shape == (512, 1)
    assert got["c.weight_scale"].shape == (64, 1, 3, 1)
    for i in range(3):
        eq(f"blocks.{i}.weight",
           {"q8": jtree["blocks"]["kernel"]["q8"][i],
            "scale": jtree["blocks"]["kernel"]["scale"][i]}, np.transpose)
    for name, leaf in (("d.bias", jtree["d"]["bias"]),
                       ("s.weight", jtree["s"]["kernel"].T)):
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows,k,n", [(1, 256, 384), (37, 512, 256),
                                      (70, 256, 128), (300, 768, 768)])
def test_q8_matmul_law_matches_jax_kernel(rows, k, n, a8):
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import q8_matmul

    x, q, s = _case(rows, k, n, seed=rows + k)
    want = jq.q8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                        block_n=128, block_k=128, interpret=True, a8=a8)
    w, sc = _port(torch, q, s)
    got = q8_matmul(torch.from_numpy(x), w, sc, a8=a8)
    assert got.dtype == torch.bfloat16
    if a8:       # exact int32 sums, the same two roundings: bit for bit
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    _assert_ulp(got.float().numpy(), want)


@pytest.mark.parametrize("a8", [False, True])
def test_q8_matmul_stacked_every_layer_and_clamp(a8):
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import q8_matmul_stacked

    x, q, s = _case(45, 256, 384, seed=3, layers=3)
    w, sc = _port(torch, q, s)
    xt = torch.from_numpy(x)
    for layer in (0, 1, 2, 5, -1):
        want = jq.q8_matmul_stacked(jnp.asarray(x), jnp.asarray(q),
                                    jnp.asarray(s), layer, block_n=128,
                                    block_k=128, interpret=True, a8=a8)
        got = q8_matmul_stacked(xt, w, sc, torch.tensor(layer, dtype=torch.int32),
                                a8=a8)
        _assert_ulp(got.float().numpy(), want)
    # an out-of-range id is the last layer, a negative one the first
    np.testing.assert_array_equal(
        q8_matmul_stacked(xt, w, sc, 9, a8=a8).float().numpy(),
        q8_matmul_stacked(xt, w, sc, 2, a8=a8).float().numpy())


def _mlp_case(rows, c, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, c)).astype(np.float32)
    w1 = rng.standard_normal((2, c, h)).astype(np.float32) / np.sqrt(c)
    w2 = rng.standard_normal((2, h, c)).astype(np.float32) / np.sqrt(h)
    (q1, s1), (q2, s2) = _quant(w1, -2), _quant(w2, -2)
    b1 = (rng.standard_normal(h) * 0.1).astype(jnp.bfloat16)
    b2 = (rng.standard_normal(c) * 0.1).astype(jnp.bfloat16)
    return x, q1, s1, b1, q2, s2, b2


def _mlp_both(torch, case, layer, a8):
    from mla_tpu_torch.ops.q8_matmul import q8_mlp_stacked

    x, q1, s1, b1, q2, s2, b2 = case
    want = jq.q8_mlp_stacked(jnp.asarray(x), jnp.asarray(q1), jnp.asarray(s1),
                             jnp.asarray(b1), jnp.asarray(q2), jnp.asarray(s2),
                             jnp.asarray(b2), layer, interpret=True, a8=a8)
    (w1, sc1), (w2, sc2) = _port(torch, q1, s1), _port(torch, q2, s2)
    got = q8_mlp_stacked(torch.from_numpy(x), w1, sc1,
                         torch.from_numpy(np.asarray(b1, np.float32)), w2,
                         sc2, torch.from_numpy(np.asarray(b2, np.float32)),
                         layer, a8=a8)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("a8,rows,bh", [(False, 77, None), (False, 300, None),
                                        (True, 256, 2048), (True, 600, 1024)])
def test_q8_mlp_law_matches_jax_kernel(a8, rows, bh):
    """B6 against the fused TPU kernel (interpret) on layer 1 and an
    out-of-range id (C 512, H 2048): weight-only at two row counts under
    the TPU's 512-row fusion limit, W8A8 at two whose chooser gives
    different group widths."""
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import mlp_group_width

    if a8:
        assert mlp_group_width(rows, 512, 2048) == bh
        assert jq._mlp_bm_a8(rows, 512, 2048)[1] == bh
    case = _mlp_case(rows, 512, 2048, seed=rows)
    for layer in (1, 4):
        got, want = _mlp_both(torch, case, layer, a8)
        _assert_ulp(got, want, atol=4e-3)


def test_group_width_law_is_the_jax_chooser():
    from mla_tpu_torch.ops.q8_matmul import _mlp_bm_a8, mlp_group_width

    for rows in (1, 31, 257, 513, 2056, 4000, 16448):
        for c, h in ((768, 3072), (1024, 4096), (384, 1536), (1280, 5120)):
            assert _mlp_bm_a8(rows, c, h) == jq._mlp_bm_a8(rows, c, h)
    assert [mlp_group_width(r, 768, 3072) for r in (257, 2056, 16448)] == \
        [1536, 768, 512]


def test_dropped_crossovers_size_of_the_law_difference():
    """Above the TPU's 4-row-block crossover (2048 rows) the JAX package
    takes its reference law (the weight dequantized in bf16, then a bf16
    dot); the port keeps the kernel law at every row count. The same holds
    for the fused MLP above 512 rows (two GEMMs with bf16 intermediates).
    Each difference stays within bf16 noise of the output and is not 0."""
    torch = _torch()
    from mla_tpu_torch.ops.q8_matmul import q8_matmul

    x, q, s = _case(2100, 128, 128, seed=8)
    jax_ref = np.asarray(jq.q8_matmul(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s), interpret=True),
                         np.float32)
    np.testing.assert_array_equal(jax_ref, np.asarray(jq.q8_matmul_reference(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)), np.float32))
    w, sc = _port(torch, q, s)
    got = q8_matmul(torch.from_numpy(x), w, sc).float().numpy()
    rel = np.linalg.norm(got - jax_ref) / np.linalg.norm(jax_ref)
    assert 0 < rel < 4e-3, rel                   # measured 1.9e-3
    got, want = _mlp_both(torch, _mlp_case(600, 512, 2048, seed=9), 0, False)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel < 8e-3, rel                   # measured 3.6e-3


def test_cpu_tensor_takes_plain_version_cuda_tensor_never(monkeypatch):
    """Each wrapper runs its plain version on a CPU tensor and nothing
    else; off the CPU it goes to the kernel, which takes CUDA tensors only
    and counts no launch when it refuses."""
    torch = _torch()
    from mla_tpu_torch.ops import q8_matmul as pq

    x = torch.zeros(3, 64)
    w = torch.zeros(128, 64, dtype=torch.int8)
    s = torch.ones(128)
    before = (pq.q8_matmul.launches, pq.q8_matmul_stacked.launches,
              pq.q8_mlp_stacked.launches)
    assert pq.q8_matmul(x, w, s).shape == (3, 128)
    assert pq.q8_matmul_stacked(x, w[None], s[None], 0).shape == (3, 128)
    assert (pq.q8_matmul.launches, pq.q8_matmul_stacked.launches,
            pq.q8_mlp_stacked.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        pq.quantize_rows_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pq._check_cuda("q8_matmul", x.to("meta"), w)
