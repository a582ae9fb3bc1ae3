"""The bf16 attention forward kernel's tile law (mla_tpu_torch/ops/csrc/
flat_attention.cu, mma_fwd_kernel, behind B1f and B2f), written here in
plain torch, against the JAX package: its Pallas kernels in interpret mode
(flash_attention_flat, flash_attention) and attention_reference.

The law, per (batch row, head) and key tile of 64: scores q.k in fp32 times
scale*log2(e) (a masked key's score replaced by -1e7*log2(e)); the running
maximum m over the tiles so far; p = 2^(x - m), unnormalised; the running
sum l of p in fp32, rescaled by 2^(m_old - m); p rounded to bf16 before the
P.V product, summed in fp32 and rescaled as l; at the end O * (1/l), rounded
to bf16. The TPU kernels normalise P first and then round it (one softmax
over the whole row); attention_reference does the same. So the law differs
from both by where P rounds: about one bf16 ulp of the output.

Tolerance: atol 2e-2 + rtol 1e-2 * |want|, the card's bf16 tolerance for
the kernel against its plain version (chip_smoke.py TOL). Measured at these
inputs: at most 7.8e-3 from each of the three (one bf16 ulp of an output in
[1, 2)), 0.27 of the tolerance; recorded in ROADMAP.md C. Fully masked
rows (batch row 1) are held against attention_reference only: the Pallas
kernels average such a row over S padded to a multiple of 8 (ROADMAP.md C,
All-masked rows). Torch is imported inside the tests (ROADMAP.md C, Torch
import at collection).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import attention as jattn

B, H = 3, 3
TILE = 64            # keys per tile of mma_fwd_kernel (BT)
LOG2E = np.float32(1.4426950408889634)
ATOL, RTOL = 2e-2, 1e-2
CASES = [(s, d) for s in (9, 70, 257) for d in (16, 64)]


def _inputs(s, d, seed):
    """qkv (B, S, 3C) fp32 values exact in bf16, and a (B, S) mask: row 0
    text-style padding, row 1 fully masked, row 2 scattered."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, s, 3 * H * d)).astype(np.float32)
    qkv = np.array(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
    mask = np.zeros((B, s), np.float32)
    mask[0, 1 + rng.integers(0, s):] = 1.0
    mask[1, :] = 1.0
    mask[2] = rng.random(s) < 0.3
    mask[2, 0] = 0.0
    return qkv, mask


def _heads(torch, qkv, d):
    """(B, S, 3C) -> q, k, v (B, H, S, D) bf16 torch tensors."""
    b, s, _ = qkv.shape
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    return t.reshape(b, s, 3, H, d).permute(2, 0, 3, 1, 4)


def _tile_law(torch, q, k, v, mask):
    """The kernel's law on q, k, v (B, H, S, D) bf16 -> (B, H, S, D) bf16."""
    f32 = torch.float32
    s, d = q.shape[2], q.shape[3]
    scale2 = torch.tensor(d ** -0.5, dtype=f32) * torch.tensor(LOG2E)
    masked2 = torch.tensor(-1e7, dtype=f32) * torch.tensor(LOG2E)
    q, k, v = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3] + (1,), -float("inf"), dtype=f32)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, s, TILE):
        x = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + TILE]) * scale2
        x = torch.where(mask[:, None, None, k0:k0 + TILE] > 0, masked2, x)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd",
                                    p.to(torch.bfloat16).float(),
                                    v[:, :, k0:k0 + TILE])
        m = m_new
    return (o * (1.0 / l)).to(torch.bfloat16)


def _law(s, d, seed):
    """(qkv, mask, the law's output (B, H, S, D) as fp32 numpy)."""
    import torch

    qkv, mask = _inputs(s, d, seed)
    q, k, v = _heads(torch, qkv, d)
    got = _tile_law(torch, q, k, v, torch.from_numpy(mask))
    return qkv, mask, got.float().numpy()


def _assert_close(got, want, rows):
    got, want = got[rows], want[rows]
    diff = np.abs(got - want)
    assert np.all(diff <= ATOL + RTOL * np.abs(want)), diff.max()


@pytest.mark.parametrize("s,d", CASES)
def test_tile_law_matches_pallas_flat_interpret(s, d):
    qkv, mask, got = _law(s, d, seed=s + d)
    want = jattn.flash_attention_flat(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(mask), H, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, s, H, d)
    _assert_close(got.transpose(0, 2, 1, 3), want, [0, 2])


@pytest.mark.parametrize("s,d", CASES)
def test_tile_law_matches_pallas_heads_interpret(s, d):
    qkv, mask, got = _law(s, d, seed=s + d)
    parts = jnp.asarray(qkv, jnp.bfloat16).reshape(B, s, 3, H, d)
    q, k, v = jnp.transpose(parts, (2, 0, 3, 1, 4))
    want = jattn.flash_attention(q, k, v, jnp.asarray(mask), interpret=True)
    _assert_close(got, np.asarray(want.astype(jnp.float32)), [0, 2])


@pytest.mark.parametrize("s,d", CASES)
def test_tile_law_matches_attention_reference(s, d):
    """Every row, the fully masked one included: there both give the mean
    of V over the S real keys."""
    qkv, mask, got = _law(s, d, seed=s + d)
    parts = jnp.asarray(qkv, jnp.bfloat16).reshape(B, s, 3, H, d)
    q, k, v = jnp.transpose(parts, (2, 0, 3, 1, 4))
    want = jattn.attention_reference(q, k, v, jnp.asarray(mask))
    _assert_close(got, np.asarray(want.astype(jnp.float32)), [0, 1, 2])
