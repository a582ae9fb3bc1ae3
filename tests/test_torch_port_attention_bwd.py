"""The port's attention backward (mla_tpu_torch/ops/attention.py) against the
JAX package's: ``flat_attention_bwd_reference`` (the plain version of the
hand-written kernel csrc/flat_attention_bwd.cu) against ``jax.vjp`` of
``attention_reference`` and against the Pallas flat backward kernel in
interpret mode; ``FlatAttention`` (the counterpart of the JAX package's
``_flat_mha`` custom VJP) against autograd through the plain forward. Inputs
come from numpy with a fixed seed; torch is imported inside the tests.

Tolerances. fp32: atol 1e-5 + rtol 1e-5 (the same fp32 arithmetic, sums in
another order; gradients here reach |x| ~ 10). bf16 (against the Pallas
kernel, which rounds ds and P to bf16 at the same points): atol 2e-2 + rtol
1e-2, about one bf16 ulp of the output, because a ds that lands near a
rounding boundary in one and not the other moves its products by one ulp.

The Pallas kernel pads S to a multiple of 8 with masked keys and does not
zero ds at masked keys, so on a batch row whose keys are ALL masked it
differs from the VJP of the reference (whose mask replaces the score, giving
ds = 0 there); such rows are left out of the interpret-mode comparison, as
the forward's test does. M3AE never builds one (CLS is never masked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import attention as jattn

B, H, D = 2, 4, 16
C = H * D


def _inputs(s, seed=0, fully_masked_row=True):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, s, 3 * C)).astype(np.float32)
    do = rng.standard_normal((B, s, C)).astype(np.float32)
    mask = (rng.random((B, s)) < 0.3).astype(np.float32)
    mask[0, 0] = 0.0                      # row 0 keeps a live key
    if fully_masked_row:
        mask[1, :] = 1.0
    else:
        mask[1, 0] = 0.0
    return qkv, do, mask


def _jax_flat_reference(qkv, mask):
    b, s, _ = qkv.shape
    parts = qkv.reshape(b, s, 3, H, D).transpose(2, 0, 3, 1, 4)
    out = jattn.attention_reference(parts[0], parts[1], parts[2], mask)
    return out.transpose(0, 2, 1, 3).reshape(b, s, C)


def _jax_vjp(qkv, do, mask):
    _, pull = jax.vjp(lambda x: _jax_flat_reference(x, jnp.asarray(mask)),
                      jnp.asarray(qkv))
    return np.asarray(pull(jnp.asarray(do))[0])


def _plain_bwd(qkv, do, mask, dtype=None):
    import torch
    from mla_tpu_torch.ops.attention import flat_attention_bwd_reference

    q, g = torch.from_numpy(qkv), torch.from_numpy(do)
    if dtype is not None:
        q, g = q.to(dtype), g.to(dtype)
    return flat_attention_bwd_reference(q, g, torch.from_numpy(mask), H)


@pytest.mark.parametrize("s,fully_masked_row", [(9, True), (9, False),
                                                (16, True)])
def test_plain_bwd_matches_jax_vjp_fp32(s, fully_masked_row):
    """Every row, fully masked ones included: on such a row only dv takes a
    gradient (P is uniform over the S real keys, ds is 0)."""
    qkv, do, mask = _inputs(s, fully_masked_row=fully_masked_row)
    got = _plain_bwd(qkv, do, mask).numpy()
    want = _jax_vjp(qkv, do, mask)
    assert got.shape == (B, s, 3 * C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if fully_masked_row:
        np.testing.assert_array_equal(got[1, :, :2 * C], 0.0)   # dq, dk
        dv = do[1].sum(axis=0) / s                               # P = 1/S
        np.testing.assert_allclose(got[1, :, 2 * C:],
                                   np.broadcast_to(dv, (s, C)), atol=1e-6)


@pytest.mark.parametrize("s,fully_masked_row", [(9, True), (9, False),
                                                (16, True)])
def test_plain_bwd_matches_pallas_flat_bwd_interpret(s, fully_masked_row):
    """fp32, rows with at least one live key."""
    qkv, do, mask = _inputs(s, seed=1, fully_masked_row=fully_masked_row)
    dq, dk, dv = jattn.flash_attention_flat_bwd(
        jnp.asarray(qkv), jnp.asarray(do), jnp.asarray(mask), H,
        interpret=True)
    want = np.concatenate([np.asarray(x) for x in (dq, dk, dv)], axis=-1)
    got = _plain_bwd(qkv, do, mask).numpy()
    live = [b for b in range(B) if mask[b].min() == 0.0]
    assert live == ([0] if fully_masked_row else [0, 1])
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [9, 16])
def test_plain_bwd_bf16_matches_pallas_flat_bwd_interpret(s):
    """bf16 in, bf16 out: ds and P round to bf16 before their products in
    both (the JAX kernel's attention.py:409 and :417)."""
    import torch

    qkv, do, mask = _inputs(s, seed=2, fully_masked_row=False)
    qb = jnp.asarray(qkv, jnp.bfloat16)
    gb = jnp.asarray(do, jnp.bfloat16)
    dq, dk, dv = jattn.flash_attention_flat_bwd(qb, gb, jnp.asarray(mask), H,
                                                interpret=True)
    want = np.concatenate([np.asarray(x.astype(jnp.float32))
                           for x in (dq, dk, dv)], axis=-1)
    got = _plain_bwd(qkv, do, mask, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=1e-2)


def test_flat_attention_function_grads_equal_autograd_of_plain_forward():
    """FlatAttention on the CPU (plain forward, plain backward) gives the
    gradient autograd takes through flat_attention_reference, fp32."""
    import torch
    from mla_tpu_torch.ops.attention import (FlatAttention,
                                             flat_attention_reference)

    qkv, do, mask = _inputs(9, seed=3)
    m, g = torch.from_numpy(mask), torch.from_numpy(do)
    x1 = torch.from_numpy(qkv).requires_grad_()
    x2 = torch.from_numpy(qkv).requires_grad_()
    out1 = FlatAttention.apply(x1, m, H)
    out2 = flat_attention_reference(x2, m, H)
    assert torch.equal(out1, out2.detach())
    (got,) = torch.autograd.grad(out1, x1, g)
    (want,) = torch.autograd.grad(out2, x2, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_fused_attention_qkv_keeps_autograd_and_records_nothing_in_inference():
    """The output stays on the autograd graph when qkv needs a gradient,
    and the same call under inference_mode records nothing."""
    import torch
    from mla_tpu_torch.ops.attention import fused_attention_qkv

    qkv, _, mask = _inputs(9, seed=4)
    x = torch.from_numpy(qkv).requires_grad_()
    out = fused_attention_qkv(x, torch.from_numpy(mask), H)
    assert out.grad_fn is not None
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with torch.inference_mode():
        plain = fused_attention_qkv(torch.from_numpy(qkv),
                                    torch.from_numpy(mask), H)
    assert plain.grad_fn is None
    assert torch.equal(plain, out.detach())


def test_kernel_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the wrappers raise: the plain version is chosen by
    FlatAttention from the tensor's device, never inside a wrapper."""
    import torch
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flash_attention_flat_bwd)

    qkv, do, mask = _inputs(9, seed=5)
    q, g, m = (torch.from_numpy(x) for x in (qkv, do, mask))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_flat(q, m, H)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_flat_bwd(q, g, m, H)
