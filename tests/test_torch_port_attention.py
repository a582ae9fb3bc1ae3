"""The port's plain attention (mla_tpu_torch/ops/attention.py) against the JAX
package's attention: the reference, and the Pallas flat kernel in interpret
mode. Inputs come from numpy with a fixed seed; torch is imported inside the
tests (a torch import at collection can abort XLA:CPU later in the worker).

Divergence kept out of the interpret-mode comparison: the Pallas flat kernel
pads S up to a multiple of 8 with zero keys and masks them too
(mla_tpu/ops/attention.py:357-362), so on a row whose keys are ALL masked it
averages V over the padded length; attention_reference (and the port, and
the original PyTorch model) average over the S real keys. M3AE never makes
such a row (CLS is never masked).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import attention as jattn

B, H, D = 2, 4, 16


def _inputs(s, seed=0, fully_masked_row=True):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, s, 3 * H * D)).astype(np.float32)
    mask = (rng.random((B, s)) < 0.3).astype(np.float32)
    mask[0, 0] = 0.0                      # row 0 keeps a live key
    if fully_masked_row:
        mask[1, :] = 1.0
    else:
        mask[1, 0] = 0.0
    return qkv, mask


def _jax_reference(qkv, mask, dtype=jnp.float32):
    b, s, _ = qkv.shape
    parts = jnp.asarray(qkv, dtype).reshape(b, s, 3, H, D)
    parts = jnp.transpose(parts, (2, 0, 3, 1, 4))
    out = jattn.attention_reference(parts[0], parts[1], parts[2],
                                    jnp.asarray(mask))
    return np.asarray(jnp.transpose(out, (0, 2, 1, 3)).reshape(b, s, H * D)
                      .astype(jnp.float32))


@pytest.mark.parametrize("s", [9, 16])
def test_plain_matches_jax_reference_fp32(s):
    """Fully masked rows and S % 8 != 0 included: atol 1e-5 in fp32 (the
    same fp32 arithmetic, summed in another order)."""
    import torch
    from mla_tpu_torch.ops.attention import flat_attention_reference

    qkv, mask = _inputs(s)
    got = flat_attention_reference(torch.from_numpy(qkv),
                                   torch.from_numpy(mask), H).numpy()
    np.testing.assert_allclose(got, _jax_reference(qkv, mask), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("s,fully_masked_row", [(9, True), (9, False),
                                                (16, True)])
def test_plain_matches_pallas_flat_interpret(s, fully_masked_row):
    """Rows with at least one live key: atol 1e-5. A fully masked row is
    excluded (the padded-length divergence in the module docstring)."""
    import torch
    from mla_tpu_torch.ops.attention import flat_attention_reference

    qkv, mask = _inputs(s, seed=1, fully_masked_row=fully_masked_row)
    want = np.asarray(jattn.flash_attention_flat(
        jnp.asarray(qkv), jnp.asarray(mask), H, interpret=True))
    got = flat_attention_reference(torch.from_numpy(qkv),
                                   torch.from_numpy(mask), H).numpy()
    live = [b for b in range(B) if mask[b].min() == 0.0]
    assert live == ([0] if fully_masked_row else [0, 1])
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=0)


def test_fully_masked_row_is_uniform_over_real_keys():
    """The port's semantics on a fully masked row: the mean of V over the S
    real keys, for every query."""
    import torch
    from mla_tpu_torch.ops.attention import flat_attention_reference

    qkv, mask = _inputs(9, seed=2)
    got = flat_attention_reference(torch.from_numpy(qkv),
                                   torch.from_numpy(mask), H).numpy()
    v_mean = qkv[1, :, 2 * H * D:].mean(axis=0)
    np.testing.assert_allclose(got[1], np.broadcast_to(v_mean, got[1].shape),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [9, 16])
def test_plain_bf16_matches_jax_reference(s):
    """bf16 inputs: atol 2e-2 (the probabilities round to bf16 before PV in
    both; the remaining difference is accumulation order and rounding of
    the bf16 output, ~1 ulp at |x| ~ 2)."""
    import torch
    from mla_tpu_torch.ops.attention import flat_attention_reference

    qkv, mask = _inputs(s, seed=3)
    qkv_bf = torch.from_numpy(qkv).to(torch.bfloat16)
    got = flat_attention_reference(qkv_bf, torch.from_numpy(mask), H)
    assert got.dtype == torch.bfloat16
    want = _jax_reference(qkv, mask, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_fused_attention_qkv_on_cpu_is_the_plain_version():
    import torch
    from mla_tpu_torch.ops.attention import (flat_attention_reference,
                                             fused_attention_qkv)

    qkv, mask = _inputs(9, seed=4)
    q, m = torch.from_numpy(qkv), torch.from_numpy(mask)
    assert torch.equal(fused_attention_qkv(q, m, H),
                       flat_attention_reference(q, m, H))
    # no mask == all keys live
    assert torch.equal(fused_attention_qkv(q, None, H),
                       flat_attention_reference(q, torch.zeros_like(m), H))
