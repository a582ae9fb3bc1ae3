"""The hand-written flat attention kernel (mla_tpu_torch/ops/csrc/
flat_attention.cu) against its plain version, on the card. Marked ``gpu``;
on a machine without a CUDA device each test skips inside itself. Run on the
card with:

    python -m pytest tests/test_torch_port_gpu.py -m gpu

Tolerances: fp32 atol 1e-5 (the same fp32 arithmetic, an online softmax
summed in another order); bf16 atol 2e-2 (the probabilities round to bf16
at another point of the online softmax, and the output rounds to bf16).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


def _inputs(torch, b, s, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    mask = np.zeros((b, s), np.float32)
    lens = rng.integers(1, s + 1, b)
    for i, n in enumerate(lens):
        mask[i, n:] = 1.0               # text-style padding at the end
    if b > 1:
        mask[1, :] = 1.0                # one fully masked row
    dev = torch.device("cuda")
    return (torch.from_numpy(qkv).to(dev, dtype),
            torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("dtype_name,atol", [("float32", 1e-5),
                                             ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,s,h,d", [(2, 9, 4, 16), (3, 70, 4, 16),
                                     (8, 257, 12, 64), (2, 257, 16, 80)])
def test_kernel_matches_plain(b, s, h, d, dtype_name, atol):
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flat_attention_reference)

    set_matmul_precision()
    qkv, mask = _inputs(torch, b, s, h, d, getattr(torch, dtype_name))
    before = flash_attention_flat.launches
    got = flash_attention_flat(qkv, mask, h)
    torch.cuda.synchronize()
    assert flash_attention_flat.launches == before + 1
    want = flat_attention_reference(qkv, mask, h)
    assert got.dtype == qkv.dtype and got.shape == (b, s, h * d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


def test_fused_dispatch_on_cuda_launches_the_kernel():
    torch = _cuda()
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             fused_attention_qkv)

    qkv, mask = _inputs(torch, 2, 9, 4, 16, torch.bfloat16)
    before = flash_attention_flat.launches
    fused_attention_qkv(qkv, mask, 4)
    fused_attention_qkv(qkv, None, 4)
    assert flash_attention_flat.launches == before + 2


def test_kernel_rejects_unbuilt_head_dims():
    torch = _cuda()
    from mla_tpu_torch.ops.attention import flash_attention_flat

    qkv = torch.zeros(1, 4, 3 * 2 * 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_flat(qkv, None, 2)
