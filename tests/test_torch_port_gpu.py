"""The hand-written flat attention kernels (mla_tpu_torch/ops/csrc/
flat_attention.cu and flat_attention_bwd.cu) against their plain versions,
and the training path's gradients, on the card. Marked ``gpu``; on a machine
without a CUDA device each test skips inside itself. Run on the card with:

    python -m pytest tests/test_torch_port_gpu.py -m gpu

Tolerances: forward fp32 atol 1e-5 (the same fp32 arithmetic, an online
softmax summed in another order); forward bf16 atol 2e-2 (the probabilities
round to bf16 at another point of the online softmax, and the output rounds
to bf16). Backward: fp32 atol 1e-5 + rtol 1e-5 (its gradients reach
|x| ~ 10); bf16 atol 2e-2 + rtol 1e-2, about one bf16 ulp of the output (a
ds near a rounding boundary may round the other way than in the plain
version, moving its products by one ulp).
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


@pytest.mark.parametrize("dtype_name,atol,rtol", [("float32", 1e-5, 1e-5),
                                                  ("bfloat16", 2e-2, 1e-2)])
@pytest.mark.parametrize("b,s,h,d", [(2, 9, 4, 16), (3, 70, 4, 16),
                                     (8, 257, 12, 64), (2, 257, 16, 80)])
def test_bwd_kernel_matches_plain(b, s, h, d, dtype_name, atol, rtol):
    """B1b against flat_attention_bwd_reference, a fully masked row
    included (its dq and dk are 0, its dv the mean of dO)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.attention import (flash_attention_flat_bwd,
                                             flat_attention_bwd_reference)

    set_matmul_precision()
    dtype = getattr(torch, dtype_name)
    qkv, mask = _inputs(torch, b, s, h, d, dtype)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, s, h * d)).astype(np.float32)).to("cuda", dtype)
    before = flash_attention_flat_bwd.launches
    got = flash_attention_flat_bwd(qkv, do, mask, h)
    torch.cuda.synchronize()
    assert flash_attention_flat_bwd.launches == before + 1
    want = flat_attention_bwd_reference(qkv, do, mask, h)
    assert got.dtype == qkv.dtype and got.shape == qkv.shape
    diff = (got.float() - want.float()).abs()
    assert bool(torch.all(diff <= atol + rtol * want.float().abs())), \
        diff.max().item()
    if b > 1:                           # row 1 is fully masked
        assert torch.all(got[1, :, :2 * h * d] == 0)


def _block_grads(block, x, mask):
    import torch
    out = block(x, mask)
    out.backward(torch.ones_like(out))
    grads = {n: p.grad for n, p in block.named_parameters()}
    return grads, x.grad


def test_block_backward_on_cuda_reaches_every_parameter():
    """The regression test for a kernel output cut off from autograd: a
    backward through one M3AEBlock on the card gives every parameter
    (qkv_linear and the LayerNorms included) a gradient, equal to the plain
    path's on the CPU (fp32; atol 1e-4 + rtol 1e-4 over a block's GEMMs)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.models.layers import M3AEBlock
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flash_attention_flat_bwd)

    set_matmul_precision()
    block = M3AEBlock(256, 4)           # head dim 64
    block.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    x_np = rng.standard_normal((2, 9, 256)).astype(np.float32)
    mask_np = np.zeros((2, 9), np.float32)
    mask_np[0, 6:] = 1.0
    want, want_x = _block_grads(block, torch.from_numpy(x_np).requires_grad_(),
                                torch.from_numpy(mask_np))
    want = {n: g.clone() for n, g in want.items()}
    block.zero_grad(set_to_none=True)
    block.cuda()
    fwd, bwd = flash_attention_flat.launches, flash_attention_flat_bwd.launches
    x = torch.from_numpy(x_np).cuda().requires_grad_()
    got, got_x = _block_grads(block, x, torch.from_numpy(mask_np).cuda())
    assert flash_attention_flat.launches == fwd + 1
    assert flash_attention_flat_bwd.launches == bwd + 1
    for n, g in want.items():
        assert got[n] is not None, n
        np.testing.assert_allclose(got[n].cpu().numpy(), g.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
    np.testing.assert_allclose(got_x.cpu().numpy(), want_x.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_mla_step_on_cuda_launches_each_kernel_per_block():
    """One debug MLA step on the card (fp32 master weights, bf16 compute):
    each sub-step runs one encoder's blocks forward and backward, so each
    kernel launches 2 x depth times; losses and parameters stay finite."""
    torch = _cuda()
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flash_attention_flat_bwd)
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    cfg = MLAConfig(dataset="Food101", lorb="m3ae", m3ae_size="debug",
                    gs_flag=True, batch_size=4).validate()
    model = build_classifier(cfg, seed=0, text_vocab_size=256)
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, seed=0)
    depth = len(model.mae_a.encoder.blocks)
    rng = np.random.default_rng(3)
    pm = np.zeros((4, 8), np.float32)
    pm[0, 5:] = 1.0
    batch = {"token": rng.integers(0, 256, (4, 8)),
             "padding_mask": pm,
             "image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
             "label": rng.integers(0, 101, 4),
             "valid": np.ones(4, np.float32)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    step = make_train_step(model, cfg, spec, len_dl=10)
    fwd, bwd = flash_attention_flat.launches, flash_attention_flat_bwd.launches
    state, metrics = step(state, batch, 0.01, 0)
    torch.cuda.synchronize()
    assert flash_attention_flat.launches - fwd == 2 * depth
    assert flash_attention_flat_bwd.launches - bwd == 2 * depth
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for n, p in state.params.items():
        assert p.dtype == torch.float32 and p.is_cuda, n
        assert bool(torch.isfinite(p).all()), n
