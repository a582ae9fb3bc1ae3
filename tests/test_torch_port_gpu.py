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


# lengths around the kernels' 64-row tiles and their 16-row steps, at each
# built head dim
RAGGED = [(s, d) for d in (16, 64, 80)
          for s in (1, 15, 16, 17, 63, 64, 65, 257)]


@pytest.mark.parametrize("dtype_name,atol", [("float32", 1e-5),
                                             ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,s,h,d", [(2, 9, 4, 16), (3, 70, 4, 16),
                                     (8, 257, 12, 64), (2, 257, 16, 80)]
                         + [(3, s, 2, d) for s, d in RAGGED])
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
                                     (8, 257, 12, 64), (2, 257, 16, 80)]
                         + [(3, s, 2, d) for s, d in RAGGED])
def test_bwd_kernel_matches_plain(b, s, h, d, dtype_name, atol, rtol):
    """B1b against flat_attention_bwd_reference, a fully masked row
    included (its dq and dk are 0, its dv the mean of dO), at the model's
    shapes and at ragged lengths."""
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


# --------------------------------------------------------------- B3 conv3x3
# Tolerances: fp32 atol 1e-5 + rtol 1e-5 (exact fp32 products, sums over
# 9*C terms taken in another order than cuDNN's); bf16 atol 1e-2 + rtol 1e-2,
# one bf16 ulp of the output (both accumulate exact products in fp32 and
# round once; a sum near a rounding boundary may round the other way).
CONV_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}


def _conv_inputs(torch, b, c, h, w, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    wt = (rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)).astype(
        np.float32)
    x = torch.from_numpy(x).to("cuda", dtype).contiguous(
        memory_format=torch.channels_last)
    return x, torch.from_numpy(wt).to("cuda", dtype)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,w", [(2, 64, 9, 10), (3, 64, 33, 157),
                                     (2, 128, 17, 79), (2, 256, 5, 6),
                                     (2, 512, 5, 20), (3, 64, 1, 1),
                                     (1, 128, 2, 3)])
def test_conv3x3_kernel_matches_plain(b, c, h, w, dtype_name):
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    set_matmul_precision()
    x, wt = _conv_inputs(torch, b, c, h, w, getattr(torch, dtype_name))
    before = conv3x3.launches
    got = conv3x3(x, wt)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = conv3x3_reference(x, wt).float()
    atol, rtol = CONV_TOL[dtype_name]
    diff = (got.float() - want).abs()
    assert bool(torch.all(diff <= atol + rtol * want.abs())), \
        diff.max().item()


def test_conv3x3_backward_on_cuda_matches_cpu():
    """dx through Conv3x3 on the card (the kernel on the rotated weight)
    and dw (PyTorch's weight-gradient) against the CPU's autograd of
    F.conv2d, fp32 (atol 1e-4 + rtol 1e-4: dw sums 2*9*9 pixels x taps)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.conv3x3 import Conv3x3, conv3x3

    set_matmul_precision()
    x, wt = _conv_inputs(torch, 2, 64, 9, 9, torch.float32, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 64, 9, 9)).astype(np.float32))
    xc, wc = x.cpu().requires_grad_(), wt.cpu().requires_grad_()
    want = torch.autograd.grad(
        torch.nn.functional.conv2d(xc, wc, padding=1), (xc, wc), g)
    x.requires_grad_()
    wt.requires_grad_()
    before = conv3x3.launches
    got = torch.autograd.grad(Conv3x3.apply(x, wt), (x, wt), g.cuda())
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 2          # forward and dx
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_conv3x3_rejects_what_it_cannot_launch():
    torch = _cuda()
    from mla_tpu_torch.ops.conv3x3 import conv3x3

    x = torch.zeros(1, 64, 4, 4, device="cuda")
    w = torch.zeros(64, 64, 3, 3, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3(x, w)
    with pytest.raises(ValueError, match="C in"):
        conv3x3(torch.zeros(1, 32, 4, 4, device="cuda"),
                torch.zeros(32, 32, 3, 3, device="cuda"))
    with pytest.raises(TypeError):
        conv3x3(x.half(), w)


# the 8 stride-1 3x3 sites of the CREMA-D ResNet-18s at 64 clips
# (chip_smoke.py CONV_SHAPES), as (B, C, H, W)
CREMA_D_CONVS = [(192, 64, 56, 56), (192, 128, 28, 28), (192, 256, 14, 14),
                 (192, 512, 7, 7), (64, 64, 33, 157), (64, 128, 17, 79),
                 (64, 256, 9, 40), (64, 512, 5, 20)]
# B*H*W off the kernel's 64-256-pixel tiles, with a tile spanning several
# images (H*W < the tile), and 1x1 images at C = 512
RAGGED_CONVS = [(5, 64, 3, 7), (7, 128, 5, 5), (3, 512, 1, 1),
                (33, 256, 2, 2), (2, 512, 7, 7), (1, 64, 1, 1)]


def _conv_close(torch, got, want, dtype_name):
    atol, rtol = CONV_TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    assert bool(torch.all(diff <= atol + rtol * want.float().abs())), \
        diff.max().item()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,h,w", CREMA_D_CONVS + RAGGED_CONVS)
def test_conv3x3_kernel_at_the_main_path_and_ragged_shapes(b, c, h, w,
                                                           dtype_name):
    """B3 at the CREMA-D sites and at pixel counts off its tiles, against
    the plain version; a second call gives the same bits (no atomics, no
    split sums)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_reference

    set_matmul_precision()
    x, wt = _conv_inputs(torch, b, c, h, w, getattr(torch, dtype_name),
                         seed=b + c + h + w)
    got = conv3x3(x, wt)
    torch.cuda.synchronize()
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    _conv_close(torch, got, conv3x3_reference(x, wt), dtype_name)
    assert torch.equal(got, conv3x3(x, wt))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_conv3x3_dx_at_each_width(c, dtype_name):
    """dx through Conv3x3 (the kernel on the rotated, channel-swapped
    weight) against the plain version's autograd on the same inputs, at
    each channel width; dw is PyTorch's weight-gradient on both sides."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.conv3x3 import (Conv3x3, conv3x3,
                                           conv3x3_reference)

    set_matmul_precision()
    dtype = getattr(torch, dtype_name)
    x, wt = _conv_inputs(torch, 3, c, 9, 10, dtype, seed=c)
    g = torch.from_numpy(np.random.default_rng(c + 1).standard_normal(
        (3, c, 9, 10)).astype(np.float32)).to("cuda", dtype).contiguous(
            memory_format=torch.channels_last)
    x.requires_grad_()
    before = conv3x3.launches
    got = torch.autograd.grad(Conv3x3.apply(x, wt), x, g)[0]
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 2          # forward and dx
    want = torch.autograd.grad(conv3x3_reference(x, wt), x, g)[0]
    _conv_close(torch, got, want, dtype_name)


def _av_batch(torch, b, seed=0, t=2, side=32):
    rng = np.random.default_rng(seed)
    batch = {"spec": rng.standard_normal((b, 1, 33, 40)).astype(np.float32),
             "image": rng.standard_normal((b, 3, t, side, side)).astype(
                 np.float32),
             "label": rng.integers(0, 6, b), "valid": np.ones(b, np.float32)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def test_av_mla_step_on_cuda_launches_b3_per_site():
    """One debug AV MLA step on the card (stages 1,1,1,1: 5 B3 sites per
    ResNet; fp32 master weights, bf16 compute, --pallas_conv on): each
    sub-step runs its sites forward and dx, 20 launches; an eval batch 10
    and no running statistic moves; losses, parameters and statistics stay
    finite."""
    torch = _cuda()
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.evals.metrics import make_eval_step
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    cfg = MLAConfig(dataset="CREMAD", lorb="base", gs_flag=True,
                    pallas_conv="on", resnet_stages=(1, 1, 1, 1),
                    batch_size=4).validate()
    model = build_classifier(cfg, seed=0)
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, seed=0)
    batch = _av_batch(torch, 4)
    before = conv3x3.launches
    state, metrics = make_train_step(model, cfg, spec, len_dl=10)(
        state, batch, 0.01, 0)
    torch.cuda.synchronize()
    assert conv3x3.launches - before == 20
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    stats = {n: t.clone() for n, t in model.named_buffers()}
    before = conv3x3.launches
    make_eval_step(model, cfg)(batch)
    assert conv3x3.launches - before == 10
    assert all(torch.equal(t, stats[n]) for n, t in model.named_buffers())
    for n, p in state.params.items():
        assert p.dtype == torch.float32 and p.is_cuda, n
        assert bool(torch.isfinite(p).all()), n
    for n, t in model.named_buffers():
        assert t.is_cuda and bool(torch.isfinite(t.float()).all()), n


def test_av_step_on_cuda_matches_cpu_fp32():
    """A debug AV MLA step in fp32 on the card (B3 and cuDNN) against the
    CPU (plain versions): running statistics and losses come from the
    forward (1e-5 relative); parameters 1e-6 relative L2; momentum 1e-2
    relative L2, since a ReLU input within rounding of 0 may take either
    side (see tests/test_torch_port_train_av.py)."""
    torch = _cuda()
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    cfg = MLAConfig(dataset="CREMAD", lorb="base", gs_flag=True,
                    pallas_conv="on", resnet_stages=(1, 1, 1, 1),
                    batch_size=4, compute_dtype="float32").validate()
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_classifier(cfg, seed=2)
        spec = optim.make_spec(cfg)
        st = create_train_state(model, cfg, spec, seed=2, device=dev)
        batch = {k: v.to(dev) for k, v in _av_batch(torch, 4, 3).items()}
        st, met = make_train_step(model, cfg, spec, len_dl=1)(st, batch,
                                                              0.01, 0)
        out[dev] = ({n: p.detach().cpu() for n, p in st.params.items()},
                    {n: m.cpu() for n, m in st.opt_state["momentum"].items()},
                    {n: t.cpu() for n, t in model.named_buffers()
                     if n.endswith(("mean", "var"))},
                    {k: float(v) for k, v in met.items()})

    def rel(a, b):
        num = sum(float(torch.sum((a[n] - b[n]) ** 2)) for n in b)
        return (num / sum(float(torch.sum(b[n] ** 2)) for n in b)) ** 0.5

    (pg, mg, sg, lg), (pc, mc, sc, lc) = out["cuda"], out["cpu"]
    assert rel(sg, sc) <= 1e-5
    assert rel(pg, pc) <= 1e-6
    assert rel(mg, mc) <= 1e-2
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 1e-5 * abs(lc[k]), k


def test_av_serving_on_cuda_is_eval_mode(tmp_path):
    """A serving dispatch of the AV family runs BatchNorm on its running
    statistics (26 launches at full depth would be 10 here) and changes
    none of them."""
    torch = _cuda()
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    from mla_tpu_torch.runtime.export import export_serving, load_serving

    cfg = MLAConfig(dataset="CREMAD", lorb="base", gs_flag=True,
                    dynamic=True, pallas_conv="on",
                    resnet_stages=(1, 1, 1, 1)).validate()
    batch = {k: v.cpu().numpy() for k, v in _av_batch(torch, 3).items()}
    art = export_serving(cfg, build_classifier(cfg, seed=0),
                         str(tmp_path / "av"), batch_sizes=(1, 4),
                         example_batch=batch)
    srv = load_serving(art)
    stats = {n: t.clone() for n, t in srv.model.named_buffers()}
    before = conv3x3.launches
    out = srv({k: batch[k] for k in ("spec", "image")})
    torch.cuda.synchronize()
    assert conv3x3.launches - before == 10 and not srv.model.training
    assert all(torch.equal(t, stats[n]) for n, t in srv.model.named_buffers())
    assert out["fused"].shape == (3, 6) and np.isfinite(out["fused"]).all()


# ------------------------------------------------ B4, B5, B6 int8 GEMMs, MLP
# Tolerance: one bf16 ulp of the larger of the two outputs (2^-7 relative;
# the larger, since a value just below a power of 2 may round up to it):
# weight-only kernels and plain versions both sum exact bf16 x int8 products
# in fp32 and round once, in other orders, and the tensor cores' fp32
# accumulation truncates at each 16-deep step (an absolute 3e-5 covers it
# on outputs that cancel to |y| ~ 1e-5 at K = 3072); W8A8 sums are exact
# int32 on both sides (1e-6); the fused MLP's weight-only hidden is bf16
# and may round the other way (an absolute 1e-3).
ULP = 2.0 ** -7


def _q8_weight(rng, *shape):
    """A weight quantized per output channel (the last-but-one axis is N,
    the last K), as runtime/export.py:quantize_int8 does."""
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[-1])
    amax = np.abs(w).max(axis=-1, keepdims=True)
    s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s[..., 0]


def _close(torch, got, want, atol=1e-6):
    diff = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    big = torch.maximum(got.float().abs(), want.float().abs())
    assert bool(torch.all(diff <= atol + ULP * big)), diff.max().item()


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("m,k,n", [(257, 768, 2304), (77, 768, 768),
                                   (300, 3072, 768), (1000, 768, 3072)])
def test_q8_matmul_kernel_matches_plain(m, k, n, a8):
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.q8_matmul import q8_matmul, q8_matmul_plain

    set_matmul_precision()
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    q, s = _q8_weight(rng, n, k)
    w, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    before = q8_matmul.launches
    got = q8_matmul(x, w, s, a8=a8)
    torch.cuda.synchronize()
    assert q8_matmul.launches == before + 1
    _close(torch, got, q8_matmul_plain(x, w, s, a8), 1e-6 if a8 else 3e-5)


@pytest.mark.parametrize("a8", [False, True])
def test_q8_matmul_stacked_reads_and_clamps_the_layer(a8):
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.q8_matmul import (q8_matmul_plain,
                                             q8_matmul_stacked)

    set_matmul_precision()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 93, 768)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    q, s = _q8_weight(rng, 3, 768, 768)
    w, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    for layer, want_l in ((0, 0), (2, 2), (7, 2), (-4, 0)):
        lid = torch.tensor(layer, dtype=torch.int32, device="cuda")
        before = q8_matmul_stacked.launches
        got = q8_matmul_stacked(x, w, s, lid, a8=a8)
        torch.cuda.synchronize()
        assert q8_matmul_stacked.launches == before + 1
        assert got.shape == (2, 93, 768)
        _close(torch, got.reshape(-1, 768),
               q8_matmul_plain(x.reshape(-1, 768), w[want_l], s[want_l], a8),
               1e-6 if a8 else 3e-5)


# the base width's four block sites (K, N)
Q8_SITES = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072),
            "fc2": (3072, 768)}


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("site", sorted(Q8_SITES))
@pytest.mark.parametrize("m", [1, 257, 777, 16448])
def test_q8_matmul_every_site_and_rung(m, site, a8):
    """B4 at each block site at one row, rungs 1 and 64 (257, 16448 rows)
    and a row count that is a multiple of neither 64 nor 128 (the tile
    chooser's widths), against the plain version; a second call repeats
    the first bit for bit."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.q8_matmul import q8_matmul, q8_matmul_plain

    set_matmul_precision()
    k, n = Q8_SITES[site]
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    q, s = _q8_weight(rng, n, k)
    w, s = torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()
    got = q8_matmul(x, w, s, a8=a8)
    again = q8_matmul(x, w, s, a8=a8)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(torch, got, q8_matmul_plain(x, w, s, a8), 1e-6 if a8 else 3e-5)


@pytest.mark.parametrize("a8", [False, True])
def test_q8_stacked_kernels_on_twelve_layers(a8):
    """B5 (qkv site) and B6 on 12-layer base-width stacks at layer ids 0, 11
    and 99 (clamped to 11), 257 rows; each call twice, bit for bit."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.q8_matmul import (q8_matmul_plain,
                                             q8_matmul_stacked, q8_mlp_plain,
                                             q8_mlp_stacked)

    set_matmul_precision()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((257, 768)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    qq, sq = _q8_weight(rng, 12, 2304, 768)
    q1, s1 = _q8_weight(rng, 12, 3072, 768)
    q2, s2 = _q8_weight(rng, 12, 768, 3072)
    wq, sq, w1, s1, w2, s2 = (torch.from_numpy(a).cuda()
                              for a in (qq, sq, q1, s1, q2, s2))
    b1 = torch.from_numpy(rng.standard_normal(3072).astype(np.float32)
                          * 0.1).cuda()
    b2 = torch.from_numpy(rng.standard_normal(768).astype(np.float32)
                          * 0.1).cuda()
    for layer, want_l in ((0, 0), (11, 11), (99, 11)):
        lid = torch.tensor(layer, dtype=torch.int32, device="cuda")
        got = q8_matmul_stacked(x, wq, sq, lid, a8=a8)
        assert torch.equal(got, q8_matmul_stacked(x, wq, sq, lid, a8=a8))
        _close(torch, got, q8_matmul_plain(x, wq[want_l], sq[want_l], a8),
               1e-6 if a8 else 3e-5)
        got = q8_mlp_stacked(x, w1, s1, b1, w2, s2, b2, lid, a8=a8)
        assert torch.equal(got, q8_mlp_stacked(x, w1, s1, b1, w2, s2, b2,
                                               lid, a8=a8))
        _close(torch, got, q8_mlp_plain(x, w1, s1, b1, w2, s2, b2, want_l,
                                        a8), 1e-6 if a8 else 1e-3)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("m", [257, 2056, 1001, 16448])
def test_q8_mlp_kernel_matches_plain(m, a8):
    """B6 on layer 1 of a 2-layer base-width stack (C 768, H 3072) and an
    out-of-range id; W8A8 with the chooser's group width (1536 at 257 rows,
    768 at 2056, 512 at 16448)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.q8_matmul import (mlp_group_width, q8_mlp_plain,
                                             q8_mlp_stacked)

    set_matmul_precision()
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 768)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    q1, s1 = _q8_weight(rng, 2, 3072, 768)
    q2, s2 = _q8_weight(rng, 2, 768, 3072)
    b1 = torch.from_numpy(rng.standard_normal(3072).astype(np.float32) * 0.1
                          ).to("cuda", torch.bfloat16)
    b2 = torch.from_numpy(rng.standard_normal(768).astype(np.float32) * 0.1
                          ).to("cuda", torch.bfloat16)
    w1, s1, w2, s2 = (torch.from_numpy(a).cuda() for a in (q1, s1, q2, s2))
    if a8 and m in (257, 2056, 16448):
        assert mlp_group_width(m, 768, 3072) == {257: 1536, 2056: 768,
                                                 16448: 512}[m]
    for layer, want_l in ((1, 1), (5, 1)):
        lid = torch.tensor(layer, dtype=torch.int32, device="cuda")
        before = q8_mlp_stacked.launches
        got = q8_mlp_stacked(x, w1, s1, b1, w2, s2, b2, lid, a8=a8)
        torch.cuda.synchronize()
        assert q8_mlp_stacked.launches == before + 1
        want = q8_mlp_plain(x, w1, s1, b1, w2, s2, b2, want_l, a8)
        _close(torch, got, want, atol=1e-6 if a8 else 1e-3)


def test_q8_wrappers_reject_what_they_cannot_launch():
    torch = _cuda()
    from mla_tpu_torch.ops.q8_matmul import q8_matmul, q8_matmul_stacked

    x = torch.zeros(4, 96, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(128, 96, device="cuda", dtype=torch.int8)
    s = torch.ones(128, device="cuda")
    with pytest.raises(ValueError, match="K % 64"):
        q8_matmul(x, w, s)
    x64 = torch.zeros(4, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int8"):
        q8_matmul(x64, torch.zeros(128, 64, device="cuda"), s)
    with pytest.raises(ValueError, match="int32 scalar"):
        q8_matmul_stacked(x64, torch.zeros(1, 128, 64, device="cuda",
                                           dtype=torch.int8), s[None], 0)


# ------------------------------------------- B2f/B2b: (B, H, S, D) attention
# The flat kernels' tolerances (above): forward fp32 atol 1e-5, bf16 2e-2;
# backward atol + rtol * |want|, fp32 1e-5 + 1e-5, bf16 2e-2 + 1e-2.

def _heads(torch, b, h, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    mask = np.zeros((b, s), np.float32)
    for i, n in enumerate(rng.integers(1, s + 1, b)):
        mask[i, n:] = 1.0               # text-style padding at the end
    if b > 1:
        mask[1, :] = 1.0                # one fully masked row
    return q, k, v, do, torch.from_numpy(mask).cuda()


@pytest.mark.parametrize("dtype_name,atol,rtol", [("float32", 1e-5, 1e-5),
                                                  ("bfloat16", 2e-2, 1e-2)])
@pytest.mark.parametrize("b,h,s,d", [(2, 4, 9, 16), (3, 4, 70, 16),
                                     (8, 12, 257, 64), (2, 16, 257, 80),
                                     (2, 3, 1100, 64)]
                         + [(3, 2, s, d) for s, d in RAGGED])
def test_head_kernels_match_plain(b, h, s, d, dtype_name, atol, rtol):
    """B2f against attention_reference and B2b against
    attention_bwd_reference, a fully masked row included (its output is
    the mean of V, its dq and dk are 0); S = 1100 is past the JAX package's
    1024-token limit of its Pallas backward; ragged lengths as B1b's."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.attention import (attention_bwd_reference,
                                             attention_reference,
                                             flash_attention,
                                             flash_attention_bwd)

    set_matmul_precision()
    q, k, v, do, mask = _heads(torch, b, h, s, d, getattr(torch, dtype_name))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(q, k, v, mask)
    grads = flash_attention_bwd(q, k, v, do, mask)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = attention_reference(q, k, v, mask)
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= atol, err
    for got, w in zip(grads, attention_bwd_reference(q, k, v, do, mask)):
        assert got.dtype == q.dtype and got.shape == q.shape
        diff = (got.float() - w.float()).abs()
        assert bool(torch.all(diff <= atol + rtol * w.float().abs())), \
            diff.max().item()
    if b > 1:
        assert torch.all(grads[0][1] == 0) and torch.all(grads[1][1] == 0)


def _flat_and_heads(torch, b, s, h, d, dtype, seed=0):
    """Flat inputs (qkv, dO, mask) and the same values in (B, H, S, D)."""
    qkv, mask = _inputs(torch, b, s, h, d, dtype, seed)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (b, s, h * d)).astype(np.float32)).to("cuda", dtype)
    q, k, v = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
    g = do.view(b, s, h, d).transpose(1, 2).contiguous()
    return (qkv, do, mask), (q, k, v, g, mask)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d", [(8, 257, 12, 64), (2, 65, 16, 80),
                                     (3, 17, 4, 16)])
def test_bwd_kernels_repeat_bitwise(b, s, h, d, dtype_name):
    """No atomics: two calls of B1b, and of B2b, give the same bits."""
    torch = _cuda()
    from mla_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_flat_bwd)

    flat, heads = _flat_and_heads(torch, b, s, h, d,
                                  getattr(torch, dtype_name))
    first = flash_attention_flat_bwd(*flat, h)
    assert torch.equal(first, flash_attention_flat_bwd(*flat, h))
    first = flash_attention_bwd(*heads)
    for x, y in zip(first, flash_attention_bwd(*heads)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d", [(8, 257, 12, 64), (2, 65, 16, 80),
                                     (3, 17, 4, 16)])
def test_head_and_flat_bwd_give_equal_bits(b, s, h, d, dtype_name):
    """B2b and B1b run one kernel per element type on two layouts: the same
    inputs give bit-equal d(qkv)."""
    torch = _cuda()
    from mla_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_flat_bwd)

    flat, heads = _flat_and_heads(torch, b, s, h, d,
                                  getattr(torch, dtype_name))
    dqkv = flash_attention_flat_bwd(*flat, h)
    as_flat = torch.stack(flash_attention_bwd(*heads)).permute(
        1, 3, 0, 2, 4).reshape(b, s, 3 * h * d)
    assert torch.equal(dqkv, as_flat)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d", [(8, 257, 12, 64), (2, 65, 16, 80),
                                     (3, 17, 4, 16)]
                         + [(3, s, 2, d) for s, d in RAGGED])
def test_fwd_kernels_repeat_bitwise(b, s, h, d, dtype_name):
    """No atomics and no order that changes: two calls of B1f, and of B2f,
    give the same bits."""
    torch = _cuda()
    from mla_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_flat)

    flat, heads = _flat_and_heads(torch, b, s, h, d,
                                  getattr(torch, dtype_name))
    qkv, _, mask = flat
    first = flash_attention_flat(qkv, mask, h)
    assert torch.equal(first, flash_attention_flat(qkv, mask, h))
    q, k, v, _, mask = heads
    first = flash_attention(q, k, v, mask)
    assert torch.equal(first, flash_attention(q, k, v, mask))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d", [(8, 257, 12, 64), (2, 65, 16, 80),
                                     (3, 17, 4, 16)])
def test_head_and_flat_fwd_give_equal_bits(b, s, h, d, dtype_name):
    """B2f and B1f run one kernel per element type on two layouts: the same
    values give bit-equal outputs (a fully masked row included)."""
    torch = _cuda()
    from mla_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_flat)

    flat, heads = _flat_and_heads(torch, b, s, h, d,
                                  getattr(torch, dtype_name))
    qkv, _, mask = flat
    q, k, v, _, _ = heads
    as_flat = flash_attention(q, k, v, mask).transpose(1, 2).reshape(
        b, s, h * d)
    assert torch.equal(flash_attention_flat(qkv, mask, h), as_flat)


def test_serving_on_cuda_takes_the_flat_route_with_the_switch_off(tmp_path):
    """A served M3AE dispatch launches B1f once per block and encoder (2 x
    2 for the debug model; 24 for base) and B2f never, with the process's
    route switch left off; the switch is off again afterwards."""
    torch = _cuda()
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops import attention
    from mla_tpu_torch.runtime.export import export_serving, load_serving

    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    dynamic=True, m3ae_size="debug", image_size=32).validate()
    model = build_classifier(cfg, seed=0, text_vocab_size=256)
    rng = np.random.default_rng(4)
    feats = {"token": rng.integers(0, 256, (2, 8)).astype(np.int32),
             "padding_mask": np.zeros((2, 8), np.float32),
             "image": rng.standard_normal((2, 3, 32, 32)).astype(np.float32)}
    srv = load_serving(export_serving(cfg, model, str(tmp_path),
                                      batch_sizes=(2,), example_batch=feats,
                                      device="cpu"), device="cuda")
    depth = len(srv.model.mae_a.encoder.blocks)
    attention.set_flat_attention(False)
    try:
        before = (attention.flash_attention_flat.launches,
                  attention.flash_attention.launches)
        out = srv(feats)
        torch.cuda.synchronize()
        launched = (attention.flash_attention_flat.launches - before[0],
                    attention.flash_attention.launches - before[1])
        assert attention._FLAT_ENABLED is False
    finally:
        attention.set_flat_attention(True)
    assert launched == (2 * depth, 0), launched
    assert np.isfinite(out["fused"]).all()


def test_head_route_block_backward_on_cuda_matches_cpu():
    """One M3AEBlock with the flat kernels off: on the card the forward and
    backward go through B2f and B2b (never B1f/B1b) and every parameter's
    gradient equals the plain path's on the CPU (fp32; atol 1e-4 + rtol
    1e-4 over a block's GEMMs, as the flat route's test)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.models.layers import M3AEBlock
    from mla_tpu_torch.ops import attention

    set_matmul_precision()
    block = M3AEBlock(256, 4)           # head dim 64
    block.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x_np = rng.standard_normal((2, 9, 256)).astype(np.float32)
    mask_np = np.zeros((2, 9), np.float32)
    mask_np[0, 6:] = 1.0
    kernels = (attention.flash_attention, attention.flash_attention_bwd,
               attention.flash_attention_flat,
               attention.flash_attention_flat_bwd)
    attention.set_flat_attention(False)
    try:
        want, want_x = _block_grads(
            block, torch.from_numpy(x_np).requires_grad_(),
            torch.from_numpy(mask_np))
        want = {n: g.clone() for n, g in want.items()}
        block.zero_grad(set_to_none=True)
        block.cuda()
        before = [fn.launches for fn in kernels]
        got, got_x = _block_grads(block,
                                  torch.from_numpy(x_np).cuda()
                                  .requires_grad_(),
                                  torch.from_numpy(mask_np).cuda())
        launched = [fn.launches - n for fn, n in zip(kernels, before)]
    finally:
        attention.set_flat_attention(True)
    assert launched == [1, 1, 0, 0]
    for n, g in want.items():
        assert got[n] is not None, n
        np.testing.assert_allclose(got[n].cpu().numpy(), g.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
    np.testing.assert_allclose(got_x.cpu().numpy(), want_x.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_head_wrappers_reject_what_they_cannot_launch():
    torch = _cuda()
    from mla_tpu_torch.ops.attention import flash_attention

    q = torch.zeros(1, 2, 4, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 4, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must match q"):
        flash_attention(q, q[:, :, :3], q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))


# ------------------------------------------------- B7f/B7b: LN -> Dense
# Tolerances (atol, rtol of the larger of the two values), by output: B7f's
# fp32 outputs are sums over C products in another order than cuBLAS's; a
# bf16 output rounds twice (the sum, then the sum plus the bias) and may
# round the other way, up to two ulps of y where the bias cancels part of
# the sum (plus 2^-7 of the largest bias), and an LN output whose fp32
# statistics differ in the last place may round the other way too
# (absolute 6e-3 in all). B7b's dx: two bf16 ulps (a difference of nearly
# equal fp32 terms); its fp32 sums
# over the rows (dscale, dbias, dW, dc) run one after another in the
# kernels and pairwise in PyTorch (absolute 1e-2 at sums of |v| ~ 100-1000);
# a bf16 dW also sums h's that round the other way, each moving it by |dy|
# times one bf16 ulp of h (absolute 0.25). chip_smoke.py's LN_TOL.
LN_TOL = {"float32": {"y": (1e-4, 1e-5), "dx": (1e-4, 1e-4),
                      "ds": (1e-2, 1e-4), "db": (1e-2, 1e-4),
                      "dw": (1e-2, 1e-4), "dc": (1e-2, 1e-4)},
          "bfloat16": {"y": (6e-3, 2 * ULP), "dx": (2e-3, 2 * ULP),
                       "ds": (1e-2, 1e-4), "db": (1e-2, 1e-4),
                       "dw": (0.25, 1e-3), "dc": (1e-2, 1e-4)}}


def _ln(torch, n, c, f, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)
    return (t(rng.standard_normal((n, c)), dtype),
            t(rng.standard_normal(c) * 0.1 + 1.0),
            t(rng.standard_normal(c) * 0.1),
            t(rng.standard_normal((f, c)) / np.sqrt(c)),
            t(rng.standard_normal(f) * 0.1),
            t(rng.standard_normal((n, f)), dtype))


def _within(torch, got, want, tol, what):
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    big = torch.maximum(got.float().abs(), want.float().abs())
    assert bool(torch.all(diff <= atol + rtol * big)), (what,
                                                         diff.max().item())


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c,f", [(257, 768, 2304), (1000, 768, 3072),
                                   (37, 64, 96)])
def test_ln_dense_kernels_match_plain(n, c, f, dtype_name):
    """B7f against ln_dense_reference, B7b against ln_dense_bwd_reference
    (every output), and B7b twice for bitwise equality (no atomics)."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.fused_block import (ln_dense_bwd,
                                               ln_dense_bwd_reference,
                                               ln_dense_fwd,
                                               ln_dense_reference)

    set_matmul_precision()
    dt = getattr(torch, dtype_name)
    x, s, b, w, db, dy = _ln(torch, n, c, f, dt, seed=n)
    before = (ln_dense_fwd.launches, ln_dense_bwd.launches)
    y = ln_dense_fwd(x, s, b, w, db, 1e-5, dt)
    got = ln_dense_bwd(x, s, b, w, dy, 1e-5, dt)
    again = ln_dense_bwd(x, s, b, w, dy, 1e-5, dt)
    torch.cuda.synchronize()
    assert (ln_dense_fwd.launches, ln_dense_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert y.dtype == dt and y.shape == (n, f)
    tol = LN_TOL[dtype_name]
    _within(torch, y, ln_dense_reference(x, s, b, w, db, 1e-5, dt), tol["y"],
            "y")
    want = ln_dense_bwd_reference(x, s, b, w, dy, 1e-5, dt)
    for name, g, wt, g2 in zip(("dx", "ds", "db", "dw", "dc"), got, want,
                               again):
        assert g.dtype == wt.dtype and g.shape == wt.shape, name
        _within(torch, g, wt, tol[name], name)
        assert torch.equal(g, g2), name


def test_ln_dense_fp32_input_bf16_compute():
    """x in fp32 with a bf16 compute type (statistics on the raw fp32
    input, the LN output rounded to bf16): y in bf16, dx in fp32."""
    torch = _cuda()
    from mla_tpu_torch.device import set_matmul_precision
    from mla_tpu_torch.ops.fused_block import (ln_dense_bwd,
                                               ln_dense_bwd_reference,
                                               ln_dense_fwd,
                                               ln_dense_reference)

    set_matmul_precision()
    x, s, b, w, db, dy = _ln(torch, 300, 768, 2304, torch.float32, seed=3)
    dy = dy.to(torch.bfloat16)
    bf = torch.bfloat16
    y = ln_dense_fwd(x, s, b, w, db, 1e-5, bf)
    assert y.dtype == bf
    _within(torch, y, ln_dense_reference(x, s, b, w, db, 1e-5, bf),
            LN_TOL["bfloat16"]["y"], "y")
    got = ln_dense_bwd(x, s, b, w, dy, 1e-5, bf)
    want = ln_dense_bwd_reference(x, s, b, w, dy, 1e-5, bf)
    assert got[0].dtype == torch.float32
    for name, g, wt in zip(("dx", "ds", "db", "dw", "dc"), got, want):
        _within(torch, g, wt, LN_TOL["bfloat16"][name], name)


def test_ln_dense_switch_on_cuda_reaches_the_kernels():
    """ln_dense with the switch on: on a CUDA tensor LnDense launches B7f
    forward and B7b backward, and the gradients come back in the
    parameters' types; switch off, nothing launches."""
    torch = _cuda()
    from mla_tpu_torch.ops import fused_block as fbk

    x, s, b, w, db, dy = _ln(torch, 2 * 33, 256, 512, torch.bfloat16, seed=4)
    leaves = [x.view(2, 33, 256).requires_grad_()] + [
        t.requires_grad_() for t in (s, b, w, db)]
    for on, want in ((True, (1, 1)), (False, (0, 0))):
        fbk.set_fused_ln_dense(on)
        try:
            before = (fbk.ln_dense_fwd.launches, fbk.ln_dense_bwd.launches)
            y = fbk.ln_dense(*leaves, dtype=torch.bfloat16)
            grads = torch.autograd.grad(y, leaves, dy.view(2, 33, 512))
            torch.cuda.synchronize()
        finally:
            fbk.set_fused_ln_dense(False)
        assert (fbk.ln_dense_fwd.launches - before[0],
                fbk.ln_dense_bwd.launches - before[1]) == want
        assert y.shape == (2, 33, 512) and y.dtype == torch.bfloat16
        assert [g.dtype for g in grads] == [t.dtype for t in leaves]


def test_ln_dense_wrappers_reject_what_they_cannot_launch():
    torch = _cuda()
    from mla_tpu_torch.ops.fused_block import ln_dense_bwd, ln_dense_fwd

    x, s, b, w, db, dy = _ln(torch, 8, 48, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 32"):
        ln_dense_fwd(x, s, b, w, db)
    x, s, b, w, db, dy = _ln(torch, 8, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="dy must be"):
        ln_dense_bwd(x, s, b, w, dy.float())
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ln_dense_fwd(x.half(), s, b, w, db)
