"""The law of the bf16 wgmma kernels of csrc/ln_dense.cu (B7f, B7b), written
in torch on the CPU, against the JAX package's Pallas kernels
(``ln_dense_pallas`` / ``ln_dense_pallas_bwd`` in interpret mode) and the
port's plain versions (``ln_dense_reference`` / ``ln_dense_bwd_reference``).

What the law fixes, and the kernels do on the card:
- each row's statistics once (fp32, the fast variance), the LN output h =
  (x - m) * (r * scale) + bias in fp32, rounded to the compute type before
  its product; y = rnd(rnd(h . W^T) + rnd(dbias)) under bf16;
- dh = dy . W in fp32; dscale and dbias summed per row in the row pass's
  order (8 rows a warp, 4 warps a block of 32 rows, blocks in order);
- dW = dy^T . h (h rounded to dy's type) over the 64-row stages cut into
  ``splits`` runs [KT s / S, KT (s + 1) / S), each split's fp32 sum a
  partial, the partials added in split order; dc per (split, column tile
  ct of 128 of C) over the split's stages kt with kt % tiles == ct, per
  column in two row groups (the even rows of each stage, then stage after
  stage; the odd rows likewise), even + odd, then the partials in (split,
  tile) order.
Only the order of fp32 sums differs between the law, the kernels and the
plain versions, so the law must agree with both within the tolerances
below. Inputs come from numpy with a fixed seed; torch is imported inside
the tests.

Tolerances, the ones of tests/test_torch_port_fused_block.py: outputs fp32
1e-5, bf16 one bf16 ulp (atol 2e-2 + rtol 1e-2: an LN output or a sum near
a rounding boundary may round the other way); gradients fp32 2e-4 (sums of
up to 200 rows in another order), bf16 one bf16 ulp; dscale, dbias and dc
are fp32 sums in every case and keep the fp32 gradient tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import fused_block as fb

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}
GRAD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
            "bfloat16": dict(atol=2e-2, rtol=1e-2)}
F32_GRADS = ("dscale", "dbias", "dc")
NAMES = ("dx", "dscale", "dbias", "dW", "dc")
STAGE = 64                  # rows of a k-stage of the dW GEMM


def _data(n, c, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            (rng.standard_normal((c, f)) / np.sqrt(c)).astype(np.float32),
            (rng.standard_normal(f) * 0.1).astype(np.float32),
            rng.standard_normal((n, f)).astype(np.float32))


def _stats(torch, xf, eps):
    m = xf.mean(dim=-1, keepdim=True)
    v = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - m * m, 0.0)
    return m, torch.rsqrt(v + eps)


def _law_fwd(torch, x, scale, bias, w, dbias, eps, dt):
    """B7f's law: h rounded to dt before the product, fp32 sums, and under
    bf16 the sum and the bias each rounded before their sum is."""
    xf = x.float()
    m, r = _stats(torch, xf, eps)
    h = ((xf - m) * (r * scale) + bias).to(dt)
    acc = torch.matmul(h.float(), w.to(dt).float().t())
    if dt == torch.bfloat16:
        return (acc.to(dt).float() + dbias.to(dt).float()).to(dt)
    return acc + dbias


def _row_pass_sum(torch, terms):
    """Column sums in the row pass's order: 8 rows a warp one after
    another, the 4 warps of a 32-row block in order, the blocks in order."""
    n, c = terms.shape
    pad = -n % 32
    t = torch.cat([terms, terms.new_zeros(pad, c)]).view(-1, 4, 8, c)
    warp = t[:, :, 0]
    for i in range(1, 8):
        warp = warp + t[:, :, i]
    block = warp[:, 0]
    for k in range(1, 4):
        block = block + warp[:, k]
    out = block[0]
    for i in range(1, block.shape[0]):
        out = out + block[i]
    return out


def _law_bwd(torch, x, scale, bias, w, dy, eps, dt, splits):
    """B7b's law with dW and dc over ``splits`` row splits."""
    n = x.shape[0]
    xf = x.float()
    m, r = _stats(torch, xf, eps)
    xhat = (xf - m) * r
    dyf = dy.to(dt).float()
    dh = torch.matmul(dyf, w.to(dt).float())
    ds = _row_pass_sum(torch, dh * xhat)
    db = _row_pass_sum(torch, dh)
    dxh = dh * scale
    dx = r * (dxh - dxh.mean(dim=-1, keepdim=True)
              - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    h = ((xf - m) * (r * scale) + bias).to(dy.dtype).float()
    kt = -(-n // STAGE)
    tiles = -(-x.shape[1] // 128)
    assert 1 <= splits <= kt
    dyp = torch.cat([dyf, dyf.new_zeros(kt * STAGE - n, dyf.shape[1])])
    dw = dc = None
    for s in range(splits):
        k0, k1 = kt * s // splits, kt * (s + 1) // splits
        lo, hi = k0 * STAGE, min(k1 * STAGE, n)
        part = torch.matmul(dyf[lo:hi].t(), h[lo:hi])
        dw = part if dw is None else dw + part
        for ct in range(tiles):
            even = dyp.new_zeros(dyp.shape[1])
            odd = dyp.new_zeros(dyp.shape[1])
            for k in range(k0, k1):
                if k % tiles == ct:
                    for row in range(k * STAGE, (k + 1) * STAGE, 2):
                        even = even + dyp[row]
                        odd = odd + dyp[row + 1]
            part_c = even + odd
            dc = part_c if dc is None else dc + part_c
    return dx.to(x.dtype), ds, db, dw, dc


def _torch_inputs(torch, x, scale, bias, kernel, dbias, dy, dtype_name):
    dt = getattr(torch, dtype_name)
    t = torch.from_numpy
    return (t(x).to(dt), t(scale), t(bias),
            t(np.ascontiguousarray(kernel.T)), t(dbias), t(dy).to(dt), dt)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("n,c,f", [(40, 768, 2304), (37, 768, 2304),
                                   (37, 96, 160)])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_forward_law_matches_pallas_and_plain(n, c, f, dtype_name):
    import torch
    from mla_tpu_torch.ops.fused_block import ln_dense_reference

    x, scale, bias, kernel, dbias, dy = _data(n, c, f, seed=n + c)
    xt, st, bt, wt, dbt, _, dt = _torch_inputs(torch, x, scale, bias, kernel,
                                               dbias, dy, dtype_name)
    law = _law_fwd(torch, xt, st, bt, wt, dbt, 1e-5, dt)
    assert law.dtype == dt and law.shape == (n, f)
    plain = ln_dense_reference(xt, st, bt, wt, dbt, 1e-5, dt)
    np.testing.assert_allclose(law.float().numpy(), plain.float().numpy(),
                               **TOL[dtype_name])
    want = fb.ln_dense_pallas(jnp.asarray(x, dtype_name), scale, bias,
                              kernel, dbias, interpret=True)
    np.testing.assert_allclose(law.float().numpy(), _np(want),
                               **TOL[dtype_name])


@pytest.mark.parametrize("n,c,f,splits", [(40, 768, 2304, 1),
                                          (37, 768, 2304, 1),
                                          (200, 96, 160, 3),
                                          (200, 768, 2304, 2)])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_backward_law_matches_pallas_and_plain(n, c, f, splits, dtype_name):
    import torch
    from mla_tpu_torch.ops.fused_block import ln_dense_bwd_reference

    x, scale, bias, kernel, dbias, dy = _data(n, c, f, seed=3 * n + c)
    xt, st, bt, wt, _, dyt, dt = _torch_inputs(torch, x, scale, bias, kernel,
                                               dbias, dy, dtype_name)
    law = _law_bwd(torch, xt, st, bt, wt, dyt, 1e-5, dt, splits)
    plain = ln_dense_bwd_reference(xt, st, bt, wt, dyt, 1e-5, dt)
    want = fb.ln_dense_pallas_bwd(jnp.asarray(x, dtype_name), scale, bias,
                                  kernel, jnp.asarray(dy, dtype_name),
                                  interpret=True)
    for name, got, p, jw in zip(NAMES, law, plain, want):
        tol = GRAD_TOL["float32" if name in F32_GRADS else dtype_name]
        assert got.shape == p.shape and got.dtype == p.dtype, name
        np.testing.assert_allclose(got.float().numpy(), p.float().numpy(),
                                   err_msg=f"{name} vs plain", **tol)
        if name == "dW":            # the JAX kernel's dW is (C, F)
            jw = jnp.transpose(jw)
        np.testing.assert_allclose(got.float().numpy(), _np(jw),
                                   err_msg=f"{name} vs pallas", **tol)


@pytest.mark.parametrize("n,splits", [(200, 2), (200, 4), (129, 3)])
def test_dw_splits_sum_in_split_order(n, splits):
    """The split partials, each an fp32 sum over its own whole 64-row
    stages, added in split order, differ from one split only by fp32
    reassociation (bf16 dy and h, exact products)."""
    import torch

    x, scale, bias, kernel, dbias, dy = _data(n, 96, 160, seed=n)
    xt, st, bt, wt, _, dyt, dt = _torch_inputs(torch, x, scale, bias, kernel,
                                               dbias, dy, "bfloat16")
    one = _law_bwd(torch, xt, st, bt, wt, dyt, 1e-5, dt, 1)
    many = _law_bwd(torch, xt, st, bt, wt, dyt, 1e-5, dt, splits)
    for name, a, b in zip(NAMES, one, many):
        if name in ("dW", "dc"):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
        else:                       # no split touches them: the same bits
            assert torch.equal(a, b), name
