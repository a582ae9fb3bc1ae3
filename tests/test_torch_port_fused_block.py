"""The port's fused LayerNorm -> Dense op (mla_tpu_torch/ops/fused_block.py:
the plain versions of csrc/ln_dense.cu's B7f and B7b, ``LnDense``, the
``set_fused_ln_dense`` switch and ``ln_dense``) against the JAX package's
mla_tpu/ops/fused_block.py: its flax-exact references, its Pallas kernels in
interpret mode, and ``jax.grad`` of its ``_ln_dense_fused`` custom VJP with
``fb._INTERPRET`` set (as tests/test_fused_block.py does). Inputs come from
numpy with a fixed seed; the port's weight is the (F, C) transpose of the
JAX (C, F) kernel. torch is imported inside the tests.

Tolerances. fp32: rtol/atol 2e-4 for gradients (tests/test_fused_block.py's)
and 1e-5 for outputs; sums run in another order (the LayerNorm statistics
too), nothing else differs. bf16: one bf16 ulp of the value (atol 2e-2 +
rtol 1e-2): an LN output or a GEMM sum near a rounding boundary may round
the other way; the fp32 gradients of the LN parameters (dscale, dbias) and
of the Dense bias (dc) come from fp32 sums of the same bf16 products and
keep the fp32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import fused_block as fb

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}
GRAD_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
            "bfloat16": dict(atol=2e-2, rtol=1e-2)}
F32_GRADS = ("dscale", "dbias", "dc")    # fp32 sums in every case


def _data(n=48, c=64, f=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c)).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    kernel = (rng.standard_normal((c, f)) * 0.05).astype(np.float32)
    dbias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    dy = rng.standard_normal((n, f)).astype(np.float32)
    return x, scale, bias, kernel, dbias, dy


def _port(x, scale, bias, kernel, dbias, dtype_name=None):
    """numpy -> the port's tensors (x in dtype_name, the weight (F, C))."""
    import torch
    t = torch.from_numpy
    xt = t(x) if dtype_name is None else t(x).to(getattr(torch, dtype_name))
    return xt, t(scale), t(bias), t(np.ascontiguousarray(kernel.T)), t(dbias)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("x_dtype,dtype", [("float32", None),
                                           ("bfloat16", None),
                                           ("float32", "bfloat16")])
def test_ln_reference_matches_jax(x_dtype, dtype):
    import torch
    from mla_tpu_torch.ops.fused_block import ln_reference

    x, scale, bias, kernel, dbias, _ = _data()
    want = fb.ln_reference(jnp.asarray(x, x_dtype), scale, bias, 1e-5,
                           dtype and jnp.dtype(dtype))
    xt, st, bt, _, _ = _port(x, scale, bias, kernel, dbias, x_dtype)
    got = ln_reference(xt, st, bt, 1e-5, dtype and getattr(torch, dtype))
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **TOL[dtype or x_dtype])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_dense_reference_matches_jax(dtype_name):
    from mla_tpu_torch.ops.fused_block import dense_reference

    x, scale, bias, kernel, dbias, _ = _data(seed=1)
    want = fb.dense_reference(jnp.asarray(x, dtype_name), kernel, dbias)
    xt, _, _, wt, dt = _port(x, scale, bias, kernel, dbias, dtype_name)
    got = dense_reference(xt, wt, dt)
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **TOL[dtype_name])


@pytest.mark.parametrize("n", [48, 37])          # 37: rows off the block
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ln_dense_forward_matches_pallas_interpret(n, dtype_name):
    """``ln_dense`` with the switch on (LnDense's plain forward on the CPU)
    against B7f in interpret mode, which pads the rows to its block."""
    from mla_tpu_torch.ops import fused_block

    x, scale, bias, kernel, dbias, _ = _data(n=n, seed=2)
    want = fb.ln_dense_pallas(jnp.asarray(x, dtype_name), scale, bias,
                              kernel, dbias, interpret=True)
    fused_block.set_fused_ln_dense(True)
    try:
        got = fused_block.ln_dense(*_port(x, scale, bias, kernel, dbias,
                                          dtype_name))
    finally:
        fused_block.set_fused_ln_dense(False)
    assert got.grad_fn is None and str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **TOL[dtype_name])


def _port_grads(x, scale, bias, kernel, dbias, dy, dtype_name):
    """(dx, dscale, dbias, dW^T, dc) through LnDense on the CPU."""
    import torch
    from mla_tpu_torch.ops.fused_block import LnDense

    ts = [t.requires_grad_() for t in _port(x, scale, bias, kernel, dbias,
                                            dtype_name)]
    out = LnDense.apply(*ts, 1e-5, ts[0].dtype)
    g = torch.from_numpy(dy).to(out.dtype)
    dx, ds, db, dw, dc = torch.autograd.grad(out, ts, g)
    for grad, t in zip((dx, ds, db, dw, dc), ts):
        assert grad.dtype == t.dtype       # the parameters' types
    return [t.float().numpy() for t in (dx, ds, db, dw.t(), dc)]


@pytest.mark.parametrize("n", [48, 37])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ln_dense_grads_match_pallas_bwd_interpret(n, dtype_name):
    x, scale, bias, kernel, dbias, dy = _data(n=n, seed=3)
    want = fb.ln_dense_pallas_bwd(jnp.asarray(x, dtype_name), scale, bias,
                                  kernel, jnp.asarray(dy, dtype_name),
                                  interpret=True)
    got = _port_grads(x, scale, bias, kernel, dbias, dy, dtype_name)
    for name, g, w in zip(("dx", "dscale", "dbias", "dW", "dc"), got, want):
        tol = GRAD_TOL["float32" if name in F32_GRADS else dtype_name]
        np.testing.assert_allclose(g, _np(w), err_msg=name, **tol)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ln_dense_grads_match_jax_grad_of_fused_vjp(dtype_name,
                                                    monkeypatch):
    """jax.grad through the JAX custom VJP (its kernels in interpret mode)
    of sum(sin(y)), against the port's autograd through LnDense."""
    import torch
    from mla_tpu_torch.ops.fused_block import LnDense

    monkeypatch.setattr(fb, "_INTERPRET", True)
    x, scale, bias, kernel, dbias, _ = _data(seed=4)
    dt = jnp.dtype(dtype_name)

    def f(x_, s, b, k, d):
        return jnp.sum(jnp.sin(fb._ln_dense_fused(x_, s, b, k, d, 1e-5, dt)
                               .astype(jnp.float32)))

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x, dt), scale, bias, kernel, dbias)
    ts = [t.requires_grad_() for t in _port(x, scale, bias, kernel, dbias,
                                            dtype_name)]
    torch.sin(LnDense.apply(*ts, 1e-5, ts[0].dtype).float()).sum().backward()
    got = [t.grad for t in ts]
    got[3] = got[3].t()
    for name, g, w in zip(("dx", "dscale", "dbias", "dW", "dc"), got, want):
        assert str(g.dtype) == f"torch.{w.dtype}", name
        tol = GRAD_TOL["float32" if name in F32_GRADS else dtype_name]
        np.testing.assert_allclose(g.float().numpy(), _np(w), err_msg=name,
                                   **tol)


def test_switch_off_is_the_reference_composition():
    """Off (the default): the LayerNorm and Dense composition, equal to the
    JAX package's ln_dense on the CPU (its reference path), on a batched
    (..., C) input; nothing is fused and the result is differentiable."""
    import torch
    from mla_tpu_torch.ops import fused_block

    assert not fused_block._FUSED_ENABLED
    x, scale, bias, kernel, dbias, _ = _data(seed=5)
    x3 = x.reshape(4, 12, -1)
    want = fb.ln_dense(jnp.asarray(x3), scale, bias, kernel, dbias)
    xt, st, bt, wt, dt = _port(x3, scale, bias, kernel, dbias)
    got = fused_block.ln_dense(xt.requires_grad_(), st, bt, wt, dt)
    assert got.shape == (4, 12, kernel.shape[1]) and got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), _np(want),
                               **TOL["float32"])
    plain = fused_block.ln_dense_reference(xt.reshape(48, -1), st, bt, wt,
                                           dt)
    assert torch.equal(got.detach().reshape(48, -1), plain.detach())


def test_kernel_wrappers_take_cuda_tensors_only():
    import torch
    from mla_tpu_torch.ops.fused_block import ln_dense_bwd, ln_dense_fwd

    x, scale, bias, kernel, dbias, dy = _data(seed=6)
    xt, st, bt, wt, dt = _port(x, scale, bias, kernel, dbias)
    before = (ln_dense_fwd.launches, ln_dense_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ln_dense_fwd(xt, st, bt, wt, dt)
    with pytest.raises(ValueError, match="CUDA"):
        ln_dense_bwd(xt, st, bt, wt, torch.from_numpy(dy))
    assert (ln_dense_fwd.launches, ln_dense_bwd.launches) == before
