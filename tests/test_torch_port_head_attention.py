"""The port's head-layout attention (mla_tpu_torch/ops/attention.py:
``attention_reference`` and ``attention_bwd_reference``, the plain versions
of csrc/flat_attention.cu's and csrc/flat_attention_bwd.cu's (B, H, S, D)
entry points; ``HeadAttention``, the counterpart of the JAX package's
``_flash_mha``; the ``set_flat_attention`` switch) against the JAX package:
its Pallas head-chunked kernels in interpret mode, its q-blockwise kernel for
long sequences, ``jax.vjp`` of ``fused_attention``, and one MLA training
step with the flat kernels off. Inputs come from numpy with a fixed seed;
torch is imported inside the tests.

Tolerances. fp32: atol 2e-5 (tests/test_ops.py's for the kernels; the same
fp32 arithmetic, sums in another order). bf16: one bf16 ulp of the output's
scale (atol 2e-2 + rtol 1e-2, as the flat backward's test): a probability or
a ds near a rounding boundary may round the other way.

The Pallas kernels pad S to a multiple of 8 with masked keys, and the
backward does not zero ds at masked keys, so a batch row whose keys are ALL
masked differs from ``attention_reference`` unless S is a multiple of 8 (the
forward), and always in the backward; such rows are left out where they
differ, as the flat kernels' tests do. M3AE never builds one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import attention as jattn

FP32_ATOL = 2e-5
BF16_TOL = dict(atol=2e-2, rtol=1e-2)


def _inputs(b, h, s, d, seed=0, fully_masked_row=False, mask=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    m = (rng.random((b, s)) < 0.3).astype(np.float32)
    m[:, 0] = 0.0                         # every row keeps a live key
    if fully_masked_row:
        m[-1, :] = 1.0
    return q, k, v, do, (m if mask else None)


def _t(x, dtype=None):
    import torch
    t = torch.from_numpy(x)
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = [  # (b, h, s, d, fully masked row, mask given)
    (2, 4, 16, 16, True, True),      # S a multiple of 8: every row agrees
    (2, 4, 9, 16, False, True),
    (2, 4, 9, 16, False, False),     # no mask
    (1, 3, 40, 32, False, True),     # a prime head count
]


@pytest.mark.parametrize("b,h,s,d,full,masked", CASES)
def test_plain_forward_matches_pallas_heads_fp32(b, h, s, d, full, masked):
    from mla_tpu_torch.ops.attention import attention_reference

    q, k, v, _, m = _inputs(b, h, s, d, seed=s + h, fully_masked_row=full,
                            mask=masked)
    want = _np(jattn.flash_attention(_j(q), _j(k), _j(v), _j(m),
                                     interpret=True))
    got = attention_reference(_t(q), _t(k), _t(v),
                              None if m is None else _t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("b,h,s,d,full,masked", CASES[1:])
def test_plain_forward_matches_pallas_heads_bf16(b, h, s, d, full, masked):
    import torch
    from mla_tpu_torch.ops.attention import attention_reference

    q, k, v, _, m = _inputs(b, h, s, d, seed=s + h + 1, mask=masked)
    bf = jnp.bfloat16
    want = _np(jattn.flash_attention(_j(q, bf), _j(k, bf), _j(v, bf), _j(m),
                                     interpret=True))
    got = attention_reference(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                              None if m is None else _t(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("b,h,s,d,full,masked", CASES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_heads(b, h, s, d, full, masked,
                                             dtype_name):
    """Rows with a live key (the Pallas backward does not zero ds at masked
    keys, so a fully masked row differs there)."""
    import torch
    from mla_tpu_torch.ops.attention import attention_bwd_reference

    q, k, v, do, m = _inputs(b, h, s, d, seed=2 * s + h,
                             fully_masked_row=full, mask=masked)
    jm = _j(m) if m is not None else jnp.zeros((b, s), jnp.float32)
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    want = jattn.flash_attention_bwd(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                                     _j(do, jdt), jm, interpret=True)
    dt = getattr(torch, dtype_name)
    got = attention_bwd_reference(*(_t(x, dt) for x in (q, k, v, do)),
                                  None if m is None else _t(m))
    live = [i for i in range(b) if m is None or m[i].min() == 0.0]
    assert len(live) == b - int(full)
    tol = dict(atol=FP32_ATOL, rtol=1e-5) if dtype_name == "float32" \
        else BF16_TOL
    for g, w in zip(got, want):
        assert g.dtype == dt and tuple(g.shape) == (b, h, s, d)
        np.testing.assert_allclose(g.float().numpy()[live], _np(w)[live],
                                   **tol)
    if full:   # the reference's VJP: dq = dk = 0 on that row, dv = mean dO
        np.testing.assert_array_equal(got[0][-1].float().numpy(), 0.0)
        np.testing.assert_allclose(
            got[2][-1].float().numpy(),
            np.broadcast_to(do[-1].mean(axis=1, keepdims=True), do[-1].shape),
            atol=1e-6 if dtype_name == "float32" else 2e-2)


def test_qblockwise_law_equal_in_fp32_and_its_bf16_difference(monkeypatch):
    """The JAX package takes its q-blockwise kernel where even one head's
    scores outgrow VMEM (the budget is shrunk so it engages at a test
    shape): it upcasts q, k and v and never rounds P. The port keeps the
    head-chunked law at every length. In fp32 the two agree; in bf16 they
    differ by less than one bf16 ulp of the output's scale (measured here:
    0.0039 at max |out| 0.70, 0.72 ulp), bounded at 1.5 ulps."""
    import torch
    from mla_tpu_torch.ops.attention import attention_reference

    monkeypatch.setattr(jattn, "_SCORE_VMEM_BUDGET", 1024)
    b, h, s, d = 1, 3, 136, 16          # a shape no other test traces
    q, k, v, _, m = _inputs(b, h, s, d, seed=11)
    want = _np(jattn.flash_attention(_j(q), _j(k), _j(v), _j(m),
                                     interpret=True))
    got = attention_reference(_t(q), _t(k), _t(v), _t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)

    bf = jnp.bfloat16
    want = _np(jattn.flash_attention(_j(q, bf), _j(k, bf), _j(v, bf), _j(m),
                                     interpret=True))
    got = attention_reference(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                              _t(m)).float().numpy()
    diff = np.abs(got - want).max()
    ulp = 2.0 ** -7 * np.abs(want).max()
    assert 0 < diff <= 1.5 * ulp, (diff, ulp)


def test_long_sequence_backward_law_against_the_reference_vjp():
    """Beyond 1024 tokens the JAX package's backward is the VJP of
    attention_reference (no rounding of ds or P); the port keeps the kernel
    law at every length. The laws are the same in fp32; in bf16 they differ
    by under one bf16 ulp of each gradient's scale (measured here: dq 0.39,
    dk 0.74, dv 0 ulps), bounded at 1.5; the law, not the length, sets it,
    so a short S shows it."""
    import torch
    from mla_tpu_torch.ops.attention import attention_bwd_reference

    b, h, s, d = 1, 2, 40, 16
    q, k, v, do, m = _inputs(b, h, s, d, seed=12)
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        _, pull = jax.vjp(lambda q_, k_, v_: jattn.attention_reference(
            q_, k_, v_, _j(m)), _j(q, jdt), _j(k, jdt), _j(v, jdt))
        want = pull(_j(do, jdt))
        got = attention_bwd_reference(*(_t(x, dt) for x in (q, k, v, do)),
                                      _t(m))
        for g, w in zip(got, want):
            g, w = g.float().numpy(), _np(w)
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=1e-5)
            else:
                ulp = 2.0 ** -7 * np.abs(w).max()
                assert np.abs(g - w).max() <= 1.5 * ulp


def test_head_attention_grads_match_jax_vjp_of_fused_attention():
    """HeadAttention on the CPU (plain forward and backward) against
    jax.vjp of the JAX package's fused_attention, fp32, every row."""
    import torch
    from mla_tpu_torch.ops.attention import HeadAttention

    q, k, v, do, m = _inputs(2, 4, 16, 16, seed=13, fully_masked_row=True)
    out, pull = jax.vjp(lambda q_, k_, v_: jattn.fused_attention(
        q_, k_, v_, _j(m)), _j(q), _j(k), _j(v))
    want = pull(_j(do))
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    got_out = HeadAttention.apply(*ts, _t(m), None)
    got = torch.autograd.grad(got_out, ts, _t(do))
    np.testing.assert_allclose(got_out.detach().numpy(), _np(out),
                               atol=FP32_ATOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=FP32_ATOL,
                                   rtol=1e-5)


def test_head_attention_saves_nothing_without_grad():
    import torch
    from mla_tpu_torch.ops.attention import fused_attention

    q, k, v, _, m = _inputs(1, 2, 9, 16, seed=14)
    with torch.inference_mode():
        out = fused_attention(_t(q), _t(k), _t(v), _t(m))
    assert out.grad_fn is None and out.shape == (1, 2, 9, 16)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_attention_qkv_switch_off_equals_switch_on(dtype_name):
    """The head route (switch off) lays the projection out as (3, B, H, S,
    D), runs HeadAttention and lays the result back: the same output and
    d(qkv) as the flat route, and the switch is restored."""
    import torch
    from mla_tpu_torch.ops import attention

    rng = np.random.default_rng(15)
    b, s, h, d = 2, 9, 4, 16
    dt = getattr(torch, dtype_name)
    qkv_np = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    g = _t(rng.standard_normal((b, s, h * d)).astype(np.float32), dt)
    m = np.zeros((b, s), np.float32)
    m[0, 5:] = 1.0
    res = {}
    for flat in (True, False):
        x = _t(qkv_np, dt).requires_grad_()
        attention.set_flat_attention(flat)
        try:
            out = attention.fused_attention_qkv(x, _t(m), h)
        finally:
            attention.set_flat_attention(True)
        res[flat] = (out.detach(), torch.autograd.grad(out, x, g)[0])
    assert attention._FLAT_ENABLED
    assert torch.equal(res[True][0], res[False][0])
    assert torch.equal(res[True][1], res[False][1])


def test_wrappers_take_cuda_tensors_only():
    from mla_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_bwd)

    q, k, v, do, m = (_t(x) for x in _inputs(1, 2, 9, 16, seed=16))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, m)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, v, do, m)
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


# ----------------------------------------------- one MLA step, head route

VOCAB, L, IMG, NB = 256, 8, 32, 4


def _batch():
    rng = np.random.default_rng(0)
    pm = np.zeros((NB, L), np.float32)
    pm[0, 5:] = 1.0
    pm[2, 1:] = 1.0
    return {"token": rng.integers(0, VOCAB, (NB, L)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((NB, 3, IMG, IMG)).astype(np.float32),
            "label": rng.integers(0, 101, NB).astype(np.int32),
            "valid": np.array([1, 1, 1, 0], np.float32)}


def test_mla_step_with_flat_kernels_off_matches_jax(monkeypatch):
    """One debug-size MLA step (ghost updates, fp32) with the flat route off
    in the port, from the JAX package's initial weights and state, against
    the JAX step (which on the CPU takes the (B, H, S, D) reference either
    way). tests/test_torch_port_train.py's one-step tolerances: parameters
    and momentum atol 1e-5 + rtol 1e-4, losses 1e-5 relative."""
    import torch
    from mla_tpu.core.config import MLAConfig as JConfig
    from mla_tpu.models.classifiers import build_classifier as jax_build
    from mla_tpu.train import optim as joptim
    from mla_tpu.train import steps as jsteps
    from mla_tpu.train.state import create_train_state as jax_create_state
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models import convert
    from mla_tpu_torch.models.classifiers import (M3AEClassifier,
                                                  classifier_kwargs)
    from mla_tpu_torch.ops import attention
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    torch.set_num_threads(1)
    kw = dict(dataset="Food101", lorb="m3ae", m3ae_size="debug",
              compute_dtype="float32", batch_size=NB, train=True,
              gs_flag=True)
    jcfg = JConfig(**kw).validate()
    jmodel = jax_build(jcfg).clone(text_vocab_size=VOCAB)
    jspec = joptim.make_spec(jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    jstate = jax_create_state(jmodel, jcfg, jb, jspec, n_data=10, seed=0)
    cfg = MLAConfig(**kw).validate()
    with torch.device("meta"):
        model = M3AEClassifier(text_vocab_size=VOCAB, **classifier_kwargs(cfg))
    model.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), cfg), strict=True,
        assign=True)
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, n_data=10, seed=0,
                               device="cpu")
    state.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state), cfg)
    state.gs = convert.gs_state_from_jax(jstate.gs)

    lr = 0.05
    jstate, jm = jax.jit(jsteps.make_train_step(jmodel, jcfg, jspec, 4))(
        jstate, jb, jnp.float32(lr), jnp.int32(1), jnp.int32(0))
    calls = []
    real = attention.fused_attention
    monkeypatch.setattr(attention, "fused_attention",
                        lambda *a: calls.append(1) or real(*a))
    attention.set_flat_attention(False)
    try:
        state, m = make_train_step(model, cfg, spec, 4)(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()},
            lr, 1, 0)
    finally:
        attention.set_flat_attention(True)
    depth = len(model.mae_a.encoder.blocks)
    assert len(calls) == 2 * depth      # each sub-step: one encoder's blocks
    for k in ("loss", "loss_a", "loss_v"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for jtree, ttree, what in (
            (jstate.params, state.params, "params"),
            (jstate.opt_state["momentum"], state.opt_state["momentum"],
             "momentum")):
        want = convert.state_dict_from_jax(
            convert._tree_f32(jax.tree.map(np.asarray, jtree)), cfg)
        assert set(want) == set(ttree), what
        for n, w in want.items():
            np.testing.assert_allclose(ttree[n].detach().float().numpy(),
                                       w.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=f"{what}: {n}")
