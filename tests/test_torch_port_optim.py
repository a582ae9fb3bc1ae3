"""The port's optimizer and GS plugin (mla_tpu_torch/train/optim.py, gs.py)
against the JAX package's (mla_tpu/train/optim.py, gs.py), on small trees
drawn from numpy with a fixed seed. torch is imported inside the tests.

Tolerances. Parameters and fp32 moments: rtol 1e-6 (the same fp32 update,
written as torch foreach ops instead of one XLA graph). bf16 moments are the
same rounding of the same fp32 value, held to one bf16 ulp (rtol 2^-7) in
case an fp32 difference of one ulp lands on a rounding boundary. GS: rtol
1e-5 (a (D, D) projector from matrix products summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.train import gs as jgs
from mla_tpu.train import optim as joptim

SHAPES = {"mae_a.blocks.0.fc.weight": (5, 3), "mae_a.cls_token": (4,),
          "mae_v.blocks.0.fc.weight": (3, 5),
          "fusion_module.fc_out.weight": (2, 6),
          "fusion_module.fc_out.bias": (2,)}
HEAD = ("fusion_module.fc_out.weight", "fusion_module.fc_out.bias")
NO_GRAD = "mae_a.cls_token"     # REAL leaf the loss does not reach
LR = 0.05


def _modes(mode):
    return {n: 0 if n in HEAD else mode for n in SHAPES}


def _scales():
    return {n: 1.0 if n == "fusion_module.fc_out.weight" else 0.1
            for n in SHAPES}


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [joptim.REAL, joptim.GHOST, joptim.SKIP],
                         ids=["real", "ghost", "skip"])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_apply_updates_matches_jax(kind, mode, opt_dtype):
    """Three steps with lr scales: the head is REAL, the encoders take
    ``mode``; one REAL leaf has no gradient (None here, zeros in JAX)."""
    import torch
    from mla_tpu_torch.train import optim

    rng = np.random.default_rng(0)
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in SHAPES.items()}
    kw = dict(kind=kind, weight_decay=1e-2, state_dtype=opt_dtype)
    jspec = joptim.OptimizerSpec(lr_scales=_scales(), **kw)
    spec = optim.OptimizerSpec(lr_scales=_scales(), **kw)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jopt = joptim.init_opt_state(jspec, jp)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    topt = optim.init_opt_state(spec, tp)
    for _ in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in SHAPES.items()}
        g[NO_GRAD] = np.zeros(SHAPES[NO_GRAD], np.float32)
        jp, jopt = joptim.apply_updates(
            jspec, jp, {n: jnp.asarray(v) for n, v in g.items()}, jopt,
            jnp.float32(LR), _modes(mode))
        tg = {n: torch.from_numpy(v) for n, v in g.items()}
        tg[NO_GRAD] = None
        optim.apply_updates(spec, tp, tg, topt, LR, _modes(mode))
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        if mode == joptim.SKIP and n not in HEAD:
            np.testing.assert_array_equal(tp[n].numpy(), p0[n])
    moments = ("momentum",) if kind == "sgd" else ("m", "v")
    rtol = 1e-6 if opt_dtype == "float32" else 2.0 ** -7
    for key in moments:
        for n in SHAPES:
            got = topt[key][n]
            assert got.dtype == getattr(torch, opt_dtype)
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(jopt[key][n], np.float32),
                rtol=rtol, atol=1e-7, err_msg=f"{key} {n}")
    if kind == "adam":
        assert topt["t"] == {n: int(jopt["t"][n]) for n in SHAPES}


def _cfg_pair(**kw):
    from mla_tpu_torch.core.config import MLAConfig

    return JConfig(**kw).validate(), MLAConfig(**kw).validate()


@pytest.mark.parametrize("kw", [
    dict(dataset="Food101", lorb="m3ae"),
    dict(dataset="Food101", lorb="m3ae", optimizer="adam"),
    dict(dataset="Food101", lorb="m3ae", opt_dtype="bfloat16"),
    dict(dataset="CREMAD", lorb="large", cav_opti=True),
], ids=["sgd", "adam", "sgd_bf16_state", "cav_opti"])
def test_make_spec_matches_jax(kw):
    """The same optimizer and hyper-parameters; under --cav_opti the full lr
    goes to the head's weight only (the reference's stray 'module.' prefix
    leaves the bias at lr/10)."""
    from mla_tpu_torch.train import optim

    jcfg, cfg = _cfg_pair(**kw)
    jparams = {"fusion_module": {"fc_out": {"kernel": jnp.zeros((6, 2)),
                                            "bias": jnp.zeros((2,))}},
               "mae_a": {"cls_token": jnp.zeros((4,))}}
    names = ("fusion_module.fc_out.weight", "fusion_module.fc_out.bias",
             "mae_a.cls_token")
    jspec = joptim.make_spec(jcfg, jparams)
    spec = optim.make_spec(cfg, names)
    for field in ("kind", "momentum", "weight_decay", "b1", "b2", "eps",
                  "state_dtype"):
        assert getattr(spec, field) == getattr(jspec, field), field
    if jspec.lr_scales is None:
        assert spec.lr_scales is None
    else:
        js = jspec.lr_scales
        assert spec.lr_scales == {
            names[0]: js["fusion_module"]["fc_out"]["kernel"],
            names[1]: js["fusion_module"]["fc_out"]["bias"],
            names[2]: js["mae_a"]["cls_token"]}
        assert spec.lr_scales[names[0]] == 1.0
        assert spec.lr_scales[names[1]] == 0.1


@pytest.mark.parametrize("kw", [
    dict(dataset="Food101", lorb="m3ae", learning_rate=0.01,
         lr_decay_step=30, lr_decay_ratio=0.5),
    dict(dataset="CREMAD", lorb="large", cav_lrs=True, learning_rate=1e-4),
], ids=["step_lr", "cav_multistep"])
def test_lr_for_epoch_matches_jax(kw):
    from mla_tpu_torch.train import optim

    jcfg, cfg = _cfg_pair(**kw)
    for epoch in (0, 1, 2, 3, 29, 30, 61, 100, 999, 1200):
        assert optim.lr_for_epoch(cfg, epoch) == \
            joptim.lr_for_epoch(jcfg, epoch), epoch


def test_modality_mode_tree_matches_jax():
    """REAL for the current modality and the head, GHOST for encoders
    stepped earlier in the batch (when ghost updates are on), SKIP else."""
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import modality_of_path
    from mla_tpu.train.state import modality_of_path as jmodality_of_path

    jtree = {"mae_a": {"w": 0}, "mae_v": {"w": 0},
             "fusion_module": {"kernel": 0}, "other": {"w": 0}}
    names = ("mae_a.w", "mae_v.w", "fusion_module.weight", "other.w")
    for current, stepped in (("a", ()), ("v", ("a",))):
        for ghost in (True, False):
            want = joptim.modality_mode_tree(jtree, jmodality_of_path,
                                             current, stepped, ghost)
            got = optim.modality_mode_tree(names, modality_of_path, current,
                                           stepped, ghost)
            assert got == {"mae_a.w": want["mae_a"]["w"],
                           "mae_v.w": want["mae_v"]["w"],
                           "fusion_module.weight":
                               want["fusion_module"]["kernel"],
                           "other.w": want["other"]["w"]}


@pytest.mark.parametrize("rls,exp_count", [(False, 0), (False, 3),
                                           (True, 0), (True, 1), (True, 4)])
def test_gs_before_update_matches_jax(rls, exp_count):
    """Dead mode leaves Pl and the gradient alone; RLS mode skips the first
    sub-step (exp_count == 0) and projects after it. The head weight's
    gradient is (C, D) in torch and (D, C) as a flax kernel."""
    import torch
    from mla_tpu_torch.train import gs

    rng = np.random.default_rng(exp_count)
    d, c = 8, 3
    # positive features keep every alpha + r_i r_j denominator above alpha
    feats = (rng.random((4, d)) + 0.5).astype(np.float32)
    pl = (np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(np.float32)
    grad = rng.standard_normal((c, d)).astype(np.float32)
    jstate = jgs.GSState(Pl=jnp.asarray(pl),
                         exp_count=jnp.asarray(exp_count, jnp.int32))
    jnew, jgrad = jgs.gs_before_update(jstate, jnp.asarray(feats),
                                       jnp.asarray(grad.T), jnp.int32(2), 5,
                                       rls)
    new, tgrad = gs.gs_before_update(
        gs.GSState(Pl=torch.from_numpy(pl), exp_count=exp_count),
        torch.from_numpy(feats), torch.from_numpy(grad), 2, 5, rls)
    assert new.exp_count == int(jnew.exp_count) == exp_count + 1
    np.testing.assert_allclose(new.Pl.numpy(), np.asarray(jnew.Pl),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad).T,
                               rtol=1e-5, atol=1e-6)
    if not rls or exp_count == 0:
        np.testing.assert_array_equal(new.Pl.numpy(), pl)
        np.testing.assert_array_equal(tgrad.numpy(), grad)
    else:
        assert np.abs(new.Pl.numpy() - pl).max() > 1e-3   # RLS ran


def test_init_gs_state_is_identity():
    import torch
    from mla_tpu_torch.train import gs

    state = gs.init_gs_state(6, device="cpu")
    assert state.exp_count == 0
    assert torch.equal(state.Pl, torch.eye(6))
