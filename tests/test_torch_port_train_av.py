"""The port's training path on the CREMA-D AVClassifier (2x ResNet-18)
against the JAX package's: from identical weights, BatchNorm statistics,
optimizer state and batch, the MLA step (ghost updates on and off,
--masked_bn, --grad_accum 2, --pallas_conv on), the joint step (Normal, OGM,
OGM_GE) and the QMF step (the base path's loss, cml + clf + 0.1*crl) leave
the same parameters, momentum, BatchNorm running statistics and losses; the
eval step's counts match on the running statistics.

This family is where OGM acts (the reference scales the 4-D gradients of
modules named 'audio'/'visual') and where QMF takes the base path, so these
are the port's first checks of both against the JAX package.

Debug size: stages 1,1,1,1 (full widths), a (1, 33, 40) spectrogram, 2
frames of 32x32, batch 4 with one padded row, 6 classes, on the CPU, where
--pallas_conv on runs the conv's plain forward and its own backward (dx on
the rotated weight, dw by PyTorch's weight-gradient) and the JAX package
takes lax.conv.

Compute type. A ReLU's gradient flips where its input lies within rounding
of 0: in fp32 the two packages' sums in other orders put some of the ~3e5
ReLU inputs of a debug step on other sides of 0 (measured: one such input
in layer1 moves the stem's gradient by ~1%, and a float64 run of the port
sides with JAX). So the step comparisons run both packages with float32
master weights, optimizer state and losses (as in training) but float64
activations (JAX under jax.enable_x64 with a float64 model; the port with
compute type float64): the gradients then agree to ~1e-12 before they round
to the float32 parameters' type. One fp32 step is held on what no ReLU mask
reaches (losses, running statistics, the head).

Tolerances (float64 activations): parameters and momentum atol 1e-6 times
the tensor's largest entry (at least 1e-6) + rtol 1e-5 (a gradient may round
to the next float32), 3e-6 + 3e-5 after three steps (updates compound);
running statistics and losses 1e-6 relative (float32 buffers and losses).
fp32: 1e-5 relative. OGM_GE draws its noise from another generator than
JAX's: its coefficients and every gradient it leaves unscaled are held as
above, and the noise itself by its law.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.evals.metrics import make_eval_step as jax_make_eval_step
from mla_tpu.evals.metrics import summarize_counts as jax_summarize
from mla_tpu.models.classifiers import build_classifier as jax_build
from mla_tpu.train import optim as joptim
from mla_tpu.train import steps as jsteps
from mla_tpu.train.state import create_train_state as jax_create_state

STAGES = (1, 1, 1, 1)
NB, T, IMG, SPEC, NDATA = 4, 2, 32, (33, 40), 10
LR = 0.05
BATCH_SEED = 0
TOL = {1: (1e-6, 1e-5), 3: (3e-6, 3e-5)}      # (atol, rtol) by step count
LOSS_RTOL = 1e-6


def _batch(seed=BATCH_SEED):
    rng = np.random.default_rng(seed)
    return {"spec": rng.standard_normal((NB, 1) + SPEC).astype(np.float32),
            "image": rng.standard_normal((NB, 3, T, IMG, IMG)).astype(
                np.float32),
            "label": rng.integers(0, 6, NB).astype(np.int32),
            "valid": np.array([1, 1, 1, 0], np.float32),
            "idx": np.array([3, 7, 1, NDATA], np.int32)}


def _cfg_kwargs(**kw):
    base = dict(dataset="CREMAD", lorb="base", compute_dtype="float32",
                resnet_stages=STAGES, batch_size=NB, train=True)
    base.update(kw)
    return base


_INITIAL = {}


def _pair(compute="float64", **kw):
    """(JAX model, cfg, spec, state) and (port model, cfg, spec, state)
    from the same JAX-initialised weights, statistics and state; the models
    compute in ``compute``."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models import convert
    from mla_tpu_torch.models.classifiers import make_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    jcfg = JConfig(**_cfg_kwargs(**kw)).validate()
    jmodel = jax_build(jcfg, dtype=getattr(jnp, compute))
    jspec = joptim.make_spec(jcfg)
    # the initial state depends on the head (gs or concat) and, for QMF, its
    # heads and stores; jitted, flax's init of two ResNets takes seconds
    key = (jcfg.gs_flag, jcfg.modulation == "QMF")
    if key not in _INITIAL:
        jb = {k: jnp.asarray(v) for k, v in _batch().items()}
        _INITIAL[key] = jax.jit(lambda b: jax_create_state(
            jmodel, jcfg, b, jspec, n_data=NDATA, seed=0))(jb)
    # float32 weights either way; the statistics in the activations' type
    # (flax promotes them to it, and --grad_accum's scan carry must keep it)
    jstate = _INITIAL[key]
    jstate = jstate.replace(batch_stats=jax.tree.map(
        lambda a: jnp.asarray(a, getattr(jnp, compute)), jstate.batch_stats))

    cfg = MLAConfig(**_cfg_kwargs(**kw)).validate()
    model = make_classifier(cfg)
    model.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), cfg,
        jax.tree.map(np.asarray, jstate.batch_stats)),
        strict=True, assign=True)
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, n_data=NDATA, seed=0,
                               device="cpu")
    model.set_compute_dtype(getattr(torch, compute))
    state.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state), cfg)
    if jstate.gs is not None:
        state.gs = convert.gs_state_from_jax(jstate.gs)
    if jstate.qmf is not None:
        state.qmf = convert.qmf_state_from_jax(jstate.qmf)
    return (jmodel, jcfg, jspec, jstate), (model, cfg, spec, state)


def _snapshot(state):
    import copy
    return {"params": {n: t.detach().clone() for n, t in state.params.items()},
            "buffers": {n: t.clone() for n, t in
                        state.model.named_buffers()},
            "opt_state": copy.deepcopy(state.opt_state),
            "qmf": copy.deepcopy(state.qmf)}


_TRAJECTORIES = {}


def _trajectory(compute="float64", **kw):
    """Three steps of both packages on the same batch, from one pair (built
    once per configuration and shared by the tests that read it)."""
    key = (compute,) + tuple(sorted(kw.items()))
    if key in _TRAJECTORIES:
        return _TRAJECTORIES[key]
    import torch
    from mla_tpu_torch.train.steps import make_train_step

    with jax.enable_x64(compute == "float64"):
        pair = _pair(compute, **kw)
        (jmodel, jcfg, jspec, jstate), (model, cfg, spec, state) = pair
        jstep = jax.jit(jsteps.make_train_step(jmodel, jcfg, jspec, 4))
        step = make_train_step(model, cfg, spec, 4)
        jb = {k: jnp.asarray(v) for k, v in _batch().items()}
        tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
        out = {"pair": pair}
        for i in (1, 2, 3):
            jstate, jm = jstep(jstate, jb, jnp.float32(LR), jnp.int32(1),
                               jnp.int32(0))
            state, m = step(state, tb, LR, 1, 0)
            if i != 2:
                out[i] = (jstate, jm, _snapshot(state), m)
    _TRAJECTORIES[key] = out
    return out


def _assert_params(cfg, jtree, ttree, atol, rtol, what, skip=lambda n: False):
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax

    want = state_dict_from_jax(_tree_f32(jax.tree.map(np.asarray, jtree)),
                               cfg)
    assert set(want) == set(ttree), what
    for n, w in want.items():
        if not skip(n):
            w = w.numpy()
            np.testing.assert_allclose(
                ttree[n].detach().numpy(), w,
                atol=atol * max(1.0, float(np.abs(w).max())), rtol=rtol,
                err_msg=f"{what}: {n}")


def _assert_stats(jstats, buffers, atol, rtol):
    from mla_tpu_torch.models.convert import batch_stats_from_jax

    want = batch_stats_from_jax(jax.tree.map(np.asarray, jstats))
    assert set(want) == set(buffers)
    for n, w in want.items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[n].numpy(), w.numpy(),
                                       atol=atol, rtol=rtol, err_msg=n)


def _assert_metrics(jm, m, keys, rtol=LOSS_RTOL):
    for k in keys:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                   atol=rtol, err_msg=k)


# --masked_bn: MaskedBatchNorm computes in float32 whatever the compute type,
# so that run carries fp32 rounding into its gradients: one step, at the
# tolerances of fp32 (the three-step run meets a ReLU flip, as above)
FP32_TOL = (1e-5, 1e-4)
MLA_CASES = [(dict(), 1), (dict(), 3),                  # ghost updates on
             (dict(ghost_updates=False), 1), (dict(ghost_updates=False), 3),
             (dict(masked_bn=True), 1),
             (dict(grad_accum=2), 1), (dict(grad_accum=2), 3),
             (dict(pallas_conv="on"), 1), (dict(pallas_conv="on"), 3)]


@pytest.mark.parametrize("kw,n_steps", MLA_CASES, ids=[
    "ghost-1", "ghost-3", "no_ghost-1", "no_ghost-3", "masked_bn-1",
    "grad_accum2-1", "grad_accum2-3", "pallas_conv-1", "pallas_conv-3"])
def test_mla_step_matches_jax(kw, n_steps):
    traj = _trajectory(gs_flag=True, **kw)
    jstate, jm, state, m = traj[n_steps]
    cfg = traj["pair"][1][1]
    atol, rtol = FP32_TOL if kw.get("masked_bn") else TOL[n_steps]
    _assert_metrics(jm, m, ("loss", "loss_a", "loss_v"), max(rtol / 10,
                                                             LOSS_RTOL))
    assert state["opt_state"].keys() == {"momentum"}
    _assert_params(cfg, jstate.params, state["params"], atol, rtol, "params")
    _assert_params(cfg, jstate.opt_state["momentum"],
                   state["opt_state"]["momentum"], atol, rtol, "momentum")
    _assert_stats(jstate.batch_stats, state["buffers"], atol, rtol)


def test_fp32_mla_step_matches_jax_where_no_relu_mask_reaches():
    """One MLA step with fp32 activations, as training runs: the losses,
    the running statistics and the shared head's weight and momentum come
    from forward values (a ReLU mask moves none of them); 1e-5 relative."""
    traj = _trajectory(compute="float32", gs_flag=True, pallas_conv="on")
    jstate, jm, state, m = traj[1]
    cfg = traj["pair"][1][1]
    _assert_metrics(jm, m, ("loss", "loss_a", "loss_v"), 1e-5)
    _assert_stats(jstate.batch_stats, state["buffers"], 1e-5, 1e-5)

    def below_head(n):
        return not n.startswith("fusion_module.")
    _assert_params(cfg, jstate.params, state["params"], 1e-5, 1e-5,
                   "params", below_head)
    _assert_params(cfg, jstate.opt_state["momentum"],
                   state["opt_state"]["momentum"], 1e-5, 1e-5, "momentum",
                   below_head)


def test_mla_sub_steps_update_their_own_running_statistics():
    """One MLA step moves both encoders' statistics away from the start;
    under --masked_bn the padded row stays out of them (they differ from
    the plain step's)."""
    import torch

    plain = _trajectory(gs_flag=True)
    masked = _trajectory(gs_flag=True, masked_bn=True)
    start = plain["pair"][0][3].batch_stats
    buf = plain[1][2]["buffers"]
    for net in ("audio_net", "visual_net"):
        assert float(np.asarray(start[net]["bn1"]["var"]).min()) == 1.0
        assert not torch.allclose(buf[f"{net}.bn1.running_var"],
                                  torch.ones(64))
        assert not torch.allclose(buf[f"{net}.bn1.running_mean"],
                                  masked[1][2]["buffers"][
                                      f"{net}.bn1.running_mean"])


@pytest.mark.parametrize("modulation", ["Normal", "OGM"])
def test_joint_step_matches_jax(modulation):
    """One joint step (concat fusion). For the AV family OGM scales the
    4-D conv gradients of audio_net and visual_net (checked to act: one
    coefficient is below 1)."""
    traj = _trajectory(gs_flag=False, modulation=modulation)
    jstate, jm, state, m = traj[1]
    cfg = traj["pair"][1][1]
    keys = ["loss", "loss_a", "loss_v"]
    if modulation == "OGM":
        keys += ["ratio_v", "coeff_a", "coeff_v"]
        assert min(float(m["coeff_a"]), float(m["coeff_v"])) < 0.999
    _assert_metrics(jm, m, keys)
    _assert_params(cfg, jstate.params, state["params"], *TOL[1], "params")
    _assert_params(cfg, jstate.opt_state["momentum"],
                   state["opt_state"]["momentum"], *TOL[1], "momentum")
    _assert_stats(jstate.batch_stats, state["buffers"], *TOL[1])


def test_ogm_ge_step_matches_jax_but_its_noise():
    """OGM_GE: the coefficients, and every parameter and momentum that no
    noise reaches (BatchNorms, the fusion head), as JAX's; the conv weights
    of both encoders take noise and move by another amount."""
    traj = _trajectory(gs_flag=False, modulation="OGM_GE")
    jstate, jm, state, m = traj[1]
    cfg = traj["pair"][1][1]
    _assert_metrics(jm, m, ("loss", "loss_a", "loss_v", "ratio_v",
                            "coeff_a", "coeff_v"))
    p = state["params"]

    def noised(n):
        return n.split(".")[0] in ("audio_net", "visual_net") and \
            p[n].dim() == 4
    _assert_params(cfg, jstate.params, p, *TOL[1], "params", noised)
    _assert_params(cfg, jstate.opt_state["momentum"],
                   state["opt_state"]["momentum"], *TOL[1], "momentum",
                   noised)


def test_ogm_ge_noise_reaches_only_4d_encoder_grads_at_std_scale():
    import torch
    from mla_tpu_torch.train.steps import _modulate_grads

    gen = torch.Generator().manual_seed(0)
    grads = {"audio_net.layer1.0.conv1.weight": torch.randn(64, 64, 3, 3,
                                                            generator=gen),
             "visual_net.conv1.weight": 3.0 * torch.randn(64, 3, 7, 7,
                                                          generator=gen),
             "audio_net.bn1.weight": torch.randn(64, generator=gen),
             "fusion_module.fc_out.weight": torch.randn(6, 1024,
                                                        generator=gen)}
    coeffs = {"a": torch.tensor(0.25), "v": torch.tensor(1.0)}
    out = _modulate_grads(grads, coeffs, torch.Generator().manual_seed(1),
                          True, True, False)
    for n in ("audio_net.bn1.weight", "fusion_module.fc_out.weight"):
        assert torch.equal(out[n], grads[n]), n
    for n, c in (("audio_net.layer1.0.conv1.weight", 0.25),
                 ("visual_net.conv1.weight", 1.0)):
        g = grads[n]
        noise = (out[n] - c * g) / (torch.std(g, unbiased=False) + 1e-8)
        assert abs(float(noise.std()) - 1.0) < 0.05, n
        assert abs(float(noise.mean())) < 0.05, n
    off = _modulate_grads(grads, coeffs, torch.Generator().manual_seed(1),
                          True, False, False)
    assert all(torch.equal(off[n], grads[n]) for n in grads)


def test_qmf_base_path_matches_jax():
    """Three QMF steps on the base path (loss = cml + clf + 0.1*crl): losses,
    parameters, momentum, running statistics and the QMF history."""
    traj = _trajectory(gs_flag=False, modulation="QMF")
    jstate, jm, state, m = traj[3]
    cfg = traj["pair"][1][1]
    assert cfg.regime == "qmf" and cfg.lorb == "base"
    _assert_metrics(jm, m, ("loss", "loss_a", "loss_v"))
    _assert_params(cfg, jstate.params, state["params"], *TOL[3], "params")
    _assert_params(cfg, jstate.opt_state["momentum"],
                   state["opt_state"]["momentum"], *TOL[3], "momentum")
    _assert_stats(jstate.batch_stats, state["buffers"], *TOL[3])
    for store in ("correctness", "confidence"):
        for mod in ("a", "v"):
            np.testing.assert_allclose(
                getattr(state["qmf"], store)[mod].numpy(),
                np.asarray(getattr(jstate.qmf, store)[mod]),
                atol=1e-5, rtol=1e-5, err_msg=f"{store} {mod}")


@pytest.mark.parametrize("kw,eval_kw", [
    (dict(gs_flag=True), dict(dynamic=True)),
    (dict(gs_flag=False, modulation="Normal"), dict()),
    (dict(gs_flag=False, modulation="QMF"), dict()),
], ids=["mla_dynamic", "joint", "qmf"])
def test_eval_step_counts_match_jax(kw, eval_kw):
    """After the training steps, the eval step on another batch: counts
    equal to JAX's on the running statistics, which it leaves unchanged,
    and the model back in training mode."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.evals.metrics import make_eval_step, summarize_counts

    traj = _trajectory(**kw)
    jstate = traj[3][0]
    jmodel, model = traj["pair"][0][0], traj["pair"][1][0]
    jcfg = JConfig(**_cfg_kwargs(**kw, **eval_kw)).validate()
    cfg = MLAConfig(**_cfg_kwargs(**kw, **eval_kw)).validate()
    b = _batch(5)
    b["label"][:3] = 2       # a class shared by several rows
    with jax.enable_x64(True):
        want = jax.jit(jax_make_eval_step(jmodel, jcfg))(
            jstate.params, jstate.batch_stats,
            {k: jnp.asarray(v) for k, v in b.items()})
    before = {n: t.clone() for n, t in model.named_buffers()}
    assert model.training
    got = make_eval_step(model, cfg)({k: torch.from_numpy(v)
                                      for k, v in b.items()})
    assert model.training
    assert all(torch.equal(t, before[n]) for n, t in model.named_buffers())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert summarize_counts(got) == jax_summarize(want)
