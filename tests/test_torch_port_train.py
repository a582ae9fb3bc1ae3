"""The port's training path (mla_tpu_torch/train/ + evals/metrics.py) against
the JAX package's: from identical weights, optimizer state and batch, the
MLA step (ghost updates on and off, --gs_rls, --grad_accum 2), the joint
step and the QMF step leave the same parameters, optimizer state, GS / QMF
state and losses; the eval step counts match in the MLA, joint and QMF
branches. Debug size: 2 blocks, 1024 wide, 16 heads, 256-token vocabulary,
8 tokens, 32x32 images (4 patches), batch 4 with one padded row. JAX
initialises the weights; convert.py carries them, the optimizer state and
the GS / QMF state over (strict=True). fp32 on the CPU, where the port's
attention runs its plain forward and backward through FlatAttention.

Tolerances. Flax's LayerNorm uses the fast variance E[x^2]-E[x]^2 and
torch's the two-pass one, and sums (GEMMs, the attention backward, the
loss) run in other orders, so gradients agree to ~1e-6 relative, not
bitwise: momentum and parameters are held to atol 1e-5 + rtol 1e-4 after
one step and 3e-5 + 3e-4 after three (the differences compound through
updated weights), losses to 1e-5 relative (1e-4 after three steps). The
--gs_rls projector divides ELEMENTWISE by the outer product alpha + r_i r_j
(see tests/test_grad_accum.py): where an entry crosses zero, 1e-6 of
difference in the features moves Pl by tens of percent. The --gs_rls cases
therefore start from final LayerNorms with bias 3, which keeps every pooled
feature positive and every denominator above alpha, and then hold Pl and
the parameters to the tolerances above, except the shared head: Pl is then
close to I - (11^T), so the projection g Pl^T sums 1024 nearly cancelling
terms per entry, and the head's weight and momentum are held to a relative
Frobenius distance of 1e-4 (measured: 3e-5 after three steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.evals.metrics import make_eval_step as jax_make_eval_step
from mla_tpu.models.classifiers import build_classifier as jax_build
from mla_tpu.train import optim as joptim
from mla_tpu.train import steps as jsteps
from mla_tpu.train.state import create_train_state as jax_create_state

VOCAB, L, IMG, NB, NDATA = 256, 8, 32, 4, 10
LR = 0.05


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pm = np.zeros((NB, L), np.float32)
    pm[0, 5:] = 1.0
    pm[2, 1:] = 1.0
    return {"token": rng.integers(0, VOCAB, (NB, L)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((NB, 3, IMG, IMG)).astype(np.float32),
            "label": rng.integers(0, 101, NB).astype(np.int32),
            "valid": np.array([1, 1, 1, 0], np.float32),
            "idx": np.array([3, 7, 1, NDATA], np.int32)}


def _cfg_kwargs(**kw):
    base = dict(dataset="Food101", lorb="m3ae", m3ae_size="debug",
                compute_dtype="float32", batch_size=NB, train=True)
    base.update(kw)
    return base


_INITIAL = {}


def _pair(seed=0, ln_bias=None, **kw):
    """(JAX model, cfg, spec, state) and (port model, cfg, spec, state) from
    the same JAX-initialised weights and state; ``ln_bias`` sets both
    encoders' final LayerNorm bias."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import M3AEClassifier, \
        classifier_kwargs
    from mla_tpu_torch.models import convert
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    jcfg = JConfig(**_cfg_kwargs(**kw)).validate()
    jmodel = jax_build(jcfg).clone(text_vocab_size=VOCAB)
    jspec = joptim.make_spec(jcfg)
    # the initial state depends on the model and the regime's stores only
    key = (seed, jcfg.gs_flag, jcfg.modulation)
    if key not in _INITIAL:
        jb = {k: jnp.asarray(v) for k, v in _batch(seed).items()}
        _INITIAL[key] = jax_create_state(jmodel, jcfg, jb, jspec,
                                         n_data=NDATA, seed=seed)
    jstate = _INITIAL[key]
    if ln_bias is not None:
        p = jax.tree.map(lambda x: x, jstate.params)   # a new outer tree
        for enc in ("mae_a", "mae_v"):
            norm = dict(p[enc]["final_norm"])
            norm["bias"] = jnp.full_like(norm["bias"], ln_bias)
            p[enc] = {**p[enc], "final_norm": norm}
        jstate = jstate.replace(params=p)

    cfg = MLAConfig(**_cfg_kwargs(**kw)).validate()
    with torch.device("meta"):
        model = M3AEClassifier(text_vocab_size=VOCAB, **classifier_kwargs(cfg))
    params = jax.tree.map(np.asarray, jstate.params)
    model.load_state_dict(convert.state_dict_from_jax(params, cfg),
                          strict=True, assign=True)
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, n_data=NDATA, seed=seed,
                               device="cpu")
    state.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state), cfg)
    if jstate.gs is not None:
        state.gs = convert.gs_state_from_jax(jstate.gs)
    if jstate.qmf is not None:
        state.qmf = convert.qmf_state_from_jax(jstate.qmf)
    return (jmodel, jcfg, jspec, jstate), (model, cfg, spec, state)


def _torch_batch(seed=0):
    import torch
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


_TRAJECTORIES = {}


def _snapshot(state):
    import copy
    return {"params": {n: t.detach().clone() for n, t in state.params.items()},
            "opt_state": copy.deepcopy(state.opt_state),
            "gs": copy.deepcopy(state.gs), "qmf": copy.deepcopy(state.qmf)}


def _trajectory(batch_index=1, len_dl=4, **kw):
    """Three steps of both packages on the same batch, from one pair (built
    once per configuration and shared by the tests that read it). ->
    {'pair', 1: (jstate, jmetrics, port snapshot, metrics), 3: (...)}."""
    key = tuple(sorted(kw.items()))
    if key in _TRAJECTORIES:
        return _TRAJECTORIES[key]
    from mla_tpu_torch.train.steps import make_train_step

    pair = _pair(**kw)
    (jmodel, jcfg, jspec, jstate), (model, cfg, spec, state) = pair
    jstep = jax.jit(jsteps.make_train_step(jmodel, jcfg, jspec, len_dl))
    step = make_train_step(model, cfg, spec, len_dl)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    tb = _torch_batch()
    out = {"pair": pair}
    for i in (1, 2, 3):
        jstate, jm = jstep(jstate, jb, jnp.float32(LR),
                           jnp.int32(batch_index), jnp.int32(0))
        state, m = step(state, tb, LR, batch_index, 0)
        if i != 2:
            out[i] = (jstate, jm, _snapshot(state), m)
    _TRAJECTORIES[key] = out
    return out


def _assert_tree(cfg, jtree, ttree, atol, rtol, what, by_norm=()):
    """Element-wise, except the names in ``by_norm``: relative Frobenius
    distance <= 1e-4."""
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax

    want = state_dict_from_jax(_tree_f32(jax.tree.map(np.asarray, jtree)),
                               cfg)
    assert set(want) == set(ttree), what
    for n, w in want.items():
        got, w = ttree[n].detach().float().numpy(), w.numpy()
        if n in by_norm:
            rel = np.linalg.norm(got - w) / np.linalg.norm(w)
            assert rel <= 1e-4, (what, n, rel)
            continue
        np.testing.assert_allclose(got, w, atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {n}")


def _assert_metrics(jm, m, keys, rtol=1e-5):
    for k in keys:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)


TOL = {1: (1e-5, 1e-4), 3: (3e-5, 3e-4)}      # (atol, rtol) by step count
LOSS_RTOL = {1: 1e-5, 3: 1e-4}


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("kw", [
    dict(),                              # ghost updates on (the default)
    dict(ghost_updates=False),
    dict(gs_rls=True),
    dict(grad_accum=2),
], ids=["ghost", "no_ghost", "gs_rls", "grad_accum2"])
def test_mla_step_matches_jax(kw, n_steps):
    rls = kw.get("gs_rls", False)
    if rls:
        kw = dict(kw, ln_bias=3.0)
    traj = _trajectory(gs_flag=True, **kw)
    jstate, jm, state, m = traj[n_steps]
    cfg = traj["pair"][1][1]
    atol, rtol = TOL[n_steps]
    _assert_metrics(jm, m, ("loss", "loss_a", "loss_v"), LOSS_RTOL[n_steps])
    assert state["gs"].exp_count == int(jstate.gs.exp_count) == 2 * n_steps
    jpl = np.asarray(jstate.gs.Pl)
    if rls:
        assert np.abs(jpl - np.eye(jpl.shape[0])).max() > 0.1  # RLS ran
    else:
        np.testing.assert_array_equal(jpl, np.eye(jpl.shape[0]))
    np.testing.assert_allclose(state["gs"].Pl.numpy(), jpl, atol=atol,
                               rtol=rtol)
    head = ("fusion_module.fc_out.weight",) if rls else ()
    _assert_tree(cfg, jstate.params, state["params"], atol, rtol, "params",
                 head)
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state["opt_state"]["momentum"], atol, rtol, "momentum", head)


def test_ghost_updates_move_the_first_encoder_again():
    """With ghost updates the text encoder (stepped first) is updated again
    in the image sub-step by momentum and weight decay; without them it is
    not. Held against a copy of the port's own state."""
    import torch

    on = _trajectory(gs_flag=True)[1][2]["params"]
    off = _trajectory(gs_flag=True, ghost_updates=False)[1][2]["params"]
    assert not torch.equal(on["mae_a.cls_token"], off["mae_a.cls_token"])
    # the image encoder, stepped last, takes no ghost update either way
    assert torch.equal(on["mae_v.cls_token"], off["mae_v.cls_token"])


@pytest.mark.parametrize("modulation", ["Normal", "OGM_GE"])
def test_joint_step_matches_jax(modulation):
    """One joint step (concat fusion). For 2-modal M3AE, OGM modulates
    nothing (the reference matches 'audio'/'visual' names only), so OGM_GE
    is plain joint training here too; its scalars are compared."""
    traj = _trajectory(gs_flag=False, modulation=modulation)
    jstate, jm, state, m = traj[1]
    cfg = traj["pair"][1][1]
    keys = ["loss", "loss_a", "loss_v"]
    if modulation != "Normal":
        keys += ["ratio_v", "coeff_a", "coeff_v"]
    _assert_metrics(jm, m, keys)
    _assert_tree(cfg, jstate.params, state["params"], *TOL[1], "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state["opt_state"]["momentum"], *TOL[1], "momentum")


def test_qmf_step_matches_jax():
    traj = _trajectory(gs_flag=False, modulation="QMF")
    jstate, jm, state, m = traj[3]
    cfg = traj["pair"][1][1]
    _assert_metrics(jm, m, ("loss", "loss_a", "loss_v"), LOSS_RTOL[3])
    _assert_tree(cfg, jstate.params, state["params"], *TOL[3], "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state["opt_state"]["momentum"], *TOL[3], "momentum")
    qmf = state["qmf"]
    for store in ("correctness", "confidence"):
        for mod in ("a", "v"):
            np.testing.assert_allclose(
                getattr(qmf, store)[mod].numpy(),
                np.asarray(getattr(jstate.qmf, store)[mod]),
                atol=1e-5, rtol=1e-5, err_msg=f"{store} {mod}")
    # the history accumulates over the steps; padded rows only ever touch
    # the scratch slot, with confidence 0
    assert float(qmf.correctness["a"][3]) > 0.0
    assert float(qmf.confidence["a"][NDATA]) == 0.0


@pytest.mark.parametrize("kw,eval_kw", [
    (dict(gs_flag=True), dict(dynamic=True)),
    (dict(gs_flag=False, modulation="Normal"), dict()),
    (dict(gs_flag=False, modulation="QMF"), dict()),
], ids=["mla_dynamic", "joint", "qmf"])
def test_eval_step_counts_match_jax(kw, eval_kw):
    """Three training steps, then the eval step on another batch: per-class
    counts equal, and summarize_counts gives the same accuracies."""
    from mla_tpu.evals.metrics import summarize_counts as jax_summarize
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.evals.metrics import make_eval_step, summarize_counts

    traj = _trajectory(**kw)
    jstate = traj[3][0]
    jmodel, model = traj["pair"][0][0], traj["pair"][1][0]
    jcfg = JConfig(**_cfg_kwargs(**kw, **eval_kw)).validate()
    cfg = MLAConfig(**_cfg_kwargs(**kw, **eval_kw)).validate()
    b = _batch(5)
    b["label"][:3] = 7       # a class shared by several rows
    want = jax.jit(jax_make_eval_step(jmodel, jcfg))(
        jstate.params, jstate.batch_stats,
        {k: jnp.asarray(v) for k, v in b.items()})
    import torch
    got = make_eval_step(model, cfg)({k: torch.from_numpy(v)
                                      for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert summarize_counts(got) == jax_summarize(want)


def test_qmf_regime_builds_its_heads():
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier

    cfg = MLAConfig(dataset="Food101", lorb="m3ae", modulation="QMF",
                    m3ae_size="debug").validate()
    model = build_classifier(cfg, seed=0, text_vocab_size=VOCAB)
    names = dict(model.named_parameters())
    assert names["audio_fc.weight"].shape == (101, 1024)
    assert names["visual_fc.bias"].shape == (101,)
    # under --gs_flag the QMF heads are not built (gs takes precedence)
    gs = MLAConfig(dataset="Food101", lorb="m3ae", modulation="QMF",
                   gs_flag=True, m3ae_size="debug").validate()
    assert "audio_fc.weight" not in dict(
        build_classifier(gs, seed=0, text_vocab_size=VOCAB).named_parameters())
