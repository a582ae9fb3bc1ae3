"""The training steps of the three families this port adds (CAV-MAE
``--lorb large``, IEMOCAP 3-modal ``--modal3``, CLIP ``--clip``) against
the JAX package's: from identical weights, optimizer state and batch, one
and three steps leave the same parameters, optimizer state, GS / QMF state
and losses, and the eval step counts the same.

Regimes: CAV-MAE MLA (``--gs_flag``), joint, and joint under ``--cav_opti``
(Adam, the head's weight at the full learning rate, the rest at a tenth);
3-modal MLA, joint OGM_GE and QMF; CLIP MLA and joint. Sizes: CAV-MAE 768
wide with ``--cav_blocks 1,2`` and ``--audio_length 128`` (64 audio
tokens), 32x32 images; the 3-modal family's M3AE encoders at "base1" (768
wide, one block; the shared head takes the 768-d CAV-MAE and M3AE features
alike, so the 1024-wide debug size cannot run its MLA regime in either
package) with a 64-token vocabulary, which the JAX Modal3Classifier takes
through its ``M3AEConfig`` (patched here for the module; nothing in
mla_tpu/ changes); batch 4 with one padded row; fp32 on the CPU.

Tolerances are ``tests/test_torch_port_train.py``'s: parameters and
moments atol 1e-5 + rtol 1e-4 after one step, 3e-5 + 3e-4 after three;
losses 1e-5 relative (1e-4 after three). OGM_GE's Gaussian noise
(``jax.random`` against a torch generator) lands on the 4-D gradients
only, which in the 3-modal family is the CAV-MAE patch conv: that weight
and its momentum are left out of its one-step case, everything else is
held; plain OGM (the same modulation, no noise) runs three steps.
``--cav_opti`` runs at 1e-4, the order of CAV-MAE's fine-tuning rate: Adam
divides by sqrt(v) + 1e-8, so where a gradient entry lies near 1e-8 its
fp32 sum-order difference moves that entry's update by up to the rate
(at the SGD cases' 0.05 x 0.1, 8e-5 on 4 of the patch conv's 196608
entries); at 1e-4 such an entry stays inside the tolerance, and the Adam
moments are held too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.evals.metrics import make_eval_step as jax_make_eval_step
from mla_tpu.models import classifiers as jcls
from mla_tpu.models.m3ae import M3AEConfig as JM3AEConfig
from mla_tpu.train import optim as joptim
from mla_tpu.train import steps as jsteps
from mla_tpu.train.state import create_train_state as jax_create_state

VOCAB, L, IMG, T_AUDIO, NB, NDATA = 64, 8, 32, 128, 4, 10
LR = 0.05
ADAM_LR = 1e-4     # --cav_opti's Adam at CAV-MAE's fine-tuning rate order
TOL = {1: (1e-5, 1e-4), 3: (3e-5, 3e-4)}
LOSS_RTOL = {1: 1e-5, 3: 1e-4}

FAMILY = {
    "cav": dict(dataset="CREMAD", lorb="large", audio_length=T_AUDIO,
                cav_blocks=(1, 2), image_size=IMG),
    "modal3": dict(dataset="IEMOCAP", lorb="m3ae", modal3=True,
                   m3ae_size="base1", audio_length=T_AUDIO,
                   cav_blocks=(1, 2), image_size=IMG),
    "clip": dict(dataset="Food101", clip=True),
}
CASES = {
    "cav_mla": ("cav", dict(gs_flag=True)),
    "cav_joint": ("cav", dict()),
    "cav_opti": ("cav", dict(cav_opti=True)),
    "modal3_mla": ("modal3", dict(gs_flag=True)),
    "modal3_ogm": ("modal3", dict(modulation="OGM")),
    "modal3_ogm_ge": ("modal3", dict(modulation="OGM_GE")),
    "modal3_qmf": ("modal3", dict(modulation="QMF")),
    "clip_mla": ("clip", dict(gs_flag=True)),
    "clip_joint": ("clip", dict()),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_vocab():
    mp = pytest.MonkeyPatch()
    mp.setattr(jcls, "M3AEConfig", functools.partial(
        JM3AEConfig, text_vocab_size=VOCAB))
    yield
    mp.undo()


def _batch(family, seed=0):
    rng = np.random.default_rng(seed)
    n_classes = {"cav": 6, "modal3": 4, "clip": 101}[family]
    pm = np.zeros((NB, L), np.float32)
    pm[0, 5:] = 1.0
    b = {"label": rng.integers(0, n_classes, NB).astype(np.int32),
         "valid": np.array([1, 1, 1, 0], np.float32),
         "idx": np.array([3, 7, 1, NDATA], np.int32)}
    if family == "clip":
        b["token_feat"] = rng.standard_normal((NB, 512)).astype(np.float32)
        b["image_feat"] = rng.standard_normal((NB, 512)).astype(np.float32)
        return b
    b["fbank"] = rng.standard_normal((NB, T_AUDIO, 128)).astype(np.float32)
    b["image"] = rng.standard_normal((NB, 3, IMG, IMG)).astype(np.float32)
    if family == "modal3":
        b["token"] = rng.integers(0, VOCAB, (NB, L)).astype(np.int32)
        b["padding_mask"] = pm
    return b


def _kw(family, **kw):
    return dict(FAMILY[family], compute_dtype="float32", batch_size=NB,
                train=True, **kw)


def _pair(family, **kw):
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models import convert
    from mla_tpu_torch.models.classifiers import make_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    jcfg = JConfig(**_kw(family, **kw)).validate()
    jmodel = jcls.build_classifier(jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(family).items()}
    jstate = jax_create_state(jmodel, jcfg, jb, joptim.make_spec(jcfg),
                              n_data=NDATA, seed=0)
    jspec = joptim.make_spec(jcfg, jstate.params)
    cfg = MLAConfig(**_kw(family, **kw)).validate()
    model = make_classifier(cfg, VOCAB)
    model.load_state_dict(convert.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), cfg), strict=True,
        assign=True)
    state = create_train_state(model, cfg, optim.make_spec(cfg), n_data=NDATA,
                               seed=0, device="cpu")
    spec = optim.make_spec(cfg, state.params)
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
            "opt_state": copy.deepcopy(state.opt_state),
            "gs": copy.deepcopy(state.gs), "qmf": copy.deepcopy(state.qmf)}


_TRAJ = {}


def _trajectory(case):
    """Three steps of both packages on one batch, once per case; only the
    latest case is kept (its one- and three-step tests run one after the
    other), which bounds the file's memory to one case's states."""
    if case in _TRAJ:
        return _TRAJ[case]
    _TRAJ.clear()
    import torch
    from mla_tpu_torch.train.steps import make_train_step

    family, kw = CASES[case]
    pair = _pair(family, **kw)
    (jmodel, jcfg, jspec, jstate), (model, cfg, spec, state) = pair
    jstep = jax.jit(jsteps.make_train_step(jmodel, jcfg, jspec, 4))
    step = make_train_step(model, cfg, spec, 4)
    jb = {k: jnp.asarray(v) for k, v in _batch(family).items()}
    tb = {k: torch.from_numpy(v) for k, v in _batch(family).items()}
    out = {"pair": pair}
    lr = ADAM_LR if cfg.cav_opti else LR
    for i in (1, 2, 3):
        jstate, jm = jstep(jstate, jb, jnp.float32(lr), jnp.int32(1),
                           jnp.int32(0))
        state, m = step(state, tb, lr, 1, 0)
        if i != 2:
            out[i] = (jstate, jm, _snapshot(state), m)
    _TRAJ[case] = out
    return out


def _assert_tree(cfg, jtree, ttree, atol, rtol, what, skip=()):
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax

    want = state_dict_from_jax(_tree_f32(jax.tree.map(np.asarray, jtree)),
                               cfg)
    assert set(want) == set(ttree), what
    for n, w in want.items():
        if n in skip:
            continue
        np.testing.assert_allclose(ttree[n].detach().float().numpy(),
                                   w.numpy(), atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("case,n_steps", [
    (c, n) for c in CASES for n in (1, 3)
    # OGM_GE's noise moves the patch conv in step 1, so the two packages
    # train different models from step 2 on: one step only (3-step OGM
    # modulation: the "modal3_ogm" case)
    if not (c == "modal3_ogm_ge" and n == 3)])
def test_steps_match_jax(case, n_steps):
    traj = _trajectory(case)
    jstate, jm, state, m = traj[n_steps]
    cfg = traj["pair"][1][1]
    atol, rtol = TOL[n_steps]
    mods = ("a", "v", "t") if cfg.modal3 else ("a", "v")
    for k in ("loss",) + tuple(f"loss_{x}" for x in mods):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL[n_steps], atol=1e-6,
                                   err_msg=k)
    noised = ("mae_a.patch_embed_a.proj.weight",) \
        if cfg.modulation == "OGM_GE" else ()
    if cfg.modulation in ("OGM", "OGM_GE"):
        for k in ("ratio_v", "coeff_a", "coeff_v", "coeff_t"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    _assert_tree(cfg, jstate.params, state["params"], atol, rtol, "params",
                 noised)
    if cfg.cav_opti:
        for key in ("m", "v"):
            _assert_tree(cfg, jstate.opt_state[key],
                         state["opt_state"][key], atol, rtol, key)
    else:
        _assert_tree(cfg, jstate.opt_state["momentum"],
                     state["opt_state"]["momentum"], atol, rtol, "momentum",
                     noised)
    if cfg.gs_flag:
        assert state["gs"].exp_count == int(jstate.gs.exp_count)
        np.testing.assert_allclose(state["gs"].Pl.numpy(),
                                   np.asarray(jstate.gs.Pl), atol=atol,
                                   rtol=rtol)
    if cfg.modulation == "QMF":
        for store in ("correctness", "confidence"):
            for mod in mods:
                np.testing.assert_allclose(
                    getattr(state["qmf"], store)[mod].numpy(),
                    np.asarray(getattr(jstate.qmf, store)[mod]),
                    atol=1e-5, rtol=1e-5, err_msg=f"{store} {mod}")


@pytest.mark.parametrize("case", ["cav_joint", "modal3_mla", "modal3_qmf",
                                  "clip_mla"])
def test_eval_step_counts_match_jax(case):
    """The eval step on another batch, from the same weights: the
    per-class counts equal (the 3-modal family counts acc_t too)."""
    import torch
    from mla_tpu_torch.evals.metrics import make_eval_step

    family, kw = CASES[case]
    (jmodel, jcfg, _, jstate), (model, cfg, _, _) = _pair(family, **kw)
    b = _batch(family, 5)
    b["label"][:3] = 1
    want = jax.jit(jax_make_eval_step(jmodel, jcfg))(
        jstate.params, jstate.batch_stats,
        {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_step(model, cfg)({k: torch.from_numpy(v)
                                      for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k)


def test_cav_opti_learning_rates():
    """--cav_opti: Adam with only the head's weight at the full rate (the
    reference's stray 'module.' prefix leaves the bias at a tenth); the
    --cav_lrs schedule halves from epoch 2, as in the JAX package."""
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.train import optim

    (_, jcfg, jspec, jstate), (_, cfg, spec, state) = _pair(
        "cav", cav_opti=True)
    assert spec.kind == "adam" and spec.b1 == jspec.b1 == 0.95
    assert spec.lr_scales["fusion_module.fc_out.weight"] == 1.0
    assert spec.lr_scales["fusion_module.fc_out.bias"] == 0.1
    assert set(v for k, v in spec.lr_scales.items()
               if k != "fusion_module.fc_out.weight") == {0.1}
    lrs = MLAConfig(**_kw("cav", cav_lrs=True, learning_rate=1e-3)).validate()
    jl = JConfig(**_kw("cav", cav_lrs=True, learning_rate=1e-3)).validate()
    for e in range(6):
        assert optim.lr_for_epoch(lrs, e) == joptim.lr_for_epoch(jl, e)
