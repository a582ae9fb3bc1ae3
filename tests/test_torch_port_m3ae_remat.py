"""Block remat (``--scan_blocks --remat_blocks``, ``models/m3ae.py``) and
pretrained encoders (``--pretrained_v``, ``models/torch_import.py``) of the
port's M3AE classifier against the JAX package's.

Remat: one MLA step under 'full' and 'dots' against JAX's same flags at
the one-step tolerance of tests/test_torch_port_train.py (atol 1e-5, rtol
1e-4; losses 1e-5 relative), and against the port's step without remat
bit for bit; FlatAttention is applied twice per block forward (the
recomputation relaunches the attention), and under 'dots' no block GEMM
runs again. Debug size (2 blocks, 1024 wide, 16 heads), a 256-token
vocabulary, 12 tokens, 32x32 images, batch 4 with one padded row; fp32 on
the CPU.

Pretrained: a seeded M3AE encoder file in the reference layout goes
through JAX's ``load_pretrained_encoders`` and the port's; the weights are
equal exactly.
"""

import jax
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.models.classifiers import build_classifier as jax_build

from test_torch_port_m3ae_driver import (STEP_TOL, TOKENS, VOCAB,  # noqa
                                         _assert_tree, _port_cfg, _port_run,
                                         food)

# ------------------------------------------------------------ block remat

def _remat_pair(**kw):
    """(JAX state, port state, cfgs, step fns) from the same JAX-initialised
    weights, --scan_blocks (+ the remat flags in ``kw``) on both sides."""
    import torch
    from mla_tpu.train import optim as joptim
    from mla_tpu.train import steps as jsteps
    from mla_tpu.train.state import create_train_state as jax_create_state
    from mla_tpu_torch.models import convert

    torch.set_num_threads(1)
    base = dict(dataset="Food101", lorb="m3ae", m3ae_size="debug",
                compute_dtype="float32", batch_size=4, train=True,
                gs_flag=True, scan_blocks=True, **kw)
    jcfg = JConfig(**base).validate()
    jmodel = jax_build(jcfg).clone(text_vocab_size=VOCAB)
    jspec = joptim.make_spec(jcfg)
    batch = _step_batch()
    jstate = jax_create_state(jmodel, jcfg, {k: jax.numpy.asarray(v)
                                             for k, v in batch.items()},
                              jspec, n_data=10, seed=0)
    cfg = _port_cfg(**base)
    snap = jax.tree.map(np.asarray, {"params": jstate.params,
                                     "opt_state": jstate.opt_state})
    return jmodel, jcfg, jspec, jstate, jsteps, cfg, snap, convert


def _step_batch():
    rng = np.random.default_rng(3)
    pm = np.zeros((4, TOKENS), np.float32)
    pm[0, 7:] = 1.0
    pm[2, 2:] = 1.0
    return {"token": rng.integers(0, VOCAB, (4, TOKENS)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 101, 4).astype(np.int32),
            "valid": np.array([1, 1, 1, 0], np.float32),
            "idx": np.array([3, 7, 1, 10], np.int32)}


def _port_step(cfg, snap, convert, counters):
    """One port MLA step from the JAX snapshot; counts FlatAttention
    forwards and the block GEMMs (aten.addmm) run in the backward."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from mla_tpu_torch.models.classifiers import M3AEClassifier, \
        classifier_kwargs
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    with torch.device("meta"):
        model = M3AEClassifier(text_vocab_size=VOCAB,
                               **classifier_kwargs(cfg))
    model.load_state_dict(convert.state_dict_from_jax(snap["params"], cfg),
                          strict=True, assign=True)
    spec = optim.make_spec(cfg)
    state = create_train_state(model, cfg, spec, n_data=10, device="cpu")
    state.opt_state = convert.opt_state_from_jax(snap["opt_state"], cfg)
    step = make_train_step(state.model, cfg, spec, 1)
    batch = {k: torch.from_numpy(v) for k, v in _step_batch().items()}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.addmm.default:
                counters["addmm"] += 1
            return func(*args, **(kwargs or {}))

    from mla_tpu_torch.ops import attention as attn
    fwd = attn.FlatAttention.forward

    def counted(ctx, *a):
        counters["flat"] += 1
        return fwd(ctx, *a)

    attn.FlatAttention.forward = staticmethod(counted)
    try:
        with Count():
            state, m = step(state, batch, 0.05, 0, 0)
    finally:
        attn.FlatAttention.forward = staticmethod(fwd)
    return state, m


_REMAT = {}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_step_matches_jax_and_the_step_without_remat(policy):
    """One MLA step, --scan_blocks --remat_blocks --remat_policy ``policy``:
    against JAX's same flags at the one-step tolerance; against the port's
    step without remat bit for bit; FlatAttention applied twice per block
    (2 blocks x 2 encoders: 8 against 4). The block GEMMs (aten.addmm: 4 a
    block, plus the shared head's 2) that run again in the backward:
    'dots' keeps their outputs, so none; 'full' recomputes qkv, proj and
    fc1 of each block (torch.utils.checkpoint stops the recomputation once
    the last saved tensor, fc2's input, is back, so fc2 itself never
    reruns): 3 x 2 x 2 more."""
    import torch

    (jmodel, jcfg, jspec, jstate, jsteps, cfg, snap,
     convert) = _remat_pair(remat_blocks=True, remat_policy=policy)
    assert cfg.remat_blocks and jmodel.remat_blocks
    jstep = jax.jit(jsteps.make_train_step(jmodel, jcfg, jspec, 1))
    jb = {k: jax.numpy.asarray(v) for k, v in _step_batch().items()}
    jstate2, jm = jstep(jstate, jb, jax.numpy.float32(0.05),
                        jax.numpy.int32(0), jax.numpy.int32(0))
    counters = {"flat": 0, "addmm": 0}
    state, m = _port_step(cfg, snap, convert, counters)
    if "none" not in _REMAT:
        plain = {"flat": 0, "addmm": 0}
        _REMAT["none"] = (_port_step(cfg.replace(remat_blocks=False,
                                                 remat_policy="full"),
                                     snap, convert, plain), plain)
    (ref, rm), plain = _REMAT["none"]
    assert plain == {"flat": 4, "addmm": 4 * 2 * 2 + 2}
    assert counters["flat"] == 8
    assert counters["addmm"] == plain["addmm"] + (
        3 * 2 * 2 if policy == "full" else 0)
    for k in ("loss", "loss_a", "loss_v"):
        assert torch.equal(m[k], rm[k]), k
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for (n, x), (_, y) in zip(state.model.state_dict().items(),
                              ref.model.state_dict().items()):
        assert torch.equal(x, y), n
    for n, v in state.opt_state["momentum"].items():
        assert torch.equal(v, ref.opt_state["momentum"][n]), n
    atol, rtol = STEP_TOL[1]
    _assert_tree(cfg, jax.tree.map(np.asarray, jstate2.params),
                 state.params, atol, rtol, "params")
    _assert_tree(cfg, jax.tree.map(np.asarray, jstate2.opt_state["momentum"]),
                 state.opt_state["momentum"], atol, rtol, "momentum")


# ------------------------------------------------------------- pretrained

def test_pretrained_v_merges_like_jax(monkeypatch, food, tmp_path, capsys):
    """A seeded M3AE encoder .pth in the reference layout (DataParallel
    prefix, one key the model lacks, one of the wrong shape) through JAX's
    ``load_pretrained_encoders`` and the port's give the same weights
    exactly; the skipped keys are printed; the text encoder is untouched;
    the driver loads it under --pretrained_v."""
    import torch
    from mla_tpu.models.torch_import import load_pretrained_encoders as jload
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.models.m3ae import M3AEConfig, M3AEEncoder
    from mla_tpu_torch.models.torch_import import load_pretrained_encoders

    enc = M3AEEncoder(M3AEConfig("debug", text_vocab_size=VOCAB)
                      ).to_empty(device="cpu")
    enc.reset_parameters(torch.Generator().manual_seed(42))
    sd = {"module." + k: v.clone() for k, v in enc.state_dict().items()}
    sd["module.decoder.image_output.weight"] = torch.ones(3, 4)
    sd["module.cls_token"] = torch.zeros(1, 1, 7)
    path = str(tmp_path / "m3ae_pretrained.pth")
    torch.save(sd, path)

    kw = dict(dataset="Food101", lorb="m3ae", m3ae_size="debug",
              pretrained_v=path, pretrained_t=path)
    jcfg = JConfig(**kw).validate()
    jstate = _remat_pair()[3]
    jparams = jax.tree.map(np.asarray, jload(
        jcfg.replace(scan_blocks=True), dict(jstate.params)))
    out = capsys.readouterr().out
    assert "skip mae_v.cls_token: shape" in out

    cfg = _port_cfg(**kw)
    model = build_classifier(cfg, seed=3, text_vocab_size=VOCAB)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = state_dict_from_jax(jparams, cfg)
    load_pretrained_encoders(cfg, model)
    out = capsys.readouterr().out
    assert "skip mae_v.decoder.image_output.weight: not in the model" in out
    assert "skip mae_v.cls_token: shape (1, 1, 7) != (1, 1, 1024)" in out
    assert "Loaded pretrained mae_v" in out and "mae_t" not in out
    got = model.state_dict()
    for k, v in want.items():
        if k.startswith("mae_v.") and k != "mae_v.cls_token":
            assert torch.equal(got[k], v), k
            assert torch.equal(got[k], sd["module." + k[6:]]), k
    assert torch.equal(got["mae_v.cls_token"], before["mae_v.cls_token"])
    for k, v in before.items():
        if not k.startswith("mae_v."):
            assert torch.equal(got[k], v), k

    # through the driver: the train state's mae_v is the file's
    _, (state, _) = _port_run(monkeypatch, food, tmp_path / "ck", epochs=0,
                              pretrained_v=path)
    live = state.model.state_dict()
    for k, v in sd.items():
        name = "mae_v." + k[7:]
        if name in live and name != "mae_v.cls_token":
            assert torch.equal(live[name], v), name


