"""The port's driver and CLI on the three families it adds -- CAV-MAE
(``--lorb large --cav_augnois``, CREMA-D), IEMOCAP 3-modal (``--lorb m3ae
--modal3``) and CLIP (``--clip``, Food-101) -- against the JAX package's,
on synthetic trees, with their exports: ``--export_torch``, the serving
artifact (bf16 / fp32, int8, int8_a8) and ``--pretrained_a``.

From the same state: the JAX driver trains epoch 0 with --save_last; its
``last`` snapshot is converted with ``convert.train_state_from_jax`` and
written with the port's ``save_checkpoint``; epoch 1 then runs in both
packages (--resume in the port) from the files on disk. --gs_flag (with
-dynamic for the 3-modal family), two steps an epoch (the second padded),
batch 4. The per-batch draws are ``jax.random``'s in JAX; the port's loader
is fed JAX's draws of the same key, fold_in(fold_in(key(seed), epoch),
step): the CAV-MAE fbank's SpecAug, noise and roll, the 3-modal images'
color jitter.

Sizes as tests/test_torch_port_families_train.py: CAV-MAE 768 wide,
``--cav_blocks 1,2``, ``--audio_length 64``, 32x32 images; the 3-modal
M3AE encoders at "base1" with a 64-token vocabulary (the trees' tokens
written modulo it); fp32 on the CPU. Tolerances: losses 1e-6 relative
(atol 1e-6), parameters and momentum after epoch 1's two steps atol 3e-5
+ rtol 3e-4, equal accuracies (tests/test_torch_port_m3ae_driver.py).

int8: the JAX package's ``split_q8`` hands the CAV-MAE patch conv (a
flax ``nn.Conv`` under a ``proj`` scope, the name of the attention's
int8 site) its int8 kernel without the scale, so JAX's int8 CAV-MAE
logits are far from its float ones (checked here; ROADMAP C). The port
dequantizes the conv (``q8.bf16 * scale.bf16``); the comparison gives the
JAX side the same dequantized conv before its serving function runs. Then
the tolerances of tests/test_torch_port_int8_serving.py with the JAX q8
entry points in interpret mode: atol 2e-3 int8, 5e-3 int8_a8 (4e-3 for
CAV-MAE's int8, whose visual logits pool 4 tokens: see ``TIGHT_CAV``); and
calibration names the same sites in both packages.
"""

import functools
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.data import synthetic as jsyn
from mla_tpu.models import classifiers as jcls
from mla_tpu.models.m3ae import M3AEConfig as JM3AEConfig

VOCAB, TOKENS, T_AUDIO, IMG = 64, 12, 64, 32
STEP_TOL = (3e-5, 3e-4)
LOSS_RTOL = 1e-6
TIGHT = {"int8": 2e-3, "int8_a8": 5e-3}
# CAV-MAE's visual path pools 4 tokens (32x32 images): one bf16 ulp (2^-8)
# of a GEMM output that the two packages' fp32 sums put on either side of
# a rounding boundary reaches the logits a quarter-weighted, up to ~3e-3
# (measured 2.1e-3 on 2 of 24 logits; the third row agrees to 1e-6)
TIGHT_CAV = {"int8": 4e-3, "int8_a8": 5e-3}

FAMILY = {
    "cav": dict(dataset="CREMAD", lorb="large", gs_flag=True,
                cav_augnois=True, audio_length=T_AUDIO, cav_blocks=(1, 2)),
    "modal3": dict(dataset="IEMOCAP", lorb="m3ae", modal3=True,
                   gs_flag=True, dynamic=True, m3ae_size="base1",
                   audio_length=T_AUDIO, cav_blocks=(1, 2)),
    "clip": dict(dataset="Food101", clip=True, gs_flag=True),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_vocab():
    mp = pytest.MonkeyPatch()
    mp.setattr(jcls, "M3AEConfig", functools.partial(
        JM3AEConfig, text_vocab_size=VOCAB))
    yield
    mp.undo()
    # the pairs' exports (0.2 GB a family) go with the module's tests
    for jcfg, *_ in _PAIRS.values():
        shutil.rmtree(os.path.dirname(jcfg.export_dir), ignore_errors=True)
    _PAIRS.clear()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("families_driver")
    out = {f: str(root / f) for f in FAMILY}
    jsyn.make_cremad(out["cav"], n_train=6, n_test=5, fbank=True,
                     fbank_len=T_AUDIO, seed=1)
    jsyn.make_iemocap(out["modal3"], n_train=6, n_test=5, token_len=TOKENS,
                      fbank_len=T_AUDIO, seed=1)
    jsyn.make_clip(out["clip"], n_train=6, n_test=5, seed=1)
    for f in glob.glob(os.path.join(out["modal3"],
                                    "text_token/*/*_token.npy")):
        np.save(f, np.load(f) % VOCAB)
    return out


def _kw(family, root, ckpt, **kw):
    base = dict(image_size=IMG, batch_size=4, data_root=root,
                ckpt_path=str(ckpt), num_workers=2, log_every=1,
                use_tensorboard=False, train=True, epochs=2,
                compute_dtype="float32", mesh_shape=(1, 1), **FAMILY[family])
    base.update(kw)
    return base


def _port_cfg(**kw):
    from mla_tpu_torch.core.config import MLAConfig
    return MLAConfig(**kw).validate()


# JAX's per-batch draws, replayed (as tests/test_torch_port_cav_data.py
# and tests/test_torch_port_m3ae_driver.py do)

def _mask_draws(key, size, max_width):
    kw, ks = jax.random.split(key)
    value = jax.random.uniform(kw, (), minval=0.0, maxval=float(max_width))
    start = jax.random.uniform(ks, (), minval=0.0,
                               maxval=float(size) - value)
    return float(value), float(start)


def _specaug_draws(keys, t, f):
    """keys: (B,) SpecAug keys -> the port's draws dict."""
    out = {"f": {"value": [], "start": []}, "t": {"value": [], "start": []}}
    for k in keys:
        kf, kt = jax.random.split(k)
        for ax, kk, size, w in (("f", kf, f, 48), ("t", kt, t, 192)):
            v, s = _mask_draws(kk, size, w)
            out[ax]["value"].append(v)
            out[ax]["start"].append(s)
    import torch
    return {ax: {n: torch.tensor(v, dtype=torch.float32)
                 for n, v in d.items()} for ax, d in out.items()}


def _noise_draws(keys, t, f):
    import torch
    noise, scale, shift = [], [], []
    for k in keys:
        kn, ks, kr = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.uniform(kn, (t, f))))
        scale.append(float(jax.random.uniform(ks, ())))
        shift.append(int(jax.random.randint(kr, (), -1024, 1024)))
    return {"noise": torch.from_numpy(np.stack(noise)),
            "scale": torch.tensor(scale, dtype=torch.float32),
            "shift": torch.tensor(shift, dtype=torch.int64)}


def _jitter_draws(key, b):
    fs, orders = [], []
    for k in jax.random.split(key, b):
        kf, ko = jax.random.split(k)
        fs.append(np.asarray(jax.random.uniform(kf, (3,), minval=0.6,
                                                maxval=1.4)))
        orders.append(np.asarray(jax.random.permutation(ko, 3)))
    return np.stack(fs), np.stack(orders)


def _patch(monkeypatch):
    """Both packages' drivers build the test's vocabulary, decode through
    the C++ loader the port builds, and draw JAX's draws."""
    import torch
    from mla_tpu.data import native_loader as jnl
    from mla_tpu_torch.data import native_loader, pipeline
    from mla_tpu_torch.data import transforms as T
    from mla_tpu_torch.models import classifiers
    from mla_tpu_torch.ops import specaug as sa
    from mla_tpu_torch.runtime import driver
    # imported before the patch: export binds make_classifier by name at
    # its import, and a first import under the patch would keep the
    # test's vocabulary for every later test of the process
    from mla_tpu_torch.runtime import export  # noqa: F401

    make, build = classifiers.make_classifier, classifiers.build_classifier
    monkeypatch.setattr(classifiers, "make_classifier",
                        lambda cfg, text_vocab_size=VOCAB, q8=None:
                        make(cfg, VOCAB, q8))
    monkeypatch.setattr(driver, "build_classifier",
                        lambda cfg, seed=0: build(cfg, seed, VOCAB))
    monkeypatch.setattr(jnl, "_lib", native_loader._load())
    assert jnl.available()
    monkeypatch.setattr(pipeline, "batch_generator",
                        lambda seed, epoch, step, device: (seed, epoch, step))

    def key_of(gen):
        seed, epoch, step = gen
        return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                     epoch), step)

    def jitter(gen, x):
        f, order = _jitter_draws(key_of(gen), x.shape[0])
        return T.apply_jitter(x, torch.from_numpy(f), torch.from_numpy(order))

    def fbank_keys(gen, b):
        # CAVAdapter.finish_batch: split(key) -> (image, fbank); then
        # cav_fbank_transform: split(fbank key) -> (SpecAug, noise)
        k1, k2 = jax.random.split(jax.random.split(key_of(gen))[1])
        return jax.random.split(k1, (b, 2))[:, 0], jax.random.split(k2, b)

    monkeypatch.setattr(T, "color_jitter_batch", jitter)
    monkeypatch.setattr(sa, "specaug_draws", lambda gen, b, t, f, dev, *a:
                        _specaug_draws(fbank_keys(gen, b)[0], t, f))
    monkeypatch.setattr(sa, "noise_roll_draws", lambda gen, b, t, f, dev:
                        _noise_draws(fbank_keys(gen, b)[1], t, f))


def _jax_run(monkeypatch, jcfg):
    from mla_tpu.runtime import checkpoint as jck
    from mla_tpu.runtime import driver as jdriver

    lasts = {}

    def spy(ckpt_dir, state, meta, name="best"):
        if name == "last":
            lasts[meta["saved_epoch"]] = (jck._to_saveable(state), dict(meta))
        return os.path.join(ckpt_dir, name)

    monkeypatch.setattr(jck, "save_checkpoint_async", spy)
    state, result = jdriver.run(jcfg)
    state = jax.tree.map(np.asarray, state.replace(
        rng=jax.random.key_data(state.rng)))
    return state, result, lasts


_PAIRS = {}


def _pair(monkeypatch, trees, tmp_path_factory, family):
    """JAX's uninterrupted two epochs and the port's epoch 1 resumed from
    JAX's epoch-0 `last` state, both ending with --export_dir (one
    rung: a full batch)."""
    _patch(monkeypatch)
    if family in _PAIRS:
        return _PAIRS[family]
    from mla_tpu_torch.models.convert import train_state_from_jax
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib
    from mla_tpu_torch.runtime.driver import run

    d = tmp_path_factory.mktemp(family)
    kw = _kw(family, trees[family], d / "jax", export_batch_sizes=(4,))
    jcfg = JConfig(**dict(kw, export_dir=str(d / "jax_export"))).validate()
    jstate, jres, lasts = _jax_run(monkeypatch, jcfg)
    snap, meta = lasts[0]
    cfg = _port_cfg(**dict(kw, ckpt_path=str(d / "port"),
                           export_dir=str(d / "port_export")))
    start = train_state_from_jax(
        cfg, snap["params"], None, snap["opt_state"], snap.get("gs"),
        snap.get("qmf"), snap["step"], device="cpu")
    path = ckpt_lib.save_checkpoint(cfg.ckpt_path, start, meta, name="last")
    state, res = run(cfg.replace(resume=path, save_last=False), device="cpu")
    shutil.rmtree(cfg.ckpt_path)        # the states compared are in memory
    _PAIRS[family] = (jcfg, jstate, jres, cfg, state, res)
    return _PAIRS[family]


def _assert_tree(cfg, jtree, ttree, what):
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax

    want = state_dict_from_jax(_tree_f32(jtree), cfg)
    assert set(want) == set(ttree), what
    for n, w in want.items():
        np.testing.assert_allclose(ttree[n].detach().float().numpy(),
                                   w.numpy(), atol=STEP_TOL[0],
                                   rtol=STEP_TOL[1], err_msg=f"{what}: {n}")


def _epoch1(res):
    return next(h for h in res["history"] if h["epoch"] == 1)


@pytest.mark.parametrize("family", list(FAMILY))
def test_resumed_epoch_matches_jax_driver(monkeypatch, trees,
                                          tmp_path_factory, family, capsys):
    """Epoch 1 by --resume from JAX's epoch 0: the losses, accuracies,
    parameters, momentum and GS projector of JAX's uninterrupted run."""
    jcfg, jstate, jres, cfg, state, res = _pair(monkeypatch, trees,
                                                tmp_path_factory, family)
    assert [h["epoch"] for h in res["history"]] == [1]
    jh, h = _epoch1(jres), _epoch1(res)
    mods = ("a", "v", "t") if cfg.modal3 else ("a", "v")
    for k in ("loss",) + tuple(f"loss_{m}" for m in mods):
        np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    assert h["acc"] == jh["acc"] and res["best_acc"] == jres["best_acc"]
    _assert_tree(cfg, jstate.params, state.params, "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state.opt_state["momentum"], "momentum")
    np.testing.assert_allclose(state.gs.Pl.numpy(), jstate.gs.Pl,
                               atol=STEP_TOL[0], rtol=STEP_TOL[1])


@pytest.mark.parametrize("family", list(FAMILY))
def test_export_torch_equals_jax(monkeypatch, trees, tmp_path_factory,
                                 tmp_path, family):
    """--export_torch of the converted JAX state: the JAX package's .pth
    (keys, values, metadata) exactly."""
    import torch
    from mla_tpu.models.torch_export import save_torch_checkpoint as jsave
    from mla_tpu_torch.models.convert import train_state_from_jax
    from mla_tpu_torch.models.torch_export import save_torch_checkpoint

    jcfg, jstate, _, cfg, _, _ = _pair(monkeypatch, trees, tmp_path_factory,
                                       family)
    jsave(str(tmp_path / "jax.pth"), (jstate.params, {}), jcfg, epoch=1,
          acc=0.4)
    state = train_state_from_jax(cfg, jstate.params, device="cpu")
    save_torch_checkpoint(str(tmp_path / "port.pth"), state.model, cfg,
                          epoch=1, acc=0.4)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert {k: v for k, v in got.items() if k != "model"} == \
        {k: v for k, v in want.items() if k != "model"}
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype, k
        torch.testing.assert_close(got["model"][k], v, atol=0, rtol=0)
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("family", list(FAMILY))
def test_export_specs_equal_jax_and_serve(monkeypatch, trees,
                                          tmp_path_factory, family):
    """--export_dir: the feature specs of JAX's artifact (names, shapes,
    types), and one request through the port's artifact answers as the
    JAX eval forward of JAX's final weights (within the epoch's
    parameter tolerance)."""
    import json

    import torch
    from mla_tpu.evals.metrics import eval_logits as jeval
    from mla_tpu_torch.runtime.export import load_serving

    jcfg, jstate, _, cfg, state, _ = _pair(monkeypatch, trees,
                                           tmp_path_factory, family)
    jmeta = json.load(open(os.path.join(jcfg.export_dir, "meta.json")))
    pmeta = json.load(open(os.path.join(cfg.export_dir, "meta.json")))
    want = {k: (v["shape"], v["dtype"]) for k, v in
            jmeta["feature_specs"].items() if k != "valid"}
    assert {k: (v["shape"], v["dtype"]) for k, v in
            pmeta["feature_specs"].items()} == want
    srv = load_serving(cfg.export_dir, device="cpu")
    rng = np.random.default_rng(0)
    feats = {k: (rng.integers(0, VOCAB, [3] + shape) if dt == "int32" else
                 rng.standard_normal([3] + shape)).astype(dt)
             for k, (shape, dt) in want.items()}
    if "padding_mask" in feats:
        feats["padding_mask"] = np.zeros_like(feats["padding_mask"])
    got = srv(feats)
    jmodel = jcls.build_classifier(jcfg)
    out_m, fused = jeval(jmodel, jcfg, jstate.params, {},
                         {k: jnp.asarray(v) for k, v in feats.items()},
                         jnp.ones(3, jnp.float32))
    np.testing.assert_allclose(got["fused"], np.asarray(fused), atol=1e-4,
                               rtol=1e-3)
    for m, o in out_m.items():
        np.testing.assert_allclose(got[f"logits_{m}"], np.asarray(o),
                                   atol=1e-4, rtol=1e-3, err_msg=m)
    assert torch.is_tensor(next(srv.model.parameters()))


# ------------------------------------------------------------------- int8

INT8 = {"cav_int8": ("cav", "int8", False),
        "cav_int8_a8": ("cav", "int8_a8", False),
        "modal3_int8": ("modal3", "int8", False),
        "modal3_int8_scan": ("modal3", "int8", True),
        "modal3_int8_a8_scan": ("modal3", "int8_a8", True)}


def _dequant_patch_convs(q):
    """The JAX int8 tree with each CAV-MAE patch conv's {'q8', 'scale'}
    node dequantized as the port does (q8.bf16 * scale.bf16)."""
    out = dict(q)
    for name in ("mae_a", "mae_v"):
        e = out.get(name)
        if not isinstance(e, dict):
            continue
        e = dict(e)
        for pe in ("patch_embed_a", "patch_embed_v"):
            if pe in e:
                k = e[pe]["proj"]["kernel"]
                e[pe] = {"proj": {**e[pe]["proj"], "kernel": (
                    jnp.asarray(k["q8"]).astype(jnp.bfloat16)
                    * jnp.asarray(k["scale"]).astype(jnp.bfloat16))}}
        out[name] = e
    return out


def _jax_int8(jcfg, params, feats, a8, skip=(), fix=True):
    from mla_tpu.models import layers as jl
    from mla_tpu.models import m3ae as jm3
    from mla_tpu.ops import q8_matmul as jq
    from mla_tpu.runtime.export import _quantize_int8, make_serving_fn

    model = jcls.build_classifier(jcfg)
    q = _quantize_int8(params)
    if fix:
        q = _dequant_patch_convs(q)
    serve = make_serving_fn(model, jcfg, dequant=True, a8=a8,
                            a8_skip=frozenset(skip))
    batch = {k: jnp.asarray(v) for k, v in feats.items()}
    batch["valid"] = jnp.ones(len(next(iter(feats.values()))), jnp.float32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jl, "q8_matmul", functools.partial(jq.q8_matmul,
                                                      interpret=True))
        mp.setattr(jl, "q8_matmul_stacked", functools.partial(
            jq.q8_matmul_stacked, interpret=True))
        mp.setattr(jm3, "q8_matmul", functools.partial(jq.q8_matmul,
                                                       interpret=True))
        mp.setattr(jq, "q8_mlp_stacked", functools.partial(
            jq.q8_mlp_stacked, interpret=True))
        out = serve(q, {}, batch)
    finally:
        mp.undo()
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _feats(family, n=4, seed=3):
    rng = np.random.default_rng(seed)
    f = {"fbank": rng.standard_normal((n, T_AUDIO, 128)).astype(np.float32),
         "image": rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)}
    if family == "modal3":
        f["token"] = rng.integers(0, VOCAB, (n, TOKENS)).astype(np.int32)
        pm = np.zeros((n, TOKENS), np.float32)
        pm[0, 6:] = 1.0
        f["padding_mask"] = pm
    return f


@pytest.mark.parametrize("kind", list(INT8))
def test_int8_serving_matches_jax(monkeypatch, trees, tmp_path_factory,
                                  tmp_path, kind):
    """The port's int8 artifact of JAX's trained weights (export_serving
    of the bridged model) against JAX's int8 serving function with the
    kernel laws, the CAV-MAE patch conv dequantized on both sides; the
    block sites int8 (CAV-MAE unrolled always), the patch conv and head
    dequantized; calibration names JAX's sites."""
    import torch
    from mla_tpu.runtime.export import _quantize_int8
    from mla_tpu.runtime.export import calibrate_a8 as jcalibrate
    from mla_tpu_torch.models.classifiers import make_classifier
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.models.layers import Q8Linear
    from mla_tpu_torch.runtime.export import export_serving, load_serving

    family, dtype, scan = INT8[kind]
    jcfg, jstate, _, cfg, _, _ = _pair(monkeypatch, trees, tmp_path_factory,
                                       family)
    jcfg, cfg = jcfg.replace(scan_blocks=scan), cfg.replace(scan_blocks=scan)
    params = jax.tree.map(np.asarray, jstate.params)
    model = make_classifier(cfg, VOCAB)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True,
                          assign=True)
    feats = _feats(family)
    art = export_serving(cfg, model, str(tmp_path / kind),
                         batch_sizes=(4,), weights_dtype=dtype,
                         example_batch=feats, device="cpu")
    srv = load_serving(art, device="cpu")
    sites = [m for m in srv.model.modules() if isinstance(m, Q8Linear)]
    n_cav = 4 * 2 * (2 if family == "cav" else 1)
    n_m3ae = 0 if family == "cav" else 2 * (4 + 1)
    assert len(sites) == n_cav + n_m3ae
    assert srv.model.mae_a.patch_embed_a.proj.weight.dtype == torch.float32
    jparams = params
    if scan:
        from mla_tpu.parallel.pp import to_scan_layout
        jparams = to_scan_layout(params)
    skip = srv.meta["a8_skip"]
    if dtype == "int8_a8":
        jfeats = dict(feats, valid=np.ones(4, np.float32))
        jerrs, _ = jcalibrate(jcls.build_classifier(jcfg), jcfg,
                              _dequant_patch_convs(_quantize_int8(jparams)),
                              {}, jfeats)
        errs = srv.meta["a8_site_rel_err"]
        assert set(errs) == set(jerrs)
        assert any(s.startswith("mae_a/blocks_a_0/") for s in errs)
        for s in jerrs:
            assert abs(errs[s] - jerrs[s]) <= 1e-4, s
    got = srv(feats)
    want = _jax_int8(jcfg, jparams, feats, dtype == "int8_a8", skip)
    tight = (TIGHT_CAV if family == "cav" else TIGHT)[dtype]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tight, rtol=0,
                                   err_msg=k)
    if kind == "cav_int8":
        # JAX's own int8 CAV-MAE: the patch conv's kernel unscaled
        raw = _jax_int8(jcfg, jparams, feats, False, fix=False)
        assert not np.allclose(raw["fused"], want["fused"], atol=0.05)
    shutil.rmtree(tmp_path)


# ------------------------------------------------------------- pretrained

@pytest.mark.parametrize("family", ["cav", "modal3"])
def test_pretrained_a_merges_like_jax(tmp_path, capsys, family):
    """A seeded CAV-MAE encoder .pth in the reference layout (both
    modality paths, the head, the reference's 1024-frame position table,
    a DataParallel prefix) through JAX's ``load_pretrained_encoders`` and
    the port's: the same weights exactly; keys the encoder lacks and the
    position table of the other length are skipped and printed."""
    import torch
    from mla_tpu.models import cav_mae as jcav
    from mla_tpu.models.torch_export import export_cavmae
    from mla_tpu.models.torch_import import load_pretrained_encoders as jload
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax
    from mla_tpu_torch.models.torch_import import load_pretrained_encoders

    jm = jcav.CAVMAEFT(6, img_size=IMG, audio_length=128,
                       modality_specific_depth=1, depth=2, with_head=True)
    a = jnp.zeros((1, 128, 128))
    v = jnp.zeros((1, 3, IMG, IMG))

    def touch(mdl, a, v):
        mdl.forward_feat(a, v, "av")
        return mdl(a, v, "multimodal")
    fp = jax.tree.map(np.asarray, jm.init(jax.random.key(42), a, v,
                                          method=touch)["params"])
    sd = {"module." + k: torch.from_numpy(np.ascontiguousarray(x))
          for k, x in export_cavmae(fp).items()}
    path = str(tmp_path / "cav_pretrained.pth")
    torch.save(sd, path)

    kw = dict(_kw(family, "unused", tmp_path), pretrained_a=path)
    if family == "cav":
        kw["pretrained_v"] = path
    cfg = _port_cfg(**kw)
    model = build_classifier(cfg, seed=3, text_vocab_size=VOCAB)
    jcfg = JConfig(**kw).validate()
    jmodel = jcls.build_classifier(jcfg)
    rng = np.random.default_rng(0)
    batch = {"fbank": rng.standard_normal((2, T_AUDIO, 128)),
             "image": rng.standard_normal((2, 3, IMG, IMG)),
             "token": rng.integers(0, VOCAB, (2, TOKENS)).astype(np.int32),
             "padding_mask": np.zeros((2, TOKENS))}
    batch = {k: jnp.asarray(x) if k == "token" else
             jnp.asarray(x, jnp.float32) for k, x in batch.items()}
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1),
                                                batch)["params"])
    model.load_state_dict(state_dict_from_jax(init, cfg), strict=True)
    jparams = jax.tree.map(np.asarray, jload(jcfg, dict(init)))
    jout = capsys.readouterr().out
    load_pretrained_encoders(cfg, model)
    out = capsys.readouterr().out
    assert "skip mae_a.pos_embed_a: shape" in out and \
        "skip mae_a.pos_embed_a" in jout
    assert "skip mae_a.mlp_head.1.weight: not in the model" in out
    assert "Loaded pretrained mae_a" in out
    want = state_dict_from_jax(_tree_f32(jparams), cfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    # the file's weights landed where the shapes agree
    assert torch.equal(got["mae_a.blocks_a.0.attn.qkv.weight"],
                       sd["module.blocks_a.0.attn.qkv.weight"])
    os.remove(path)
