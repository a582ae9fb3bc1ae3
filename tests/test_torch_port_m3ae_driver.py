"""The port's driver and CLI on the M3AE image-text path (``--lorb m3ae``,
Food-101 and MVSA) against the JAX package's, on synthetic trees, with
block remat, pretrained encoders and the export's feature specs.

From the same state: the JAX driver trains epoch 0 with --save_last; its
``last`` snapshot is converted with ``convert.train_state_from_jax`` and
written with the port's ``save_checkpoint``; epoch 1 then runs in both
packages (--resume in the port, the JAX run going on uninterrupted) from
the files on disk: tokens, JPEGs, the adapters, the loaders and the
on-device cubic + jitter transform. --gs_flag -dynamic, two steps an epoch
(the second on a batch padded with two rows), batch 4. The jitter's draws
are ``jax.random``'s in JAX; the port's loader is fed JAX's draws of the
same key, fold_in(fold_in(key(seed), epoch), step).

Debug size: 2 blocks, 1024 wide, 16 heads, a 256-token vocabulary (the
trees' token caches are written modulo it), 12 tokens, 32x32 images; both
drivers build the classifier with that vocabulary. fp32 on the CPU (no
ReLU reaches an M3AE, so fp32 activations hold as in
tests/test_torch_port_train.py). Tolerances: losses 1e-6 relative (with
atol 1e-6); parameters, momentum and GS ``Pl`` after epoch 1's two steps at
that file's three-step tolerance (atol 3e-5, rtol 3e-4: two steps lie
between its one- and three-step cases); equal accuracies.

Also: MVSA's step against JAX's; --export_dir's feature specs equal
JAX's (the token int32) and its logits the eval model's. Port-only: an
interrupted run resumed equals an uninterrupted one bit for bit; eval-only
reproduces the training run's accuracy; the CLI parses the M3AE lines to
the JAX package's config. Block remat and --pretrained_v:
tests/test_torch_port_m3ae_remat.py.
"""

import dataclasses
import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.core.config import config_from_args as jax_config_from_args
from mla_tpu.data import synthetic as jsyn
from mla_tpu.models.classifiers import build_classifier as jax_build

VOCAB, TOKENS = 256, 12
STEP_TOL = {1: (1e-5, 1e-4), 2: (3e-5, 3e-4)}   # (atol, rtol) by step count
LOSS_RTOL = 1e-6


def _jitter_draws(key, b):
    fs, orders = [], []
    for k in jax.random.split(key, b):
        kf, ko = jax.random.split(k)
        fs.append(np.asarray(jax.random.uniform(kf, (3,), minval=0.6,
                                                maxval=1.4)))
        orders.append(np.asarray(jax.random.permutation(ko, 3)))
    return np.stack(fs), np.stack(orders)


def _write_tree(root, dataset, n_train, n_test):
    jsyn.make_m3ae(root, dataset=dataset, n_train=n_train, n_test=n_test,
                   token_len=TOKENS, seed=1)
    for f in glob.glob(os.path.join(root, "text_token/*/*_token.npy")):
        np.save(f, np.load(f) % VOCAB)
    return root


@pytest.fixture(scope="module")
def food(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("food")), "Food101", 6, 5)


@pytest.fixture(scope="module")
def mvsa(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("mvsa")), "MVSA", 6, 5)


def _kw(root, ckpt, **kw):
    base = dict(dataset="Food101", lorb="m3ae", m3ae_size="debug",
                image_size=32, batch_size=4, data_root=root,
                ckpt_path=str(ckpt), num_workers=2, log_every=1,
                use_tensorboard=False, train=True, epochs=2, gs_flag=True,
                dynamic=True, compute_dtype="float32", mesh_shape=(1, 1))
    base.update(kw)
    return base


def _port_cfg(**kw):
    from mla_tpu_torch.core.config import MLAConfig
    return MLAConfig(**kw).validate()


def _small_vocab(monkeypatch):
    """Both packages' drivers (and the port's converters and serving
    loader) build the classifier with the test's vocabulary."""
    from mla_tpu.runtime import driver as jdriver
    from mla_tpu_torch.models import classifiers
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
    monkeypatch.setattr(jdriver, "build_classifier",
                        lambda cfg: jax_build(cfg).clone(
                            text_vocab_size=VOCAB))


def _native(monkeypatch):
    """Both packages decode through the C++ loader the port builds (the
    JAX package's own build would write native/)."""
    from mla_tpu.data import native_loader as jnl
    from mla_tpu_torch.data import native_loader

    monkeypatch.setattr(jnl, "_lib", native_loader._load())
    assert jnl.available()


def _feed_jax_draws(monkeypatch):
    import torch
    from mla_tpu_torch.data import pipeline
    from mla_tpu_torch.data import transforms as T

    monkeypatch.setattr(pipeline, "batch_generator",
                        lambda seed, epoch, step, device: (seed, epoch, step))

    def jitter(gen, x):
        seed, epoch, step = gen
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                    epoch), step)
        f, order = _jitter_draws(key, x.shape[0])
        return T.apply_jitter(x, torch.from_numpy(f), torch.from_numpy(order))

    monkeypatch.setattr(T, "color_jitter_batch", jitter)


def _jax_run(monkeypatch, jcfg, max_steps):
    """The JAX driver, uninterrupted; returns (state, result, {epoch:
    (snapshot of its `last` checkpoint, meta)}). Its checkpoints are
    snapshotted, not written: a debug M3AE state is 0.4 GB, and the
    comparison reads the snapshot (tests/test_torch_port_driver.py holds
    the JAX package's `last` on disk against its snapshot)."""
    from mla_tpu.runtime import checkpoint as jck
    from mla_tpu.runtime import driver as jdriver

    lasts = {}

    def spy(ckpt_dir, state, meta, name="best"):
        if name == "last":
            lasts[meta["saved_epoch"]] = (jck._to_saveable(state), dict(meta))
        return os.path.join(ckpt_dir, name)

    monkeypatch.setattr(jck, "save_checkpoint_async", spy)
    state, result = jdriver.run(jcfg, max_steps_per_epoch=max_steps)
    state = jax.tree.map(np.asarray, state.replace(
        rng=jax.random.key_data(state.rng)))
    return state, result, lasts


_PAIRS = {}


def _pair(monkeypatch, root, tmp_path_factory, name, max_steps=None,
          export=False, **kw):
    """JAX's uninterrupted two epochs and the port's epoch 1 resumed from
    JAX's epoch-0 `last` state, once per configuration; with ``export``
    both runs end with --export_dir."""
    if name in _PAIRS:
        return _PAIRS[name]
    from mla_tpu_torch.models.convert import train_state_from_jax
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib
    from mla_tpu_torch.runtime.driver import run

    _small_vocab(monkeypatch)
    _native(monkeypatch)
    _feed_jax_draws(monkeypatch)
    d = tmp_path_factory.mktemp(name)
    kw = _kw(root, d / "jax", **kw)
    exports = (str(d / "jax_export"), str(d / "port_export")) if export \
        else (None, None)
    if export:    # one rung: the export test serves a full batch
        kw["export_batch_sizes"] = (kw["batch_size"],)
    jcfg = JConfig(**dict(kw, export_dir=exports[0])).validate()
    jstate, jres, lasts = _jax_run(monkeypatch, jcfg, max_steps)
    snap, meta = lasts[0]
    cfg = _port_cfg(**dict(kw, ckpt_path=str(d / "port"),
                           export_dir=exports[1]))
    start = train_state_from_jax(
        cfg, snap["params"], None, snap["opt_state"], snap.get("gs"),
        snap.get("qmf"), snap["step"], device="cpu")
    path = ckpt_lib.save_checkpoint(cfg.ckpt_path, start, meta, name="last")
    state, res = run(cfg.replace(resume=path, save_last=False),
                     max_steps_per_epoch=max_steps, device="cpu")
    shutil.rmtree(cfg.ckpt_path)        # the states compared are in memory
    _PAIRS[name] = (jcfg, jstate, jres, cfg, state, res)
    return _PAIRS[name]


def _assert_tree(cfg, jtree, ttree, atol, rtol, what):
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax

    want = state_dict_from_jax(_tree_f32(jtree), cfg)
    assert set(want) == set(ttree), what
    for n, w in want.items():
        np.testing.assert_allclose(ttree[n].detach().float().numpy(),
                                   w.numpy(), atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {n}")


def _epoch1(res):
    return next(h for h in res["history"] if h["epoch"] == 1)


def _assert_losses(jres, res):
    jh, h = _epoch1(jres), _epoch1(res)
    for k in ("loss", "loss_a", "loss_v"):
        np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


def test_food101_epoch_matches_jax_driver(monkeypatch, food,
                                          tmp_path_factory):
    """--gs_flag -dynamic: epoch 1's two MLA steps (the second on a batch
    padded with two rows) and the eval over 5 samples."""
    jcfg, jstate, jres, cfg, state, res = _pair(
        monkeypatch, food, tmp_path_factory, "food", export=True)
    assert [h["epoch"] for h in res["history"]] == [1]
    _assert_losses(jres, res)
    assert _epoch1(res)["acc"] == _epoch1(jres)["acc"]
    assert res["best_acc"] == jres["best_acc"]
    atol, rtol = STEP_TOL[2]
    _assert_tree(cfg, jstate.params, state.params, atol, rtol, "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state.opt_state["momentum"], atol, rtol, "momentum")
    np.testing.assert_allclose(state.gs.Pl.numpy(), jstate.gs.Pl, atol=atol,
                               rtol=rtol)
    assert state.gs.exp_count == int(jstate.gs.exp_count) == 8
    assert state.step == int(jstate.step) == 4


def test_export_feature_specs_equal_jax_and_serve(monkeypatch, food,
                                                  tmp_path_factory):
    """--export_dir at the end of the paired runs: the port's artifact
    declares JAX's feature specs (the token int32, not float32) and one
    request through it gives the eval model's logits."""
    import torch
    from mla_tpu_torch.evals.metrics import eval_logits
    from mla_tpu_torch.runtime.export import load_serving

    jcfg, _, _, cfg, state, _ = _pair(monkeypatch, food, tmp_path_factory,
                                      "food", export=True)

    def specs(d):
        with open(os.path.join(d, "meta.json")) as f:
            return json.load(f)["feature_specs"]

    got, want = specs(cfg.export_dir), specs(jcfg.export_dir)
    assert got == want
    assert got["token"] == {"shape": [TOKENS], "dtype": "int32"}
    srv = load_serving(cfg.export_dir, device="cpu")
    rng = np.random.default_rng(0)
    n = cfg.batch_size       # a rung: no padded rows, the eval batch's GEMMs
    pm = np.zeros((n, TOKENS), np.float32)
    pm[:, 7:] = 1.0
    feats = {"token": rng.integers(0, VOCAB, (n, TOKENS)).astype(np.int32),
             "padding_mask": pm,
             "image": rng.standard_normal((n, 3, 32, 32)).astype(np.float32)}
    out = srv(feats)
    batch = {k: torch.from_numpy(v) for k, v in feats.items()}
    batch["valid"] = torch.ones(n)
    state.model.eval()
    with torch.inference_mode():
        out_m, fused = eval_logits(state.model, cfg, batch, batch["valid"])
    np.testing.assert_allclose(out["fused"], fused.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["logits_v"], out_m["v"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_mvsa_step_matches_jax_driver(monkeypatch, mvsa, tmp_path_factory):
    """--dataset MVSA (3 classes): epoch 1's first step."""
    jcfg, jstate, jres, cfg, state, res = _pair(
        monkeypatch, mvsa, tmp_path_factory, "mvsa", 1, dataset="MVSA")
    assert cfg.n_classes == 3
    assert state.model.fusion_module.fc_out.weight.shape[0] == 3
    _assert_losses(jres, res)
    atol, rtol = STEP_TOL[1]
    _assert_tree(cfg, jstate.params, state.params, atol, rtol, "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state.opt_state["momentum"], atol, rtol, "momentum")
    assert state.step == int(jstate.step) == 2


# ---------------------------------------------------------------- port only

def _port_run(monkeypatch, root, ckpt, max_steps=None, **kw):
    from mla_tpu_torch.runtime.driver import run
    _small_vocab(monkeypatch)
    _native(monkeypatch)
    cfg = _port_cfg(**_kw(root, ckpt, **kw))
    return cfg, run(cfg, max_steps_per_epoch=max_steps, device="cpu")


def test_resumed_run_equals_uninterrupted_bitwise(monkeypatch, food,
                                                  tmp_path):
    """With the port's own jitter draws (each batch's generator keyed by
    (seed, epoch, step)); eval-only from the best checkpoint gives its
    accuracy. Each run's checkpoints are deleted once read (a debug M3AE
    state is 0.4 GB)."""
    import torch
    from mla_tpu_torch.runtime.driver import run

    cfg, (_, cut_res) = _port_run(monkeypatch, food, tmp_path / "cut",
                                  epochs=2)
    _, (resumed, res) = _port_run(monkeypatch, food, tmp_path / "cut",
                                  epochs=3, save_last=False,
                                  resume=str(tmp_path / "cut" / "last"))
    assert [h["epoch"] for h in res["history"]] == [2]
    best = sorted(n for n in os.listdir(tmp_path / "cut")
                  if n.startswith("best_model") and not n.endswith(".json"))
    assert best
    epoch = int(best[-1].split("_epoch_")[1].split("_")[0])
    _, accs = run(cfg.replace(train=False,
                              ckpt_path=str(tmp_path / "cut" / best[-1])),
                  device="cpu")
    assert accs["acc"] == (cut_res["history"] + res["history"])[epoch]["acc"]
    shutil.rmtree(tmp_path / "cut")

    _, (full, full_res) = _port_run(monkeypatch, food, tmp_path / "full",
                                    epochs=3, save_last=False)
    shutil.rmtree(tmp_path / "full", ignore_errors=True)
    clocks = ("train_s", "wall_s")
    a, b = full_res["history"][2], res["history"][0]
    assert {k: v for k, v in a.items() if k not in clocks} == \
        {k: v for k, v in b.items() if k not in clocks}
    assert full_res["history"][:2] == [
        dict(h, **{c: f[c] for c in clocks})
        for h, f in zip(cut_res["history"], full_res["history"])]
    for (n, x), (_, y) in zip(full.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(x, y), n
    for n, m in full.opt_state["momentum"].items():
        assert torch.equal(m, resumed.opt_state["momentum"][n]), n
    assert torch.equal(full.gs.Pl, resumed.gs.Pl)
    assert full.step == resumed.step == 6


# -------------------------------------------------------------------- CLI

M3AE_LINES = [
    "--train --ckpt_path ckpt --batch_size 64 --lorb m3ae --modulation "
    "Normal --epochs 100 --dataset Food101 --gs_flag -dynamic "
    "--data_root /path/to/food101",
    "--train --ckpt_path ckpt --batch_size 64 --lorb m3ae --dataset MVSA "
    "--gs_flag -dynamic --scan_blocks --remat_blocks --remat_policy dots",
    "--ckpt_path ckpt/name --batch_size 64 --lorb m3ae --dataset Food101 "
    "--gs_flag -dynamic --pretrained_v m3ae.pth",
    "--ckpt_path ckpt/name --batch_size 64 --lorb m3ae --dataset MVSA "
    "--modulation QMF --scan_blocks --remat_blocks --export_dir out",
]


@pytest.mark.parametrize("line", range(len(M3AE_LINES)))
def test_cli_parses_the_jax_config(line):
    from mla_tpu_torch.runtime.cli import parse_args

    argv = M3AE_LINES[line].split()
    want = dataclasses.asdict(jax_config_from_args(argv))
    for device in ("cuda", "cpu"):
        extra = [] if device == "cuda" else ["--device", "cpu"]
        cfg, dev = parse_args(extra + argv)
        assert dev == device and dataclasses.asdict(cfg) == want
