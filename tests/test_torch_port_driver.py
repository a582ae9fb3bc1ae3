"""The port's driver and CLI (``mla_tpu_torch/runtime/{driver,cli,
checkpoint}.py``) against the JAX package's, on a synthetic CREMA-D tree.

From the same state: the JAX driver trains epoch 0 with --save_last; its
``last`` state (the host snapshot its checkpoint holds) is converted with
``convert.train_state_from_jax`` and written with the port's
``save_checkpoint``; then epoch 1 runs in both packages (--resume in the
port, the JAX run going on uninterrupted) from the files on disk, through
the adapters, the loaders and the on-device transform. Epoch 1's losses,
accuracies, parameters, momentum, BatchNorm statistics, GS ``Pl`` and QMF
history must agree: --gs_flag for a whole epoch (two steps, the second on a
padded batch), OGM_GE and QMF for one step each (QMF on a padded batch with
masked files, so the ``idx`` sentinel and the masking are in it).

As in tests/test_torch_port_train_av.py (whose tolerances these are, by
step count), both packages run float32 weights and optimizer state with
float64 activations (compute_dtype float64, JAX under jax.enable_x64), so a
ReLU input within rounding of 0 cannot flip between them. The frames still
pass the float32 transform in both, which agree to ~1e-7. OGM_GE draws its
noise from another generator than JAX's: everything its noise does not
reach is held (the losses, the running statistics, every parameter and
momentum but the encoders' conv weights).

Port-only: an interrupted run resumed equals an uninterrupted one bit for
bit on the CPU; best-checkpoint names and metadata; the warm start drops
only fc_out; eval-only from a port checkpoint and from a reference-layout
.pth gives the training run's accuracy; --export_dir logits equal the eval
model's; the CLI parses the README's CREMA-D lines to the JAX package's
config; unported flags raise.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.core.config import config_from_args as jax_config_from_args
from mla_tpu.data import synthetic as jsyn

TOL = {1: (1e-6, 1e-5), 2: (3e-6, 3e-5)}      # (atol, rtol) by step count
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module")
def tiny_cremad(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cre"))
    jsyn.make_cremad(root, n_train=6, n_test=5, spec_shape=(33, 40))
    return root


def _kw(root, ckpt, **kw):
    base = dict(dataset="CREMAD", lorb="base", image_size=32,
                resnet_stages=(1, 1, 1, 1), batch_size=4, data_root=root,
                ckpt_path=str(ckpt), num_workers=2, log_every=1,
                use_tensorboard=False, train=True, epochs=2,
                mesh_shape=(1, 1))
    base.update(kw)
    return base


def _port_cfg(**kw):
    from mla_tpu_torch.core.config import MLAConfig
    return MLAConfig(**kw).validate()


# ---------------------------------------------------------------- JAX side

def _jax_run(monkeypatch, jcfg, max_steps):
    """The JAX driver, uninterrupted; returns (state, result, {epoch:
    (snapshot of its `last` checkpoint, meta)})."""
    from mla_tpu.runtime import checkpoint as jck
    from mla_tpu.runtime import driver as jdriver

    lasts = {}
    orig = jck.save_checkpoint_async

    def spy(ckpt_dir, state, meta, name="best"):
        if name == "last":
            lasts[meta["saved_epoch"]] = (jck._to_saveable(state), dict(meta))
        return orig(ckpt_dir, state, meta, name=name)

    monkeypatch.setattr(jck, "save_checkpoint_async", spy)
    # both packages decode through the C++ loader the port builds (the JAX
    # package's own build would write native/, which another test process
    # may be compiling into at the same moment)
    from mla_tpu.data import native_loader as jnl
    from mla_tpu_torch.data import native_loader
    monkeypatch.setattr(jnl, "_lib", native_loader._load())
    assert jnl.available()
    # the running statistics in the activations' type from the start, as
    # flax promotes them to it at the first update (one compile, not two)
    create = jdriver.create_train_state
    monkeypatch.setattr(jdriver, "create_train_state", lambda *a, **k: (
        lambda s: s.replace(batch_stats=jax.tree.map(
            lambda x: x.astype(np.float64), s.batch_stats)))(create(*a, **k)))
    with jax.enable_x64(True):
        state, result = jdriver.run(jcfg, max_steps_per_epoch=max_steps)
        state = jax.tree.map(np.asarray, state.replace(
            rng=jax.random.key_data(state.rng)))
    return state, result, lasts


_PAIRS = {}


def _pair(monkeypatch, tiny_cremad, tmp_path_factory, name, max_steps, **kw):
    """JAX's uninterrupted two epochs and the port's epoch 1 resumed from
    JAX's epoch-0 `last` state, once per configuration."""
    if name in _PAIRS:
        return _PAIRS[name]
    from mla_tpu_torch.models.convert import train_state_from_jax
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib
    from mla_tpu_torch.runtime.driver import run

    d = tmp_path_factory.mktemp(name)
    kw = _kw(tiny_cremad, d / "jax", compute_dtype="float64", **kw)
    jcfg = JConfig(**kw).validate()
    jstate, jres, lasts = _jax_run(monkeypatch, jcfg, max_steps)
    snap, meta = lasts[0]
    cfg = _port_cfg(**dict(kw, ckpt_path=str(d / "port")))
    start = train_state_from_jax(
        cfg, snap["params"], snap["batch_stats"], snap["opt_state"],
        snap.get("gs"), snap.get("qmf"), snap["step"], device="cpu")
    path = ckpt_lib.save_checkpoint(cfg.ckpt_path, start, meta, name="last")
    state, res = run(cfg.replace(resume=path), max_steps_per_epoch=max_steps,
                     device="cpu")
    _PAIRS[name] = (jcfg, jstate, jres, cfg, state, res, lasts)
    return _PAIRS[name]


def _assert_tree(cfg, jtree, ttree, atol, rtol, what, skip=lambda n: False):
    from mla_tpu_torch.models.convert import _tree_f32, state_dict_from_jax

    want = state_dict_from_jax(_tree_f32(jtree), cfg)
    assert set(want) <= set(ttree), what
    for n, w in want.items():
        if not skip(n):
            w = w.numpy()
            np.testing.assert_allclose(
                ttree[n].detach().float().numpy(), w,
                atol=atol * max(1.0, float(np.abs(w).max())), rtol=rtol,
                err_msg=f"{what}: {n}")


def _assert_stats(jstats, model, rtol):
    from mla_tpu_torch.models.convert import batch_stats_from_jax

    buffers = dict(model.named_buffers())
    for n, w in batch_stats_from_jax(jstats).items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[n].numpy(), w.numpy(),
                                       atol=rtol, rtol=rtol, err_msg=n)


def _epoch1(res):
    return next(h for h in res["history"] if h["epoch"] == 1)


def _assert_losses(jres, res, keys=("loss", "loss_a", "loss_v")):
    jh, h = _epoch1(jres), _epoch1(res)
    for k in keys:
        np.testing.assert_allclose(h[k], jh[k], rtol=LOSS_RTOL, atol=0,
                                   err_msg=k)


def test_mla_epoch_matches_jax_driver(monkeypatch, tiny_cremad,
                                      tmp_path_factory):
    """--gs_flag: epoch 1, two MLA steps (the second on a batch padded
    with two rows) and the eval over 5 clips (one padded batch)."""
    jcfg, jstate, jres, cfg, state, res, _ = _pair(
        monkeypatch, tiny_cremad, tmp_path_factory, "gs", None, gs_flag=True)
    assert [h["epoch"] for h in res["history"]] == [1]
    _assert_losses(jres, res)
    assert _epoch1(res)["acc"] == _epoch1(jres)["acc"]
    assert res["best_acc"] == jres["best_acc"]
    atol, rtol = TOL[2]
    _assert_tree(cfg, jstate.params, state.params, atol, rtol, "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state.opt_state["momentum"], atol, rtol, "momentum")
    _assert_stats(jstate.batch_stats, state.model, LOSS_RTOL)
    np.testing.assert_array_equal(state.gs.Pl.numpy(), jstate.gs.Pl)
    assert state.gs.exp_count == int(jstate.gs.exp_count) == 8
    assert state.step == int(jstate.step) == 4


def test_jax_last_checkpoint_is_the_state_converted(monkeypatch, tiny_cremad,
                                                    tmp_path_factory):
    """The snapshot the comparison converts is what JAX's `last`
    checkpoint holds on disk (read back with Orbax), and the port's
    checkpoint of the converted state restores it exactly."""
    import orbax.checkpoint as ocp
    import torch
    from mla_tpu_torch.models.convert import train_state_from_jax
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib

    jcfg, jstate, _, cfg, _, _, lasts = _pair(
        monkeypatch, tiny_cremad, tmp_path_factory, "gs", None, gs_flag=True)
    disk = ocp.PyTreeCheckpointer().restore(
        os.path.abspath(os.path.join(jcfg.ckpt_path, "last")))
    snap = lasts[1][0]
    jax.tree.map(np.testing.assert_array_equal, disk["params"],
                 snap["params"])
    jax.tree.map(np.testing.assert_array_equal, disk["opt_state"],
                 snap["opt_state"])
    state = train_state_from_jax(cfg, snap["params"], snap["batch_stats"],
                                 snap["opt_state"], snap["gs"], None,
                                 snap["step"], device="cpu")
    path = ckpt_lib.save_checkpoint(str(cfg.ckpt_path) + "_x", state,
                                    {"saved_epoch": 1}, name="last")
    again = train_state_from_jax(cfg, snap["params"], snap["batch_stats"],
                                 device="cpu")
    ckpt_lib.restore_checkpoint(path, again)
    for a, b in zip(state.model.state_dict().values(),
                    again.model.state_dict().values()):
        assert torch.equal(a, b)
    for n, m in state.opt_state["momentum"].items():
        assert torch.equal(m, again.opt_state["momentum"][n])
    assert torch.equal(state.gs.Pl, again.gs.Pl) and again.step == 4


def test_ogm_ge_step_matches_jax_driver_but_its_noise(monkeypatch, tiny_cremad,
                                                      tmp_path_factory):
    jcfg, jstate, jres, cfg, state, res, _ = _pair(
        monkeypatch, tiny_cremad, tmp_path_factory, "ogm_ge", 1,
        modulation="OGM_GE")
    _assert_losses(jres, res)
    p = state.params

    def noised(n):
        return n.split(".")[0] in ("audio_net", "visual_net") and \
            p[n].dim() == 4
    atol, rtol = TOL[1]
    _assert_tree(cfg, jstate.params, p, atol, rtol, "params", noised)
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state.opt_state["momentum"], atol, rtol, "momentum", noised)
    _assert_stats(jstate.batch_stats, state.model, LOSS_RTOL)
    assert state.step == int(jstate.step) == 2


def test_qmf_step_matches_jax_driver(monkeypatch, tiny_cremad,
                                     tmp_path_factory):
    """QMF at batch 8: the single batch holds 6 clips and 2 padded rows
    (idx = n_data, the scratch slot), the last 3 clips' spectrograms are
    masked (--mask_percent 0.5 --mask_m audio)."""
    jcfg, jstate, jres, cfg, state, res, _ = _pair(
        monkeypatch, tiny_cremad, tmp_path_factory, "qmf", 1,
        modulation="QMF", batch_size=8, mask_percent=0.5, mask_m="audio")
    _assert_losses(jres, res)
    assert _epoch1(res)["acc"] == _epoch1(jres)["acc"]
    atol, rtol = TOL[1]
    _assert_tree(cfg, jstate.params, state.params, atol, rtol, "params")
    _assert_tree(cfg, jstate.opt_state["momentum"],
                 state.opt_state["momentum"], atol, rtol, "momentum")
    _assert_stats(jstate.batch_stats, state.model, LOSS_RTOL)
    for store in ("correctness", "confidence"):
        for m, v in getattr(state.qmf, store).items():
            want = np.asarray(getattr(jstate.qmf, store)[m])
            assert v.shape == want.shape == (7,)      # n_data + scratch
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{store} {m}")


# ---------------------------------------------------------------- port only

def _port_run(root, ckpt, max_steps=None, **kw):
    from mla_tpu_torch.runtime.driver import run
    cfg = _port_cfg(**_kw(root, ckpt, compute_dtype="float32", **kw))
    return cfg, run(cfg, max_steps_per_epoch=max_steps, device="cpu")


def _best(ckpt_dir):
    names = [n for n in os.listdir(ckpt_dir) if n.startswith("best_model")
             and not n.endswith(".json")]
    return [os.path.join(ckpt_dir, n) for n in sorted(names)]


def test_resumed_run_equals_uninterrupted_bitwise(tiny_cremad, tmp_path):
    import torch

    _, (full, full_res) = _port_run(tiny_cremad, tmp_path / "full", epochs=3,
                                    gs_flag=True, batch_size=2)
    cfg, _ = _port_run(tiny_cremad, tmp_path / "cut", epochs=2, gs_flag=True,
                       batch_size=2)
    _, (resumed, res) = _port_run(tiny_cremad, tmp_path / "cut", epochs=3,
                                  gs_flag=True, batch_size=2,
                                  resume=str(tmp_path / "cut" / "last"))
    assert [h["epoch"] for h in res["history"]] == [2]
    a, b = full_res["history"][2], res["history"][0]
    clocks = ("train_s", "wall_s")
    assert {k: v for k, v in a.items() if k not in clocks} == \
        {k: v for k, v in b.items() if k not in clocks}
    assert res["best_acc"] == full_res["best_acc"]
    for (n, x), (_, y) in zip(full.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(x, y), n
    for n, m in full.opt_state["momentum"].items():
        assert torch.equal(m, resumed.opt_state["momentum"][n]), n
    assert torch.equal(full.gs.Pl, resumed.gs.Pl)
    assert torch.equal(full.rng.get_state(), resumed.rng.get_state())
    assert full.step == resumed.step == 9


def test_checkpoints_meta_warm_start_eval_only_and_exports(tiny_cremad,
                                                           tmp_path):
    import torch
    from mla_tpu_torch.models.convert import load_reference_checkpoint
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib
    from mla_tpu_torch.runtime.driver import run
    from mla_tpu_torch.runtime.export import load_serving
    from mla_tpu_torch.evals.metrics import eval_logits

    cfg, (state, res) = _port_run(
        tiny_cremad, tmp_path / "ck", epochs=2, gs_flag=True,
        export_torch=str(tmp_path / "final.pth"),
        export_dir=str(tmp_path / "serve"))
    best = _best(cfg.ckpt_path)
    assert best, os.listdir(cfg.ckpt_path)
    name = os.path.basename(best[-1])
    epoch = max(h["epoch"] for h in res["history"]
                if h["acc"] == res["best_acc"] and h["acc"] > 0)
    assert name == ("best_model_of_dataset_CREMAD_Normal_alpha_0.3_optimizer_"
                    f"sgd_modulate_starts_0_ends_50_epoch_{epoch}_acc_"
                    f"{res['best_acc']}")
    meta = ckpt_lib.load_meta(best[-1])
    assert meta == {"saved_epoch": epoch, "modulation": "Normal",
                    "alpha": 0.3, "fusion": "concat", "acc": res["best_acc"]}
    os.remove(best[-1] + ".meta.json")        # a crash before the meta write
    assert ckpt_lib.load_meta(best[-1]) == {
        "reconstructed": True, "saved_epoch": epoch, "acc": res["best_acc"]}
    last = ckpt_lib.load_meta(os.path.join(cfg.ckpt_path, "last"))
    assert last["saved_epoch"] == 1 and last["best_acc"] == res["best_acc"]
    assert os.path.isfile(os.path.join(best[-1], ckpt_lib.STATE_FILE))
    # weight averaging over every checkpoint of the directory, BatchNorm
    # statistics included
    sds = [torch.load(os.path.join(cfg.ckpt_path, n, ckpt_lib.STATE_FILE),
                      weights_only=True)["model"]
           for n in sorted(os.listdir(cfg.ckpt_path))
           if os.path.isdir(os.path.join(cfg.ckpt_path, n))]
    avg = ckpt_lib.wa_params(cfg.ckpt_path)
    assert len(sds) == len(best) + 1 and set(avg) == set(sds[0])
    for n, v in avg.items():
        if v.is_floating_point():
            torch.testing.assert_close(v, sum(sd[n] for sd in sds) / len(sds))

    # eval-only from the best checkpoint and from the reference-layout .pth
    ev = cfg.replace(train=False, ckpt_path=best[-1], export_torch="",
                     export_dir=None)
    _, accs = run(ev, device="cpu")
    assert accs["acc"] == res["best_acc"]
    saved = torch.load(tmp_path / "final.pth", weights_only=True)
    assert saved["saved_epoch"] == 1 and saved["acc"] == res["best_acc"]
    assert all(k.startswith("module.") for k in saved["model"])
    _, accs = run(ev.replace(ckpt_path=str(tmp_path / "final.pth")),
                  device="cpu")
    assert accs["acc"] == res["history"][-1]["acc"]
    sd = load_reference_checkpoint(str(tmp_path / "final.pth"))
    for n, v in state.model.state_dict().items():
        assert torch.equal(sd[n], v.float() if v.is_floating_point() else v)

    # --export_dir: the artifact's logits are the final eval model's
    srv = load_serving(str(tmp_path / "serve"), device="cpu")
    rng = np.random.default_rng(0)
    feats = {"spec": rng.standard_normal((3, 1, 33, 40)).astype(np.float32),
             "image": rng.standard_normal((3, 3, 3, 32, 32)).astype(
                 np.float32)}
    out = srv(feats)
    batch = {k: torch.from_numpy(v) for k, v in feats.items()}
    batch["valid"] = torch.ones(3)
    state.model.eval()
    with torch.inference_mode():
        out_m, fused = eval_logits(state.model, cfg, batch, batch["valid"])
    np.testing.assert_allclose(out["fused"], fused.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["logits_a"], out_m["a"].numpy(),
                               rtol=1e-6, atol=1e-6)

    # warm start: every parameter but the shared head's output layer
    # loads; BatchNorm statistics keep the new model's
    _, (warm, _) = _port_run(tiny_cremad, tmp_path / "warm", epochs=0,
                             gs_flag=True, ckpt_load_path_train=best[-1])
    raw = torch.load(os.path.join(best[-1], ckpt_lib.STATE_FILE),
                     weights_only=True)["model"]
    for n, p in warm.model.named_parameters():
        assert torch.equal(p, raw[n]) != n.startswith("fusion_module.fc_out"), n
    assert torch.equal(warm.model.audio_net.bn1.running_var,
                       torch.ones(64))


def test_port_torch_export_equals_jax_export(monkeypatch, tiny_cremad,
                                             tmp_path_factory, tmp_path):
    """--export_torch: the port's .pth of the converted JAX state holds the
    JAX package's .pth (keys, values, metadata) exactly, except the shape
    of BatchNorm's ``num_batches_tracked``: the JAX export writes it with
    shape (1,) (``np.ascontiguousarray`` of a 0-d array), the port the 0-d
    tensor the reference's BatchNorm2d holds."""
    import torch
    from mla_tpu.models.torch_export import save_torch_checkpoint as jsave
    from mla_tpu_torch.models.convert import train_state_from_jax
    from mla_tpu_torch.models.torch_export import save_torch_checkpoint

    jcfg, jstate, _, cfg, _, _, _ = _pair(
        monkeypatch, tiny_cremad, tmp_path_factory, "gs", None, gs_flag=True)
    jsave(str(tmp_path / "jax.pth"), (jstate.params, jstate.batch_stats),
          jcfg, epoch=1, acc=0.4)
    state = train_state_from_jax(cfg, jstate.params, jstate.batch_stats,
                                 device="cpu")
    save_torch_checkpoint(str(tmp_path / "port.pth"), state.model, cfg,
                          epoch=1, acc=0.4)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert {k: v for k, v in got.items() if k != "model"} == \
        {k: v for k, v in want.items() if k != "model"}
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        if k.endswith("num_batches_tracked"):
            assert got["model"][k].shape == () and v.shape == (1,)
            v = v.reshape(())
        assert got["model"][k].dtype == v.dtype, k
        torch.testing.assert_close(got["model"][k], v, atol=0, rtol=0)


def test_tensorboard_profile_and_flag_checks(tiny_cremad, tmp_path, capsys):
    from mla_tpu.runtime.driver import scalar_groups as jax_groups
    from mla_tpu_torch.runtime.driver import run, scalar_groups

    cfg, _ = _port_run(tiny_cremad, tmp_path / "ck", epochs=1,
                       modulation="OGM_GE", batch_size=2,
                       use_tensorboard=True,
                       tensorboard_path=str(tmp_path / "tb"),
                       profile_dir=str(tmp_path / "prof"), scan_unroll=1,
                       compile_cache=str(tmp_path / "cc"))
    out = capsys.readouterr().out
    assert "NOTE: --compile_cache names a JAX mechanism" in out
    runs = os.listdir(tmp_path / "tb" / "CREMAD")
    assert len(runs) == 1 and runs[0].startswith("concat_OGM_GE_")
    assert os.listdir(tmp_path / "tb" / "CREMAD" / runs[0])
    assert os.path.isfile(tmp_path / "prof" / "train_steps.json")
    m, a = {"loss": 1.0, "loss_a": 2.0, "loss_v": 3.0}, {"acc": 0.5}
    assert scalar_groups(cfg, m, a) == jax_groups(cfg, m, a)

    for kw, item in ((dict(mesh_shape=(2, 1)), "9"), (dict(fsdp=True), "9"),
                     (dict(dist_coordinator="localhost:1234"), "9"),
                     (dict(seq_parallel=True), "9"),
                     (dict(pp_microbatches=2, scan_blocks=True), "9"),
                     (dict(mesh_shape=(1, 2)), "9"),
                     (dict(pp_remat=True), "9"),
                     (dict(dist_num_processes=2), "9"),
                     (dict(seq_parallel=True, lorb="large"), "9")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            run(cfg.replace(**kw), device="cpu")
    # the families of ROADMAP item 8 are ported: their flags pass the check
    from mla_tpu_torch.runtime.driver import check_flags
    for kw in (dict(cav_augnois=True, lorb="large"), dict(clip=True),
               dict(lorb="m3ae", dataset="IEMOCAP", modal3=True)):
        check_flags(cfg.replace(**kw))


README_LINES = [
    "--train --ckpt_path ckpt --batch_size 64 --lorb base --modulation Normal "
    "--epochs 100 --dataset CREMAD --gs_flag --data_root /path/to/CREMA-D",
    "--ckpt_path ckpt/name --batch_size 64 --lorb base --dataset CREMAD "
    "--gs_flag",
    "--train --ckpt_path ckpt --batch_size 64 --lorb base --modulation "
    "OGM_GE --epochs 100 --dataset CREMAD --alpha 0.8",
    "--train --lorb base --dataset CREMAD --modulation QMF --mask_percent 0.3 "
    "--mask_m audio --resume ckpt/last --no_save_last --av_alpha=0.6",
]


@pytest.mark.parametrize("line", range(len(README_LINES)))
def test_cli_parses_the_jax_config(line):
    from mla_tpu_torch.runtime.cli import parse_args

    argv = README_LINES[line].split()
    want = dataclasses.asdict(jax_config_from_args(argv))
    for device in ("cuda", "cpu"):
        extra = [] if device == "cuda" else ["--device", "cpu"]
        cfg, dev = parse_args(extra + argv)
        assert dev == device and dataclasses.asdict(cfg) == want
