"""The port's ResNet-18 path against the JAX package's: the 3x3 conv op
(mla_tpu_torch/ops/conv3x3.py) and its backward against ``conv3x3`` in
interpret mode and ``conv3x3_vjp``; BatchNorm (models/norm.py), plain and
masked, against flax ``nn.BatchNorm`` and ``MaskedBatchNorm``; ``ResNet18``
and ``AVClassifier`` in train and eval mode; and the ResNet weight and
optimizer-state bridges of convert.py against ``export_classifier``.

Debug size: stages 1,1,1,1 (full widths 64..512), a (1, 33, 40) spectrogram,
2 frames of 32x32, batch 4. JAX initialises the weights (and BatchNorm's
statistics); convert.py carries them over and the port loads them with
strict=True. On the CPU the port's conv op runs its plain version.

Tolerances. Conv: fp32 atol 1e-5 + rtol 1e-5 (exact products, sums over
9*C terms in another order); bf16 2e-2 (the port rounds its output to bf16,
the Pallas kernel returns fp32 of bf16 operands: one bf16 ulp). BatchNorm:
fp32 atol 1e-5, running statistics 1e-6 (sums in another order); bf16
outputs 2e-2 (one ulp). ResNet18 and AVClassifier: atol 2e-4 in fp32
(through 18 convs and BatchNorms).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.models import torch_export
from mla_tpu.models.norm import MaskedBatchNorm
from mla_tpu.models.resnet import ResNet18 as JResNet18
from mla_tpu.ops.conv3x3 import conv3x3 as jconv3x3
from mla_tpu.ops.conv3x3 import conv3x3_vjp as jconv3x3_vjp

STAGES = (1, 1, 1, 1)
NB, T, IMG, SPEC = 4, 2, 32, (33, 40)
ATOL = 2e-4


def _nchw(x):
    import torch
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2))).contiguous(
            memory_format=torch.channels_last)


def _conv_case(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) / np.sqrt(9 * c)).astype(
        np.float32)
    return x, k


def _oihw(k):
    import torch
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,h,w,c", [(2, 6, 7, 64), (1, 5, 3, 128)])
def test_conv_op_matches_pallas_interpret(b, h, w, c, dtype_name, tol):
    import torch
    from mla_tpu_torch.ops.conv3x3 import conv3x3_vjp

    x, k = _conv_case(b, h, w, c)
    want = jconv3x3(jnp.asarray(x), jnp.asarray(k), interpret=True,
                    compute_dtype=getattr(jnp, dtype_name))
    dt = getattr(torch, dtype_name)
    got = conv3x3_vjp(_nchw(x).to(dt), _oihw(k).to(dt))
    assert got.dtype == dt
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_conv_backward_matches_conv3x3_vjp():
    """dx (the conv on the rotated, channel-swapped weight) and dw
    (PyTorch's weight-gradient) against jax.grad through conv3x3_vjp, fp32:
    atol 1e-5 + rtol 1e-5."""
    import torch
    from mla_tpu_torch.ops.conv3x3 import conv3x3_vjp

    x, k = _conv_case(2, 6, 7, 64, seed=1)
    gx, gk = jax.grad(lambda x, k: jnp.sum(jnp.sin(jconv3x3_vjp(
        x, k, True, jnp.float32))), (0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = _nchw(x).requires_grad_()
    kt = _oihw(k).requires_grad_()
    dx, dk = torch.autograd.grad(torch.sum(torch.sin(conv3x3_vjp(xt, kt))),
                                 (xt, kt))
    np.testing.assert_allclose(dx.numpy().transpose(0, 2, 3, 1),
                               np.asarray(gx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dk.numpy().transpose(2, 3, 1, 0),
                               np.asarray(gk), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ BatchNorm

def _bn_case(c=8, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 5, 6, c)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    stats = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, params, stats


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
@pytest.mark.parametrize("mode", ["train", "masked", "masked_empty", "eval"])
def test_batchnorm_matches_flax(mode, dtype_name, tol):
    """Output and running statistics. 'masked' has one padded row;
    'masked_empty' no valid row (the running statistics stay)."""
    import torch
    from mla_tpu_torch.models.norm import BatchNorm

    x, params, stats = _bn_case()
    jdt = getattr(jnp, dtype_name)
    valid = {"masked": np.array([1, 1, 0, 1], np.float32),
             "masked_empty": np.zeros(4, np.float32)}.get(mode)
    train = mode != "eval"
    variables = {"params": params, "batch_stats": stats}
    xj = jnp.asarray(x).astype(jdt)
    if valid is None:
        mod = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                           epsilon=1e-5, dtype=jdt)
        want, new = mod.apply(variables, xj, mutable=["batch_stats"])
    else:
        mod = MaskedBatchNorm(use_running_average=False, momentum=0.9,
                              epsilon=1e-5, dtype=jdt)
        want, new = mod.apply(variables, xj, jnp.asarray(valid),
                              mutable=["batch_stats"])
    bn = BatchNorm(8)
    bn.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"]),
        "num_batches_tracked": torch.zeros((), dtype=torch.long)})
    bn.train(train)
    dt = getattr(torch, dtype_name)
    with torch.no_grad():
        got = bn(_nchw(x).to(dt),
                 None if valid is None else torch.from_numpy(valid))
    assert got.dtype == dt
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, buf).numpy(),
                                   np.asarray(new["batch_stats"][key]),
                                   atol=1e-6, rtol=1e-6, err_msg=buf)
        assert getattr(bn, buf).dtype == torch.float32
    if mode in ("eval", "masked_empty"):
        np.testing.assert_array_equal(bn.running_mean.numpy(), stats["mean"])


# ------------------------------------------------------------ ResNet18

def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"spec": rng.standard_normal((NB, 1) + SPEC).astype(np.float32),
            "image": rng.standard_normal((NB, 3, T, IMG, IMG)).astype(
                np.float32),
            "valid": np.array([1, 1, 1, 0], np.float32)}


def _perturbed_stats(stats, seed=3):
    """Running statistics away from their 0/1 start, so eval mode reads
    something only the bridge can have carried."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(
            np.float32), stats)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("modality", ["audio", "visual"])
def test_resnet18_matches_jax(modality, train):
    import torch
    from mla_tpu_torch.models.convert import (batch_stats_from_jax,
                                              resnet_state_dict)
    from mla_tpu_torch.models.resnet import ResNet18, fold_frames

    torch.set_num_threads(1)
    b = _inputs()
    if modality == "audio":
        x = b["spec"]
    else:
        x = fold_frames(torch.from_numpy(b["image"])).numpy()
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    jnet = JResNet18(modality=modality, stage_sizes=STAGES)
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(0), xj,
                                                   train=True))
    stats = _perturbed_stats(variables["batch_stats"])
    want, new = jnet.apply({"params": variables["params"],
                            "batch_stats": stats}, xj, train=train,
                           mutable=["batch_stats"])
    with torch.device("meta"):
        net = ResNet18(x.shape[1], STAGES)
    sd = resnet_state_dict(variables["params"])
    sd.update({k[len("audio_net."):]: v for k, v in batch_stats_from_jax(
        {"audio_net": stats}).items()})
    net.load_state_dict(sd, strict=True, assign=True)
    net.train(train)
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=ATOL, rtol=ATOL)
    moved = {k[len("audio_net."):]: v for k, v in batch_stats_from_jax(
        {"audio_net": new["batch_stats"]}).items()}
    for name, t in net.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), moved[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


# ------------------------------------------------------------ AVClassifier

def _jcfg(**kw):
    return JConfig(dataset="CREMAD", lorb="base", compute_dtype="float32",
                   resnet_stages=STAGES, train=True, **kw).validate()


def _jax_av(cfg, seed=0):
    from mla_tpu.models.classifiers import build_classifier
    model = build_classifier(cfg)
    b = {k: jnp.asarray(v) for k, v in _inputs().items()}
    variables = jax.tree.map(np.asarray, model.init(jax.random.key(seed), b,
                                                    train=True))
    return model, variables["params"], variables["batch_stats"]


def _port_av(cfg, params, stats):
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import make_classifier
    from mla_tpu_torch.models.convert import state_dict_from_jax

    tcfg = MLAConfig(**{f: getattr(cfg, f) for f in (
        "dataset", "lorb", "gs_flag", "modulation", "masked_bn",
        "resnet_stages", "pallas_conv", "compute_dtype")}).validate()
    model = make_classifier(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg, stats),
                          strict=True, assign=True)
    torch.set_num_threads(1)
    return model, tcfg


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kw", [
    dict(gs_flag=True), dict(gs_flag=True, pallas_conv="on"),
    dict(modulation="Normal"), dict(modulation="QMF"),
    dict(modulation="Normal", masked_bn=True)],
    ids=["gs", "gs_pallas_conv", "concat", "qmf", "masked_bn"])
def test_av_classifier_matches_jax(kw, train):
    """The forward's outputs, and in train mode the running statistics it
    leaves (under --masked_bn over the valid rows only)."""
    import torch
    from mla_tpu_torch.models.convert import batch_stats_from_jax

    cfg = _jcfg(**kw)
    jmodel, params, stats = _jax_av(cfg)
    stats = _perturbed_stats(stats)
    b = _inputs()
    want, new = jmodel.apply({"params": params, "batch_stats": stats},
                             {k: jnp.asarray(v) for k, v in b.items()},
                             train=train, mutable=["batch_stats"])
    model, _ = _port_av(cfg, params, stats)
    model.train(train)
    got = model({k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL, rtol=ATOL,
                                   err_msg=k)
    buffers = dict(model.named_buffers())
    for name, t in batch_stats_from_jax(new["batch_stats"]).items():
        np.testing.assert_allclose(buffers[name].numpy(), t.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_av_heads_are_xavier_normal_and_the_build_is_seeded():
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier

    cfg = MLAConfig(dataset="CREMAD", lorb="base",
                    resnet_stages=STAGES).validate()
    a, b = build_classifier(cfg, seed=3), build_classifier(cfg, seed=3)
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert p.equal(q), n
    w = a.fusion_module.fc_out.weight
    assert w.shape == (6, 1024)
    assert abs(float(w.std()) - (2 / (1024 + 6)) ** 0.5) < 5e-3
    assert float(a.fusion_module.fc_out.bias.abs().max()) == 0.0
    conv = a.audio_net.layer2[0].conv1.weight         # (128, 64, 3, 3)
    assert abs(float(conv.std()) - (2 / (128 * 9)) ** 0.5) < 2e-3
    assert float(a.visual_net.bn1.running_var.min()) == 1.0


# ------------------------------------------------------------ bridges

@pytest.mark.parametrize("kw", [dict(gs_flag=True), dict(modulation="QMF")],
                         ids=["gs", "qmf"])
def test_state_dict_from_jax_equals_export_classifier(kw):
    from mla_tpu_torch.models.convert import state_dict_from_jax

    cfg = _jcfg(**kw)
    _, params, stats = _jax_av(cfg)
    stats = _perturbed_stats(stats)
    want = torch_export.export_classifier(params, stats, cfg)
    got = state_dict_from_jax(params, cfg, stats)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_opt_state_from_jax_transposes_conv_momentum():
    """SGD momentum crosses with the parameters' map (conv kernels HWIO ->
    OIHW, BatchNorm scale -> weight) and holds no buffer."""
    from mla_tpu_torch.models.convert import (opt_state_from_jax,
                                              state_dict_from_jax)

    cfg = _jcfg(gs_flag=True)
    _, params, stats = _jax_av(cfg)
    mom = jax.tree.map(lambda a: np.asarray(a) * 0.5 + 1.0, params)
    got = opt_state_from_jax({"momentum": mom}, cfg)["momentum"]
    model, tcfg = _port_av(cfg, params, stats)
    assert set(got) == set(dict(model.named_parameters()))
    want = state_dict_from_jax(mom, tcfg)
    for n, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[n].numpy(), err_msg=n)
    k = np.asarray(mom["audio_net"]["layer2_0"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        got["audio_net.layer2.0.conv1.weight"].numpy(),
        k.transpose(3, 2, 0, 1))


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16"])
def test_av_serving_matches_jax_eval_logits(tmp_path, weights_dtype):
    """export_serving -> load_serving -> run_batch of the AV family against
    the JAX package's eval_logits on the same weights and running
    statistics (--gs_flag -dynamic, 3 rows padded to the rung of 4): fp32
    compute, 2e-4 for float32 weights, 2e-2 for bf16 weights (rounded
    once). BatchNorm's running statistics travel in float32 either way, and
    a request changes none of them."""
    import torch
    from mla_tpu.evals.metrics import eval_logits as jax_eval_logits
    from mla_tpu_torch.runtime.export import export_serving, load_serving
    from mla_tpu_torch.runtime.serve import run_batch

    cfg = _jcfg(gs_flag=True, dynamic=True)
    jmodel, params, stats = _jax_av(cfg)
    stats = _perturbed_stats(stats)
    b = {k: v[:3] for k, v in _inputs().items()}
    out_m, fused = jax_eval_logits(
        jmodel, cfg, params, stats,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.ones(3))
    model, tcfg = _port_av(cfg, params, stats)
    art = export_serving(tcfg, model, str(tmp_path / "av"),
                         batch_sizes=(1, 4), weights_dtype=weights_dtype,
                         example_batch=b)
    srv = load_serving(art, device="cpu", compute_dtype="float32")
    assert srv.meta["feature_specs"]["image"]["shape"] == [3, T, IMG, IMG]
    assert srv.meta["config"]["resnet_stages"] == list(STAGES)
    before = {n: t.clone() for n, t in srv.model.named_buffers()}
    assert all(t.dtype != torch.bfloat16 for t in before.values())
    got = run_batch(srv, {k: b[k] for k in ("spec", "image")})
    assert all(torch.equal(t, before[n])
               for n, t in srv.model.named_buffers())
    tol = ATOL if weights_dtype == "float32" else 2e-2
    np.testing.assert_allclose(got["fused"], np.asarray(fused), atol=tol,
                               rtol=tol)
    for m in ("a", "v"):
        np.testing.assert_allclose(got[f"logits_{m}"], np.asarray(out_m[m]),
                                   atol=tol, rtol=tol)
