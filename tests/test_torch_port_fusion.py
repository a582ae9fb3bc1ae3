"""The port's small modules against the JAX package's, on the CPU: fusion
heads (mla_tpu_torch/models/fusion.py; FiLM and GatedFusion under both
switches, loaded through ``convert.fusion_state_dict`` with strict=True,
also in bf16 compute at the port's bf16 tolerance, relative L2 <= 1e-2),
test-time fusion
(evals/fusion_eval.py), metrics (evals/metrics.py), the sin-cos tables
(ops/pos_embed.py) and patchify (ops/image.py). Inputs from numpy with a
fixed seed; fp32 throughout, atol 1e-5 (one fp32 matmul or softmax summed
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.evals import fusion_eval as jfe
from mla_tpu.evals import metrics as jmetrics
from mla_tpu.models import fusion as jfusion
from mla_tpu.ops import image as jimage
from mla_tpu.ops import pos_embed as jpos

ATOL = 1e-5
FEAT, N_CLS, B = 24, 7, 5


def _linear_from(lin, node):
    import torch
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.array(node["kernel"]).T))
        lin.bias.copy_(torch.from_numpy(np.array(node["bias"])))


@pytest.mark.parametrize("name,n_in", [("SharedHead", 1), ("ConcatFusion", 2),
                                       ("ConcatFusion3", 3), ("SumFusion", 2)])
def test_fusion_heads_match_jax(name, n_in):
    import torch
    from mla_tpu_torch.models import fusion

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((B, FEAT)).astype(np.float32)
          for _ in range(n_in)]
    jmod = getattr(jfusion, name)(N_CLS, torch_default=True)
    params = jmod.init(jax.random.key(0), *map(jnp.asarray, xs))["params"]
    want = jmod.apply({"params": params}, *map(jnp.asarray, xs))
    tmod = getattr(fusion, name)(FEAT, N_CLS)
    tmod.reset_parameters(torch.Generator().manual_seed(0))
    for lin_name, node in params.items():
        _linear_from(getattr(tmod, lin_name), node)
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, xs))
    if name == "SharedHead":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,switch", [("FiLM", True), ("FiLM", False),
                                         ("GatedFusion", True),
                                         ("GatedFusion", False)])
def test_film_and_gated_match_flax(name, switch, dtype):
    import torch
    from mla_tpu_torch.models import fusion
    from mla_tpu_torch.models.convert import fusion_state_dict

    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((B, FEAT)).astype(np.float32)
          for _ in range(2)]
    kw = {"x_film" if name == "FiLM" else "x_gate": switch}
    jmod = getattr(jfusion, name)(FEAT, N_CLS, **kw)
    params = jax.device_get(
        jmod.init(jax.random.key(1), *map(jnp.asarray, xs))["params"])
    tmod = getattr(fusion, name)(FEAT, FEAT, N_CLS, **kw)
    tmod.load_state_dict(fusion_state_dict(params), strict=True)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmod.clone(dtype=jdt).apply(
        {"params": params}, *[jnp.asarray(x, jdt) for x in xs])
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(x).to(tdt) for x in xs])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == tdt and w.dtype == jdt and g.shape == w.shape
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            assert _rel_l2(g, w) <= 1e-2


@pytest.mark.parametrize("name", ["FiLM", "GatedFusion"])
def test_film_and_gated_init_is_xavier_normal(name):
    import torch
    from mla_tpu_torch.models import fusion

    mod = getattr(fusion, name)(512, 512, 100)
    mod.reset_parameters(torch.Generator().manual_seed(2))
    lins = [m for m in mod.modules() if isinstance(m, torch.nn.Linear)]
    assert len(lins) == (2 if name == "FiLM" else 3)
    for lin in lins:
        std = (2.0 / (lin.in_features + lin.out_features)) ** 0.5
        w = lin.weight.detach()
        assert abs(float(w.std()) / std - 1.0) < 0.03
        assert abs(float(w.mean())) < 0.05 * std
        assert not lin.bias.detach().any()


def test_torch_default_init_bounds():
    import torch
    from mla_tpu_torch.models import fusion

    head = fusion.ConcatFusion(FEAT, N_CLS)
    head.reset_parameters(torch.Generator().manual_seed(1))
    bound = (2 * FEAT) ** -0.5
    for p in (head.fc_out.weight, head.fc_out.bias):
        top = float(p.detach().abs().max())
        assert 0.5 * bound < top <= bound


def _logits(seed=1):
    rng = np.random.default_rng(seed)
    out = {m: (3 * rng.standard_normal((B, N_CLS))).astype(np.float32)
           for m in ("a", "v", "t")}
    valid = np.array([1, 1, 1, 0, 0], np.float32)
    return out, valid


@pytest.mark.parametrize("dynamic,modal3", [(True, False), (False, False),
                                            (True, True), (False, True)])
def test_fuse_outputs_matches_jax(dynamic, modal3):
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.evals import fusion_eval

    out, valid = _logits()
    mods = ("a", "v", "t") if modal3 else ("a", "v")
    kw = dict(dataset="IEMOCAP", lorb="m3ae", modal3=True) if modal3 else \
        dict(dataset="Food101", lorb="m3ae")
    jcfg = JConfig(dynamic=dynamic, av_alpha=0.55, **kw).validate()
    tcfg = MLAConfig(dynamic=dynamic, av_alpha=0.55, **kw).validate()
    want = jfe.fuse_outputs({m: jnp.asarray(out[m]) for m in mods},
                            jnp.asarray(valid), jcfg)
    got = fusion_eval.fuse_outputs({m: torch.from_numpy(out[m]) for m in mods},
                                   torch.from_numpy(valid), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gating_pieces_match_jax():
    import torch
    from mla_tpu_torch.evals import fusion_eval

    out, valid = _logits(2)
    jo = {m: jnp.asarray(v) for m, v in out.items()}
    to = {m: torch.from_numpy(v) for m, v in out.items()}
    for m in out:
        np.testing.assert_allclose(
            float(fusion_eval.calculate_entropy(to[m],
                                                torch.from_numpy(valid))),
            float(jfe.calculate_entropy(jo[m], jnp.asarray(valid))),
            atol=ATOL, rtol=0)
    got = fusion_eval.per_sample_gating_weights(to)
    want = jfe.per_sample_gating_weights(jo)
    for m in out:
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   atol=ATOL, rtol=0)
    # padded rows never move the batch-axis gating
    out2 = {m: v.copy() for m, v in out.items()}
    for v in out2.values():
        v[3:] = 100.0
    a = fusion_eval.gating_weights(to, torch.from_numpy(valid))
    b = fusion_eval.gating_weights({m: torch.from_numpy(v)
                                    for m, v in out2.items()},
                                   torch.from_numpy(valid))
    for m in out:
        assert torch.equal(a[m], b[m])


@pytest.mark.parametrize("with_valid", [False, True])
def test_metrics_match_jax(with_valid):
    import torch
    from mla_tpu_torch.evals import metrics

    out, valid = _logits(3)
    label = np.array([0, 3, 6, 1, 1], np.int32)
    logits = out["a"]
    label[0] = int(np.argmax(logits[0]))          # at least one hit
    v = valid if with_valid else None
    got = metrics.top1_accuracy(torch.from_numpy(logits),
                                torch.from_numpy(label),
                                None if v is None else torch.from_numpy(v))
    want = jmetrics.top1_accuracy(jnp.asarray(logits), jnp.asarray(label),
                                  None if v is None else jnp.asarray(v))
    assert float(got) == pytest.approx(float(want)) and float(got) > 0
    counts = metrics.per_class_counts(torch.from_numpy(logits),
                                      torch.from_numpy(label),
                                      torch.from_numpy(valid), N_CLS)
    np.testing.assert_array_equal(
        counts.numpy(),
        np.asarray(jmetrics.per_class_counts(jnp.asarray(logits),
                                             jnp.asarray(label),
                                             jnp.asarray(valid), N_CLS)))


def test_pos_embed_and_patchify_match_jax():
    import torch
    from mla_tpu_torch.ops import image, pos_embed

    for d, n in ((768, 256), (64, 4)):
        np.testing.assert_array_equal(
            pos_embed.get_2d_sincos_pos_embed_square(d, n),
            jpos.get_2d_sincos_pos_embed_square(d, n))
        np.testing.assert_array_equal(pos_embed.get_1d_sincos_pos_embed(d, n),
                                      jpos.get_1d_sincos_pos_embed(d, n))
    img = np.random.default_rng(4).standard_normal((2, 3, 32, 48)).astype(
        np.float32)
    np.testing.assert_array_equal(
        image.patchify(torch.from_numpy(img), 16).numpy(),
        np.asarray(jimage.patchify(jnp.asarray(img), 16)))
