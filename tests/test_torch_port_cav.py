"""The port's CAV-MAE encoder (``models/cav_mae.py``, ``layers.CAVBlock``),
its rectangular sin-cos table and the weight bridge of the three families
it brings (``--lorb large``, ``--modal3``, ``--clip``) against the JAX
package's.

Size: 768 wide, 12 heads, ``--cav_blocks 1,2`` (one block per modality,
one shared), ``--audio_length 128`` (an 8 x 8 audio grid, 64 tokens),
32x32 images (4 visual tokens). Weights are initialised in JAX, carried
over by ``convert.state_dict_from_jax`` / ``cavmae_state_dict`` and
loaded with ``strict=True``.

Tolerances: atol 2e-4 in fp32, as the other encoder tests (sums in other
orders; the block's LayerNorm is two-pass in both packages, the final
norms' fast variance in flax); under bf16 compute the relative L2 of the
outputs <= 1e-2 (bf16 roundings at the same points, one ulp apart where
the fp32 sums before them differ). The sin-cos table is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.models import cav_mae as jcav
from mla_tpu.models import layers as jlayers
from mla_tpu.models.torch_export import export_classifier
from mla_tpu.ops import pos_embed as jpos

ATOL, BF16_REL = 2e-4, 1e-2
T_AUDIO, IMG, NB, D = 128, 32, 2, 768
MODES = ["multimodal", "audioonly", "videoonly", "missingaudioonly",
         "missingvideoonly"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NB, T_AUDIO, 128)).astype(np.float32),
            rng.standard_normal((NB, 3, IMG, IMG)).astype(np.float32))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("grid", [(8, 64), (14, 14), (8, 8), (2, 2)])
def test_pos_embed_rect_exact(grid):
    from mla_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed_rect
    for cls in (False, True):
        np.testing.assert_array_equal(
            get_2d_sincos_pos_embed_rect(D, *grid, cls_token=cls),
            jpos.get_2d_sincos_pos_embed_rect(D, *grid, cls_token=cls))


@pytest.fixture(scope="module")
def block_pair():
    import torch
    from mla_tpu_torch.models.convert import cavmae_state_dict
    from mla_tpu_torch.models.layers import CAVBlock

    torch.set_num_threads(1)
    jblk = jlayers.CAVBlock(D, 12)
    x = np.random.default_rng(1).standard_normal((NB, 20, D)).astype(
        np.float32)
    params = jax.tree.map(np.asarray, jblk.init(
        jax.random.key(0), jnp.asarray(x))["params"])
    # the six LayerNorms apart, so each modality's pick shows
    rng = np.random.default_rng(2)
    params = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
                  if k.startswith("norm") else v) for k, v in params.items()}
    sd = {k[len("blocks_a.0."):]: v for k, v in
          cavmae_state_dict({"blocks_a_0": params}).items()}
    with torch.device("meta"):
        tblk = CAVBlock(D, 12)
    tblk.load_state_dict(sd, strict=True, assign=True)
    return jblk, params, tblk, x


@pytest.mark.parametrize("modality", [None, "a", "v"])
def test_cav_block_matches_flax(block_pair, modality):
    import torch
    jblk, params, tblk, x = block_pair
    want = np.asarray(jblk.apply({"params": params}, jnp.asarray(x),
                                 modality))
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), modality).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _jax_full_init(jm, a, v):
    """Every submodule's parameters: the 'av' features and the
    multimodal forward (flax creates a submodule's parameters when it
    runs)."""
    def touch(mdl, a, v):
        mdl.forward_feat(a, v, "av")
        return mdl(a, v, "multimodal")
    return jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), jnp.asarray(a), jnp.asarray(v),
        method=touch)["params"])


@pytest.fixture(scope="module")
def encoder_pair():
    import torch
    from mla_tpu_torch.models.cav_mae import CAVMAEFT
    from mla_tpu_torch.models.convert import cavmae_state_dict

    torch.set_num_threads(1)
    kw = dict(label_dim=6, img_size=IMG, audio_length=T_AUDIO,
              modality_specific_depth=1, depth=2, with_head=True)
    a, v = _inputs()
    jm = jcav.CAVMAEFT(**kw)
    params = _jax_full_init(jm, a, v)
    with torch.device("meta"):
        tm = CAVMAEFT(**kw)
    tm.load_state_dict(cavmae_state_dict(params), strict=True, assign=True)
    return jm, params, tm


def _port(tm, fn, dtype=None):
    import torch
    tm.compute_dtype = dtype
    try:
        with torch.no_grad():
            return fn(tm)
    finally:
        tm.compute_dtype = None


@pytest.mark.parametrize("mode", ["a", "v", "av"])
def test_forward_feat_matches_flax(encoder_pair, mode):
    import torch
    jm, params, tm = encoder_pair
    a, v = _inputs(3)
    want = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(v), mode,
                    method=jm.forward_feat)
    got = _port(tm, lambda m: m.forward_feat(torch.from_numpy(a),
                                             torch.from_numpy(v), mode))
    want = want if mode == "av" else (want,)
    got = got if mode == "av" else (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_head_modes_match_flax(encoder_pair, mode):
    import torch
    jm, params, tm = encoder_pair
    a, v = _inputs(4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(a),
                               jnp.asarray(v), mode))
    got = _port(tm, lambda m: m(torch.from_numpy(a), torch.from_numpy(v),
                                mode))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["a", "multimodal"])
def test_bf16_compute_matches_flax(encoder_pair, mode):
    """fp32 weights, bf16 compute: the residual stream fp32 (the fp32
    position and modality embeddings promote it), the final norms bf16."""
    import torch
    jm, params, tm = encoder_pair
    a, v = _inputs(5)
    jb = jm.clone(dtype=jnp.bfloat16)
    if mode == "a":
        want = jb.apply({"params": params}, jnp.asarray(a), None, "a",
                        method=jb.forward_feat)
        got = _port(tm, lambda m: m.forward_feat(torch.from_numpy(a), None,
                                                 "a"), torch.bfloat16)
        # the stream before the final norm is fp32, as in JAX
        emb = _port(tm, lambda m: m._embed_a(torch.from_numpy(a)),
                    torch.bfloat16)
        assert emb.dtype == torch.float32
    else:
        want = jb.apply({"params": params}, jnp.asarray(a), jnp.asarray(v),
                        mode)
        got = _port(tm, lambda m: m(torch.from_numpy(a), torch.from_numpy(v),
                                    mode), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    rel = _rel(got.float().numpy(), np.asarray(want, np.float32))
    assert rel <= BF16_REL, rel


# the 3-modal family at M3AE's base width with one block ("base1"): its
# shared head takes the 768-d CAV-MAE and M3AE features alike, so the
# 1024-wide debug size cannot run --gs_flag in either package
M3 = dict(dataset="IEMOCAP", lorb="m3ae", modal3=True, m3ae_size="base1")
FAMILIES = {
    "large": dict(dataset="CREMAD", lorb="large", gs_flag=True),
    "large_joint": dict(dataset="CREMAD", lorb="large"),
    "modal3": dict(M3, gs_flag=True),
    "modal3_qmf": dict(M3, modulation="QMF"),
    "modal3_joint": M3,
    "clip": dict(dataset="Food101", clip=True, gs_flag=True),
    "clip_joint": dict(dataset="Food101", clip=True),
}


def _family_params(kw):
    import functools
    from mla_tpu.models import classifiers as jcls
    from mla_tpu.models.m3ae import M3AEConfig

    cfg = JConfig(**{"m3ae_size": "debug", **kw}, audio_length=T_AUDIO,
                  cav_blocks=(1, 2), image_size=IMG).validate()
    rng = np.random.default_rng(6)
    batch = {"fbank": rng.standard_normal((NB, T_AUDIO, 128)),
             "image": rng.standard_normal((NB, 3, IMG, IMG)),
             "token": rng.integers(0, 64, (NB, 8)).astype(np.int32),
             "padding_mask": np.zeros((NB, 8)),
             "token_feat": rng.standard_normal((NB, 512)),
             "image_feat": rng.standard_normal((NB, 512))}
    batch = {k: jnp.asarray(v, jnp.int32 if k == "token" else jnp.float32)
             for k, v in batch.items()}
    mp = pytest.MonkeyPatch()
    # a 64-token vocabulary (the JAX Modal3Classifier takes none)
    mp.setattr(jcls, "M3AEConfig", functools.partial(M3AEConfig,
                                                     text_vocab_size=64))
    try:
        model = jcls.build_classifier(cfg)
        params = model.init(jax.random.key(0), batch)["params"]
    finally:
        mp.undo()
    return cfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_equals_export_classifier(family):
    """``state_dict_from_jax`` key for key and bit for bit equal to the
    JAX package's ``export_classifier``, and the port's classifier of
    that configuration loads it with strict=True."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import make_classifier
    from mla_tpu_torch.models.convert import state_dict_from_jax

    jcfg, params = _family_params(FAMILIES[family])
    want = export_classifier(params, {}, jcfg)
    got = state_dict_from_jax(params, jcfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    cfg = MLAConfig(**{"m3ae_size": "debug", **FAMILIES[family]},
                    audio_length=T_AUDIO, cav_blocks=(1, 2),
                    image_size=IMG).validate()
    model = make_classifier(cfg, 64)
    model.load_state_dict(got, strict=True, assign=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
