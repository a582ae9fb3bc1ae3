"""The port's M3AE encoder and classifier against the JAX package's, at debug
size (2 blocks, 1024 wide, 16 heads, 256-token vocabulary, 32x32 images = 4
patches, 8 text tokens). Weights are initialised in JAX, carried over by
state_dict_from_jax and loaded with strict=True.

Tolerance: atol 2e-4 in fp32. Flax's LayerNorm uses the fast variance
E[x^2]-E[x]^2 and torch's the two-pass one, and sums run in other orders;
that is a tolerance, not bit equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.models import m3ae as jm3ae
from mla_tpu.models.classifiers import M3AEClassifier as JClassifier

VOCAB, L, IMG, NB = 256, 8, 32, 3
ATOL = 2e-4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pm = np.zeros((NB, L), np.float32)
    pm[0, 5:] = 1.0          # padded text
    pm[2, 1:] = 1.0
    return {"token": rng.integers(0, VOCAB, (NB, L)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((NB, 3, IMG, IMG)).astype(np.float32)}


def _patches(image):
    b = image.shape[0]
    x = image.reshape(b, 3, IMG // 16, 16, IMG // 16, 16)
    return x.transpose(0, 2, 4, 1, 3, 5).reshape(b, -1, 768)


@pytest.fixture(scope="module")
def encoder_pair():
    import torch
    from mla_tpu_torch.models.convert import m3ae_state_dict
    from mla_tpu_torch.models.m3ae import M3AEConfig, M3AEEncoder

    torch.set_num_threads(1)
    jenc = jm3ae.M3AEEncoder(jm3ae.M3AEConfig(model_type="debug",
                                              text_vocab_size=VOCAB))
    b = _batch()
    params = jenc.init(jax.random.key(0), jnp.asarray(_patches(b["image"])),
                       jnp.asarray(b["token"]))["params"]
    params = jax.tree.map(np.asarray, params)
    with torch.device("meta"):
        tenc = M3AEEncoder(M3AEConfig(model_type="debug",
                                      text_vocab_size=VOCAB))
    tenc.load_state_dict(m3ae_state_dict(params), strict=True, assign=True)
    return jenc, params, tenc.eval()


@pytest.mark.parametrize("modality", ["text", "image", "both"])
def test_encoder_matches_jax(encoder_pair, modality):
    import torch

    jenc, params, tenc = encoder_pair
    b = _batch(1)
    image = _patches(b["image"]) if modality in ("image", "both") else None
    text = b["token"] if modality in ("text", "both") else None
    pm = b["padding_mask"] if text is not None else None
    want = np.asarray(jenc.apply(
        {"params": params},
        None if image is None else jnp.asarray(image),
        None if text is None else jnp.asarray(text),
        None if pm is None else jnp.asarray(pm)))
    with torch.no_grad():
        got = tenc(None if image is None else torch.from_numpy(image),
                   None if text is None else torch.from_numpy(text),
                   None if pm is None else torch.from_numpy(pm)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _classifier_pair(scan_blocks, gs):
    import torch
    from mla_tpu_torch.models.classifiers import M3AEClassifier
    from mla_tpu_torch.models.convert import state_dict_from_jax

    jmodel = JClassifier(n_classes=101, gs_flag=gs,
                         model_type="debug", text_vocab_size=VOCAB,
                         scan_blocks=scan_blocks, dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1), jb,
                                                  train=False)["params"])
    cfg = JConfig(dataset="Food101", lorb="m3ae", gs_flag=gs,
                  m3ae_size="debug", scan_blocks=scan_blocks).validate()
    with torch.device("meta"):
        tmodel = M3AEClassifier(n_classes=101, gs_flag=gs,
                                model_type="debug", text_vocab_size=VOCAB)
    tmodel.load_state_dict(state_dict_from_jax(params, cfg), strict=True,
                           assign=True)
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("scan_blocks,gs", [
    (False, True),     # MLA shared head
    (True, True),      # --scan_blocks stacked layout
    (False, False),    # joint concat fusion
])
def test_classifier_matches_jax(scan_blocks, gs):
    import torch

    torch.set_num_threads(1)
    jmodel, params, tmodel = _classifier_pair(scan_blocks, gs)
    b = _batch(2)
    want = jmodel.apply({"params": params},
                        {k: jnp.asarray(v) for k, v in b.items()},
                        train=False)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_seeded_init_is_deterministic_and_keeps_the_quirks():
    """build_classifier draws from an explicit generator: same seed, same
    weights; cls/type embeddings are mean 0.02, std 1.0 (the reference's
    .normal_(0.02)); the text table is N(0, 1)."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier

    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    m3ae_size="debug").validate()
    a = build_classifier(cfg, seed=3, text_vocab_size=VOCAB).state_dict()
    b = build_classifier(cfg, seed=3, text_vocab_size=VOCAB).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    tbl = a["mae_a.text_embedding.weight"]
    assert abs(float(tbl.mean())) < 0.02 and abs(float(tbl.std()) - 1) < 0.02
    cls = torch.cat([a["mae_a.cls_token"], a["mae_v.cls_token"],
                     a["mae_a.encoder_text_type_embedding"]]).flatten()
    assert abs(float(cls.std()) - 1.0) < 0.1
    head = a["fusion_module.fc_out.weight"]
    assert float(head.abs().max()) <= 1024 ** -0.5
