"""The port's serving path always takes the flat attention route
(mla_tpu_torch/runtime/export.py:ServingModel), as the JAX package traces its
serving graph with the flat kernels forced on (mla_tpu/runtime/export.py,
export_from_driver), whatever the process's route switch
(``ops.attention.set_flat_attention``) says; the caller's setting comes
back afterwards. Debug M3AE (2 blocks, 1024 wide, 16 heads, 256-token
vocabulary, 8 tokens, 32x32 images, --gs_flag -dynamic), fp32, on the CPU
(plain versions); the logits with the switch off equal those with it on,
bit for bit, since both run the same route.
"""

import numpy as np
import pytest

VOCAB, L, IMG, NB = 256, 8, 32, 2


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    pm = np.zeros((NB, L), np.float32)
    pm[0, 5:] = 1.0
    return {"token": rng.integers(0, VOCAB, (NB, L)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((NB, 3, IMG, IMG)).astype(np.float32)}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.runtime.export import export_serving

    torch.set_num_threads(1)
    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    dynamic=True, m3ae_size="debug", image_size=IMG,
                    compute_dtype="float32").validate()
    model = build_classifier(cfg, seed=0, text_vocab_size=VOCAB)
    return export_serving(cfg, model, str(tmp_path_factory.mktemp("route")),
                          batch_sizes=(NB,), example_batch=_feats(),
                          device="cpu")


def _counting(monkeypatch):
    """Count apply() of both attention autograd Functions."""
    from mla_tpu_torch.ops import attention

    calls = {"flat": 0, "head": 0}
    for key, fn in (("flat", attention.FlatAttention),
                    ("head", attention.HeadAttention)):
        def counted(*args, _key=key, _apply=fn.apply):
            calls[_key] += 1
            return _apply(*args)
        monkeypatch.setattr(fn, "apply", counted)
    return calls


@pytest.mark.parametrize("switch", [False, True])
def test_serving_takes_the_flat_route_whatever_the_switch(artifact,
                                                          monkeypatch,
                                                          switch):
    from mla_tpu_torch.ops import attention
    from mla_tpu_torch.runtime.export import load_serving

    srv = load_serving(artifact, device="cpu")
    want = srv(_feats(1))               # the default switch: flat
    calls = _counting(monkeypatch)
    attention.set_flat_attention(switch)
    try:
        got = srv(_feats(1))
        assert attention._FLAT_ENABLED is switch      # restored
    finally:
        attention.set_flat_attention(True)
    # 2 blocks in each of the 2 encoders, all through FlatAttention
    assert calls == {"flat": 4, "head": 0}, calls
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_route_context_restores_the_setting_on_error():
    from mla_tpu_torch.ops import attention

    attention.set_flat_attention(False)
    try:
        with pytest.raises(RuntimeError):
            with attention.flat_attention_route(True):
                assert attention._FLAT_ENABLED is True
                raise RuntimeError("inside")
        assert attention._FLAT_ENABLED is False
    finally:
        attention.set_flat_attention(True)
