"""The port's frame transform (``mla_tpu_torch/ops/image.py``,
``mla_tpu_torch/data/transforms.py``) against the JAX package's.

The resample is ``jax.image.scale_and_translate`` (triangle kernel,
antialias) over a fractional box per sample; the port builds JAX's weight
matrices and applies them as two batched matmuls. The JAX package runs it
compiled (``crop_resize_normalize`` and ``image_batch_transform`` are
jitted), so the per-sample op is held under ``jax.jit`` too: XLA rounds the
sample positions its own way (1/scale folded, one fma), and the port
follows the compiled rounding.

Tolerances: the resample atol 1e-5 on [0, 1] values (float32 sums in
another order); after normalisation atol 5e-5 (1/std amplifies by about
4.4); in bfloat16 one bf16 ulp of the JAX value beyond that (a value
within float32 rounding of a bf16 rounding boundary may round the other
way; near 0 the float32 tolerance is the larger).
Box sampling is numpy in both packages and must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.data import transforms as jT
from mla_tpu.ops import image as jim

RESAMPLE_ATOL = 1e-5
NORM_ATOL = 5e-5


def _jax_crop_resize(x_hwc, boxes, out_hw):
    fn = jax.jit(jax.vmap(lambda im, b: jim._crop_resize_one(
        im, b, out_hw, "linear")))
    return np.asarray(fn(jnp.asarray(x_hwc), jnp.asarray(boxes)))


# (input H, W), out (h, w), boxes (i, j, h, w)
CASES = {
    "scale_down": ((48, 64), (16, 16), [[0, 0, 48, 64], [4.5, 3.25, 40, 52]]),
    "scale_up": ((48, 64), (40, 40), [[10, 12, 8, 9], [0.3, 0.7, 20.5, 17.25]]),
    "fractional": ((48, 48), (32, 32), [[1.37, 2.91, 30.2, 28.7],
                                        [7.77, 0.01, 39.9, 47.3]]),
    "edge": ((48, 64), (32, 32), [[0, 0, 12, 64], [36, 40, 12, 24],
                                  [0, 50, 48, 14]]),
    "non_square": ((32, 80), (24, 40), [[0, 0, 32, 80], [5, 10, 20, 60]]),
    "canonical": ((256, 256), (224, 224), [[0, 0, 256, 256],
                                           [17.3, 40.1, 180.5, 200.25],
                                           [200, 3, 56, 90]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_crop_resize_matches_scale_and_translate(case):
    import torch
    from mla_tpu_torch.ops import image as im

    (h, w), out_hw, boxes = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.random((len(boxes), h, w, 3)).astype(np.float32)
    b = np.asarray(boxes, np.float32)
    want = _jax_crop_resize(x, b, out_hw)
    got = im.crop_resize(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(b), out_hw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=RESAMPLE_ATOL, rtol=0)


def test_resample_weights_follow_jax_rule():
    """Each output row's weights sum to 1 inside the image and are 0 where
    the sample lies outside it (a box reaching past both edges: samples at
    2o - 7.5, outside for o < 4 and o > 13)."""
    import torch
    from mla_tpu_torch.ops import image as im

    w = im.resample_matrix(torch.tensor([-8.0, 0.0]), torch.tensor([32.0, 8.0]),
                           16, 20)
    sums = w.sum(-1)
    assert torch.all(sums[0, :4] == 0) and torch.all(sums[0, 14:] == 0)
    torch.testing.assert_close(sums[0, 4:14], torch.ones(10), atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(sums[1], torch.ones(16), atol=1e-6, rtol=0)
    assert torch.all(w >= 0)


def _frames(rng, b, t, hw):
    frames = rng.integers(0, 256, (b, t, hw, hw, 3), dtype=np.uint8)
    boxes = np.stack([[im_box(rng, hw) for _ in range(t)] for _ in range(b)]
                     ).astype(np.float32)
    flip = rng.random((b, t)) < 0.5
    return frames, boxes, flip


def im_box(rng, hw):
    from mla_tpu_torch.ops import image as im
    return im.random_resized_crop_params(rng, hw, hw)


def test_crop_resize_normalize_matches_jax():
    import torch
    from mla_tpu_torch.ops import image as im

    rng = np.random.default_rng(1)
    frames, boxes, flip = _frames(rng, 4, 1, 48)
    args = (frames[:, 0], boxes[:, 0], flip[:, 0])
    for to_chw in (True, False):
        want = np.asarray(jim.crop_resize_normalize(
            *(jnp.asarray(a) for a in args), jnp.asarray(jim.IMAGENET_MEAN),
            jnp.asarray(jim.IMAGENET_STD), out_hw=(32, 32), to_chw=to_chw))
        got = im.crop_resize_normalize(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
            im.IMAGENET_MEAN, im.IMAGENET_STD, out_hw=(32, 32),
            to_chw=to_chw)
        np.testing.assert_allclose(got.numpy(), want, atol=NORM_ATOL, rtol=0)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("canon,out", [(48, 32), (96, 64)])
def test_av_frames_transform_matches_jax(out_dtype, canon, out):
    import torch
    from mla_tpu_torch.data import transforms as T

    rng = np.random.default_rng(2)
    frames, boxes, flip = _frames(rng, 3, 3, canon)
    want = np.asarray(jT.av_frames_transform(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(flip),
        jax.random.key(0), out=out, out_dtype=getattr(jnp, out_dtype)
    ).astype(jnp.float32))
    got = T.av_frames_transform(
        torch.from_numpy(frames), torch.from_numpy(boxes),
        torch.from_numpy(flip), None, out=out,
        out_dtype=getattr(torch, out_dtype))
    assert got.shape == (3, 3, 3, out, out) and got.dtype == getattr(
        torch, out_dtype)
    got = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, atol=NORM_ATOL, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + NORM_ATOL)


SIZES = [(48, 64), (256, 256), (256, 100), (480, 640), (3, 500), (500, 3),
         (1, 1), (7, 9)]


def test_crop_box_sampling_equals_jax_exactly():
    from mla_tpu_torch.ops import image as im

    for hw in SIZES:
        for seed in range(60):
            a = np.random.default_rng(seed)
            b = np.random.default_rng(seed)
            got = im.random_resized_crop_params(a, *hw)
            assert got == jim.random_resized_crop_params(b, *hw)
            # the generators advanced alike (same draws consumed)
            assert a.random() == b.random()
        for short, crop in ((256, 224), (288, 256), (48, 32)):
            assert im.resize_center_crop_box(*hw, short, crop) == \
                jim.resize_center_crop_box(*hw, short, crop)
    # an extreme aspect ratio always takes torchvision's fallback branch,
    # the centre box clamped to the ratio range
    assert im.random_resized_crop_params(np.random.default_rng(0), 3, 500) \
        == (0, 248, 3, 4)
    assert im.random_resized_crop_params(np.random.default_rng(0), 500, 3) \
        == (248, 0, 4, 3)


def _jax_jitter_draws(key, b):
    keys = jax.random.split(key, b)
    fs, orders = [], []
    for k in keys:
        kf, ko = jax.random.split(k)
        fs.append(np.asarray(jax.random.uniform(kf, (3,), minval=0.6,
                                                maxval=1.4)))
        orders.append(np.asarray(jax.random.permutation(ko, 3)))
    return np.stack(fs), np.stack(orders)


def test_color_jitter_matches_jax_at_its_draws(monkeypatch):
    """The jitter law at JAX's draws, alone and inside the batch transform
    (clip -> jitter -> flip -> normalise, JAX's order)."""
    import torch
    from mla_tpu_torch.data import transforms as T

    rng = np.random.default_rng(3)
    b = 6
    x = rng.random((b, 20, 24, 3)).astype(np.float32)
    key = jax.random.key(7)
    f, order = _jax_jitter_draws(key, b)
    want = np.asarray(jT.color_jitter_batch(key, jnp.asarray(x)))
    got = T.apply_jitter(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(f), torch.from_numpy(order))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)

    frames, boxes, flip = _frames(rng, b, 1, 48)
    want = np.asarray(jT.image_batch_transform(
        jnp.asarray(frames[:, 0]), jnp.asarray(boxes[:, 0]),
        jnp.asarray(flip[:, 0]), key, jnp.asarray(jim.IMAGENET_MEAN),
        jnp.asarray(jim.IMAGENET_STD), out=32, jitter=True))
    monkeypatch.setattr(T, "color_jitter_batch", lambda gen, y: T.apply_jitter(
        y, torch.from_numpy(f), torch.from_numpy(order)))
    got = T.image_batch_transform(
        torch.from_numpy(frames[:, 0]), torch.from_numpy(boxes[:, 0]),
        torch.from_numpy(flip[:, 0]), None, T.im.IMAGENET_MEAN,
        T.im.IMAGENET_STD, out=32, jitter=True)
    np.testing.assert_allclose(got.numpy(), want, atol=NORM_ATOL, rtol=0)


def test_color_jitter_draws_by_their_law():
    """The port's own draws: factors in [0.6, 1.4], each order a
    permutation, and the batch equals the law at those draws."""
    import torch
    from mla_tpu_torch.data import transforms as T

    x = torch.rand(64, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    out = T.color_jitter_batch(gen, x)
    replay = torch.Generator().manual_seed(5)
    f = torch.rand((64, 3), generator=replay) * 0.8 + 0.6
    order = torch.argsort(torch.rand((64, 3), generator=replay), dim=1)
    assert torch.all((f >= 0.6) & (f <= 1.4))
    assert torch.all(torch.sort(order, dim=1).values == torch.arange(3))
    assert len({tuple(o.tolist()) for o in order}) == 6   # all 6 orders drawn
    torch.testing.assert_close(out, T.apply_jitter(x, f, order), atol=0,
                               rtol=0)
    assert out.min() >= 0 and out.max() <= 1
