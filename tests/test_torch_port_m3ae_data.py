"""The port's image-text data path (``mla_tpu_torch/ops/image.py``'s cubic
resample, ``data/transforms.py``, ``data/datasets.py``'s ``M3AEAdapter`` and
``TVAdapter``, ``data/pipeline.py``'s per-batch generator) against the JAX
package's.

The M3AE images are resampled by ``jax.image.scale_and_translate`` with the
Keys cubic kernel and ``antialias=True`` over a fractional box, clipped to
[0, 1] (the cubic's negative lobes overshoot it), color-jittered in
training, flipped and normalised. The port builds JAX's weight matrices;
the JAX op is held compiled, as the JAX package runs it (see
tests/test_torch_port_image.py for the sample positions' rounding).

Random draws: the crop boxes and flips are numpy in both packages and
must be equal bit for bit; the jitter's factors and orders come from
``jax.random`` in JAX and from the batch's ``torch.Generator`` in the port,
so every comparison feeds JAX's draws of the loader's key
``fold_in(fold_in(key(seed), epoch), step)`` to the port's jitter law, and
the port's own draws are held by their law.

Tolerances: the weights and the resample atol 1e-5 on [0, 1] values
(float32 sums in another order); after normalisation atol 5e-5 (1/std
amplifies by about 4.4); in bfloat16 one bf16 ulp of the JAX value beyond
that. Host batches: bit for bit, on the C++ loader's path (each package's
ctypes binding of the port-built library) and on the per-sample cv2 path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.data import datasets as jds
from mla_tpu.data import native_loader as jnl
from mla_tpu.data import pipeline as jpipe
from mla_tpu.data import synthetic as jsyn
from mla_tpu.data import transforms as jT
from mla_tpu.ops import image as jim

WEIGHT_ATOL = 1e-5
RESAMPLE_ATOL = 1e-5
NORM_ATOL = 5e-5
N_TRAIN, N_TEST = 7, 5


def _jitter_draws(key, b):
    """JAX's per-sample jitter factors and op orders of ``key`` for a batch
    of ``b`` (``transforms._jitter_one``'s draws)."""
    fs, orders = [], []
    for k in jax.random.split(key, b):
        kf, ko = jax.random.split(k)
        fs.append(np.asarray(jax.random.uniform(kf, (3,), minval=0.6,
                                                maxval=1.4)))
        orders.append(np.asarray(jax.random.permutation(ko, 3)))
    return np.stack(fs), np.stack(orders)


def _loader_key(seed, epoch, step):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), epoch),
                              step)


def _feed_jax_draws(monkeypatch):
    """The port's loader hands each batch (seed, epoch, step) instead of a
    generator, and its jitter applies JAX's draws of the loader key of that
    triple."""
    import torch
    from mla_tpu_torch.data import pipeline
    from mla_tpu_torch.data import transforms as T

    monkeypatch.setattr(pipeline, "batch_generator",
                        lambda seed, epoch, step, device: (seed, epoch, step))

    def jitter(gen, x):
        f, order = _jitter_draws(_loader_key(*gen), x.shape[0])
        return T.apply_jitter(x, torch.from_numpy(f), torch.from_numpy(order))

    monkeypatch.setattr(T, "color_jitter_batch", jitter)


def _bf16_ulp(x):
    a = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


# ------------------------------------------------------------ the resample

# (input H, W), out (h, w), boxes (i, j, h, w): down- and up-scaling,
# fractional boxes, boxes partly outside the image, the canonical 288 -> 256
CASES = {
    "scale_down": ((48, 64), (16, 16), [[0, 0, 48, 64], [4.5, 3.25, 40, 52]]),
    "scale_up": ((48, 64), (40, 40), [[10, 12, 8, 9], [0.3, 0.7, 20.5, 17.25]]),
    "fractional": ((48, 48), (32, 32), [[1.37, 2.91, 30.2, 28.7],
                                        [7.77, 0.01, 39.9, 47.3]]),
    "outside": ((48, 64), (32, 32), [[-5, -3, 30, 70], [36, 40, 20, 30],
                                     [-8, 50, 64, 20]]),
    "canonical": ((288, 288), (256, 256), [[0, 0, 288, 288],
                                           [17.3, 40.1, 180.5, 200.25],
                                           [200, 3, 56, 90]]),
}


def _jax_weights(start, length, out, size):
    """JAX's cubic weight matrix (out, size) of one box axis, read off
    ``scale_and_translate`` of the identity (its einsum contracts the
    identity's rows with the weights), computed as ``_crop_resize_one``
    does and compiled."""
    def one(s, ln):
        scale = jnp.stack([out / ln])
        trans = jnp.stack([-s * out / ln])
        return jax.image.scale_and_translate(
            jnp.eye(size, dtype=jnp.float32), (out, size), (0,), scale,
            trans, method="cubic", antialias=True)
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(start),
                                             jnp.asarray(length)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cubic_weights_and_resample_match_scale_and_translate(case):
    import torch
    from mla_tpu_torch.ops import image as im

    (h, w), out_hw, boxes = CASES[case]
    b = np.asarray(boxes, np.float32)
    for axis, size, out in ((0, h, out_hw[0]), (1, w, out_hw[1])):
        want = _jax_weights(b[:, axis], b[:, axis + 2], out, size)
        got = im.resample_matrix(torch.from_numpy(b[:, axis]),
                                 torch.from_numpy(b[:, axis + 2]), out, size,
                                 im.keys_cubic_kernel)
        np.testing.assert_allclose(got.numpy(), want, atol=WEIGHT_ATOL,
                                   rtol=0)
    rng = np.random.default_rng(0)
    x = rng.random((len(boxes), h, w, 3)).astype(np.float32)
    fn = jax.jit(jax.vmap(lambda a, bb: jim._crop_resize_one(
        a, bb, out_hw, "cubic")))
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(b)))
    got = im.crop_resize(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(b), out_hw, "cubic")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=RESAMPLE_ATOL, rtol=0)
    # the cubic overshoots [0, 1] on noise: the clip after it bites
    if case != "scale_down":
        assert want.min() < 0 or want.max() > 1


def test_cubic_kernel_is_keys_and_the_clip_holds():
    """The kernel at its knots (1 at 0, 0 at 1 and 2, the a = -0.5 lobe
    -0.0625 at 1.5) and the transform's [0, 1] clip on an image the cubic
    overshoots (a step edge)."""
    import torch
    from mla_tpu_torch.ops import image as im

    k = im.keys_cubic_kernel(torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0, 2.5]))
    torch.testing.assert_close(k, torch.tensor([1.0, 0.5625, 0.0, -0.0625,
                                                0.0, 0.0]), atol=0, rtol=0)
    edge = np.zeros((1, 16, 16, 3), np.uint8)
    edge[:, :, 8:] = 255
    box = torch.tensor([[0.0, 0.0, 16.0, 16.0]])
    raw = im.crop_resize(torch.from_numpy(edge).permute(0, 3, 1, 2).float()
                         / 255.0, box, (40, 40), "cubic")
    assert raw.min() < 0 and raw.max() > 1
    unit = im.crop_resize_unit(torch.from_numpy(edge), box, (40, 40), "cubic")
    assert unit.min() == 0 and unit.max() == 1
    with pytest.raises(NotImplementedError, match="lanczos3"):
        im.crop_resize_unit(torch.from_numpy(edge), box, (8, 8), "lanczos3")


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_cubic_jitter_transform_matches_jax(monkeypatch, out_dtype):
    """``image_batch_transform(method='cubic', jitter=True)`` at JAX's
    draws: resample, clip, jitter, flip, normalise, cast."""
    import torch
    from mla_tpu_torch.data import transforms as T

    rng = np.random.default_rng(4)
    b = 6
    imgs = rng.integers(0, 256, (b, 48, 48, 3), dtype=np.uint8)
    boxes = np.asarray([jim.random_resized_crop_params(rng, 48, 48)
                        for _ in range(b)], np.float32)
    flip = rng.random(b) < 0.5
    key = jax.random.key(11)
    want = np.asarray(jT.image_batch_transform(
        jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(flip), key,
        jnp.asarray(jim.IMAGENET_MEAN), jnp.asarray(jim.IMAGENET_STD),
        out=32, method="cubic", jitter=True,
        out_dtype=getattr(jnp, out_dtype)).astype(jnp.float32))
    f, order = _jitter_draws(key, b)
    monkeypatch.setattr(T, "color_jitter_batch", lambda gen, y:
                        T.apply_jitter(y, torch.from_numpy(f),
                                       torch.from_numpy(order)))
    got = T.image_batch_transform(
        torch.from_numpy(imgs), torch.from_numpy(boxes),
        torch.from_numpy(flip), None, T.im.IMAGENET_MEAN, T.im.IMAGENET_STD,
        out=32, method="cubic", jitter=True,
        out_dtype=getattr(torch, out_dtype))
    assert got.shape == (b, 3, 32, 32) and got.dtype == getattr(torch,
                                                                out_dtype)
    got = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, atol=NORM_ATOL, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + NORM_ATOL)


# ------------------------------------------------------------- the adapters

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("m3ae")
    out = {}
    for ds in ("Food101", "MVSA"):
        path = str(root / ds)
        jsyn.make_m3ae(path, dataset=ds, n_train=N_TRAIN, n_test=N_TEST,
                       token_len=12, seed=2)
        out[ds] = path
    return out


def _cfgs(root, dataset, lorb="m3ae", **kw):
    from mla_tpu_torch.core.config import MLAConfig
    base = dict(dataset=dataset, lorb=lorb, image_size=32, data_root=root,
                compute_dtype="float32")
    base.update(kw)
    return JConfig(**base).validate(), MLAConfig(**base).validate()


def _native(monkeypatch, on):
    """Both packages on the C++ loader (the JAX side bound to the library
    the port built, so no test runs ``make -C native``), or both on the
    per-sample cv2 path."""
    from mla_tpu_torch.data import native_loader

    if on:
        lib = native_loader._load()
        assert lib is not None
        monkeypatch.setattr(jnl, "_lib", lib)
        assert jnl.available()
    else:
        monkeypatch.setattr(jnl, "_load", lambda: None)
        monkeypatch.setattr(native_loader, "_load", lambda: None)


def _equal_host(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


ADAPTERS = {"m3ae_food": ("Food101", "m3ae", "M3AEAdapter"),
            "m3ae_mvsa": ("MVSA", "m3ae", "M3AEAdapter"),
            "tv_mvsa": ("MVSA", "base", "TVAdapter")}


@pytest.mark.parametrize("native", ["native", "cv2"])
@pytest.mark.parametrize("which", sorted(ADAPTERS))
def test_host_batches_bitwise(trees, monkeypatch, native, which):
    """Tokens (int32), pm (float32), uint8 images, boxes, flips, labels and
    indices, train and test modes, sample by sample and as batches."""
    from mla_tpu_torch.data import datasets

    _native(monkeypatch, native == "native")
    ds, lorb, cls = ADAPTERS[which]
    jcfg, cfg = _cfgs(trees[ds], ds, lorb)
    assert type(datasets.build_adapter(cfg, "train")).__name__ == cls
    assert type(jds.build_adapter(jcfg, "train")).__name__ == cls
    for mode in ("train", "test"):
        ja = getattr(jds, cls)(jcfg, mode)
        pa = getattr(datasets, cls)(cfg, mode)
        assert (pa.out, pa.canon, len(pa)) == (ja.out, ja.canon, len(ja))
        idx = list(range(len(pa)))[::-1]
        for i in idx[:3]:
            _equal_host(ja.sample_host(i, np.random.default_rng((0, 1, i))),
                        pa.sample_host(i, np.random.default_rng((0, 1, i))))
        rngs = lambda: [np.random.default_rng((0, 2, i)) for i in idx]
        want, got = ja.batch_host(idx, rngs()), pa.batch_host(idx, rngs())
        _equal_host(want, got)
        assert got["token"].dtype == np.int32 and got["token"].shape == \
            (len(idx), 12)


@pytest.mark.parametrize("which", sorted(ADAPTERS))
def test_finish_batch_matches_jax(trees, monkeypatch, which):
    """The device batch from one padded host batch: token, padding_mask,
    label, idx and valid equal, the image within the transform's
    tolerance (training: JAX's jitter draws fed to the port)."""
    import torch
    from mla_tpu_torch.data import datasets
    from mla_tpu_torch.data import pipeline
    from mla_tpu_torch.data import transforms as T

    _native(monkeypatch, True)
    ds, lorb, cls = ADAPTERS[which]
    jcfg, cfg = _cfgs(trees[ds], ds, lorb)
    for mode in ("train", "test"):
        ja = getattr(jds, cls)(jcfg, mode)
        pa = getattr(datasets, cls)(cfg, mode)
        idx = [4, 0, 2]
        hb = jpipe.pad_rows(ja.batch_host(
            idx, [np.random.default_rng((3, 0, i)) for i in idx]), 3, 4,
            len(ja))
        key = _loader_key(3, 0, 1)
        want = jax.tree.map(np.asarray, ja.finish_batch(hb, key))
        f, order = _jitter_draws(key, 4)
        monkeypatch.setattr(T, "color_jitter_batch", lambda gen, y:
                            T.apply_jitter(y, torch.from_numpy(f),
                                           torch.from_numpy(order)))
        staged = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in pipeline.pad_rows(
                      pa.batch_host(idx, [np.random.default_rng((3, 0, i))
                                          for i in idx]), 3, 4,
                      len(pa)).items()}
        got = pa.finish_batch(staged, None)
        assert set(got) == set(want)
        for k in got:
            g = got[k].float().numpy() if got[k].is_floating_point() \
                else got[k].numpy()
            assert g.shape == want[k].shape, k
            if k == "image":
                np.testing.assert_allclose(g, want[k], atol=NORM_ATOL,
                                           rtol=0, err_msg=f"{mode} image")
            else:
                np.testing.assert_array_equal(g, want[k], err_msg=k)
                assert g.dtype == want[k].dtype, k


# --------------------------------------------------------------- the loader

def _jax_epoch(loader, epoch):
    return [jax.tree.map(np.asarray, b) for b in loader.epoch(epoch)]


def _port_epoch(loader, epoch):
    return [{k: v.float().numpy() if v.is_floating_point() else v.numpy()
             for k, v in b.items()} for b in loader.epoch(epoch)]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_loader_matches_jax_over_two_epochs(trees, monkeypatch, mode):
    """Food-101, batch 3 (the last batch padded): two epochs batch for
    batch, the training images jittered at JAX's per-step draws."""
    from mla_tpu_torch.data import datasets, pipeline

    _native(monkeypatch, True)
    _feed_jax_draws(monkeypatch)
    jcfg, cfg = _cfgs(trees["Food101"], "Food101")
    shuffle = mode == "train"
    jl = jpipe.Loader(jds.M3AEAdapter(jcfg, mode), 3, mesh=None,
                      shuffle=shuffle, seed=5, num_workers=2)
    pl = pipeline.Loader(datasets.M3AEAdapter(cfg, mode), 3, shuffle=shuffle,
                         seed=5, num_workers=2, device="cpu")
    n = N_TRAIN if shuffle else N_TEST
    assert len(pl) == len(jl) == -(-n // 3)
    for epoch in (0, 1):
        want, got = _jax_epoch(jl, epoch), _port_epoch(pl, epoch)
        assert len(got) == len(want) == len(pl)
        for w, g in zip(want, got):
            assert set(g) == set(w) == {"token", "padding_mask", "image",
                                        "label", "idx", "valid"}
            for k in ("token", "padding_mask", "label", "idx", "valid"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_allclose(g["image"], w["image"],
                                       atol=NORM_ATOL, rtol=0)
        last, n_pad = got[-1], 3 * len(pl) - n
        assert list(last["valid"][-n_pad:]) == [0.0] * n_pad
        assert list(last["idx"][-n_pad:]) == [n] * n_pad


def test_port_draws_by_their_law(trees, monkeypatch):
    """The port's own draws: each batch's generator is seeded from (seed,
    epoch, step) alone, so two loaders agree bit for bit and a step's
    training images are the jitter law at the draws that generator gives;
    two steps draw different factors."""
    import torch
    from mla_tpu_torch.data import datasets, pipeline
    from mla_tpu_torch.data import transforms as T
    from mla_tpu_torch.utils.seed import batch_generator

    _native(monkeypatch, True)
    _, cfg = _cfgs(trees["Food101"], "Food101")
    seen = []
    law = T.color_jitter_batch

    def spy(gen, x):
        seen.append(gen.get_state())
        return law(gen, x)

    monkeypatch.setattr(T, "color_jitter_batch", spy)
    ad = datasets.M3AEAdapter(cfg, "train")
    a = _port_epoch(pipeline.Loader(ad, 3, seed=9, device="cpu"), 1)
    b = _port_epoch(pipeline.Loader(ad, 3, seed=9, device="cpu"), 1)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert len(seen) == 2 * len(a)
    for step, state in enumerate(seen[:len(a)]):
        assert torch.equal(state, batch_generator(9, 1, step).get_state())
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(batch_generator(9, 0, 1).get_state(),
                           batch_generator(9, 1, 0).get_state())
    # one batch replayed: the law at the generator's draws
    replay = batch_generator(9, 1, 0)
    f = torch.rand((3, 3), generator=replay) * 0.8 + 0.6
    order = torch.argsort(torch.rand((3, 3), generator=replay), dim=1)
    assert torch.all((f >= 0.6) & (f <= 1.4))
    assert torch.all(torch.sort(order, dim=1).values == torch.arange(3))


def test_build_adapter_selection_and_unported(trees, tmp_path):
    """--lorb m3ae takes the M3AE adapter for Food-101 and MVSA; MVSA on
    another family the TV adapter; --clip the CLIP feature adapter (before
    --lorb m3ae) and IEMOCAP or --modal3 the 3-modal one (before every
    other), as the JAX package selects."""
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.data import datasets

    for ds in ("Food101", "MVSA"):
        ad = datasets.build_adapter(_cfgs(trees[ds], ds)[1], "test")
        assert type(ad) is datasets.M3AEAdapter and ad.out == 32
    tv = datasets.build_adapter(_cfgs(trees["MVSA"], "MVSA", "base")[1],
                                "train")
    assert type(tv) is datasets.TVAdapter
    clip = datasets.build_adapter(
        _cfgs(trees["Food101"], "Food101", "base", clip=True)[1], "train")
    assert type(clip) is datasets.CLIPAdapter and len(clip) == 0  # no npys
    iemo = str(tmp_path / "iemo")
    jsyn.make_iemocap(iemo, n_train=2, n_test=1)
    for kw in (dict(lorb="m3ae", modal3=True), dict(lorb="base"),
               dict(lorb="large")):
        jcfg, cfg = _cfgs(iemo, "IEMOCAP", **kw)
        assert type(datasets.build_adapter(cfg, "train")) is \
            datasets.Modal3Adapter
        assert type(jds.build_adapter(jcfg, "train")).__name__ == \
            "Modal3Adapter"
    assert MLAConfig is not None
