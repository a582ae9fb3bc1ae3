"""The CAV-MAE input path of the port (``ops/specaug.py``, ``ops/fbank.py``,
``data/transforms.py:cav_fbank_transform``) and the adapters of the three
families it brings (``CAVAdapter``, ``Modal3Adapter``, ``CLIPAdapter``)
against the JAX package's.

Draws: ``jax.random`` cannot be reproduced in torch, so the laws are held
at JAX's draws (replayed here from its ``split`` sequence and fed to the
port's laws): SpecAug, noise and roll within 1e-6 (``normalize_fbank``
divides in another order, and the noise's product rounds once). The
port's own draws are held by their law: integer starts and widths, width
0 with probability 1/48 and 1/192, the mean width (max - 1) / 2, the roll
in [-1024, 1024), the noise scale in [0, 0.1).

Host batches are bitwise against JAX's on both decode paths (the C++
loader the port builds, bound to the JAX side too, and the per-sample cv2
path), the 3-modal mask matrix included; the 3-modal per-sample path keeps
each array's type where JAX's numpy promotes the masked arrays to int64 /
float64 (equal values). Device batches: fbank within 1e-6, images within
the cubic transform's 5e-5 (tests/test_torch_port_m3ae_data.py).
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
from mla_tpu.ops import fbank as jfb
from mla_tpu.ops import specaug as jsa

T_AUDIO, N_TRAIN, N_TEST = 64, 5, 3
FB_ATOL, NORM_ATOL = 1e-6, 5e-5


# ------------------------------------------------------------- JAX's draws

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


def _feed(monkeypatch, key, b, *, augment=False):
    """The port's SpecAug and noise draws replaced by JAX's for ``key``:
    as ``cav_fbank_transform`` splits it (k1 -> SpecAug over split(k1,
    (B, 2))[:, 0], k2 -> split(k2, B) noise and roll) or, ``augment``, as
    ``augment_fbank_batch`` does (split(key, (B, 2)), column 0 then 1)."""
    from mla_tpu_torch.ops import specaug as sa

    if augment:
        keys = jax.random.split(key, (b, 2))
        ks, kn = keys[:, 0], keys[:, 1]
    else:
        k1, k2 = jax.random.split(key)
        ks, kn = jax.random.split(k1, (b, 2))[:, 0], jax.random.split(k2, b)
    monkeypatch.setattr(sa, "specaug_draws",
                        lambda gen, b, t, f, dev, *a: _specaug_draws(ks, t, f))
    monkeypatch.setattr(sa, "noise_roll_draws",
                        lambda gen, b, t, f, dev: _noise_draws(kn, t, f))


def _fbanks(seed=0, b=3, t=T_AUDIO * 4):
    return np.random.default_rng(seed).normal(-5.0, 4.0, (b, t, 128)).astype(
        np.float32)


@pytest.mark.parametrize("t", [256, 1024])
def test_cav_fbank_transform_at_jax_draws(monkeypatch, t):
    """Training under --cav_augnois (SpecAug, normalise, noise and roll)
    and every other case (normalise only), at JAX's draws."""
    import torch
    from mla_tpu_torch.data import transforms as T

    x = _fbanks(1, 3, t)
    key = jax.random.key(7)
    _feed(monkeypatch, key, 3)
    for train, aug in ((True, True), (True, False), (False, True)):
        want = np.asarray(jT.cav_fbank_transform(jnp.asarray(x), key, train,
                                                 aug))
        got = T.cav_fbank_transform(torch.from_numpy(x), None, train, aug)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=FB_ATOL, rtol=0,
                                   err_msg=f"train={train} augnois={aug}")


def test_augment_fbank_batch_at_jax_draws(monkeypatch):
    import torch
    from mla_tpu_torch.ops import specaug as sa

    x = _fbanks(2)
    key = jax.random.key(3)
    _feed(monkeypatch, key, 3, augment=True)
    for noise in (False, True):
        want = np.asarray(jsa.augment_fbank_batch(key, jnp.asarray(x),
                                                  noise=noise))
        got = sa.augment_fbank_batch(None, torch.from_numpy(x), noise=noise)
        np.testing.assert_allclose(got.numpy(), want, atol=FB_ATOL, rtol=0)


def test_specaug_masks_whole_bands():
    """The law at chosen draws: starts and widths truncate to integers,
    the mel band before the time band, masked to exactly 0."""
    import torch
    from mla_tpu_torch.ops import specaug as sa

    x = torch.ones((2, 10, 6))
    draws = {"f": {"value": torch.tensor([2.9, 0.99]),
                   "start": torch.tensor([1.7, 3.0])},
             "t": {"value": torch.tensor([3.5, 1.0]),
                   "start": torch.tensor([6.2, 0.0])}}
    y = sa.specaug(x, draws)
    assert torch.all(y[0][:, 1:3] == 0) and torch.all(y[0][6:9] == 0)
    assert int((y[0] == 0).sum()) == 10 * 2 + 3 * 4
    assert torch.all(y[1][0] == 0) and int((y[1] == 0).sum()) == 6


def test_port_draws_by_their_law():
    import torch
    from mla_tpu_torch.ops import specaug as sa

    gen = torch.Generator().manual_seed(0)
    n = 200_000
    for size, w in ((128, 48), (1024, 192)):
        d = sa.axis_mask_draws(gen, n, size, w, "cpu")
        width, start = torch.floor(d["value"]), torch.floor(d["start"])
        assert float(d["value"].min()) >= 0 and float(d["value"].max()) < w
        assert torch.all(start + width <= size)
        p0 = float((width == 0).float().mean())
        assert abs(p0 - 1 / w) < 5 * (1 / w / n) ** 0.5, (w, p0)
        mean = float(width.mean())
        assert abs(mean - (w - 1) / 2) < 0.02 * w, (w, mean)
        m = sa._axis_mask(d, size)
        np.testing.assert_array_equal(m.sum(1).numpy(), width.numpy())
    d = sa.noise_roll_draws(gen, 4096, 8, 4, "cpu")
    assert int(d["shift"].min()) >= -1024 and int(d["shift"].max()) < 1024
    assert int(d["shift"].min()) < -1000 and int(d["shift"].max()) > 1000
    s = d["scale"] / 10.0
    assert float(s.min()) >= 0 and float(s.max()) < 0.1
    assert 0 <= float(d["noise"].min()) and float(d["noise"].max()) < 1
    # noise_roll: the noise added, then a circular roll of the time axis
    x = torch.arange(8.0)[None, :, None].expand(1, 8, 4).contiguous()
    one = {"noise": torch.zeros(1, 8, 4), "scale": torch.zeros(1),
           "shift": torch.tensor([3])}
    want = np.roll(x.numpy(), 3, axis=1)
    np.testing.assert_array_equal(sa.noise_roll(x, one).numpy(), want)


def test_normalize_and_pad_or_trim():
    import torch
    from mla_tpu_torch.ops import fbank as fb

    x = _fbanks(4)
    np.testing.assert_allclose(fb.normalize_fbank(torch.from_numpy(x)).numpy(),
                               np.asarray(jfb.normalize_fbank(jnp.asarray(x))),
                               atol=FB_ATOL, rtol=0)
    assert (fb.CAV_NORM_MEAN, fb.CAV_NORM_STD) == (jfb.CAV_NORM_MEAN,
                                                   jfb.CAV_NORM_STD)
    for n in (100, 256, 300):
        got = fb.pad_or_trim_frames(torch.from_numpy(x[:, :n]), 256)
        want = np.asarray(jfb.pad_or_trim_frames(jnp.asarray(x[:, :n]), 256))
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- adapters

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    out = {"cav": str(root / "cav"), "iemo": str(root / "iemo"),
           "clip": str(root / "clip")}
    jsyn.make_cremad(out["cav"], n_train=N_TRAIN, n_test=N_TEST, fbank=True,
                     fbank_len=T_AUDIO, seed=3)
    jsyn.make_iemocap(out["iemo"], n_train=N_TRAIN, n_test=N_TEST,
                      token_len=12, fbank_len=T_AUDIO, seed=4)
    jsyn.make_clip(out["clip"], n_train=N_TRAIN, n_test=N_TEST, seed=5)
    # a name whose feature npy is missing is dropped
    import os
    os.remove(f"{out['clip']}/clip_feature/image/train/imgtrain002.npy")
    return out


ADAPTERS = {
    "cav": ("cav", dict(dataset="CREMAD", lorb="large", cav_augnois=True),
            "CAVAdapter"),
    "modal3": ("iemo", dict(dataset="IEMOCAP", lorb="m3ae", modal3=True,
                            mask_percent=0.5), "Modal3Adapter"),
    "clip": ("clip", dict(dataset="Food101", clip=True), "CLIPAdapter"),
}


def _cfgs(root, **kw):
    from mla_tpu_torch.core.config import MLAConfig
    base = dict(image_size=32, audio_length=T_AUDIO, data_root=root,
                compute_dtype="float32", random_seed=11)
    base.update(kw)
    return JConfig(**base).validate(), MLAConfig(**base).validate()


def _native(monkeypatch, on):
    from mla_tpu_torch.data import native_loader
    if on:
        lib = native_loader._load()
        assert lib is not None
        monkeypatch.setattr(jnl, "_lib", lib)
        assert jnl.available()
    else:
        monkeypatch.setattr(jnl, "_load", lambda: None)
        monkeypatch.setattr(native_loader, "_load", lambda: None)


def _equal_host(want, got, types=True):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        if types:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("native", ["native", "cv2"])
@pytest.mark.parametrize("which", sorted(ADAPTERS))
def test_host_batches_bitwise(trees, monkeypatch, native, which):
    from mla_tpu_torch.data import datasets

    _native(monkeypatch, native == "native")
    tree, kw, cls = ADAPTERS[which]
    jcfg, cfg = _cfgs(trees[tree], **kw)
    for mode in ("train", "test"):
        ja, pa = jds.build_adapter(jcfg, mode), datasets.build_adapter(cfg,
                                                                      mode)
        assert type(ja).__name__ == type(pa).__name__ == cls
        assert len(pa) == len(ja) and pa.index.names == ja.index.names
        if which == "modal3":
            np.testing.assert_array_equal(pa.maskmatrix, ja.maskmatrix)
            assert 0 < pa.maskmatrix.sum() < pa.maskmatrix.size
        idx = list(range(len(pa)))[::-1]
        rngs = lambda: [np.random.default_rng((0, 2, i)) for i in idx]
        want, got = ja.batch_host(idx, rngs()), pa.batch_host(idx, rngs())
        # the 3-modal per-sample path: the port keeps the types
        _equal_host(want, got, types=not (which == "modal3"
                                          and native == "cv2"))
        if which == "modal3" and native == "cv2":
            assert got["image_u8"].dtype == np.uint8
            assert got["token"].dtype == np.int32
            assert got["fbank"].dtype == got["pm"].dtype == np.float32


@pytest.mark.parametrize("which", sorted(ADAPTERS))
def test_finish_batch_matches_jax(trees, monkeypatch, which):
    """The device batch from one padded host batch. Training CAV-MAE
    batches at JAX's draws (its key split image first, then fbank; the
    image draws nothing); the 3-modal images in eval mode (their jitter is
    the M3AE adapter's, held in tests/test_torch_port_m3ae_data.py), its
    fbank not normalised."""
    import torch
    from mla_tpu_torch.data import datasets

    _native(monkeypatch, True)
    tree, kw, _ = ADAPTERS[which]
    jcfg, cfg = _cfgs(trees[tree], **kw)
    modes = ("train", "test") if which != "modal3" else ("test",)
    for mode in modes:
        ja, pa = jds.build_adapter(jcfg, mode), datasets.build_adapter(cfg,
                                                                      mode)
        idx = [2, 0]
        hb = jpipe.pad_rows(ja.batch_host(
            idx, [np.random.default_rng(i) for i in idx]), 2, 3, len(ja))
        key = jax.random.key(5)
        want = jax.tree.map(np.asarray, ja.finish_batch(hb, key))
        if which == "cav":
            _feed(monkeypatch, jax.random.split(key)[1], 3)
        got = pa.finish_batch({k: torch.from_numpy(np.asarray(v))
                               for k, v in hb.items()}, None)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].float().numpy() if got[k].is_floating_point() \
                else got[k].numpy()
            if k == "image":
                np.testing.assert_allclose(g, w, atol=NORM_ATOL, rtol=0)
            elif k in ("fbank", "token_feat", "image_feat"):
                np.testing.assert_allclose(g, w, atol=FB_ATOL, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        if which == "modal3":
            np.testing.assert_array_equal(got["fbank"].numpy(), hb["fbank"])



def test_native_path_cuts_and_pads_the_fbank(tmp_path, monkeypatch):
    """The native path reads each fbank at (audio_length, 128), the
    length the model is built for: a short file zero-padded, a long one
    cut, as in the JAX package."""
    from mla_tpu_torch.data import datasets

    _native(monkeypatch, True)
    root = str(tmp_path / "cav")
    jsyn.make_cremad(root, n_train=3, n_test=1, fbank=True, fbank_len=T_AUDIO)
    adir = f"{root}/audio/train_fbank"
    np.save(f"{adir}/cliptrain001.npy", np.ones((T_AUDIO - 9, 128),
                                                np.float32))
    np.save(f"{adir}/cliptrain002.npy", np.ones((T_AUDIO + 9, 128),
                                                np.float32))
    jcfg, cfg = _cfgs(root, dataset="CREMAD", lorb="large")
    ja, pa = jds.CAVAdapter(jcfg, "train"), datasets.CAVAdapter(cfg, "train")
    rngs = lambda: [np.random.default_rng(i) for i in range(3)]
    want, got = ja.batch_host([0, 1, 2], rngs()), pa.batch_host([0, 1, 2],
                                                                  rngs())
    _equal_host(want, got)
    assert got["fbank"].shape == (3, T_AUDIO, 128)
    assert np.all(got["fbank"][1, T_AUDIO - 9:] == 0)
    assert np.all(got["fbank"][2] == 1)
