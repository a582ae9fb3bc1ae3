"""The port's data path (``mla_tpu_torch/data/``) against the JAX package's:
the datalists, the QMF masking and the synthetic fixture trees are the
same; the CREMA-D adapter gives the same frames, boxes, flips, labels and
indices bit for bit on each decode path (the C++ loader's, through each
package's own ctypes binding, and the per-sample cv2 path); the loader
gives the same order, padding, ``valid`` mask and ``idx`` sentinel over two
epochs, and its device transform the same images within the transform's
tolerance (tests/test_torch_port_image.py); an abandoned iterator leaves no
thread behind.
"""

import filecmp
import os
import threading

import jax
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.data import datalists as jdl
from mla_tpu.data import datasets as jds
from mla_tpu.data import masking as jmask
from mla_tpu.data import native_loader as jnl
from mla_tpu.data import pipeline as jpipe
from mla_tpu.data import synthetic as jsyn

NORM_ATOL = 5e-5
N_TRAIN, N_TEST = 7, 5


@pytest.fixture(scope="module")
def cremad_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cre"))
    jsyn.make_cremad(root, n_train=N_TRAIN, n_test=N_TEST,
                     spec_shape=(20, 24))
    return root


def _cfgs(root, **kw):
    from mla_tpu_torch.core.config import MLAConfig
    base = dict(dataset="CREMAD", lorb="base", image_size=32, data_root=root,
                compute_dtype="float32")
    base.update(kw)
    return JConfig(**base).validate(), MLAConfig(**base).validate()


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files
                or cmp.funny_files), (cmp.left_only, cmp.right_only,
                                      cmp.diff_files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


MAKERS = {
    "cremad": ("make_cremad", dict(spec_shape=(10, 12))),
    "cremad_learnable": ("make_cremad", dict(spec_shape=(12, 10),
                                             learnable=True)),
    "cremad_fbank": ("make_cremad", dict(fbank=True, fbank_len=32)),
    "m3ae": ("make_m3ae", dict(token_len=16)),
    "iemocap": ("make_iemocap", dict(token_len=16, fbank_len=32)),
    "clip": ("make_clip", {}),
}


@pytest.mark.parametrize("maker", sorted(MAKERS))
def test_synthetic_trees_are_byte_identical(maker, tmp_path):
    from mla_tpu_torch.data import synthetic

    fn, kw = MAKERS[maker]
    want = getattr(jsyn, fn)(str(tmp_path / "jax"), n_train=4, n_test=3,
                             seed=3, **kw)
    got = getattr(synthetic, fn)(str(tmp_path / "port"), n_train=4, n_test=3,
                                 seed=3, **kw)
    assert got == want
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_datalists_and_masking_equal_jax(cremad_root, tmp_path):
    from mla_tpu_torch.data import datalists, masking

    for mode in ("train", "test"):
        a = jdl.build_index("CREMAD", cremad_root, mode,
                            required=("audio", "visual"))
        b = datalists.build_index("CREMAD", cremad_root, mode,
                                  required=("audio", "visual"))
        assert (a.names, a.labels, a.classes, a.mode) == \
            (b.names, b.labels, b.classes, b.mode)
        assert a.dir("audio") == b.dir("audio")
        assert a.dir("visual") == b.dir("visual")
    assert {k: v.__dict__ for k, v in jdl.LAYOUTS.items()} == \
        {k: v.__dict__ for k, v in datalists.LAYOUTS.items()}
    iemo = str(tmp_path / "iemo")
    jsyn.make_iemocap(iemo, n_train=3, n_test=2, token_len=8, fbank_len=16)
    lst = os.path.join(iemo, "lists", "my_train_iemo.txt")
    assert jdl.read_datalist(lst, " [split|sign] ") == \
        datalists.read_datalist(lst, " [split|sign] ")
    # a datalist entry whose files are missing is dropped alike
    os.remove(os.path.join(cremad_root, "audio/train_fbank/cliptrain003.npy"))
    try:
        a = jdl.build_index("CREMAD", cremad_root, "train",
                            required=("audio", "visual"))
        b = datalists.build_index("CREMAD", cremad_root, "train",
                                  required=("audio", "visual"))
        assert a.names == b.names and len(b) == N_TRAIN - 1
    finally:
        jsyn.make_cremad(cremad_root, n_train=N_TRAIN, n_test=N_TEST,
                         spec_shape=(20, 24))

    names = [f"n{i}" for i in range(17)]
    for pct in (0.0, 0.3, 0.5, 1.0):
        assert masking.qmf_mask_set(names, pct) == jmask.qmf_mask_set(names,
                                                                      pct)
    for views, n, rate in ((3, 40, 0.3), (3, 5, 0.7), (2, 30, 0.0),
                           (3, 12, 0.5)):
        np.testing.assert_array_equal(
            masking.random_mask(views, n, rate, np.random.default_rng(4)),
            jmask.random_mask(views, n, rate, np.random.default_rng(4)))


def _equal_host(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


def _native(monkeypatch, on):
    """Both packages on the C++ loader, or both on the cv2 path. The JAX
    side binds the library the port built from the same source with the
    same flags (its own build would write native/, which another test
    process may be compiling into at the same moment)."""
    from mla_tpu_torch.data import native_loader

    if on:
        lib = native_loader._load()
        assert lib is not None
        monkeypatch.setattr(jnl, "_lib", lib)
        assert jnl.available()
    else:
        monkeypatch.setattr(jnl, "_load", lambda: None)
        monkeypatch.setattr(native_loader, "_load", lambda: None)


@pytest.mark.parametrize("native", ["native", "cv2"])
@pytest.mark.parametrize("regime", ["normal", "qmf_audio", "qmf_visual"])
def test_av_adapter_host_batches_bitwise(cremad_root, monkeypatch, native,
                                         regime):
    from mla_tpu_torch.data import datasets

    _native(monkeypatch, native == "native")
    kw = {} if regime == "normal" else dict(
        modulation="QMF", mask_percent=0.5, mask_m=regime.split("_")[1])
    jcfg, cfg = _cfgs(cremad_root, **kw)
    for mode in ("train", "test"):
        ja, pa = jds.AVAdapter(jcfg, mode), datasets.AVAdapter(cfg, mode)
        assert pa.mask_files == ja.mask_files
        idx = list(range(len(pa)))[::-1]
        for i in idx[:3]:
            _equal_host(ja.sample_host(i, np.random.default_rng((0, 1, i))),
                        pa.sample_host(i, np.random.default_rng((0, 1, i))))
        rngs = lambda: [np.random.default_rng((0, 2, i)) for i in idx]
        _equal_host(ja.batch_host(idx, rngs()), pa.batch_host(idx, rngs()))


@pytest.mark.parametrize("native", ["native", "cv2"])
def test_loader_io_functions_equal_jax(tmp_path, monkeypatch, native):
    """npy batches cut and pad to the item shape; a JPEG that fails to
    decode leaves a zeroed slot with size (0, 0); on both paths."""
    from mla_tpu_torch.data import native_loader

    _native(monkeypatch, native == "native")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((10, 12, 15)):
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], rng.standard_normal(n).astype(np.float32))
    np.testing.assert_array_equal(native_loader.load_npy_batch(paths, (12,)),
                                  jnl.load_npy_batch(paths, (12,)))
    jsyn._write_jpg(str(tmp_path / "ok.jpg"), rng, hw=(20, 30))
    (tmp_path / "bad.jpg").write_bytes(b"not a jpeg")
    jpgs = [str(tmp_path / "ok.jpg"), str(tmp_path / "bad.jpg")]
    got, want = native_loader.decode_jpeg_batch(jpgs, (16, 24)), \
        jnl.decode_jpeg_batch(jpgs, (16, 24))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [[20, 30], [0, 0]] and not got[0][1].any()


def test_native_library_builds_into_the_port_build_dir():
    from mla_tpu_torch.data import native_loader
    from mla_tpu_torch.ops import _build

    assert native_loader.available()
    path = native_loader.library_path()
    assert path.exists() and path.parent == _build.build_dir()
    assert native_loader.SOURCE.name == "mla_native.cc"


def _jax_epoch(loader, epoch):
    return [jax.tree.map(np.asarray, b) for b in loader.epoch(epoch)]


def _port_epoch(loader, epoch):
    return [{k: v.float().numpy() if v.is_floating_point() else v.numpy()
             for k, v in b.items()} for b in loader.epoch(epoch)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax_over_two_epochs(cremad_root, monkeypatch,
                                            shuffle):
    from mla_tpu_torch.data import datasets, pipeline

    _native(monkeypatch, True)
    jcfg, cfg = _cfgs(cremad_root)
    mode = "train" if shuffle else "test"
    jl = jpipe.Loader(jds.AVAdapter(jcfg, mode), 3, mesh=None,
                      shuffle=shuffle, seed=5, num_workers=2)
    pl = pipeline.Loader(datasets.AVAdapter(cfg, mode), 3, shuffle=shuffle,
                         seed=5, num_workers=2, device="cpu")
    assert len(pl) == len(jl)
    orders = []
    for epoch in (0, 1):
        want, got = _jax_epoch(jl, epoch), _port_epoch(pl, epoch)
        assert len(got) == len(want) == len(pl)
        for w, g in zip(want, got):
            assert set(g) == set(w) == {"spec", "image", "label", "idx",
                                        "valid"}
            for k in ("spec", "label", "idx", "valid"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["image"].shape == w["image"].shape
            np.testing.assert_allclose(g["image"], w["image"],
                                       atol=NORM_ATOL, rtol=0)
        # drop_last=False: the last batch is padded with zero rows, valid 0
        # and the QMF scratch index n_data
        last = got[-1]
        n_pad = len(pl) * 3 - len(pl.adapter)
        assert n_pad > 0 and list(last["valid"][-n_pad:]) == [0.0] * n_pad
        assert list(last["idx"][-n_pad:]) == [len(pl.adapter)] * n_pad
        assert not last["spec"][-n_pad:].any()
        orders.append(np.concatenate([g["idx"] for g in got]))
    assert shuffle == (not np.array_equal(orders[0], orders[1]))


def test_pad_rows_and_collate_equal_jax():
    from mla_tpu_torch.data import pipeline

    samples = [{"x": np.full(3, i, np.float32), "label": i, "idx": i}
               for i in range(3)]
    _equal_host(jpipe.collate_pad(samples, 5, n_data=11),
                pipeline.collate_pad(samples, 5, n_data=11))
    hb = {"x": np.arange(8, dtype=np.float32).reshape(4, 2),
          "idx": np.arange(4)}
    _equal_host(jpipe.pad_rows(dict(hb), 4, 4, 9),
                pipeline.pad_rows(dict(hb), 4, 4, 9))


def test_abandoned_iterator_stops_producer(cremad_root):
    """Taking one batch and abandoning the iterator stops the producer
    thread and the worker pool."""
    from mla_tpu_torch.data import datasets, pipeline

    _, cfg = _cfgs(cremad_root)
    ad = datasets.AVAdapter(cfg, "train")
    before = threading.active_count()
    for e in range(10):
        it = pipeline.Loader(ad, batch_size=2, shuffle=True, seed=e,
                             device="cpu").epoch(e)
        next(it)
        it.close()   # GeneratorExit -> stop event -> join
    assert threading.active_count() - before <= 1


def test_loader_cv2_path_runs_on_its_workers(cremad_root, monkeypatch):
    """Without the C++ library the loader decodes sample by sample over its
    ``num_workers`` threads: the same batches as the JAX package's cv2 path,
    every sample loaded on a pool thread, and no pool thread left once an
    iterator is abandoned."""
    from mla_tpu_torch.data import datasets, pipeline

    _native(monkeypatch, False)
    jcfg, cfg = _cfgs(cremad_root)
    ad = datasets.AVAdapter(cfg, "train")
    threads = []
    sample_host = ad.sample_host

    def traced(i, rng):
        threads.append(threading.current_thread().name)
        return sample_host(i, rng)

    monkeypatch.setattr(ad, "sample_host", traced)
    jl = jpipe.Loader(jds.AVAdapter(jcfg, "train"), 3, mesh=None, seed=5,
                      num_workers=2)
    pl = pipeline.Loader(ad, 3, seed=5, num_workers=3, device="cpu")
    want, got = _jax_epoch(jl, 1), _port_epoch(pl, 1)
    assert len(got) == len(want) == len(pl)
    for w, g in zip(want, got):
        for k in ("spec", "label", "idx", "valid"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["image"], w["image"], atol=NORM_ATOL,
                                   rtol=0)
    assert len(threads) == N_TRAIN
    assert all(n.startswith("ThreadPoolExecutor") for n in threads), threads

    def pool_threads():
        return {t for t in threading.enumerate()
                if t.name.startswith("ThreadPoolExecutor")}

    before = pool_threads()
    it = pl.epoch(2)
    next(it)
    it.close()
    assert not pool_threads() - before


@pytest.mark.parametrize("learnable", [False, True])
def test_make_cremad_writes_frames_at_the_asked_size(tmp_path, learnable):
    import cv2
    from mla_tpu_torch.data import synthetic

    synthetic.make_cremad(str(tmp_path), n_train=2, n_test=1,
                          spec_shape=(4, 5), learnable=learnable,
                          frame_hw=(36, 40))
    frames = sorted(tmp_path.glob("visual/*/Image-01-FPS/*/*.jpg"))
    assert len(frames) == 3 * 4
    assert {cv2.imread(str(f)).shape for f in frames} == {(36, 40, 3)}


def test_loader_raises_producer_errors(cremad_root):
    from mla_tpu_torch.data import datasets, pipeline

    _, cfg = _cfgs(cremad_root)
    ad = datasets.AVAdapter(cfg, "train")
    ad.batch_host = lambda idx, rngs, map_fn: (_ for _ in ()).throw(
        OSError("disk gone"))
    with pytest.raises(OSError, match="disk gone"):
        next(pipeline.Loader(ad, 2, device="cpu").epoch(0))


def test_only_the_av_adapter_is_ported(cremad_root, tmp_path):
    """build_adapter picks each family's adapter as the JAX package does:
    the CREMA-D AV one for --lorb base, the CAV-MAE one for --lorb large,
    the CLIP feature one for --clip and the IEMOCAP 3-modal one for
    --modal3 (the image-text adapters are held in
    tests/test_torch_port_m3ae_data.py; the new ones against JAX's in
    tests/test_torch_port_cav_data.py)."""
    from mla_tpu_torch.data import datasets

    jsyn.make_clip(str(tmp_path / "clip"), n_train=2, n_test=1)
    jsyn.make_iemocap(str(tmp_path / "iemo"), n_train=2, n_test=1)
    for root, kw, cls in (
            (cremad_root, {}, datasets.AVAdapter),
            (cremad_root, dict(lorb="large"), datasets.CAVAdapter),
            (str(tmp_path / "clip"), dict(dataset="Food101", clip=True),
             datasets.CLIPAdapter),
            (str(tmp_path / "iemo"), dict(dataset="IEMOCAP", lorb="m3ae",
                                          modal3=True),
             datasets.Modal3Adapter)):
        jcfg, cfg = _cfgs(root, **kw)
        ad = datasets.build_adapter(cfg, "train")
        assert type(ad) is cls
        ja = jds.build_adapter(jcfg, "train")
        assert type(ad).__name__ == type(ja).__name__
        assert ad.index.names == ja.index.names and len(ad) > 0
