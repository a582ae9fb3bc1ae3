"""The port's offline ETL CLI (``mla_tpu_torch/data/etl/cli.py``) against
the JAX package's (``mla_tpu/data/etl/cli.py``), subcommand by subcommand,
on the CPU: both CLIs run on the same seeded inputs, the port's with
``--device cpu``. Artifacts whose law is not numeric (lists, token and pm
npys, JPEGs from cv2 and PIL, ffmpeg's argv, the extract-spec crop) are
byte-equal; the log-STFT and fbank npys agree within 1e-3 in the log domain
(the JAX package's golden tolerance, ``tests/test_ops.py``). Two places
differ on purpose, each shown here: ``--mix_lambda 0`` is passed through
(the JAX CLI makes it -1.0), and an error of the fbank itself ends the
subcommand where the JAX CLI writes its 0.01-filled fallback.
"""

import json
import os
import stat
import sys

import numpy as np
import pytest

from mla_tpu.data.etl import cli as jcli

LOG_ATOL = 1e-3
SR = 16000
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the un ##aff ##able hello world "
         "don ' t , . ! ? a b ab cat ##nap catnap").split()


def _write_wav(path, n, seed, dtype=np.int16):
    from scipy.io import wavfile
    rng = np.random.default_rng(seed)
    scale = 0.1 * (32767 if dtype == np.int16 else 2**31 - 1)
    wavfile.write(str(path), SR, (rng.standard_normal(n) * scale
                                  ).astype(dtype))


def _port(argv):
    from mla_tpu_torch.data.etl import cli
    cli.main([*argv, "--device", "cpu"] if argv[0] in cli.DEVICE_COMMANDS
             else argv)


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _same_bytes(a, b):
    assert _files(a) == _files(b) and _files(a)
    for f in _files(a):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _close_npys(a, b, shape=None):
    """Every npy of ``a`` against ``b``'s within LOG_ATOL; the largest
    difference is returned (and printed)."""
    assert _files(a) == _files(b) and _files(a)
    worst = 0.0
    for f in _files(a):
        got, want = np.load(a / f), np.load(b / f)
        assert got.dtype == want.dtype == np.float32 and \
            got.shape == want.shape, f
        if shape is not None:
            assert got.shape == shape, f
        if got.size:
            worst = max(worst, float(np.abs(got - want).max()))
    print(f"largest difference from the JAX CLI's npys: {worst:.3e}")
    assert worst <= LOG_ATOL
    return worst


@pytest.fixture
def wavs(tmp_path):
    """Seeded wavs: int16 of 2.0 s and 3.3 s, int32 of 1.2 s, 320 samples
    (shorter than one fbank frame), stereo int16, and an unreadable file."""
    d = tmp_path / "wav"
    d.mkdir()
    _write_wav(d / "a.wav", 2 * SR, 0)
    _write_wav(d / "b.wav", int(3.3 * SR), 1)
    _write_wav(d / "c.wav", int(1.2 * SR), 2, np.int32)
    _write_wav(d / "d.wav", 320, 3)
    from scipy.io import wavfile
    rng = np.random.default_rng(4)
    wavfile.write(str(d / "e.wav"), SR, (rng.standard_normal((SR, 2))
                                         * 3000).astype(np.int16))
    (d / "notes.txt").write_text("not audio")
    return d


def test_wavread_matches_jax(wavs):
    from mla_tpu_torch.data.etl import cli
    for f in ("a.wav", "c.wav", "d.wav", "e.wav"):
        sr, got = cli._wavread(str(wavs / f))
        jsr, want = jcli._wavread(str(wavs / f))
        assert sr == jsr == SR and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_extract_spec_same_crop_and_empty_skip(wavs, tmp_path, capsys):
    from scipy.io import wavfile
    wavfile.write(str(wavs / "z.wav"), SR, np.zeros(0, np.int16))
    for seed in ("0", "7"):
        out_p, out_j = tmp_path / f"p{seed}", tmp_path / f"j{seed}"
        _port(["extract-spec", str(wavs), str(out_p), "--seed", seed])
        assert "skip z.wav: empty waveform" in capsys.readouterr().out
        jcli.main(["extract-spec", str(wavs), str(out_j), "--seed", seed])
        _close_npys(out_p, out_j, shape=(129, 626))
        assert "z.npy" not in _files(out_p)


def test_extract_fbank_plain_short_and_unreadable(wavs, tmp_path):
    (wavs / "f.wav").write_bytes(b"RIFF0000garbage")
    out_p, out_j = tmp_path / "p", tmp_path / "j"
    _port(["extract-fbank", str(wavs), str(out_p), "--target_length", "512"])
    jcli.main(["extract-fbank", str(wavs), str(out_j), "--target_length",
               "512"])
    _close_npys(out_p, out_j, shape=(512, 128))
    assert not np.load(out_p / "d.npy").any()       # 320 samples: no frame
    np.testing.assert_array_equal(np.load(out_p / "f.npy"),
                                  np.load(out_j / "f.npy"))
    assert np.all(np.load(out_p / "f.npy") == np.float32(0.01))


def test_extract_fbank_mixup(wavs, tmp_path):
    mix = tmp_path / "mix"
    mix.mkdir()
    for i, (f, n) in enumerate((("a.wav", 3 * SR), ("b.wav", SR),
                                ("c.wav", int(1.2 * SR)))):
        _write_wav(mix / f, n, 20 + i)
    out_p, out_j = tmp_path / "p", tmp_path / "j"
    argv = ["--mix_dir", str(mix), "--mix_lambda", "0.3"]
    _port(["extract-fbank", str(wavs), str(out_p), *argv])
    jcli.main(["extract-fbank", str(wavs), str(out_j), *argv])
    # d.wav and e.wav have no partner: both write the read fallback
    _close_npys(out_p, out_j, shape=(1024, 128))
    assert np.all(np.load(out_p / "d.npy") == np.float32(0.01))


@pytest.mark.parametrize("flag", [["--mix_lambda", "0.5"], ["--mix_dir", "x"]])
def test_mix_flags_go_together(wavs, tmp_path, flag):
    with pytest.raises(SystemExit, match="go together"):
        _port(["extract-fbank", str(wavs), str(tmp_path / "o"), *flag])


def test_mix_lambda_zero_deliberate_difference(tmp_path):
    """The JAX CLI passes ``args.mix_lambda or -1.0``: at 0.0 it blends
    -w1 + 2 w2. The port passes 0.0 through: w2 alone, the reference's law
    at lambda 0 (extract_fbank.py:14-32)."""
    import jax.numpy as jnp
    import torch
    from mla_tpu.ops import fbank as jfbank
    from mla_tpu_torch.ops import fbank

    src, mix = tmp_path / "w", tmp_path / "m"
    src.mkdir(), mix.mkdir()
    _write_wav(src / "a.wav", 2 * SR, 0)
    _write_wav(mix / "a.wav", int(2.5 * SR), 1)
    argv = ["--mix_dir", str(mix), "--mix_lambda", "0"]
    _port(["extract-fbank", str(src), str(tmp_path / "p"), *argv])
    jcli.main(["extract-fbank", str(src), str(tmp_path / "j"), *argv])
    got = np.load(tmp_path / "p" / "a.npy")
    jax_out = np.load(tmp_path / "j" / "a.npy")
    w1 = jcli._wavread(str(src / "a.wav"))[1]
    w2 = jcli._wavread(str(mix / "a.wav"))[1]
    jax_minus1 = np.asarray(jfbank.wav2fbank(
        jnp.asarray(w1), waveform2=jnp.asarray(w2), mix_lambda=-1.0))
    np.testing.assert_allclose(jax_out, jax_minus1, atol=1e-5, rtol=0)
    port_zero = fbank.wav2fbank(torch.from_numpy(w1),
                                waveform2=torch.from_numpy(w2),
                                mix_lambda=0.0).numpy()
    np.testing.assert_array_equal(got, port_zero)
    # lambda 0 is w2 alone, cut to w1's length and mean-centred (the
    # centring's sums run in another order: the log-domain tolerance)
    np.testing.assert_allclose(
        got, fbank.wav2fbank(torch.from_numpy(w2[:len(w1)])).numpy(),
        atol=LOG_ATOL, rtol=0)
    assert np.abs(got - jax_out).max() > 1.0


def test_fbank_error_propagates_deliberate_difference(wavs, tmp_path,
                                                      monkeypatch):
    """An error of the fbank (a CUDA or build failure on the card) ends the
    port's subcommand; the JAX CLI writes its 0.01 fallback for it."""
    import mla_tpu.ops.fbank as jfbank
    import mla_tpu_torch.ops.fbank as fbank

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(fbank, "wav2fbank", broken)
    monkeypatch.setattr(jfbank, "wav2fbank", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _port(["extract-fbank", str(wavs), str(tmp_path / "p")])
    assert not list((tmp_path / "p").glob("*.npy"))
    lists, faces = _iemo_inputs(tmp_path, wavs)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _port(["preprocess-iemo", str(lists), str(wavs), str(faces),
               str(tmp_path / "pi"), "--vocab", str(tmp_path / "vocab.txt"),
               "--target_length", "64", "--max_length", "16"])
    jcli.main(["extract-fbank", str(wavs), str(tmp_path / "j")])
    assert np.all(np.load(tmp_path / "j" / "a.npy") == np.float32(0.01))


def _write_video(path, frames, seed, hw=(48, 64), fps=30):
    import cv2
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                        (hw[1], hw[0]))
    for _ in range(frames):
        w.write(rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
    w.release()


@pytest.mark.parametrize("fps", ["1", "10"])
def test_video_frames_same_jpeg_bytes(tmp_path, capsys, fps):
    src = tmp_path / "vid"
    src.mkdir()
    _write_video(src / "v0.avi", 75, 0)
    _write_video(src / "v1.avi", 31, 1, hw=(36, 40), fps=15)
    (src / "broken.avi").write_bytes(b"")
    _port(["video-frames", str(src), str(tmp_path / "p"), "--fps", fps])
    assert "Fail @ broken.avi" in capsys.readouterr().out
    jcli.main(["video-frames", str(src), str(tmp_path / "j"), "--fps", fps])
    _same_bytes(tmp_path / "p", tmp_path / "j")
    n = len(list((tmp_path / "p" / "v0").glob("*.jpg")))
    assert n == (3 if fps == "1" else 25)


@pytest.fixture
def jax_wordpiece(monkeypatch):
    """The JAX tokenizer bound to the port-built library (its own build
    would run ``make -C native``); each binding's vocabulary record reset."""
    from mla_tpu.data import wordpiece as jwp
    from mla_tpu_torch.data import wordpiece

    monkeypatch.setattr(jwp, "_lib", wordpiece._load())
    monkeypatch.setattr(jwp, "_loaded_vocab", (None, 0))
    monkeypatch.setattr(wordpiece, "_loaded_vocab", (None, 0))


def test_extract_token_vocab_byte_equal(tmp_path, jax_wordpiece):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    tsv = tmp_path / "texts.tsv"
    tsv.write_text("s0\thello world!\ns1\tthe unaffable catnap\n"
                   "s2\t\ns3\t" + "hello " * 30 + "\n")
    for out in ("p", "j"):
        run = _port if out == "p" else jcli.main
        run(["extract-token", str(tsv), str(tmp_path / out),
             "--max_length", "16", "--vocab", str(vocab)])
    _same_bytes(tmp_path / "p", tmp_path / "j")
    assert np.load(tmp_path / "p" / "s0_token.npy").dtype == np.int64
    assert np.load(tmp_path / "p" / "s2_pm.npy").shape == (1, 16)


def test_extract_token_hf_path(tmp_path):
    """The HF tokenizer path, only where a cached bert-base-uncased loads
    without the network (as the JAX package's test holds it)."""
    try:
        from transformers import BertTokenizer
        BertTokenizer.from_pretrained("bert-base-uncased",
                                      local_files_only=True)
    except Exception:
        pytest.skip("bert-base-uncased is not cached")
    tsv = tmp_path / "texts.tsv"
    tsv.write_text("s0\thello world this is a test\ns1\t\n")
    _port(["extract-token", str(tsv), str(tmp_path / "p"),
           "--max_length", "16"])
    jcli.main(["extract-token", str(tsv), str(tmp_path / "j"),
               "--max_length", "16"])
    _same_bytes(tmp_path / "p", tmp_path / "j")


def test_extract_token_unloadable_tokenizer_exits(tmp_path, monkeypatch):
    import transformers

    def refuse(*a, **k):
        raise OSError("no cached copy")

    monkeypatch.setattr(transformers.BertTokenizer, "from_pretrained",
                        refuse)
    tsv = tmp_path / "texts.tsv"
    tsv.write_text("s0\thello\n")
    with pytest.raises(SystemExit, match="cannot load HF tokenizer"):
        _port(["extract-token", str(tsv), str(tmp_path / "p")])


def _iemo_inputs(tmp_path, wavs):
    """Datalists (train: three clips, clip 'x' without a wav; no dev list),
    face dirs for a and b only (c has none), and the vocabulary."""
    from PIL import Image
    lists, faces = tmp_path / "lists", tmp_path / "faces"
    lists.mkdir(exist_ok=True)
    sep = " [split|sign] "
    (lists / "my_train_iemo.txt").write_text(
        f"a.mp4{sep}hello world{sep}ang\n"
        f"b.mp4{sep}the unable{sep}neu\n"
        f"x.mp4{sep}catnap!{sep}hap\n\n")
    (lists / "my_test_iemo.txt").write_text(f"c.mp4{sep}don't{sep}sad\n")
    rng = np.random.default_rng(9)
    for name, n in (("a", 2), ("b", 1)):
        d = faces / name
        d.mkdir(parents=True, exist_ok=True)
        for k in range(n):
            Image.fromarray(rng.integers(0, 255, (30 + k, 40, 3),
                                         dtype=np.uint8)).save(d / f"f{k}.jpg")
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
                        ).save(d / "g.png")
        (d / "notes.txt").write_text("skipped")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return lists, faces


def test_preprocess_iemo_matches_jax(wavs, tmp_path, capsys, jax_wordpiece):
    lists, faces = _iemo_inputs(tmp_path, wavs)
    argv = [str(lists), str(wavs), str(faces)]
    opts = ["--splits", "train,dev,test", "--target_length", "64",
            "--max_length", "16", "--vocab", str(tmp_path / "vocab.txt")]
    _port(["preprocess-iemo", *argv, str(tmp_path / "p"), *opts])
    said = capsys.readouterr().out
    assert "skip split 'dev'" in said and "Fail @ c: no face dir" in said
    assert "there is a loading error (x:" in said
    jcli.main(["preprocess-iemo", *argv, str(tmp_path / "j"), *opts])
    p, j = tmp_path / "p", tmp_path / "j"
    assert _files(p) == _files(j)
    assert not (p / "audio" / "dev_fbank").exists()
    assert not (p / "visual" / "test_imgs" / "c").exists()
    assert _files(p / "visual") == ["train_imgs/a/f0.jpg",
                                    "train_imgs/a/f1.jpg",
                                    "train_imgs/a/g.jpg",
                                    "train_imgs/b/f0.jpg",
                                    "train_imgs/b/g.jpg"]
    _same_bytes(p / "visual", j / "visual")
    _same_bytes(p / "text_token", j / "text_token")
    _close_npys(p / "audio", j / "audio", shape=(64, 128))
    assert np.all(np.load(p / "audio" / "train_fbank" / "x.npy")
                  == np.float32(0.01))


def test_gen_txt_and_gen_stat_byte_equal(tmp_path):
    all_list = tmp_path / "all.txt"
    all_list.write_text("".join(f"clip{i:02d}.flv LAB{i % 3}\n"
                                for i in range(23)) + "\nlast.flv LAB1")
    for out, run in (("p", _port), ("j", jcli.main)):
        d = tmp_path / out
        d.mkdir()
        run(["gen-txt", str(all_list), str(d / "my"), "--test_frac", "0.25",
             "--seed", "3"])
        run(["gen-stat", str(d / "my_train.txt"), str(d / "my_test.txt"),
             "--out", str(d / "stat.txt")])
    _same_bytes(tmp_path / "p", tmp_path / "j")
    assert len((tmp_path / "p" / "my_test.txt").read_text().splitlines()) == 6
    (tmp_path / "other.txt").write_text("a.flv LAB0\nb.flv LABX\n")
    with pytest.raises(SystemExit, match="label sets differ"):
        _port(["gen-stat", str(tmp_path / "p" / "my_train.txt"),
               str(tmp_path / "other.txt"), "--out", str(tmp_path / "s")])


def test_mp4_to_wav_same_ffmpeg_argv(tmp_path, monkeypatch):
    """A stub ``ffmpeg`` on PATH records its argv and writes the wav."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "ffmpeg"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import json, os, sys\n"
        "with open(os.environ['FFMPEG_LOG'], 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[-1], 'wb').write(b'RIFF')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    src = tmp_path / "mp4"
    src.mkdir()
    for f in ("b.mp4", "a.flv", "c.avi", "d.txt"):
        (src / f).write_bytes(b"")
    out = tmp_path / "out"
    logs = {}
    for who, run in (("p", _port), ("j", jcli.main)):
        log = tmp_path / f"{who}.log"
        monkeypatch.setenv("FFMPEG_LOG", str(log))
        run(["mp4-to-wav", str(src), str(out)])
        logs[who] = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert logs["p"] == logs["j"] and len(logs["p"]) == 2
    assert logs["p"][0] == ["-y", "-i", str(src / "a.flv"), "-acodec",
                            "pcm_s16le", "-ar", "16000", "-ac", "1",
                            str(out / "a.wav")]
    assert _files(out) == ["a.wav", "b.wav"]


def test_device_flag_parses_anywhere_and_keeps_the_jax_flags():
    from mla_tpu_torch.data.etl import cli
    assert cli.DEVICE_COMMANDS == ("extract-spec", "extract-fbank",
                                   "preprocess-iemo")
    args = cli.parse_args(["extract-fbank", "--device", "cpu", "i", "o"])
    assert args.device.type == "cpu" and args.target_length == 1024
    assert args.mix_dir is None and args.mix_lambda is None
    args = cli.parse_args(["preprocess-iemo", "l", "a", "f", "o",
                           "--device", "cpu"])
    assert args.device.type == "cpu" and args.splits == "train,dev,test"
    # the subcommands that touch no device take no --device
    args = cli.parse_args(["gen-txt", "all", "pre"])
    assert args.test_frac == 0.1 and args.seed == 0
    assert not hasattr(args, "device")
    with pytest.raises(SystemExit):
        cli.parse_args(["gen-txt", "all", "pre", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.parse_args(["extract-spec", "i", "o", "--device", "tpu"])
