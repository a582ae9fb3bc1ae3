"""The port's audio ops of the offline ETL (``mla_tpu_torch/ops/stft.py``,
``mla_tpu_torch/ops/fbank.py``) against the JAX package's
(``mla_tpu/ops/stft.py``, ``mla_tpu/ops/fbank.py``), on the CPU, from
seeded numpy inputs: the framing exactly, the windows and mel banks bit for
bit, the log-STFT and the Kaldi fbank within 1e-3 in the log domain (the
tolerance of the JAX package's own goldens, ``tests/test_ops.py``: two FFTs
sum in different orders and bins of tiny power amplify that in the log),
and waveforms shorter than one 400-sample frame (zero frames, so
``wav2fbank`` gives zeros) at 0, 1, 399, 400, 401 and 560 samples.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.ops import fbank as jfbank
from mla_tpu.ops import stft as jstft

LOG_ATOL = 1e-3


def _noise(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _max_diff(got, want, what):
    d = float(np.abs(got - np.asarray(want)).max()) if got.size else 0.0
    print(f"{what}: largest difference from JAX {d:.3e}")
    return d


@pytest.mark.parametrize("t,frame,hop", [(1000, 256, 128), (560, 400, 160),
                                         (400, 400, 160), (399, 400, 160),
                                         (1, 400, 160), (0, 400, 160)])
def test_frame_signal_exact(t, frame, hop):
    import torch
    from mla_tpu_torch.ops.stft import frame_signal

    x = _noise((2, t), 0)
    want = np.asarray(jstft.frame_signal(jnp.asarray(x), frame, hop))
    got = frame_signal(torch.from_numpy(x), frame, hop).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_windows_and_mel_banks_bit_equal():
    from mla_tpu_torch.ops import fbank, stft

    np.testing.assert_array_equal(stft._hann_periodic(256),
                                  jstft._hann_periodic(256))
    np.testing.assert_array_equal(fbank._kaldi_hanning(400),
                                  jfbank._kaldi_hanning(400))
    for bins, padded, sr in ((128, 512, 16000.0), (80, 1024, 22050.0)):
        got = fbank.kaldi_mel_banks(bins, padded, sr)
        want = jfbank.kaldi_mel_banks(bins, padded, sr)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(80000,), (3, 80000)],
                         ids=["5s", "batch3"])
def test_log_stft_matches_jax(shape):
    import torch
    from mla_tpu_torch.ops.stft import crema_spectrogram, log_stft

    x = _noise(shape, 1)
    want = np.asarray(jstft.log_stft(jnp.asarray(x)))
    got = log_stft(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:-1], 129, 626)
    assert _max_diff(got, want, f"log_stft {shape}") <= LOG_ATOL
    if len(shape) == 1:
        np.testing.assert_array_equal(
            crema_spectrogram(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("seconds", [1, 3])
def test_kaldi_fbank_matches_jax(seconds):
    import torch
    from mla_tpu_torch.ops.fbank import kaldi_fbank

    x = _noise(16000 * seconds, 2 + seconds, 0.1)
    want = np.asarray(jfbank.kaldi_fbank(jnp.asarray(x)))
    got = kaldi_fbank(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1 + (16000 * seconds - 400) // 160,
                                       128)
    assert _max_diff(got, want, f"kaldi_fbank {seconds} s") <= LOG_ATOL


@pytest.mark.parametrize("n", [0, 1, 399, 400, 401, 560])
def test_wav2fbank_short_inputs_match_jax(n):
    import torch
    from mla_tpu_torch.ops.fbank import kaldi_fbank, wav2fbank

    x = _noise(n, 10 + n, 0.1)
    want = np.asarray(jfbank.wav2fbank(jnp.asarray(x), target_length=16))
    got = wav2fbank(torch.from_numpy(x), target_length=16).numpy()
    assert got.shape == want.shape == (16, 128)
    frames = 1 + (n - 400) // 160 if n >= 400 else 0
    assert kaldi_fbank(torch.from_numpy(x)).shape == (frames, 128)
    if n < 400:
        assert not got.any() and not want.any()
    assert np.abs(got[frames:]).max() == 0.0
    assert _max_diff(got, want, f"wav2fbank {n} samples") <= LOG_ATOL


@pytest.mark.parametrize("n2", [12000, 16000, 20000],
                         ids=["shorter", "equal", "longer"])
def test_mix_waveforms_matches_jax(n2):
    import torch
    from mla_tpu_torch.ops.fbank import mix_waveforms, wav2fbank

    w1, w2 = _noise(16000, 4, 0.1), _noise(n2, 5, 0.1)
    want = np.asarray(jfbank.mix_waveforms(jnp.asarray(w1), jnp.asarray(w2),
                                           0.3))
    got = mix_waveforms(torch.from_numpy(w1), torch.from_numpy(w2),
                        0.3).numpy()
    assert got.shape == want.shape == (16000,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    fb_want = np.asarray(jfbank.wav2fbank(jnp.asarray(w1),
                                          waveform2=jnp.asarray(w2),
                                          mix_lambda=0.3))
    fb_got = wav2fbank(torch.from_numpy(w1), waveform2=torch.from_numpy(w2),
                       mix_lambda=0.3).numpy()
    assert _max_diff(fb_got, fb_want, f"mixed fbank w2 {n2}") <= LOG_ATOL
