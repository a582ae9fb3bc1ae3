"""The port's WordPiece tokenizer (``mla_tpu_torch/data/wordpiece.py``, its
own ctypes binding of ``native/wordpiece.cc``) against the JAX package's
(``mla_tpu/data/wordpiece.py``): the same ids and padding mask, exactly, on
the strings of ``tests/test_etl.py``'s HF parity class and its vocabulary,
written by the test. The JAX side is bound to the port-built library (its
own build would run ``make -C native``, which writes ``native/``); each
binding keeps its own record of which vocabulary the library holds.
"""

import numpy as np
import pytest

import test_etl

from mla_tpu.data import wordpiece as jwp

PARITY = test_etl.TestWordPieceHFParity
TEXTS = PARITY.TEXTS + ["", "   \t\n  ", "​\xad"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(PARITY.VOCAB) + "\n")
    return str(p)


@pytest.fixture
def pair(vocab, monkeypatch):
    from mla_tpu_torch.data import wordpiece

    monkeypatch.setattr(jwp, "_lib", wordpiece._load())
    monkeypatch.setattr(jwp, "_loaded_vocab", (None, 0))
    monkeypatch.setattr(wordpiece, "_loaded_vocab", (None, 0))
    return jwp.WordPieceTokenizer(vocab), wordpiece.WordPieceTokenizer(vocab)


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_ids_and_pm_equal_jax(pair, i):
    jax_tok, port_tok = pair
    for length in (32, 8):
        want = jax_tok.encode(TEXTS[i], max_length=length)
        got = port_tok.encode(TEXTS[i], max_length=length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape == (1, length)
            np.testing.assert_array_equal(g, w)


def test_library_builds_into_the_port_build_dir_and_vocabs_swap(vocab,
                                                                tmp_path):
    from mla_tpu_torch.data import wordpiece
    from mla_tpu_torch.ops import _build

    path = wordpiece.library_path()
    assert wordpiece.SOURCE.name == "wordpiece.cc"
    tok = wordpiece.WordPieceTokenizer(vocab)
    assert path.exists() and path.parent == _build.build_dir()
    assert tok.vocab_size == len(PARITY.VOCAB)
    other = tmp_path / "other.txt"
    other.write_text("[PAD]\n[UNK]\nhello\n")
    small = wordpiece.WordPieceTokenizer(str(other))
    assert small.encode("hello world", 4)[0].tolist() == [[2, 1, 0, 0]]
    # the first tokenizer reloads its own vocabulary
    ids, pm = tok.encode("hello world", 4)
    assert ids.tolist() == [[PARITY.VOCAB.index("hello"),
                             PARITY.VOCAB.index("world"), 0, 0]]
    assert pm.tolist() == [[0.0, 0.0, 1.0, 1.0]]
    with pytest.raises(FileNotFoundError):
        wordpiece.WordPieceTokenizer(str(tmp_path / "missing.txt"))
