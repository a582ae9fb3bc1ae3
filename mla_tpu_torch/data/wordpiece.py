"""ctypes binding for the C++ WordPiece tokenizer ``native/wordpiece.cc``,
the port's own (port of ``mla_tpu/data/wordpiece.py``).

Self-contained replacement for HF BertTokenizer in the offline ETL stage
(reference: data/extract_token.py): it writes the token caches the M3AE
adapter reads, and no training step calls it. Same output contract: ids
without special tokens, padded to max_length, pm = 1 - attention_mask.

The library is built at first use with g++ and ``native/Makefile``'s flags
into the port's build directory (``native_loader.build``), named by a hash
of the source and flags; ``native/`` itself is never written.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wordpiece.cc"

_lib = None
_LOCK = threading.Lock()


def library_path() -> Path:
    from mla_tpu_torch.data import native_loader
    return native_loader.library_path(SOURCE, link=())


def _load() -> ctypes.CDLL:
    """The library, built at first use; raises when g++ fails."""
    global _lib
    with _LOCK:
        if _lib is None:
            from mla_tpu_torch.data import native_loader
            lib = ctypes.CDLL(str(native_loader.build(SOURCE, link=())))
            lib.wp_load_vocab.restype = ctypes.c_int
            lib.wp_load_vocab.argtypes = [ctypes.c_char_p]
            lib.wp_encode.restype = ctypes.c_int
            lib.wp_encode.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int]
            _lib = lib
        return _lib


# The C library holds ONE global vocab; track whose it is (path -> size) so
# two tokenizers with different vocabs never read each other's tables:
# encode() reloads when another instance swapped vocabs.
_loaded_vocab = (None, 0)  # (abspath, size)


class WordPieceTokenizer:
    def __init__(self, vocab_path: str):
        self._lib = _load()
        self._vocab_path = os.path.abspath(vocab_path)
        self.vocab_size = self._ensure_vocab()

    def _ensure_vocab(self) -> int:
        global _loaded_vocab
        if _loaded_vocab[0] != self._vocab_path:
            n = self._lib.wp_load_vocab(self._vocab_path.encode())
            if n <= 0:
                raise FileNotFoundError(
                    f"cannot load vocab {self._vocab_path}")
            _loaded_vocab = (self._vocab_path, n)
        return _loaded_vocab[1]

    def encode(self, text: str, max_length: int = 256
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids (1, L) int64, pm (1, L) float32) like extract_token.py."""
        self._ensure_vocab()
        ids = np.zeros((max_length,), np.int32)
        pm = np.zeros((max_length,), np.float32)
        n = self._lib.wp_encode(text.encode(),
                                ids.ctypes.data_as(ctypes.c_void_p),
                                pm.ctypes.data_as(ctypes.c_void_p),
                                max_length)
        if n < 0:
            raise RuntimeError("vocab not loaded")
        return ids[None].astype(np.int64), pm[None]
