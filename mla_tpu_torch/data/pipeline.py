"""Host input pipeline: threaded sample loading, static-shape batches,
pinned host staging, prefetch (port of ``mla_tpu/data/pipeline.py``).

Replaces the reference's 32-worker torch DataLoader (main.py:813-817).
Batches are padded to a fixed batch_size with a ``valid`` mask; the final
transform (crop/resize/normalize) runs on the device after the copy.

What the port does differently is the copy: the producer thread stages
each padded host batch in pinned (page-locked) memory, and the consumer
copies it with ``non_blocking=True``, so the copy is a DMA on the current
stream that overlaps the host's next work (a pageable copy of the AV
frames blocks the host for its whole length). One process, one device:
the JAX package's mesh and multi-host row windows go to ROADMAP A9.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from mla_tpu_torch.device import resolve_device
from mla_tpu_torch.utils.seed import batch_generator


def pad_rows(hb: Dict[str, np.ndarray], n_real: int, width: int,
             idx_sentinel: int) -> Dict[str, np.ndarray]:
    """Single source of the padded-batch semantics: zero rows beyond
    ``n_real`` up to ``width``, a float ``valid`` mask, and padded ``idx``
    rows pointed at the sentinel slot (``n_data`` — the QMF scratch row)."""
    if n_real < width:
        hb = {k: np.concatenate(
            [v[:n_real], np.zeros((width - n_real,) + v.shape[1:], v.dtype)])
            for k, v in hb.items()}
    hb["valid"] = np.concatenate(
        [np.ones(n_real, np.float32), np.zeros(width - n_real, np.float32)])
    if "idx" in hb:
        hb["idx"] = hb["idx"].astype(np.int32)
        hb["idx"][n_real:] = idx_sentinel
    return hb


def collate_pad(samples, batch_size: int, n_data: int) -> Dict[str, np.ndarray]:
    """Stack sample dicts; pad to batch_size with zero rows, valid=0 and
    idx=n_data (the QMF scratch slot) for padded rows."""
    out = {k: np.stack([np.asarray(s[k]) for s in samples])
           for k in samples[0].keys()}
    return pad_rows(out, len(samples), batch_size, n_data)


class Loader:
    """Iterates device-ready batch dicts for one adapter.

    Shuffle per epoch with a seed-derived numpy generator (reference:
    DataLoader shuffle=True train / False eval, main.py:813-817);
    drop_last=False. ``device``: where batches land and the transform runs
    (the card unless 'cpu' is asked for)."""

    def __init__(self, adapter, batch_size: int, shuffle=True,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 device=None):
        self.adapter = adapter
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.n = len(adapter)

    def __len__(self):
        return (self.n + self.batch_size - 1) // self.batch_size

    def _host_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield each padded batch. The permutation and per-sample generator
        streams are keyed by (seed, epoch, dataset index), so a resumed run
        sees the batches an uninterrupted one does."""
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        # the adapter loads a batch in one call: through the C++ thread pool
        # when the native library is built, else per sample over these
        # ``num_workers`` threads (no thread starts until a sample is asked)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, self.n, self.batch_size):
                idxs = [int(i) for i in order[start:start + self.batch_size]]
                rngs = [np.random.default_rng((self.seed, epoch, i))
                        for i in idxs]
                hb = self.adapter.batch_host(idxs, rngs, pool.map)
                yield pad_rows(hb, len(idxs), self.batch_size, self.n)

    def _stage(self, hb: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors the consumer copies from: pinned memory for
        a card (PyTorch's caching host allocator reuses a block only after
        the copies that read it have finished), the arrays themselves for
        the CPU."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in hb.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        """Device-ready batches with background prefetch.

        Abandoning the iterator mid-epoch (e.g. taking only the first batch)
        stops the producer thread and shuts the worker pool down — no thread
        leak across many short epochs."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()

        def producer():
            try:
                for hb in self._host_batches(epoch):
                    staged = self._stage(hb)
                    while not stop.is_set():
                        try:
                            q.put(staged, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:   # noqa: BLE001 — raised by the consumer
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.25)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        step = 0
        try:
            while True:
                hb = q.get()
                if hb is sentinel:
                    if err:
                        raise err[0]
                    return
                batch = {k: v.to(self.device, non_blocking=True)
                         for k, v in hb.items()}
                # the batch's device draws (the JAX loader's key
                # fold_in(fold_in(key(seed), epoch), step))
                gen = batch_generator(self.seed, epoch, step, self.device)
                with torch.profiler.record_function("mla.transform"):
                    batch = self.adapter.finish_batch(batch, gen)
                yield batch
                step += 1
        finally:
            stop.set()
            t.join(timeout=5.0)
