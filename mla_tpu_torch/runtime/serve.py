"""Inference over an exported serving artifact: batch CLI or HTTP server
(port of ``mla_tpu/runtime/serve.py``).

Batch mode:
    python -m mla_tpu_torch.runtime.serve --artifact DIR --input feats.npz \
        [--output preds.npz] [--topk 5] [--device cuda|cpu]

`feats.npz` holds one array per feature the artifact expects (names from its
meta.json: token/padding_mask/image), leading axis = examples. Requests
larger than the biggest exported batch rung are chunked. Output: fused
logits, per-modality logits, and top-k class ids — written to --output or
summarized to stdout.

Server mode (stdlib-only, no extra deps):
    python -m mla_tpu_torch.runtime.serve --artifact DIR --http PORT \
        [--coalesce_ms MS]
    GET  /meta     -> the artifact's meta.json
    GET  /healthz  -> 200 once the artifact is loaded
    GET  /stats    -> request/dispatch counters (coalescing observability)
    POST /predict  -> body is an .npz of feature arrays; response is an
                      .npz of fused/per-modality logits (chunked through
                      the batch ladder like batch mode)

--coalesce_ms enables dynamic request coalescing: concurrent small
/predict requests are concatenated into ONE device dispatch, filled up to
the artifact's largest batch rung or until MS milliseconds pass since the
batch opened. A lone request waits up to MS extra; default off (MS=0).

This module is host code around ``ServingModel`` (runtime/export.py), which
keeps the weights on the device across requests.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mla_tpu_torch.runtime.export import load_serving


class DispatchError(RuntimeError):
    """A device-side failure while running a request (as opposed to request
    validation): surfaces as HTTP 500, not 400 — the client's request was
    well-formed."""


def run_batch(srv, feats: dict, chunk: int | None = None):
    """Chunk a request of any length through the artifact's batch ladder."""
    names = srv.feature_names
    if names[0] not in feats:
        raise KeyError(f"serving request missing features "
                       f"{[k for k in names if k not in feats]}")
    n = int(np.asarray(feats[names[0]]).shape[0])
    if n < 1:
        raise ValueError("serving request has 0 rows")
    chunk = chunk or srv.batch_sizes[-1]
    outs = []
    for lo in range(0, n, chunk):
        outs.append(srv({k: np.asarray(v)[lo:lo + chunk]
                         for k, v in feats.items() if k in names}))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


class Batcher:
    """Dynamic request coalescing over one ServingModel.

    submit(feats) blocks the calling (HTTP handler) thread until its rows
    come back; a single worker thread drains the queue, concatenates
    requests up to ``max_rows`` (the artifact's largest batch rung) or until
    ``wait_ms`` has passed since the batch opened, runs ONE device dispatch
    through srv's ladder padding, and splits the logits back per request.

    Requests are validated (names + per-sample shapes) BEFORE enqueueing so
    one malformed client cannot fail a coalesced batch; a device-side error
    propagates to every request of that batch only. The device lock is
    shared with the non-coalesced path so exactly one forward runs at a
    time either way.

    Numeric contract: a coalesced batch computes EXACTLY what one merged
    request of the same rows would. Per-modality logits are row-independent,
    so each client gets the same answer either way; the fused head of a
    --dynamic artifact is batch-coupled by the reference's own batch-axis
    entropy gating (main.py:65-70), so there, as with run_batch's chunking,
    batch composition is part of the semantics.
    """

    def __init__(self, srv, wait_ms: float, lock=None):
        self.srv = srv
        self.wait_s = wait_ms / 1000.0
        self.max_rows = srv.batch_sizes[-1]
        self.lock = lock if lock is not None else threading.Lock()
        self.stats = {"requests": 0, "rows": 0, "dispatches": 0,
                      "coalesced_batches": 0}
        self._q: queue.Queue = queue.Queue()
        self._carry = None  # drained item that didn't fit the closing batch
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, feats: dict) -> dict:
        """Validate, enqueue, block until this request's logits return."""
        if self._stop.is_set():
            raise DispatchError("batcher closed")
        names = self.srv.feature_names
        feats = {k: np.asarray(v) for k, v in feats.items() if k in names}
        n = self.srv.validate_request(feats)
        if n > self.max_rows:
            raise ValueError(
                f"coalescing batcher takes requests up to the largest "
                f"exported rung ({self.max_rows} rows), got {n}; chunk "
                f"large requests through run_batch")
        fut: Future = Future()
        self._q.put((feats, n, fut, time.monotonic()))
        return fut.result()

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._worker.join(timeout=5)
        # Resolve anything still queued/carried so no handler thread is left
        # blocked on fut.result() forever.
        stranded = []
        if self._carry is not None:
            stranded.append(self._carry)
            self._carry = None
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                stranded.append(item)
        for _, _, fut, _ in stranded:
            fut.set_exception(DispatchError("batcher closed"))

    def _next(self, timeout):
        if self._carry is not None:
            item, self._carry = self._carry, None
            return item
        return self._q.get(timeout=timeout)

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._next(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            rows = first[1]
            # Deadline from the OLDEST item's enqueue time, not dequeue: a
            # carried-over request has already burned its wait window, so
            # the batch it opens closes as soon as the immediately-available
            # queue is drained.
            deadline = first[3] + self.wait_s
            while rows < self.max_rows:
                left = max(deadline - time.monotonic(), 0.0)
                try:
                    item = self._next(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    break
                if rows + item[1] > self.max_rows:
                    self._carry = item  # opens the next batch
                    break
                batch.append(item)
                rows += item[1]
            self._dispatch(batch, rows)

    def _dispatch(self, batch, rows):
        names = self.srv.feature_names
        self.stats["requests"] += len(batch)
        self.stats["rows"] += rows
        self.stats["dispatches"] += 1
        if len(batch) > 1:
            self.stats["coalesced_batches"] += 1
        try:
            merged = {k: np.concatenate([b[0][k] for b in batch])
                      for k in names}
            with self.lock:
                out = self.srv(merged)
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            # requests were validated at submit — a failure here is a
            # server/device fault, typed so the HTTP layer answers 500
            for _, _, fut, _ in batch:
                fut.set_exception(DispatchError(str(e)))
            return
        lo = 0
        for _, n, fut, _ in batch:
            fut.set_result({k: v[lo:lo + n] for k, v in out.items()})
            lo += n


def make_server(srv, port: int, host: str = "127.0.0.1",
                coalesce_ms: float = 0.0) -> ThreadingHTTPServer:
    """HTTP front for a loaded ServingModel. Returned server is not yet
    serving — call serve_forever() (or serve in a thread for tests).
    Device work is serialized with a lock: one forward at a time, the
    HTTP threads only parse/serialize. coalesce_ms > 0 routes rung-sized
    requests through a Batcher (see class docstring); oversized requests
    still chunk through run_batch. The batcher is exposed as
    ``server.batcher`` (None when off) — call batcher.close() on teardown."""
    lock = threading.Lock()
    batcher = Batcher(srv, coalesce_ms, lock) if coalesce_ms > 0 else None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/meta":
                self._send(200, json.dumps(srv.meta).encode())
            elif self.path == "/healthz":
                self._send(200, b'{"ok": true}')
            elif self.path == "/stats":
                stats = dict(batcher.stats) if batcher else {}
                stats["coalesce_ms"] = coalesce_ms
                self._send(200, json.dumps(stats).encode())
            else:
                self._send(404, b'{"error": "unknown path"}')

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b'{"error": "unknown path"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    feats = {k: z[k] for k in z.files}
            except Exception as e:  # noqa: BLE001 — unparseable body
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            try:
                if batcher is not None and srv.feature_names[0] in feats \
                        and np.asarray(feats[srv.feature_names[0]]).shape[0] \
                        <= batcher.max_rows:
                    out = batcher.submit(feats)
                else:
                    with lock:
                        out = run_batch(srv, feats)
            except (KeyError, ValueError) as e:  # malformed request
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            except Exception as e:  # noqa: BLE001 — server/device fault
                self._send(500, json.dumps({"error": str(e)}).encode())
                return
            buf = io.BytesIO()
            np.savez(buf, **out)
            self._send(200, buf.getvalue(), ctype="application/npz")

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="mla-tpu-torch inference")
    p.add_argument("--artifact", required=True,
                   help="directory written by mla_tpu_torch.runtime.export")
    p.add_argument("--input", default=None, help=".npz of feature arrays")
    p.add_argument("--output", default=None,
                   help=".npz for logits + predictions (default: stdout "
                        "summary only)")
    p.add_argument("--topk", default=1, type=int)
    p.add_argument("--http", default=None, type=int, metavar="PORT",
                   help="serve over HTTP instead of batch mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--coalesce_ms", default=0.0, type=float,
                   help="dynamic batching: coalesce concurrent /predict "
                        "requests for up to this many ms into one device "
                        "dispatch (0 = off)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs; 'cuda' raises without a card")
    args = p.parse_args(argv)
    if args.coalesce_ms < 0:
        raise SystemExit("--coalesce_ms must be >= 0")

    srv = load_serving(args.artifact, device=args.device)
    if args.http is not None:
        httpd = make_server(srv, args.http, args.host, args.coalesce_ms)
        print(json.dumps({"serving": srv.meta["family"],
                          "port": httpd.server_address[1]}), flush=True)
        httpd.serve_forever()
        return
    if not args.input:
        raise SystemExit("--input is required in batch mode (or use --http)")
    with np.load(args.input) as z:
        feats = {k: z[k] for k in z.files}
    missing = [k for k in srv.feature_names if k not in feats]
    if missing:
        raise SystemExit(f"--input is missing features {missing} "
                         f"(artifact expects {srv.feature_names})")
    out = run_batch(srv, feats)
    order = np.argsort(-out["fused"], axis=1)
    out["topk"] = order[:, :args.topk].astype(np.int32)
    if args.output:
        np.savez(args.output, **out)
    n = out["fused"].shape[0]
    summary = {
        "examples": n, "n_classes": int(out["fused"].shape[1]),
        "family": srv.meta["family"],
        "pred_head": out["topk"][:, 0][:16].tolist(),
        "output": args.output}
    if "label" in feats:  # labeled npz: report accuracy directly
        label = np.asarray(feats["label"]).reshape(-1)[:n]
        summary["accuracy"] = float(np.mean(out["topk"][:, 0] == label))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
