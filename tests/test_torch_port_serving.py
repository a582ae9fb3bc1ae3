"""The port's serving path (mla_tpu_torch/runtime/export.py + serve.py) on
the CPU: the artifact's logits against the JAX package's eval_logits with
gs_flag (fixed alpha and --dynamic, valid-masked padding included), request
validation, run_batch chunking, coalescing and the HTTP front, mirroring
tests/test_export.py's serving tests. Debug size: 2 blocks, 1024 wide,
256-token vocabulary, 8 tokens, 32x32 images, a (2, 4) batch ladder.

Tolerances: fp32 against JAX, atol 2e-4 (LayerNorm variance formula and
summation order differ, see test_torch_port_m3ae.py); bf16 weights and
compute against fp32, relative L2 <= 3e-2 (bf16 keeps ~3 significant
digits through 2 blocks).
"""

import io
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.core.config import MLAConfig as JConfig
from mla_tpu.evals.metrics import eval_logits as jax_eval_logits
from mla_tpu.models.classifiers import M3AEClassifier as JClassifier

VOCAB, L, IMG, NB = 256, 8, 32, 4
ATOL = 2e-4
KEYS = ("token", "padding_mask", "image")


def _feats(seed=0, n=NB):
    rng = np.random.default_rng(seed)
    pm = np.zeros((n, L), np.float32)
    pm[0, 6:] = 1.0
    pm[1, 2:] = 1.0
    return {"token": rng.integers(0, VOCAB, (n, L)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX model + params, and port artifacts exported from the same
    weights: {dynamic: artifact dir} in fp32 and a bf16-weights one."""
    import torch
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import M3AEClassifier
    from mla_tpu_torch.models.convert import state_dict_from_jax
    from mla_tpu_torch.runtime.export import export_serving

    torch.set_num_threads(1)
    jmodel = JClassifier(n_classes=101, gs_flag=True, model_type="debug",
                         text_vocab_size=VOCAB, dtype=jnp.float32)
    f = {k: jnp.asarray(v) for k, v in _feats().items()}
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), f,
                                                  train=False)["params"])
    jcfg = JConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                   m3ae_size="debug").validate()
    with torch.device("meta"):
        model = M3AEClassifier(n_classes=101, gs_flag=True,
                               model_type="debug", text_vocab_size=VOCAB)
    model.load_state_dict(state_dict_from_jax(params, jcfg), strict=True,
                          assign=True)
    root = tmp_path_factory.mktemp("port_serving")
    arts = {}
    for dynamic in (False, True):
        cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                        dynamic=dynamic, m3ae_size="debug", image_size=IMG,
                        compute_dtype="float32").validate()
        arts[dynamic] = export_serving(cfg, model, str(root / f"d{dynamic}"),
                                       batch_sizes=(4, 2),
                                       example_batch=_feats())
    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    dynamic=True, m3ae_size="debug", image_size=IMG,
                    compute_dtype="bfloat16").validate()
    arts["bf16"] = export_serving(cfg, model, str(root / "bf16"),
                                  batch_sizes=(2, 4), weights_dtype="bfloat16",
                                  example_batch=_feats())
    return jmodel, params, arts


@pytest.fixture(scope="module")
def srv(served):
    from mla_tpu_torch.runtime.export import load_serving
    return load_serving(served[2][True], device="cpu")


def _jax(jmodel, params, feats, valid, dynamic):
    cfg = JConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                  dynamic=dynamic, m3ae_size="debug").validate()
    batch = {k: jnp.asarray(v) for k, v in feats.items()}
    out_m, fused = jax_eval_logits(jmodel, cfg, params, {}, batch,
                                   jnp.asarray(valid))
    return {"fused": np.asarray(fused), "logits_a": np.asarray(out_m["a"]),
            "logits_v": np.asarray(out_m["v"])}


@pytest.mark.parametrize("dynamic", [False, True])
def test_serving_matches_jax_eval_logits(served, dynamic):
    from mla_tpu_torch.runtime.export import load_serving

    jmodel, params, arts = served
    srv = load_serving(arts[dynamic], device="cpu")
    assert srv.batch_sizes == [2, 4] and srv.compute_dtype == "float32"
    feats = _feats(1)
    got = srv(feats)
    want = _jax(jmodel, params, feats, np.ones(NB, np.float32), dynamic)
    for k in want:
        assert got[k].shape == (NB, 101) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def test_padded_request_matches_valid_masked_gating(served, srv):
    """n=3 on the 4-row rung: per-modality rows equal the full call's
    exactly (row-independent heads), and the fused head equals the JAX
    gating over the 3 valid rows of the padded batch."""
    jmodel, params, _ = served
    feats = _feats(2)
    three = {k: v[:3] for k, v in feats.items()}
    padded, n, rung = srv.pad_request(three)
    assert (n, rung) == (3, 4)
    np.testing.assert_array_equal(padded["valid"], [1, 1, 1, 0])
    got = srv(three)
    assert got["fused"].shape == (3, 101)
    full = srv(feats)
    for m in ("a", "v"):
        np.testing.assert_array_equal(got[f"logits_{m}"],
                                      full[f"logits_{m}"][:3])
    want = _jax(jmodel, params, {k: padded[k] for k in KEYS},
                padded["valid"], True)
    np.testing.assert_allclose(got["fused"], want["fused"][:3], atol=ATOL,
                               rtol=0)
    # the padded row really is excluded: gating over 4 real rows differs
    assert not np.allclose(got["fused"], full["fused"][:3], atol=1e-6)


def test_bf16_artifact_tracks_fp32(served, srv):
    import torch
    from mla_tpu_torch.runtime.export import load_serving

    bf = load_serving(served[2]["bf16"], device="cpu")
    assert bf.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.bfloat16 for p in bf.model.parameters())
    feats = _feats(3)
    got, want = bf(feats), srv(feats)
    for k in want:
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel <= 3e-2, (k, rel)


def test_request_validation(srv):
    feats = _feats(4)
    with pytest.raises(KeyError, match="missing features"):
        srv({k: v for k, v in feats.items() if k != "image"})
    with pytest.raises(ValueError, match="per-sample shape"):
        srv({**feats, "image": feats["image"][..., :16]})
    with pytest.raises(ValueError, match="rows, expected"):
        srv({**feats, "padding_mask": feats["padding_mask"][:2]})
    with pytest.raises(ValueError, match="largest exported batch"):
        srv({k: np.concatenate([v, v]) for k, v in feats.items()})
    with pytest.raises(ValueError, match="0 rows"):
        srv({k: v[:0] for k, v in feats.items()})
    bad = dict(feats, token=feats["token"].copy())
    bad["token"][0, 0] = VOCAB
    with pytest.raises(ValueError, match="token ids"):
        srv(bad)


def test_run_batch_chunks_through_the_ladder(srv):
    from mla_tpu_torch.runtime import serve

    feats = _feats(5)
    seven = {k: np.concatenate([v, v[:3]]) for k, v in feats.items()}
    out = serve.run_batch(srv, seven)
    assert out["fused"].shape == (7, 101)
    first, rest = srv(feats), srv({k: v[4:] for k, v in seven.items()})
    for k in out:
        np.testing.assert_array_equal(out[k][:4], first[k])
        np.testing.assert_array_equal(out[k][4:], rest[k])


def test_batch_cli(served, srv, tmp_path, capsys):
    from mla_tpu_torch.runtime import serve

    feats = _feats(6)
    inp, outp = str(tmp_path / "feats.npz"), str(tmp_path / "preds.npz")
    np.savez(inp, label=np.arange(NB), **feats)
    serve.main(["--artifact", served[2][True], "--input", inp, "--output",
                outp, "--topk", "3", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["examples"] == NB and 0.0 <= summary["accuracy"] <= 1.0
    with np.load(outp) as z:
        np.testing.assert_array_equal(z["fused"], srv(feats)["fused"])
        assert z["topk"].shape == (NB, 3)
        assert (z["topk"][:, 0] == np.argmax(z["fused"], axis=1)).all()
    np.savez(inp, token=feats["token"])
    with pytest.raises(SystemExit, match="missing features"):
        serve.main(["--artifact", served[2][True], "--input", inp,
                    "--device", "cpu"])


class TestCoalescing:
    """Contract: a coalesced batch == one merged request of the same rows."""

    def test_dispatch_splits_exactly(self, srv):
        from concurrent.futures import Future

        from mla_tpu_torch.runtime import serve

        feats = _feats(7)
        b = serve.Batcher(srv, wait_ms=1.0)
        try:
            slices = [(0, 2), (2, 3), (3, 4)]
            items = [({k: v[lo:hi] for k, v in feats.items()}, hi - lo,
                      Future(), 0.0) for lo, hi in slices]
            b._dispatch(items, 4)
            merged = srv(feats)
            for (lo, hi), (_, _, fut, _) in zip(slices, items):
                got = fut.result(timeout=5)
                for k in merged:
                    np.testing.assert_array_equal(got[k], merged[k][lo:hi])
            assert b.stats == {"requests": 3, "rows": 4, "dispatches": 1,
                               "coalesced_batches": 1}
        finally:
            b.close()

    def test_concurrent_submits_coalesce(self, srv):
        from mla_tpu_torch.runtime import serve

        feats = _feats(8)
        b = serve.Batcher(srv, wait_ms=2000.0)
        results = {}

        def one(i):
            results[i] = b.submit({k: v[i:i + 1] for k, v in feats.items()})

        try:
            ts = [threading.Thread(target=one, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
                assert not t.is_alive()
            assert b.stats["requests"] == 4
            assert b.stats["dispatches"] == 1   # the rung filled, no timeout
            assert b.stats["coalesced_batches"] == 1
            for i in range(4):
                direct = srv({k: v[i:i + 1] for k, v in feats.items()})
                for m in ("a", "v"):
                    # solo runs the 2-row rung, coalesced the 4-row one:
                    # other GEMM shapes, so fp32 rounding tolerance
                    np.testing.assert_allclose(
                        results[i][f"logits_{m}"], direct[f"logits_{m}"],
                        rtol=1e-5, atol=1e-5)
        finally:
            b.close()

    def test_carry_when_rung_overflows(self, srv):
        from mla_tpu_torch.runtime import serve

        feats = _feats(9)
        b = serve.Batcher(srv, wait_ms=300.0)
        results = {}

        def one(name, lo, hi, delay):
            time.sleep(delay)
            results[name] = b.submit({k: v[lo:hi] for k, v in feats.items()})

        try:
            # 3-row first + 2-row second > the 4-row rung -> second carries
            ts = [threading.Thread(target=one, args=("first", 0, 3, 0.0)),
                  threading.Thread(target=one, args=("second", 2, 4, 0.1))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
                assert not t.is_alive()
            assert b.stats["dispatches"] == 2
            assert b.stats["coalesced_batches"] == 0
            for name, (lo, hi) in (("first", (0, 3)), ("second", (2, 4))):
                direct = srv({k: v[lo:hi] for k, v in feats.items()})
                for k in direct:
                    np.testing.assert_array_equal(results[name][k], direct[k])
        finally:
            b.close()

    def test_validation_precedes_enqueue(self, srv):
        from mla_tpu_torch.runtime import serve

        feats = _feats(10)
        b = serve.Batcher(srv, wait_ms=1.0)
        try:
            with pytest.raises(ValueError, match="per-sample shape"):
                b.submit({**feats, "image": feats["image"][..., :5]})
            with pytest.raises(ValueError, match="rows, expected"):
                b.submit({**feats, "token": feats["token"][:1]})
            with pytest.raises(ValueError, match="largest exported rung"):
                b.submit({k: np.concatenate([v, v]) for k, v in feats.items()})
            assert b.stats["requests"] == 0
            got = b.submit({k: v[:1] for k, v in feats.items()})
            direct = srv({k: v[:1] for k, v in feats.items()})
            np.testing.assert_array_equal(got["fused"], direct["fused"])
        finally:
            b.close()

    def test_stress_every_request_gets_its_own_rows(self):
        """More submitting threads than cores, a short switch interval: no
        request is lost, mixed up with another, or counted twice."""
        import sys

        from mla_tpu_torch.runtime import serve

        class Echo:
            feature_names = ["x"]
            batch_sizes = [1, 4]

            def validate_request(self, feats):
                return int(np.asarray(feats["x"]).shape[0])

            def __call__(self, feats):
                return {"fused": np.asarray(feats["x"]) * 2.0}

        n_threads = 4 * (os.cpu_count() or 1) + 3
        b = serve.Batcher(Echo(), wait_ms=2.0)
        res, errs = {}, []

        def call(i):
            try:
                res[i] = b.submit({"x": np.full((1 + i % 2, 3), float(i))})
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            ts = [threading.Thread(target=call, args=(i,))
                  for i in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
            b.close()
        assert not errs and sorted(res) == list(range(n_threads))
        for i, out in res.items():
            np.testing.assert_array_equal(out["fused"],
                                          np.full((1 + i % 2, 3), 2.0 * i))
        assert b.stats["requests"] == n_threads
        assert b.stats["rows"] == sum(1 + i % 2 for i in range(n_threads))

    def test_close_resolves_stranded_futures(self):
        """close() leaves no queued request blocked on fut.result(): it
        drains queue and carry with a typed server-side error."""
        from mla_tpu_torch.runtime import serve

        class Stub:
            feature_names = ["x"]
            batch_sizes = [1]

            def __init__(self):
                self.go = threading.Event()

            def validate_request(self, feats):
                return int(np.asarray(feats["x"]).shape[0])

            def __call__(self, feats):
                self.go.wait(10)
                return {"fused": np.asarray(feats["x"])}

        stub = Stub()
        b = serve.Batcher(stub, wait_ms=20.0)
        res = {}

        def call(name):
            try:
                res[name] = b.submit({"x": np.ones((1, 2), np.float32)})
            except Exception as e:  # noqa: BLE001
                res[name] = e

        t1 = threading.Thread(target=call, args=("a",))
        t1.start()
        time.sleep(0.3)           # worker now blocked inside dispatch of 'a'
        t2 = threading.Thread(target=call, args=("b",))
        t2.start()
        time.sleep(0.2)           # 'b' sits in the queue (rung is 1 row)
        closer = threading.Thread(target=b.close)
        closer.start()
        time.sleep(0.1)
        stub.go.set()             # unblock the in-flight dispatch
        for t in (closer, t1, t2):
            t.join(timeout=15)
            assert not t.is_alive()
        assert isinstance(res["b"], serve.DispatchError)
        assert isinstance(res["a"], dict)
        with pytest.raises(serve.DispatchError, match="closed"):
            b.submit({"x": np.ones((1, 2), np.float32)})


def _post(base, rows):
    import urllib.request

    buf = io.BytesIO()
    np.savez(buf, **rows)
    req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return {k: z[k] for k in z.files}


def test_http_predict_meta_health_and_errors(srv):
    import http.client
    import urllib.request
    from urllib.error import HTTPError

    from mla_tpu_torch.runtime import serve

    httpd = serve.make_server(srv, port=0)   # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz") as r:
            assert json.loads(r.read())["ok"] is True
        with urllib.request.urlopen(f"{base}/meta") as r:
            meta = json.loads(r.read())
        assert meta["family"] == "M3AEClassifier" and "torch_version" in meta
        with urllib.request.urlopen(f"{base}/stats") as r:
            assert json.loads(r.read()) == {"coalesce_ms": 0.0}
        feats = _feats(11)
        got = _post(base, {k: v[:3] for k, v in feats.items()})
        direct = srv({k: v[:3] for k, v in feats.items()})
        np.testing.assert_array_equal(got["fused"], direct["fused"])
        bad = urllib.request.Request(f"{base}/predict", data=b"junk",
                                     method="POST")
        with pytest.raises(HTTPError) as ei:
            urllib.request.urlopen(bad)
        assert ei.value.code == 400
        with pytest.raises(HTTPError) as ei:
            _post(base, {"token": feats["token"]})   # missing features
        assert ei.value.code == 400
        c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1])
        c.putrequest("POST", "/predict")
        c.putheader("Content-Length", "abc")
        c.endheaders()
        assert c.getresponse().status == 400
        c.close()
        with urllib.request.urlopen(f"{base}/healthz") as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_http_coalescing_end_to_end(srv):
    import urllib.request

    from mla_tpu_torch.runtime import serve

    httpd = serve.make_server(srv, port=0, coalesce_ms=100.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    feats = _feats(12)
    try:
        outs = {}
        ts = [threading.Thread(target=lambda i=i: outs.update(
            {i: _post(base, {k: v[i:i + 1] for k, v in feats.items()})}))
            for i in range(3)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=30)
            assert not th.is_alive()
        assert set(outs) == {0, 1, 2}
        for i in range(3):
            assert outs[i]["fused"].shape == (1, 101)
        with urllib.request.urlopen(f"{base}/stats") as r:
            stats = json.loads(r.read())
        assert stats["coalesce_ms"] == 100.0 and stats["requests"] >= 3
        # oversized (5 rows > rung 4): bypasses the batcher, chunks
        big = {k: np.concatenate([v, v[:1]]) for k, v in feats.items()}
        assert _post(base, big)["fused"].shape == (5, 101)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        t.join(timeout=10)
