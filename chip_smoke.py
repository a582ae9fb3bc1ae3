"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

1. device  — the card's name and power limit (nvidia-smi), the device count;
             no card, no run.
2. build   — every CUDA source of the port compiled with nvcc for sm_90a;
             the ptxas report printed.
3. kernels — each kernel against its plain PyTorch version on the card at
             the shapes the serving path gives it (and a few edge shapes),
             with the tolerance stated; kernel, plain and one-library-call
             times from CUDA events; the least time the card could take.
4. serving — the port's main path at full width: the base M3AE classifier
             (Food-101, 101 classes, --gs_flag -dynamic, seeded weights) is
             exported with export_serving (ladder 1/8/64, float32 weights),
             loaded with load_serving (bf16 compute) and answers requests
             through run_batch (n = 1, 3, 64) and concurrent HTTP /predict
             with coalescing. Every launch counter is set to 0 just before
             and read just after; each dispatch must launch the attention
             kernel 24 times (12 blocks x 2 encoders). Logits are checked
             finite and held against the same artifact run on the CPU in
             float32 (plain attention there). After the counted run, one
             request at n=1 and one at n=64 run under torch.profiler:
             device time by kernel and the device's busy share.

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor cores
              torch.float32: 67e12}     # FP32 outside the tensor cores

# bf16: the probabilities round to bf16 at another point of the online
# softmax, and outputs round to bf16 (1 ulp = 2^-7 relative)
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 1e-2)}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 2

KERNEL_SOURCES = ("flat_attention",)


def phase_build():
    from mla_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = [_build.build(name) for name in KERNEL_SOURCES]
    secs = time.perf_counter() - t0
    print(f"[build] {len(libs)} CUDA source(s) built in {secs:.1f} s")
    for lib in libs:
        print(f"[build] ptxas report for {lib.name}:")
        print(lib.with_suffix(".log").read_text().strip())
    return secs


# ---------------------------------------------------------------- phase 3

def text_mask(rng, b, s):
    """CLS never masked; trailing text padding of random length."""
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        mask[i, 1 + rng.integers(0, s - 1):] = 1.0
    return mask


def attention_case(b, s, h, d, dtype, fully_masked_row=False, seed=0,
                   reps=20):
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flat_attention_reference)
    rng = np.random.default_rng(seed)
    c = h * d
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * c)).astype(
        np.float32)).to("cuda", dtype)
    mask_np = text_mask(rng, b, s)
    if fully_masked_row:
        mask_np[-1, :] = 1.0
    mask = torch.from_numpy(mask_np).cuda()
    got = flash_attention_flat(qkv, mask, h)
    torch.cuda.synchronize()
    want = flat_attention_reference(qkv, mask, h)
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= atol + rtol * want.float().abs()))
    if fully_masked_row:      # the mean of V over the S real keys
        v_mean = qkv[-1, :, 2 * c:].float().mean(dim=0)
        ok = ok and bool(torch.allclose(got[-1].float(),
                                        v_mean.expand(s, c),
                                        atol=atol, rtol=rtol))
    es = qkv.element_size()
    nbytes = b * s * 3 * c * es + b * s * 4 + b * s * c * es
    flops = 4 * b * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    q, k, v = (qkv[..., i * c:(i + 1) * c].view(b, s, h, d).transpose(1, 2)
               for i in range(3))
    bias = (mask * -1e7).to(dtype)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
           "fully_masked_row": fully_masked_row, "max_abs_err": err,
           "atol": atol, "rtol": rtol, "ok": ok,
           "ms": time_cuda(lambda: flash_attention_flat(qkv, mask, h), reps),
           "plain_ms": time_cuda(
               lambda: flat_attention_reference(qkv, mask, h), reps),
           # yardstick only: one library call on an equivalent additive
           # mask; the port never calls it
           "library_ms": time_cuda(lambda: sdpa(q, k, v, attn_mask=bias),
                                   reps),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("[kernel] flat_attention_fwd " + json.dumps(row), flush=True)
    return row


def phase_kernels():
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8, 64):                       # the serving rungs
            rows.append(attention_case(b, 257, 12, 64, dtype, seed=b))
        rows.append(attention_case(8, 257, 16, 80, dtype, seed=80))  # huge
        rows.append(attention_case(2, 9, 4, 16, dtype, True, seed=9))
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"flat attention kernel disagrees with its plain "
                   f"version: {bad}")
    return rows


# ---------------------------------------------------------------- phase 4

def request(rng, n, text_len=256, side=256):
    pm = text_mask(rng, n, text_len + 1)[:, 1:]
    return {"token": rng.integers(0, 30522, (n, text_len)).astype(np.int32),
            "padding_mask": pm,
            "image": rng.standard_normal((n, 3, side, side)).astype(
                np.float32)}


def post(base, rows):
    buf = io.BytesIO()
    np.savez(buf, **rows)
    req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        with np.load(io.BytesIO(r.read())) as z:
            return {k: z[k] for k in z.files}


def check_logits(out, n, where):
    for k in ("fused", "logits_a", "logits_v"):
        check(out[k].shape == (n, 101), f"{where}: {k} shape {out[k].shape}")
        check(bool(np.isfinite(out[k]).all()), f"{where}: {k} not finite")


def profile_request(srv, feats) -> dict:
    """One request under torch.profiler: device time by kernel name and the
    device's busy share of the request's wall time (the profiler's own
    host overhead is inside that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv(feats)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [{"name": k[:90], "ms": ms, "count": c}
                    for k, ms, c in kernels[:12]]}


def phase_serving(work: Path):
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.attention import flash_attention_flat
    from mla_tpu_torch.runtime.export import export_serving, load_serving
    from mla_tpu_torch.runtime.serve import make_server, run_batch

    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    dynamic=True, m3ae_size="base").validate()
    t0 = time.perf_counter()
    model = build_classifier(cfg, seed=0)
    art = export_serving(cfg, model, str(work / "m3ae_base"),
                         batch_sizes=(1, 8, 64), weights_dtype="float32")
    del model
    print(f"[serve] built + exported base M3AE in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    srv = load_serving(art)                       # cuda, bf16 compute
    check(srv.device.type == "cuda" and srv.compute_dtype == "bfloat16",
          "serving model not on the card in bf16")
    rng = np.random.default_rng(0)
    reqs = {n: request(rng, n) for n in (1, 3, 64)}
    per_dispatch = 2 * 12                         # 2 encoders x 12 blocks

    # -- the main path: counters 0 just before, read just after ----------
    flash_attention_flat.launches = 0
    dispatches = 0
    rungs = {}
    for n, feats in reqs.items():
        times = []
        for i in range(12):                       # 2 warm-up + 10 timed
            before = flash_attention_flat.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_batch(srv, feats)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            dispatches += 1
            check(flash_attention_flat.launches - before == per_dispatch,
                  f"n={n}: {flash_attention_flat.launches - before} kernel "
                  f"launches in one dispatch, expected {per_dispatch}")
            if i >= 2:
                times.append(dt)
        check_logits(out, n, f"run_batch n={n}")
        med = float(np.median(times)) * 1e3
        rungs[n] = {"rung": srv._rung(n), "median_ms": med,
                    "min_ms": float(np.min(times)) * 1e3,
                    "rows_per_s": n / med * 1e3, "reps": len(times)}
        print(f"[serve] n={n} (rung {srv._rung(n)}): median {med:.2f} ms, "
              f"{n / med * 1e3:.1f} rows/s", flush=True)

    httpd = make_server(srv, port=0, coalesce_ms=50.0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        sizes = (1, 2, 3, 1, 4, 2)
        outs = {}
        rows_of = {i: request(np.random.default_rng(100 + i), n)
                   for i, n in enumerate(sizes)}
        ts = [threading.Thread(target=lambda i=i: outs.update(
            {i: post(base, rows_of[i])})) for i in range(len(sizes))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
            check(not t.is_alive(), "HTTP request did not finish")
        check(sorted(outs) == list(range(len(sizes))), "HTTP requests lost")
        for i, n in enumerate(sizes):
            check_logits(outs[i], n, f"HTTP request {i}")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.close()
        th.join(timeout=30)
    dispatches += stats["dispatches"]
    launches = flash_attention_flat.launches
    # -- end of the main path ---------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    check(stats["requests"] == len(sizes), f"batcher stats {stats}")
    check(stats["coalesced_batches"] >= 1, f"no request coalesced: {stats}")
    check(launches == per_dispatch * dispatches,
          f"{launches} launches over {dispatches} dispatches")
    print(f"[serve] HTTP: {stats}; main path: {dispatches} dispatches, "
          f"{launches} attention launches; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    profiles = {n: profile_request(srv, reqs[n]) for n in (1, 64)}
    for n, p in profiles.items():
        print(f"[trace] n={n}: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_ms']:.2f} ms ({100 * p['busy_share']:.1f}%); top: "
              + json.dumps(p["top"][:6]), flush=True)

    # -- the same artifact on the CPU in float32 (plain attention) ---------
    two = {k: v[:2] for k, v in reqs[64].items()}
    gpu = srv(two)
    del srv
    torch.cuda.empty_cache()
    cpu = load_serving(art, device="cpu", compute_dtype="float32")(two)
    rel = {k: float(np.linalg.norm(gpu[k] - cpu[k]) / np.linalg.norm(cpu[k]))
           for k in cpu}
    print(f"[serve] bf16 card vs fp32 CPU, relative L2: {rel}")
    check(all(v <= 3e-2 for v in rel.values()),
          f"card logits drift from the CPU float32 reference: {rel}")
    return {"rungs": rungs, "http": stats, "dispatches": dispatches,
            "launches": launches, "peak_bytes": peak, "rel_l2_vs_cpu": rel,
            "profiles": profiles}


# ---------------------------------------------------------------- main

def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{kind} x{count}", flush=True)
    t_start = time.perf_counter()
    build_s = phase_build()
    rows = phase_kernels()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        serving = phase_serving(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    main_case = next(r for r in rows if r["shape"] == [64, 257, 12, 64]
                     and r["dtype"] == "bfloat16")
    kernels = [{"name": "flat_attention_fwd", "route": "cuda",
                "source": "mla_tpu_torch/ops/csrc/flat_attention.cu",
                "replaces": "mla_tpu/ops/attention.py:322",
                "launches": serving["launches"],
                "max_abs_err": main_case["max_abs_err"],
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"],
                "at": "B=64 S=257 H=12 D=64 bf16",
                # over every case of phase 3 (both dtypes, D=80, S=9)
                "max_abs_err_all": max(r["max_abs_err"] for r in rows),
                "all_ok": all(r["ok"] for r in rows)}]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "kernel_cases": rows, "serving": serving,
        "seconds": time.perf_counter() - t_start}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
