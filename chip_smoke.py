"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

1. device   — the card's name and power limit (nvidia-smi), the device count;
              no card, no run.
2. build    — every CUDA source of the port compiled with nvcc for sm_90a,
              one nvcc per source, all started together; the ptxas reports
              printed; the tensor-core instructions (HMMA / IMMA for
              mma.sync, HGMMA / IGMMA for wgmma) of each attention forward,
              attention backward, int8 GEMM and 3x3 conv kernel function
              counted in cuobjdump -sass: every bf16 attention one
              (mma_fwd_*, mma_bwd_*) must have some, every int8 GEMM one
              wgmma of its kind (HGMMA weight-only, IGMMA W8A8) and every
              bf16 conv one (conv3x3_wgmma_kernel<...>) HGMMA and no HMMA,
              printed with its ptxas registers and spills.
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes the serving and training paths give it (and a few
              edge shapes), with the tolerance stated; kernel, plain and
              library times from CUDA events; the least time the card could
              take. Every attention row (B1f, B1b, B2f, B2b) also says
              whether a second call repeats the first bit for bit (it
              must); the backward rows give their TFLOP/s on the five
              products the bound counts. The 3x3
              conv (B3) at the 8 CREMA-D ResNet-18 body shapes
              in bf16 and fp32 and one odd edge, each called twice for
              bitwise equality, with its TFLOP/s and its kernel's device
              time alone (device_ms, torch.profiler; ms includes the
              weight packing and the host; cuDNN's device time beside
              its library_ms), and its dx through the
              Conv3x3 autograd Function against the plain version's
              autograd.
4. serving  — the port's serving path at full width: the base M3AE
              classifier (Food-101, 101 classes, --gs_flag -dynamic, seeded
              weights) is exported with export_serving (ladder 1/8/64,
              float32 weights), loaded with load_serving (bf16 compute) and
              answers requests through run_batch (n = 1, 3, 64) and
              concurrent HTTP /predict with coalescing. Every launch counter
              is set to 0 just before and read just after; each dispatch
              must launch the attention kernel 24 times (12 blocks x 2
              encoders). Logits are checked finite and held against the same
              artifact run on the CPU in float32 (plain attention there).
              One request at n=1 and one at n=64 then run under
              torch.profiler: device time by kernel and the busy share.
5. training — the port's training path at full width: the same classifier
              (seeded, float32 master weights, bf16 compute) takes 2 warm-up
              and 5 timed MLA steps at B=64 through create_train_state /
              make_spec / make_train_step; every counter is set to 0 just
              before and read just after, and each step must launch the
              forward and the backward kernel 24 times each (12 blocks x 2
              sub-steps). Then one eval batch through make_eval_step, one
              joint step and one QMF step at a small batch, every loss and
              parameter checked finite. Then one profiled MLA step, and one
              MLA step at B=2 in float32 on the card against the same step
              on the CPU (plain versions there) from the same weights.
6. AV serving — the CREMA-D AVClassifier (2x ResNet-18, 6 classes, spec
              (1, 129, 626), 3 frames of 224x224, --gs_flag -dynamic,
              --pallas_conv on, seeded weights) through export_serving ->
              load_serving -> run_batch at n = 1, 3, 64: 26 B3 launches per
              dispatch (13 per ResNet), finite logits, running statistics
              unchanged, bf16 on the card against fp32 on the CPU; one n=64
              request profiled.
7. AV training — the same classifier, float32 master weights, bf16 compute,
              --pallas_conv on: 2 warm-up and 5 timed MLA steps at B=64
              (52 B3 launches per step: 13 forward + 13 dx in each
              sub-step), then the same steps of a --pallas_conv off model
              (cuDNN, no launch) as the step-level yardstick; an eval batch
              (26 launches, running statistics unchanged), a joint OGM_GE
              and a QMF step at B=8 (52 each), a profiled step, and an fp32
              MLA step at B=2 on the card against the CPU (parameters,
              momentum, losses and BatchNorm running statistics).

8. int8 serving — the base M3AE classifier of phase 4 (same seeded weights)
              exported three more ways: --export_dtype int8 (unrolled),
              int8 --scan_blocks and int8_a8 --scan_blocks (calibrated on an
              example batch), plus a bfloat16 artifact as the yardstick. Each
              serves n = 1, 3, 64 through run_batch and one HTTP request;
              per dispatch B4 runs 97 times unrolled (4 sites x 12 blocks x
              2 encoders + the image projection), and in the stacked layout
              B4 once, B5 48 times and B6 24 times (a skipped W8A8 MLP site
              turns the 24 B6 launches into 48 more B5), B1f 24 times.
              Fused logits against the bf16 artifact's, the card against
              the CPU (plain versions, bf16 compute) on one n=3 request,
              latency, rows/s, peak memory, artifact bytes against fp32,
              beside the bf16 artifact's latency at the same sizes.

9. head-layout training — phase 5's classifier (same seeded weights) with
              the flat attention kernels off for the whole phase
              (set_flat_attention(False), restored after), as the JAX
              driver runs a mesh with a model axis: 2 warm-up and 5 timed
              MLA steps at B=64, bf16 compute, each launching B2f and B2b 24
              times and B1f/B1b never; one eval batch (24 B2f); a profiled
              step; one step from the same weights and batch through each
              route, losses and parameters compared; an fp32 MLA step at
              B=2 on the card against the CPU, with phase 5's limits.
10. ln_dense — the fused LayerNorm -> Dense op through its entry point at
              the M3AE block's two sites (norm1 -> qkv 768 -> 2304, norm2 ->
              fc1 768 -> 3072) on 16448 bf16 token rows with fp32
              parameters, forward and backward through autograd: switch on,
              one B7f launch a forward and one B7b call a backward; switch
              off, no launch and the LayerNorm and Dense composition's
              result.

Phase 3 also holds the int8 kernels against their plain versions: B4 and
B5 (weight-only and W8A8) at the four block sites of the base width (qkv
768x2304, proj 768x768, fc1 768x3072, fc2 3072x768) and the image
projection, at 257 and 16448 rows (rungs 1 and 64); B5 at layers 0, 11 and
an out-of-range id (= 11); B6 at 257 and 16448 rows with the chooser's
W8A8 group width; each a second time for bitwise equality. Their ms is
the mean of one batch of CUDA-event timings, as every other row's;
ms_median the median of five such batches (rung 1 is host-bound, and
a batch reads the host's spread), device_ms the card's time per call
with the host's enqueue hidden behind a spin kernel; a W8A8 row's ms
includes its row quantization, also timed alone (quantize_ms), and every
row gives its TOPS. It holds the head-layout attention pair B2f/B2b at the
training shape (B=64, S=257, H=12, D=64) in bf16 and fp32, at D=80, at S=9
with a fully masked row and at S=1360 (B=2, H=12), and B7f/B7b at both
block sites, at 257 and 16448 rows and at 1000 (off the kernels' tiles),
in bf16 and fp32, B7b run twice for bitwise equality.

Each path's launch counters are set to 0 just before it runs and read just
after. The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor cores
              torch.float32: 67e12,     # FP32 outside the tensor cores
              torch.int8: 1979e12}      # dense int8 tensor cores (ops/s)

# bf16: the probabilities round to bf16 at another point of the online
# softmax, and outputs round to bf16 (1 ulp = 2^-7 relative)
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 1e-2)}
# the backward's: bf16 as the forward's (a ds near a rounding boundary may
# round the other way, moving its products by about one bf16 ulp); fp32
# gains rtol 1e-5 because its gradients reach |x| ~ 10, where 1e-5 is a few
# fp32 ulps of sums over 257 keys taken in another order
TOL_BWD = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# the 3x3 conv: fp32 products are exact and sums over 9*C <= 4608 terms run
# in another order than cuDNN's (|y| ~ 1: a few 1e-6); bf16 outputs round
# once from fp32 sums, so a sum near a rounding boundary differs by one
# bf16 ulp (2^-8 relative)
TOL_CONV = {torch.float32: (5e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


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

KERNEL_SOURCES = ("flat_attention", "flat_attention_bwd", "conv3x3",
                  "q8_matmul", "q8_mlp", "ln_dense")


def phase_build():
    """-> (build seconds, the attention libraries' tensor-core instruction
    counts and ptxas reports by kernel function, forward and backward, the
    int8 libraries' and the conv library's counts and ptxas reports by
    kernel function)."""
    from mla_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:   # nvcc each
        libs = list(pool.map(_build.build, KERNEL_SOURCES))
    secs = time.perf_counter() - t0
    print(f"[build] {len(libs)} CUDA source(s) built in {secs:.1f} s")
    for lib in libs:
        print(f"[build] ptxas report for {lib.name}:")
        print(lib.with_suffix(".log").read_text().strip())
    sass = {}
    for name, kind, n_bf16 in (("flat_attention", "forward", 3),
                               ("flat_attention_bwd", "backward", 2 * 3)):
        lib = libs[KERNEL_SOURCES.index(name)]
        counts = sass_mma_counts(lib, attention_function)
        reports = ptxas_reports(lib.with_suffix(".log"), attention_function)
        sass[kind] = {f: {**counts.get(f, {}), **reports.get(f, {})}
                      for f in sorted(set(counts) | set(reports))}
        print(f"[build] tensor-core instructions (cuobjdump -sass) and the "
              f"ptxas report per attention {kind} kernel function: "
              + json.dumps(sass[kind]), flush=True)
        # the bf16 kernels (mma_*) must run their products on the tensor
        # cores; the fp32 ones (fma_*) stay on the FMA pipes
        bf16 = {k: v for k, v in sass[kind].items() if k.startswith("mma_")}
        check(len(bf16) == n_bf16 and all(
            v.get("HMMA", 0) + v.get("HGMMA", 0) > 0 for v in bf16.values()),
              f"a bf16 attention {kind} kernel has no tensor-core "
              f"instruction: {sass[kind]}")
    q8 = {}
    for name in ("q8_matmul", "q8_mlp"):
        lib = libs[KERNEL_SOURCES.index(name)]
        counts = sass_mma_counts(lib, q8_function)
        reports = ptxas_reports(lib.with_suffix(".log"), q8_function)
        q8[name] = {f: {**counts.get(f, {}), **reports.get(f, {})}
                    for f in sorted(set(counts) | set(reports))}
        print(f"[build] {name}: wgmma (HGMMA bf16, IGMMA int8) and mma.sync "
              f"(HMMA, IMMA) instructions and the ptxas report per int8 "
              f"kernel function: " + json.dumps(q8[name]), flush=True)
    # each int8 GEMM runs wgmma: bf16 (weight-only) HGMMA, int8 IGMMA
    bad = {f: v for lib_ in q8.values() for f, v in lib_.items()
           if v.get("IGMMA" if "A_BF16" not in f else "HGMMA", 0) == 0}
    check(len(q8["q8_matmul"]) == 6 and len(q8["q8_mlp"]) == 11 and not bad,
          f"an int8 GEMM kernel function has no wgmma instruction of its "
          f"kind: {bad or q8}")
    lib = libs[KERNEL_SOURCES.index("conv3x3")]
    counts = sass_mma_counts(lib, conv_function)
    reports = ptxas_reports(lib.with_suffix(".log"), conv_function)
    conv = {f: {**counts.get(f, {}), **reports.get(f, {})}
            for f in sorted(set(counts) | set(reports))}
    print("[build] conv3x3: wgmma (HGMMA) and mma.sync (HMMA) instructions "
          "and the ptxas report per conv kernel function: "
          + json.dumps(conv), flush=True)
    # every bf16 conv kernel (one per tile shape) runs wgmma; the fp32 one
    # stays on the FMA pipes
    bf16 = {k: v for k, v in conv.items() if k.startswith("conv3x3_wgmma")}
    check(len(bf16) == len(CONV_TILES) and all(
        v.get("HGMMA", 0) > 0 and v.get("HMMA", 0) == 0
        for v in bf16.values()),
          f"a bf16 conv kernel function has no wgmma instruction (or an "
          f"mma.sync one): {conv}")
    return secs, sass, q8, conv


def attention_function(mangled: str):
    """'mma_fwd_kernel<64>' or 'mma_bwd_dq_kernel<64>' for an attention
    kernel function's mangled name, else None."""
    import re
    m = re.search(r"((?:mma|fma)_(?:fwd|bwd_[a-z]+)_kernel)I((?:Li\d+E)+)E",
                  mangled)
    if m is None:
        return None
    return f"{m[1]}<{', '.join(re.findall(r'Li(\d+)E', m[2]))}>"


Q8_KINDS = ("A_BF16", "A_S8", "A_S8G")       # csrc/q8_gemm.cuh AKind


def q8_function(mangled: str):
    """'gemm_kernel<A_S8, 256, EpiA8>' for an int8 GEMM kernel function's
    mangled name, else None."""
    import re
    m = re.search(r"gemm_kernelILi(\d)ELi(\d+)E.*?\d(Epi[A-Za-z0-9]+?)E",
                  mangled)
    if m is None:
        return None
    return f"gemm_kernel<{Q8_KINDS[int(m[1])]}, {m[2]}, {m[3]}>"


# csrc/conv3x3.cu's bf16 kernel instantiations: (pixels a warpgroup, filter
# groups of 64 a tile)
CONV_TILES = ((128, 2), (256, 2), (128, 1))


def conv_function(mangled: str):
    """'conv3x3_wgmma_kernel<128, 1>' or 'conv3x3_f32_kernel' for a conv
    kernel function's mangled name, else None."""
    import re
    m = re.search(r"conv3x3_wgmma_kernelILi(\d+)ELi(\d)E", mangled)
    if m:
        return f"conv3x3_wgmma_kernel<{m[1]}, {m[2]}>"
    return "conv3x3_f32_kernel" if "conv3x3_f32_kernel" in mangled else None


def sass_mma_counts(lib: Path, name_of) -> dict:
    """Tensor-core instructions, HMMA / IMMA (mma.sync) and HGMMA / IGMMA
    (wgmma), in each kernel function of a built library that ``name_of``
    names, by the toolkit's cuobjdump -sass."""
    from mla_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    check(tool.exists(), f"cuobjdump not found beside nvcc: {tool}")
    out = subprocess.run([str(tool), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = name_of(line)
            cur = None if name is None else counts.setdefault(
                name, {op: 0 for op in ("HMMA", "HGMMA", "IMMA", "IGMMA")})
        elif cur is not None:
            for op in cur:
                cur[op] += f" {op}." in line or f" {op} " in line
    return counts


def ptxas_reports(log: Path, name_of) -> dict:
    """Registers, spill bytes, stack frame and static shared memory of each
    kernel function ``name_of`` names, from a build's ptxas -v report."""
    import re
    out, cur = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = name_of(m[1])
            cur = None if name is None else out.setdefault(name, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm[1]) if sm else 0
    return out


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
    # no atomics: a second call gives the same bits
    repeat_bitwise = torch.equal(got, flash_attention_flat(qkv, mask, h))
    want = flat_attention_reference(qkv, mask, h)
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = repeat_bitwise and bool(
        torch.all(diff <= atol + rtol * want.float().abs()))
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
           "atol": atol, "rtol": rtol, "repeat_bitwise": repeat_bitwise,
           "ok": ok,
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


def attention_bwd_case(b, s, h, d, dtype, fully_masked_row=False, seed=0,
                       reps=10):
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flash_attention_flat_bwd,
                                             flat_attention_bwd_reference)
    rng = np.random.default_rng(seed)
    c = h * d
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * c)).astype(
        np.float32)).to("cuda", dtype)
    do = torch.from_numpy(rng.standard_normal((b, s, c)).astype(
        np.float32)).to("cuda", dtype)
    mask_np = text_mask(rng, b, s)
    if fully_masked_row:
        mask_np[-1, :] = 1.0
    mask = torch.from_numpy(mask_np).cuda()
    got = flash_attention_flat_bwd(qkv, do, mask, h)
    torch.cuda.synchronize()
    # no atomics: a second call gives the same bits
    repeat_bitwise = torch.equal(got, flash_attention_flat_bwd(qkv, do, mask,
                                                               h))
    want = flat_attention_bwd_reference(qkv, do, mask, h)
    atol, rtol = TOL_BWD[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = repeat_bitwise and bool(
        torch.all(diff <= atol + rtol * want.float().abs()))
    if fully_masked_row:      # P = 1/S: dq = dk = 0, dv = mean of dO
        dv = do[-1].float().mean(dim=0)
        ok = ok and bool(torch.all(got[-1, :, :2 * c] == 0)) and bool(
            torch.allclose(got[-1, :, 2 * c:].float(), dv.expand(s, c),
                           atol=atol, rtol=rtol))
    es = qkv.element_size()
    # qkv and dO read once, the mask read once, d(qkv) written once
    nbytes = 2 * b * s * 3 * c * es + b * s * c * es + b * s * 4
    # recomputed scores, dp, dq, dk, dv: five (S, S, D) products per head
    flops = 10 * b * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    q, k, v = (qkv[..., i * c:(i + 1) * c].view(b, s, h, d).transpose(1, 2)
               for i in range(3))
    g = do.view(b, s, h, d).transpose(1, 2)
    bias = (mask * -1e7).to(dtype)[:, None, None, :]

    library_ms, library_fwd_bwd_ms, library_device_ms = time_sdpa_bwd(
        q, k, v, g, bias, reps)
    row = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
           "fully_masked_row": fully_masked_row, "max_abs_err": err,
           "atol": atol, "rtol": rtol, "repeat_bitwise": repeat_bitwise,
           "ok": ok,
           "ms": time_cuda(lambda: flash_attention_flat_bwd(qkv, do, mask, h),
                           reps),
           "plain_ms": time_cuda(
               lambda: flat_attention_bwd_reference(qkv, do, mask, h), reps),
           "fwd_ms": time_cuda(lambda: flash_attention_flat(qkv, mask, h),
                               reps),
           "library_ms": library_ms, "library_fwd_bwd_ms": library_fwd_bwd_ms,
           "library_device_ms": library_device_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    row["fwd_plus_bwd_ms"] = row["fwd_ms"] + row["ms"]
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    print("[kernel] flat_attention_bwd " + json.dumps(row), flush=True)
    return row


def time_sdpa_bwd(q, k, v, g, bias, reps):
    """Yardstick only, never called by the port: SDPA's backward alone (one
    autograd backward through a kept graph) and its forward + backward, on
    an equivalent additive mask; and the backward's device time per call
    (its kernels under torch.profiler), which the host's enqueue of the
    autograd backward cannot inflate. -> (backward ms, forward + backward
    ms, backward device ms)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(q, k, v, attn_mask=bias)

    def bwd_call():
        return torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

    bwd = time_cuda(bwd_call, reps)
    both = time_cuda(lambda: torch.autograd.grad(
        sdpa(q, k, v, attn_mask=bias), (q, k, v), g), reps)
    device = profile_call(lambda: [bwd_call() for _ in range(reps)])
    return bwd, both, device["device_ms"] / reps


def head_inputs(b, s, h, d, dtype, fully_masked_row, seed):
    """q, k, v, dO (B, H, S, D) and a text-style (B, S) mask on the card."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to("cuda", dtype) for _ in range(4))
    mask_np = text_mask(rng, b, s)
    if fully_masked_row:
        mask_np[-1, :] = 1.0
    return q, k, v, do, torch.from_numpy(mask_np).cuda()


def head_attention_case(b, s, h, d, dtype, fully_masked_row=False, seed=0,
                        reps=20):
    """B2f against attention_reference; SDPA as the library yardstick."""
    from mla_tpu_torch.ops.attention import (attention_reference,
                                             flash_attention)
    q, k, v, _, mask = head_inputs(b, s, h, d, dtype, fully_masked_row, seed)
    got = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    # no atomics: a second call gives the same bits
    repeat_bitwise = torch.equal(got, flash_attention(q, k, v, mask))
    want = attention_reference(q, k, v, mask)
    atol, rtol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    ok = repeat_bitwise and bool(
        torch.all(diff <= atol + rtol * want.float().abs()))
    if fully_masked_row:      # the mean of V over the S real keys
        ok = ok and bool(torch.allclose(
            got[-1].float(), v[-1].float().mean(dim=1, keepdim=True)
            .expand(h, s, d), atol=atol, rtol=rtol))
    es = q.element_size()
    bias = (mask * -1e7).to(dtype)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
           "fully_masked_row": fully_masked_row,
           "max_abs_err": float(diff.max()), "atol": atol, "rtol": rtol,
           "repeat_bitwise": repeat_bitwise, "ok": ok,
           "ms": time_cuda(lambda: flash_attention(q, k, v, mask), reps),
           "plain_ms": time_cuda(
               lambda: attention_reference(q, k, v, mask), reps),
           # yardstick only: one library call; the port never calls it
           "library_ms": time_cuda(lambda: sdpa(q, k, v, attn_mask=bias),
                                   reps),
           # q, k, v read once, the mask read once, the output written once
           **bound(4 * b * h * s * d * es + b * s * 4, 4 * b * h * s * s * d,
                   PEAK_FLOPS[dtype])}
    print("[kernel] head_attention " + json.dumps(row), flush=True)
    return row


def head_attention_bwd_case(b, s, h, d, dtype, fully_masked_row=False,
                            seed=0, reps=10):
    """B2b against attention_bwd_reference; SDPA's backward (and forward +
    backward, beside B2f + B2b) as the library yardstick."""
    from mla_tpu_torch.ops.attention import (attention_bwd_reference,
                                             flash_attention,
                                             flash_attention_bwd)
    q, k, v, do, mask = head_inputs(b, s, h, d, dtype, fully_masked_row,
                                    seed)
    got = flash_attention_bwd(q, k, v, do, mask)
    torch.cuda.synchronize()
    # no atomics: a second call gives the same bits
    repeat_bitwise = all(torch.equal(x, y) for x, y in zip(
        got, flash_attention_bwd(q, k, v, do, mask)))
    want = attention_bwd_reference(q, k, v, do, mask)
    atol, rtol = TOL_BWD[dtype]
    diffs = [(gt.float() - w.float()).abs() for gt, w in zip(got, want)]
    ok = repeat_bitwise and all(
        bool(torch.all(df <= atol + rtol * w.float().abs()))
        for df, w in zip(diffs, want))
    if fully_masked_row:      # P = 1/S: dq = dk = 0, dv = mean of dO
        ok = ok and bool(torch.all(got[0][-1] == 0)) and bool(
            torch.all(got[1][-1] == 0)) and bool(torch.allclose(
                got[2][-1].float(), do[-1].float().mean(dim=1, keepdim=True)
                .expand(h, s, d), atol=atol, rtol=rtol))
    es = q.element_size()
    bias = (mask * -1e7).to(dtype)[:, None, None, :]
    library_ms, library_fwd_bwd_ms, library_device_ms = time_sdpa_bwd(
        q, k, v, do, bias, reps)
    row = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
           "fully_masked_row": fully_masked_row,
           "max_abs_err": max(float(df.max()) for df in diffs),
           "atol": atol, "rtol": rtol, "repeat_bitwise": repeat_bitwise,
           "ok": ok,
           "ms": time_cuda(lambda: flash_attention_bwd(q, k, v, do, mask),
                           reps),
           "plain_ms": time_cuda(
               lambda: attention_bwd_reference(q, k, v, do, mask), reps),
           "fwd_ms": time_cuda(lambda: flash_attention(q, k, v, mask), reps),
           "library_ms": library_ms, "library_fwd_bwd_ms": library_fwd_bwd_ms,
           "library_device_ms": library_device_ms,
           # q, k, v, dO and the mask read once, dq, dk, dv written once;
           # five (S, S, D) products per head (scores, dp, dq, dk, dv)
           **bound(7 * b * h * s * d * es + b * s * 4, 10 * b * h * s * s * d,
                   PEAK_FLOPS[dtype])}
    row["fwd_plus_bwd_ms"] = row["fwd_ms"] + row["ms"]
    # on the five products the bound counts
    row["tflops"] = 10 * b * h * s * s * d / (row["ms"] * 1e-3) / 1e12
    print("[kernel] head_attention_bwd " + json.dumps(row), flush=True)
    return row


def phase_kernels():
    rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for case, out in ((attention_case, rows),
                          (attention_bwd_case, bwd_rows)):
            for b in (1, 8, 64):           # the serving rungs; 64 trains
                out.append(case(b, 257, 12, 64, dtype, seed=b))
            out.append(case(8, 257, 16, 80, dtype, seed=80))   # huge
            out.append(case(2, 9, 4, 16, dtype, True, seed=9))
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"flat attention kernel disagrees with its plain "
                   f"version: {bad}")
    bad = [r for r in bwd_rows if not r["ok"]]
    check(not bad, f"flat attention backward kernel disagrees with its "
                   f"plain version: {bad}")
    return rows, bwd_rows


def phase_head_kernels():
    """B2f and B2b at the training shape (bf16, fp32), the huge width's
    D = 80, S = 9 with a fully masked row, and S = 1360, where the JAX
    package on a TPU would take its q-blockwise kernel and its XLA
    backward."""
    rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for case, out in ((head_attention_case, rows),
                          (head_attention_bwd_case, bwd_rows)):
            out.append(case(64, 257, 12, 64, dtype, seed=64))
            out.append(case(8, 257, 16, 80, dtype, seed=80))
            out.append(case(2, 9, 4, 16, dtype, True, seed=9))
            out.append(case(2, 1360, 12, 64, dtype, seed=1360))
    bad = [r for r in rows + bwd_rows if not r["ok"]]
    check(not bad, f"head attention kernels disagree with their plain "
                   f"versions: {bad}")
    return rows, bwd_rows


# the stride-1 3x3 sites of the CREMA-D ResNet-18s at B = 64 clips (3 frames
# each): (B, H, W, C) as benchmarks/bench_conv.py names them, then the audio
# branch's odd edges (129 x 626 spectrograms)
CONV_SHAPES = {"vis_l1": (192, 56, 56, 64), "vis_l2": (192, 28, 28, 128),
               "vis_l3": (192, 14, 14, 256), "vis_l4": (192, 7, 7, 512),
               "aud_l1": (64, 33, 157, 64), "aud_l2": (64, 17, 79, 128),
               "aud_l3": (64, 9, 40, 256), "aud_l4": (64, 5, 20, 512)}


def conv_case(name, b, h, w, c, dtype, seed=0, reps=20):
    from mla_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_reference,
                                           pack_weight)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32)).to("cuda", dtype).contiguous(
            memory_format=torch.channels_last)
    wt = torch.from_numpy((rng.standard_normal((c, c, 3, 3))
                           / np.sqrt(9 * c)).astype(np.float32)).to(
                               "cuda", dtype)
    got = conv3x3(x, wt)
    torch.cuda.synchronize()
    # no atomics, no split sums: a second call gives the same bits
    repeat_bitwise = torch.equal(got, conv3x3(x, wt))
    want = conv3x3_reference(x, wt).float()
    atol, rtol = TOL_CONV[dtype]
    diff = (got.float() - want).abs()
    es = x.element_size()
    # x read once, the packed weight read once, the output written once
    nbytes = 2 * x.numel() * es + pack_weight(wt, dtype).numel() * es
    flops = 2 * b * h * w * 9 * c * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    conv2d = torch.nn.functional.conv2d
    row = {"name": name, "shape": [b, h, w, c],
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float(diff.max()), "atol": atol, "rtol": rtol,
           "repeat_bitwise": repeat_bitwise,
           "ok": repeat_bitwise and bool(
               torch.all(diff <= atol + rtol * want.abs())),
           "ms": time_cuda(lambda: conv3x3(x, wt), reps),
           "device_ms": kernel_device_ms(lambda: conv3x3(x, wt),
                                         "conv3x3_"),
           "plain_ms": time_cuda(lambda: conv3x3_reference(x, wt), reps),
           # yardstick only: one cuDNN call on the same channels_last
           # operands; the port never calls it in B3's place
           "library_ms": time_cuda(lambda: conv2d(x, wt, padding=1), reps),
           "library_device_ms": kernel_device_ms(
               lambda: conv2d(x, wt, padding=1)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "gflop": flops / 1e9}
    row["tflops"] = flops / row["ms"] / 1e9
    print("[kernel] conv3x3 " + json.dumps(row), flush=True)
    return row


def kernel_device_ms(fn, name: str = "", calls: int = 10) -> float:
    """The device time per call of the kernels whose name holds ``name``
    (every kernel by default), over ``calls`` calls of fn under
    torch.profiler: the kernels' own time, without the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key
               ) / 1e3 / calls


def conv_dx_case(name, b, h, w, c, dtype, seed=0):
    """dx (B3 on the rotated weight) and dw (PyTorch's weight-gradient)
    through Conv3x3 against the plain version's autograd, same inputs."""
    from mla_tpu_torch.ops.conv3x3 import Conv3x3, conv3x3_reference
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32)).to("cuda", dtype).contiguous(
            memory_format=torch.channels_last).requires_grad_()
    wt = torch.from_numpy((rng.standard_normal((c, c, 3, 3))
                           / np.sqrt(9 * c)).astype(np.float32)).to(
                               "cuda", dtype).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32)).to("cuda", dtype).contiguous(
            memory_format=torch.channels_last)
    got = torch.autograd.grad(Conv3x3.apply(x, wt), (x, wt), g)
    want = torch.autograd.grad(conv3x3_reference(x, wt), (x, wt), g)
    torch.cuda.synchronize()
    atol, rtol = TOL_CONV[dtype]
    dx_diff = (got[0].float() - want[0].float()).abs()
    # dw is PyTorch's conv weight-gradient on both sides (cuDNN may pick
    # another algorithm for a dw-only call: 1e-5 in fp32, about one bf16
    # ulp, 2^-8, in bf16)
    rel_dw = float(torch.linalg.norm(got[1].float() - want[1].float())
                   / torch.linalg.norm(want[1].float()))
    dw_tol = 1e-5 if dtype == torch.float32 else 1e-2
    row = {"name": name, "shape": [b, h, w, c],
           "dtype": str(dtype).replace("torch.", ""),
           "dx_max_abs_err": float(dx_diff.max()), "dw_rel_l2": rel_dw,
           "ok": bool(torch.all(dx_diff <= atol + rtol
                                * want[0].float().abs())) and rel_dw <= dw_tol}
    print("[kernel] conv3x3 dx " + json.dumps(row), flush=True)
    return row


def phase_conv_kernels():
    rows, dx_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, shape) in enumerate(CONV_SHAPES.items()):
            rows.append(conv_case(name, *shape, dtype, seed=i))
        rows.append(conv_case("odd_edge", 3, 1, 3, 128, dtype, seed=99))
        dx_rows.append(conv_dx_case("vis_l1", *CONV_SHAPES["vis_l1"], dtype))
        dx_rows.append(conv_dx_case("aud_l4", *CONV_SHAPES["aud_l4"], dtype))
    bad = [r for r in rows + dx_rows if not r["ok"]]
    check(not bad, f"conv3x3 kernel disagrees with its plain version: {bad}")
    return rows, dx_rows


# the int8 kernels: B4 and B5 at the base block sites (K, N) and the image
# projection, at rungs 1 and 64 of the base M3AE (B x 257 token rows)
Q8_SITES = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072),
            "fc2": (3072, 768), "image": (768, 768)}
Q8_ROWS = (257, 16448)
# one bf16 ulp of the larger output (2^-7 relative): weight-only sums of
# exact products in fp32 in another order may round the other way, plus an
# absolute 3e-5 for the tensor cores' fp32 accumulation, which truncates at
# each 16-deep mma step (measured 1.4e-6 on outputs of |y| ~ 1e-5 that
# cancel at K = 3072); W8A8 sums are exact int32 on both sides; B6's
# weight-only hidden is bf16 and may round the other way (absolute 1e-3)
ULP = 2.0 ** -7
Q8_ATOL = {False: 3e-5, True: 1e-6}     # by a8


def q8_weight(rng, *shape):
    """An int8 (..., N, K) weight and its fp32 (..., N) scales, per output
    channel as runtime/export.py:quantize_int8 makes them."""
    w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[-1])
    amax = np.abs(w).max(axis=-1, keepdims=True)
    sc = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
    return torch.from_numpy(q).cuda(), torch.from_numpy(sc[..., 0]).cuda()


def ulp_err(got, want, atol, rtol=ULP):
    """(max |got - want|, whether each is within atol + rtol of the larger
    of the two; by default one bf16 ulp)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())
    return float(diff.max()), bool(torch.all(diff <= atol + rtol * big))


def bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_median(fn, reps: int, batches: int = 5) -> float:
    """The median over `batches` of time_cuda's mean ms per call, beside a
    row's ms: the int8 rows at rung 1 are host-bound, and one batch of them
    reads the host's spread as much as the kernel."""
    return float(np.median([time_cuda(fn, reps) for _ in range(batches)]))


def device_ms(fn, calls: int = 20) -> float:
    """The card's time per call of fn with the host's enqueue hidden: the
    stream first spins for about 10 ms while the host enqueues the calls,
    and the events time the calls back to back. What an int8 row costs
    the card when its ms is the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)          # GPU clock cycles
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def q8_gemm_case(site, m, a8, stacked, seed, reps=20):
    """B4 (or B5 on a 12-layer stack, at layers 0, 11 and 99 = 11) against
    the plain version, and a second call bit for bit the first; times of the
    kernel (W8A8: with its row quantization, and that alone as
    quantize_ms), the plain version and a library call (weight-only:
    dequantize + torch.matmul; W8A8: torch._int_mm, without the
    quantization)."""
    from mla_tpu_torch.ops.q8_matmul import (q8_matmul, q8_matmul_plain,
                                             q8_matmul_stacked,
                                             quantize_rows,
                                             quantize_rows_cuda)
    k, n = Q8_SITES[site]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    w, sc = q8_weight(rng, *((12, n, k) if stacked else (n, k)))
    if stacked:
        ids = {i: torch.tensor(i, dtype=torch.int32, device="cuda")
               for i in (0, 11, 99)}
        errs = []
        for i, li in ((0, 0), (11, 11), (99, 11)):
            got = q8_matmul_stacked(x, w, sc, ids[i], a8)
            torch.cuda.synchronize()
            errs.append(ulp_err(got, q8_matmul_plain(x, w[li], sc[li], a8),
                                Q8_ATOL[a8]))
        w11, s11 = w[11], sc[11]
        kernel = lambda: q8_matmul_stacked(x, w, sc, ids[11], a8)  # noqa: E731
    else:
        got = q8_matmul(x, w, sc, a8)
        torch.cuda.synchronize()
        errs = [ulp_err(got, q8_matmul_plain(x, w, sc, a8), Q8_ATOL[a8])]
        w11, s11 = w, sc
        kernel = lambda: q8_matmul(x, w, sc, a8)  # noqa: E731
    same = bool(torch.equal(kernel(), kernel()))
    if a8:
        xq, _ = quantize_rows(x)
        wt = w11.t()
        library = lambda: torch._int_mm(xq, wt)  # noqa: E731
    else:
        library = lambda: x @ (w11.to(torch.bfloat16)  # noqa: E731
                               * s11.to(torch.bfloat16)[:, None]).t()
    try:
        lib_ms = time_cuda(library, reps)
    except RuntimeError as e:        # a yardstick only: record, go on
        lib_ms, lib_err = None, str(e)[:120]
    else:
        lib_err = None
    row = {"site": site, "rows": m, "k": k, "n": n, "a8": a8,
           "stacked": stacked, "max_abs_err": max(e[0] for e in errs),
           "repeat_bitwise": same, "ok": all(e[1] for e in errs) and same,
           "ms": time_cuda(kernel, reps), "ms_median": time_median(kernel, reps),
           "device_ms": device_ms(kernel),
           "quantize_ms": time_cuda(lambda: quantize_rows_cuda(x), reps)
           if a8 else None,
           "plain_ms": time_cuda(
               lambda: q8_matmul_plain(x, w11, s11, a8), max(reps // 4, 3)),
           "library_ms": lib_ms, "library_error": lib_err,
           **bound(2 * m * k + n * k + 4 * n + 2 * m * n, 2 * m * n * k,
                   PEAK_FLOPS[torch.int8 if a8 else torch.bfloat16])}
    row["tops"] = 2 * m * n * k / row["ms"] / 1e9
    name = "q8_matmul_stacked" if stacked else "q8_matmul"
    print(f"[kernel] {name} " + json.dumps(row), flush=True)
    return row


def q8_mlp_case(m, a8, seed, reps=10):
    """B6 on layer 5 of 12-layer base-width stacks (and id 99 = 11) against
    the plain version; the library call is the unfused pair on dequantized
    bf16 weights with F.gelu between."""
    import torch.nn.functional as F
    from mla_tpu_torch.ops.q8_matmul import (mlp_group_width, q8_mlp_plain,
                                             q8_mlp_stacked,
                                             quantize_rows_cuda)
    c, h = 768, 3072
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    w1, s1 = q8_weight(rng, 12, h, c)
    w2, s2 = q8_weight(rng, 12, c, h)
    b1 = torch.from_numpy(rng.standard_normal(h).astype(np.float32) * 0.1).to(
        "cuda", torch.bfloat16)
    b2 = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1).to(
        "cuda", torch.bfloat16)
    errs = []
    for i, li in ((5, 5), (99, 11)):
        lid = torch.tensor(i, dtype=torch.int32, device="cuda")
        got = q8_mlp_stacked(x, w1, s1, b1, w2, s2, b2, lid, a8)
        torch.cuda.synchronize()
        errs.append(ulp_err(got, q8_mlp_plain(x, w1, s1, b1, w2, s2, b2, li,
                                              a8), 1e-6 if a8 else 1e-3))
    lid = torch.tensor(5, dtype=torch.int32, device="cuda")
    kernel = lambda: q8_mlp_stacked(  # noqa: E731
        x, w1, s1, b1, w2, s2, b2, lid, a8)
    same = bool(torch.equal(kernel(), kernel()))
    d1 = (w1[5].to(torch.bfloat16) * s1[5].to(torch.bfloat16)[:, None])
    d2 = (w2[5].to(torch.bfloat16) * s2[5].to(torch.bfloat16)[:, None])
    row = {"rows": m, "c": c, "h": h, "a8": a8,
           "group_width": mlp_group_width(m, c, h) if a8 else None,
           "max_abs_err": max(e[0] for e in errs),
           "repeat_bitwise": same, "ok": all(e[1] for e in errs) and same,
           "ms": time_cuda(kernel, reps), "ms_median": time_median(kernel, reps),
           "device_ms": device_ms(kernel),
           "quantize_ms": time_cuda(lambda: quantize_rows_cuda(x), reps)
           if a8 else None,
           "plain_ms": time_cuda(lambda: q8_mlp_plain(
               x, w1, s1, b1, w2, s2, b2, 5, a8), 3),
           "library_ms": time_cuda(lambda: F.linear(F.gelu(F.linear(
               x, d1, b1)), d2, b2), reps),
           **bound(4 * m * c + 2 * c * h + 6 * (c + h), 4 * m * c * h,
                   PEAK_FLOPS[torch.int8 if a8 else torch.bfloat16])}
    row["tops"] = 4 * m * c * h / row["ms"] / 1e9
    print("[kernel] q8_mlp_stacked " + json.dumps(row), flush=True)
    return row


def phase_q8_kernels():
    gemm, mlp = [], []
    for a8 in (False, True):
        for m in Q8_ROWS:
            for i, site in enumerate(Q8_SITES):
                rows = m // 257 * 256 if site == "image" else m  # patches
                gemm.append(q8_gemm_case(site, rows, a8, False, seed=i))
                if site in ("qkv", "proj"):
                    gemm.append(q8_gemm_case(site, m, a8, True, seed=10 + i))
            mlp.append(q8_mlp_case(m, a8, seed=m))
    bad = [r for r in gemm + mlp if not r["ok"]]
    check(not bad, f"int8 kernels disagree with their plain versions: {bad}")
    return gemm, mlp


# the fused LayerNorm -> Dense op (B7f, B7b) at the M3AE block's two sites
# (norm1 -> qkv, norm2 -> fc1), at rungs 1 and 64 of the base width (257 and
# 16448 token rows) and at a row count off the kernels' tiles
LN_SITES = {"qkv": (768, 2304), "fc1": (768, 3072)}
LN_ROWS = (257, 16448)
# B7f: fp32 outputs are sums over C = 768 products in another order than
# cuBLAS's (|y| ~ 1). A bf16 output rounds twice, the fp32 sum and then the
# sum plus the bias, and a sum near a rounding boundary may round the other
# way: one ulp of the sum, up to two of y where the bias cancels part of it
# (2 * ULP, plus 2^-7 of the largest |bias| ~ 0.45; two ulps measured on
# an H100); an LN output h whose fp32 statistics differ in the last place
# may round the other way too, moving its products by 2^-8 of one term
# (absolute 2e-3, 6e-3 in all).
# B7b, by output: dx two bf16 ulps, since it is a difference of nearly
# equal fp32 terms (1.22 ulps measured on an H100); dscale, dbias, dW and
# dc are fp32 sums over up to 16448 rows,
# taken one after another in the kernels and pairwise by PyTorch (absolute
# 1e-2 at sums of |v| ~ 100-1000; measured 4.3e-3); a bf16 dW also sums
# h's that round the other way, each moving it by |dy| times one bf16 ulp
# of h (up to ~0.06; absolute 0.25 covers a few in one sum).
LN_TOL = {torch.float32: {"y": (1e-4, 1e-5), "dx": (1e-4, 1e-4),
                          "ds": (1e-2, 1e-4), "db": (1e-2, 1e-4),
                          "dw": (1e-2, 1e-4), "dc": (1e-2, 1e-4)},
          torch.bfloat16: {"y": (6e-3, 2 * ULP), "dx": (2e-3, 2 * ULP),
                           "ds": (1e-2, 1e-4), "db": (1e-2, 1e-4),
                           "dw": (0.25, 1e-3), "dc": (1e-2, 1e-4)}}


def ln_inputs(n, c, f, dtype, seed):
    """x (n, C) and dy (n, F) in dtype; the LN scale and bias (C,), the
    Dense weight (F, C) and bias (F,) in fp32, as the M3AE block holds
    them."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)
    return (t(rng.standard_normal((n, c)), dtype),
            t(rng.standard_normal(c) * 0.1 + 1.0),
            t(rng.standard_normal(c) * 0.1),
            t(rng.standard_normal((f, c)) / np.sqrt(c)),
            t(rng.standard_normal(f) * 0.1),
            t(rng.standard_normal((n, f)), dtype))


def ln_dense_case(site, n, dtype, seed=0, reps=20):
    """B7f against ln_dense_reference; F.layer_norm + F.linear as the
    library yardstick."""
    import torch.nn.functional as F
    from mla_tpu_torch.ops.fused_block import (ln_dense_fwd,
                                               ln_dense_reference)
    c, f = LN_SITES[site]
    x, sc, bi, w, db, _ = ln_inputs(n, c, f, dtype, seed)
    got = ln_dense_fwd(x, sc, bi, w, db, 1e-5, dtype)
    torch.cuda.synchronize()
    want = ln_dense_reference(x, sc, bi, w, db, 1e-5, dtype)
    es = x.element_size()
    wc, sc_c, bi_c, db_c = (t.to(dtype) for t in (w, sc, bi, db))
    err, ok = ulp_err(got, want, *LN_TOL[dtype]["y"])
    row = {"site": site, "rows": n, "c": c, "f": f,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": LN_TOL[dtype]["y"], "ok": ok,
           "ms": time_cuda(lambda: ln_dense_fwd(x, sc, bi, w, db, 1e-5,
                                                dtype), reps),
           "plain_ms": time_cuda(lambda: ln_dense_reference(
               x, sc, bi, w, db, 1e-5, dtype), max(reps // 4, 3)),
           # yardstick only, never called by the port
           "library_ms": time_cuda(lambda: F.linear(F.layer_norm(
               x, (c,), sc_c, bi_c), wc, db_c), reps),
           # x, the LN and Dense parameters read once, the output written
           **bound(n * c * es + 8 * c + f * c * es + 4 * f + n * f * es,
                   2 * n * c * f, PEAK_FLOPS[dtype])}
    row["tflops"] = 2 * n * c * f / row["ms"] / 1e9
    print("[kernel] ln_dense " + json.dumps(row), flush=True)
    return row


def ln_dense_bwd_case(site, n, dtype, seed=0, reps=10):
    """B7b against ln_dense_bwd_reference, and run twice for bitwise
    equality (no atomics); the autograd backward of F.layer_norm + F.linear
    as the library yardstick."""
    import torch.nn.functional as F
    from mla_tpu_torch.ops.fused_block import (ln_dense_bwd,
                                               ln_dense_bwd_reference,
                                               ln_dense_fwd)
    c, f = LN_SITES[site]
    x, sc, bi, w, db, dy = ln_inputs(n, c, f, dtype, seed)
    got = ln_dense_bwd(x, sc, bi, w, dy, 1e-5, dtype)
    again = ln_dense_bwd(x, sc, bi, w, dy, 1e-5, dtype)
    torch.cuda.synchronize()
    want = ln_dense_bwd_reference(x, sc, bi, w, dy, 1e-5, dtype)
    names = ("dx", "ds", "db", "dw", "dc")
    res = {k: ulp_err(g, wt, *LN_TOL[dtype][k])
           for k, g, wt in zip(names, got, want)}
    errs = {k: r[0] for k, r in res.items()}
    oks = {k: r[1] for k, r in res.items()}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [t.detach().to(dtype).requires_grad_()
              for t in (x, sc, bi, w, db)]
    out = F.linear(F.layer_norm(leaves[0], (c,), leaves[1], leaves[2]),
                   leaves[3], leaves[4])
    es = x.element_size()
    row = {"site": site, "rows": n, "c": c, "f": f,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": max(errs.values()), "errs": errs, "oks": oks,
           "deterministic": same, "ok": all(oks.values()) and same,
           "ms": time_cuda(lambda: ln_dense_bwd(x, sc, bi, w, dy, 1e-5,
                                                dtype), reps),
           "plain_ms": time_cuda(lambda: ln_dense_bwd_reference(
               x, sc, bi, w, dy, 1e-5, dtype), 3),
           "fwd_ms": time_cuda(lambda: ln_dense_fwd(x, sc, bi, w, db, 1e-5,
                                                    dtype), reps),
           # yardstick only: the library pair's autograd backward alone
           "library_ms": time_cuda(lambda: torch.autograd.grad(
               out, leaves, dy, retain_graph=True), reps),
           # x, the parameters, W and dy read once; dx, dscale, dbias, dW
           # (fp32) and dc written once; two GEMMs (dh and dW)
           **bound(2 * n * c * es + 8 * c + f * c * es + n * f * es
                   + 8 * c + 4 * f * c + 4 * f, 4 * n * c * f,
                   PEAK_FLOPS[dtype])}
    row["fwd_plus_bwd_ms"] = row["fwd_ms"] + row["ms"]
    print("[kernel] ln_dense_bwd " + json.dumps(row), flush=True)
    return row


def phase_ln_kernels():
    rows, bwd_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for i, site in enumerate(LN_SITES):
            for n in LN_ROWS:
                rows.append(ln_dense_case(site, n, dtype, seed=n + i))
                bwd_rows.append(ln_dense_bwd_case(site, n, dtype, seed=n + i))
        rows.append(ln_dense_case("qkv", 1000, dtype, seed=1000))
        bwd_rows.append(ln_dense_bwd_case("qkv", 1000, dtype, seed=1000))
    bad = [r for r in rows + bwd_rows if not r["ok"]]
    check(not bad, f"ln_dense kernels disagree with their plain versions: "
                   f"{bad}")
    return rows, bwd_rows


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


def profile_call(fn, match: str = None) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel name
    and the device's busy share of the call's wall time (the profiler's own
    host overhead is inside that wall time); with ``match``, also the device
    time and launches of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms,
           "top": [{"name": k[:90], "ms": ms, "count": c}
                   for k, ms, c in kernels[:12]]}
    if match:
        out.update(match=match,
                   match_ms=sum(r[1] for r in kernels if match in r[0]),
                   match_count=sum(r[2] for r in kernels if match in r[0]))
    return out


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
    profiles = {n: profile_call(lambda n=n: srv(reqs[n])) for n in (1, 64)}
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


# ---------------------------------------------------------------- phase 5

TRAIN_BATCH, TRAIN_SIZE = 64, "base"      # the training path's shape

def train_batch(rng, n, n_data=None, device="cuda"):
    """A Food-101-shaped batch (256 text tokens, 256x256 images) with labels,
    all rows valid, and for QMF the rows' dataset indices."""
    rows = {**request(rng, n), "label": rng.integers(0, 101, n),
            "valid": np.ones(n, np.float32)}
    if n_data is not None:
        rows["idx"] = rng.permutation(n_data)[:n]
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in rows.items()}


def mla_step_flops(b, c, depth, s=257, n_classes=101):
    """Model FLOPs of one MLA step, from the shapes: each sub-step runs one
    encoder forward and backward (3x the forward). Per block 24·N·C² of
    GEMMs (qkv 3C, proj C, fc1 4C, fc2 4C; N = B·S) and 4·B·S²·C of
    attention; the image encoder adds its patch projection, each sub-step
    the shared head."""
    def encoder(extra):
        return (depth * (24 * b * s * c * c + 4 * b * s * s * c) + extra
                + 2 * b * c * n_classes)
    return 3 * (encoder(0) + encoder(2 * b * (s - 1) * 768 * c))


def rel_l2(a, ref) -> float:
    """Relative L2 distance of two name-keyed tensor dicts, over all names."""
    num = sum(float(torch.sum((a[n] - ref[n]) ** 2)) for n in ref)
    return (num / sum(float(torch.sum(ref[n] ** 2)) for n in ref)) ** 0.5


def all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def attention_kernels():
    """The attention wrappers by kernel."""
    from mla_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_bwd,
                                             flash_attention_flat,
                                             flash_attention_flat_bwd)
    return {"B2f": flash_attention, "B2b": flash_attention_bwd,
            "B1f": flash_attention_flat, "B1b": flash_attention_flat_bwd}


def attention_counts():
    return {k: fn.launches for k, fn in attention_kernels().items()}


def launch_counts():
    """(forward, backward) launches of the flat attention kernels."""
    c = attention_counts()
    return c["B1f"], c["B1b"]


def head_launch_counts():
    """(forward, backward) launches of the head-layout attention kernels."""
    c = attention_counts()
    return c["B2f"], c["B2b"]


def phase_training():
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.evals.metrics import make_eval_step, summarize_counts
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flash_attention_flat_bwd)
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    b, n_steps, n_warm = TRAIN_BATCH, 7, 2
    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    m3ae_size=TRAIN_SIZE, batch_size=b).validate()
    t0 = time.perf_counter()
    model = build_classifier(cfg, seed=0)
    width, depth = model.mae_a.config.emb_dim, model.mae_a.config.depth
    per_pass = 2 * depth        # 2 encoders, or 2 sub-steps of one each
    spec = optim.make_spec(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, cfg, spec, seed=0)    # the card
    check(all(p.is_cuda and p.dtype == torch.float32
              for p in state.params.values())
          and model.mae_a.compute_dtype == torch.bfloat16,
          "train state not float32 weights with bf16 compute on the card")
    rng = np.random.default_rng(1)
    batches = [train_batch(rng, b) for _ in range(n_steps)]
    eval_batch = train_batch(rng, b)
    step = make_train_step(model, cfg, spec, len_dl=n_steps)
    lr = optim.lr_for_epoch(cfg, 0)
    print(f"[train] built the base classifier and its train state in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    others = {}
    for name, kw in (("joint", {}), ("qmf", {"modulation": "QMF"})):
        c = MLAConfig(dataset="Food101", lorb="m3ae", m3ae_size=TRAIN_SIZE,
                      batch_size=8, **kw).validate()
        m = build_classifier(c, seed=0)
        s = optim.make_spec(c)
        others[name] = (m, c, s, create_train_state(m, c, s, n_data=64,
                                                    seed=0),
                        train_batch(rng, 8, n_data=64))

    # -- the main path: counters 0 just before, read just after ----------
    flash_attention_flat.launches = 0
    flash_attention_flat_bwd.launches = 0
    times, losses = [], []
    for i, batch in enumerate(batches):
        f0, b0 = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch, lr, i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        f1, b1 = launch_counts()
        check(f1 - f0 == per_pass and b1 - b0 == per_pass,
              f"MLA step {i}: {f1 - f0} forward / {b1 - b0} backward kernel "
              f"launches, expected {per_pass} each")
        if i >= n_warm:
            times.append(dt)
        losses.append({k: float(v) for k, v in metrics.items()})
    f0, b0 = launch_counts()
    counts = make_eval_step(model, cfg)(eval_batch)
    f1, b1 = launch_counts()
    check(f1 - f0 == per_pass and b1 == b0,
          f"eval: {f1 - f0} forward / {b1 - b0} backward launches")
    check(float(counts["num"].sum()) == b, f"eval counts {counts['num']}")
    accuracy = summarize_counts(counts)
    other_losses = {}
    for name, (m, c, s, st, bt) in others.items():
        f0, b0 = launch_counts()
        st, met = make_train_step(m, c, s, len_dl=1)(st, bt, lr, 0)
        torch.cuda.synchronize()
        f1, b1 = launch_counts()
        check(f1 - f0 == per_pass and b1 - b0 == per_pass,
              f"{name} step: {f1 - f0} forward / {b1 - b0} backward launches")
        other_losses[name] = {k: float(v) for k, v in met.items()}
        check(all(np.isfinite(v) for v in other_losses[name].values())
              and all_finite(st.params.values()),
              f"{name} step: non-finite loss or parameter")
    launches = launch_counts()
    # -- end of the main path ---------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    del others
    check(all(np.isfinite(v) for ls in losses for v in ls.values()),
          f"non-finite MLA loss: {losses}")
    check(all_finite(state.params.values()), "non-finite parameter")
    med = float(np.median(times)) * 1e3
    flops = mla_step_flops(b, width, depth)
    share = flops / (med * 1e-3) / PEAK_FLOPS[torch.bfloat16]
    print(f"[train] model FLOPs per MLA step at B={b}: {flops / 1e12:.2f} "
          f"TFLOP; at the median step {share * 100:.2f}% of the bf16 peak",
          flush=True)
    print(f"[train] MLA B={b}: median {med:.2f} ms of {len(times)} steps "
          f"(min {min(times) * 1e3:.2f}), {b / med * 1e3:.1f} clips/s; peak "
          f"{peak / 2**30:.2f} GiB; losses {losses[0]['loss']:.4f} -> "
          f"{losses[-1]['loss']:.4f}; launches fwd/bwd {launches}; eval "
          f"{accuracy}; joint/QMF {other_losses}", flush=True)
    profile = profile_call(lambda: step(state, batches[0], lr, 0))
    print(f"[trace] MLA step B={b}: wall {profile['wall_ms']:.2f} ms, device "
          f"busy {profile['device_ms']:.2f} ms "
          f"({100 * profile['busy_share']:.1f}%); top: "
          + json.dumps(profile["top"][:8]), flush=True)
    del state, model, step, batches
    torch.cuda.empty_cache()
    return {"batch": b, "step_ms": [t * 1e3 for t in times],
            "median_step_ms": med, "clips_per_s": b / med * 1e3,
            "peak_bytes": peak, "model_flops": flops,
            "bf16_peak_share": share, "losses": losses, "eval": accuracy,
            "other_losses": other_losses, "launches_fwd": launches[0],
            "launches_bwd": launches[1], "profile": profile,
            "cpu_agreement": cpu_agreement()}


def cpu_agreement(counts=None, label="train"):
    """One MLA step at B=2, full base width, float32: on the card with the
    kernels against the CPU with the plain versions, from the same weights
    and batch. Relative L2 over all parameters and momentum buffers.
    ``counts`` gives the (forward, backward) launches of the attention
    route the step takes (the flat kernels' by default)."""
    counts = counts or launch_counts
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    m3ae_size=TRAIN_SIZE, batch_size=2,
                    compute_dtype="float32").validate()
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_classifier(cfg, seed=1)
        spec = optim.make_spec(cfg)
        st = create_train_state(model, cfg, spec, seed=1, device=dev)
        batch = train_batch(np.random.default_rng(7), 2, device=dev)
        f0, b0 = counts()
        t = time.perf_counter()
        st, met = make_train_step(model, cfg, spec, len_dl=1)(
            st, batch, optim.lr_for_epoch(cfg, 0), 0)
        met = {k: float(v) for k, v in met.items()}
        f1, b1 = counts()
        n = 2 * model.mae_a.config.depth
        check((f1 - f0, b1 - b0) == ((n, n) if dev == "cuda" else (0, 0)),
              f"fp32 step on {dev}: {f1 - f0} / {b1 - b0} kernel launches")
        out[dev] = ({n: p.detach().cpu() for n, p in st.params.items()},
                    {n: m.cpu() for n, m in
                     st.opt_state["momentum"].items()},
                    met, time.perf_counter() - t)
        del model, st
    torch.cuda.empty_cache()

    (pg, mg, lg, tg), (pc, mc, lc, tc) = out["cuda"], out["cpu"]
    # (a leaf the step never reached with a zero weight has no momentum)
    worst = max((float(torch.linalg.norm(mg[n] - mc[n])
                       / torch.linalg.norm(mc[n])), n)
                for n in mc if bool(torch.any(mc[n] != 0)))
    res = {"params_rel_l2": rel_l2(pg, pc), "momentum_rel_l2": rel_l2(mg, mc),
           "momentum_worst_param": {"name": worst[1], "rel_l2": worst[0]},
           "loss_rel": {k: abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc},
           "losses_card": lg, "losses_cpu": lc, "step_s_card": tg,
           "step_s_cpu": tc}
    print(f"[{label}] fp32 MLA step B=2, card vs CPU: {json.dumps(res)}",
          flush=True)
    check(res["params_rel_l2"] <= 1e-6 and res["momentum_rel_l2"] <= 1e-3
          and max(res["loss_rel"].values()) <= 1e-4,
          f"the card's fp32 step drifts from the CPU's: {res}")
    return res


# ---------------------------------------------------------------- phases 6-7

AV_BATCH = 64                     # clips per training step (3 frames each)
AV_STAGES = (2, 2, 2, 2)          # ResNet-18 at full depth
B3_SITES = 13                     # stride-1 3x3 C==F convs per ResNet-18


def av_config(**kw):
    from mla_tpu_torch.core.config import MLAConfig
    base = dict(dataset="CREMAD", lorb="base", pallas_conv="on",
                resnet_stages=AV_STAGES)
    base.update(kw)
    return MLAConfig(**base).validate()


def av_request(rng, n):
    """A CREMA-D-shaped request: (1, 129, 626) spectrograms and 3 frames of
    3 x 224 x 224 (benchmarks/profile_step.py)."""
    return {"spec": rng.standard_normal((n, 1, 129, 626)).astype(np.float32),
            "image": rng.standard_normal((n, 3, 3, 224, 224)).astype(
                np.float32)}


def av_batch(rng, n, n_data=None, device="cuda"):
    rows = {**av_request(rng, n), "label": rng.integers(0, 6, n),
            "valid": np.ones(n, np.float32)}
    if n_data is not None:
        rows["idx"] = rng.permutation(n_data)[:n]
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in rows.items()}


def b3_launches():
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    return conv3x3.launches


def running_stats(model):
    return {n: t.detach().clone() for n, t in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def same_stats(a, b) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def phase_av_serving(work: Path):
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    from mla_tpu_torch.runtime.export import export_serving, load_serving
    from mla_tpu_torch.runtime.serve import run_batch

    cfg = av_config(gs_flag=True, dynamic=True)
    model = build_classifier(cfg, seed=0)
    art = export_serving(cfg, model, str(work / "av"),
                         batch_sizes=(1, 8, 64), weights_dtype="float32")
    del model
    torch.cuda.reset_peak_memory_stats()
    srv = load_serving(art)                       # cuda, bf16 compute
    check(srv.device.type == "cuda" and srv.compute_dtype == "bfloat16"
          and not srv.model.training, "AV serving model not in eval mode "
          "on the card in bf16")
    stats0 = running_stats(srv.model)
    rng = np.random.default_rng(0)
    reqs = {n: av_request(rng, n) for n in (1, 3, 64)}
    per_dispatch = 2 * B3_SITES

    # -- the main path: counters 0 just before, read just after ----------
    conv3x3.launches = 0
    dispatches, rungs = 0, {}
    for n, feats in reqs.items():
        times = []
        for i in range(12):                       # 2 warm-up + 10 timed
            before = conv3x3.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_batch(srv, feats)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            dispatches += 1
            check(conv3x3.launches - before == per_dispatch,
                  f"AV n={n}: {conv3x3.launches - before} B3 launches in one "
                  f"dispatch, expected {per_dispatch}")
            if i >= 2:
                times.append(dt)
        for k in ("fused", "logits_a", "logits_v"):
            check(out[k].shape == (n, 6) and bool(np.isfinite(out[k]).all()),
                  f"AV n={n}: {k} {out[k].shape} not finite")
        med = float(np.median(times)) * 1e3
        rungs[n] = {"rung": srv._rung(n), "median_ms": med,
                    "min_ms": float(np.min(times)) * 1e3,
                    "rows_per_s": n / med * 1e3, "reps": len(times)}
        print(f"[av-serve] n={n} (rung {srv._rung(n)}): median {med:.2f} ms, "
              f"{n / med * 1e3:.1f} clips/s", flush=True)
    launches = conv3x3.launches
    # -- end of the main path ---------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    check(launches == per_dispatch * dispatches,
          f"{launches} B3 launches over {dispatches} AV dispatches")
    check(same_stats(stats0, running_stats(srv.model)),
          "a serving dispatch changed a BatchNorm running statistic")
    profile = profile_call(lambda: srv(reqs[64]), match="conv3x3_")
    print(f"[trace] AV n=64: wall {profile['wall_ms']:.2f} ms, device busy "
          f"{profile['device_ms']:.2f} ms ({100 * profile['busy_share']:.1f}"
          f"%), B3 {profile['match_ms']:.2f} ms over "
          f"{profile['match_count']} launches; top: "
          + json.dumps(profile["top"][:8]), flush=True)
    two = {k: v[:2] for k, v in reqs[64].items()}
    gpu = srv(two)
    del srv
    torch.cuda.empty_cache()
    cpu = load_serving(art, device="cpu", compute_dtype="float32")(two)
    rel = {k: float(np.linalg.norm(gpu[k] - cpu[k]) / np.linalg.norm(cpu[k]))
           for k in cpu}
    print(f"[av-serve] {dispatches} dispatches, {launches} B3 launches, peak "
          f"{peak / 2**30:.2f} GiB; bf16 card vs fp32 CPU, relative L2: "
          f"{rel}", flush=True)
    # bf16 activations through 20 BatchNorms and 17 convs per ResNet
    check(all(v <= 5e-2 for v in rel.values()),
          f"AV card logits drift from the CPU float32 reference: {rel}")
    return {"rungs": rungs, "dispatches": dispatches, "launches": launches,
            "peak_bytes": peak, "rel_l2_vs_cpu": rel, "profile": profile}


def av_conv_flops(model, batch):
    """Forward FLOPs of every conv of both ResNets on ``batch`` (from the
    output shapes of one eval-mode forward), and those of the B3 sites."""
    from mla_tpu_torch.models import resnet
    from mla_tpu_torch.ops.conv3x3 import eligible
    real, total, b3 = resnet.conv2d, [0], [0]

    def counting(conv, x, pallas=False):
        out = real(conv, x, pallas)
        f = 2 * out.numel() * conv.in_channels * conv.kernel_size[0] \
            * conv.kernel_size[1]
        total[0] += f
        if pallas and conv.stride == (1, 1) and eligible(x, conv.weight):
            b3[0] += f
        return out
    resnet.conv2d = counting
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model.encode(batch, "a")
            model.encode(batch, "v")
    finally:
        resnet.conv2d = real
        model.train(was)
    return total[0], b3[0]


def av_steps(step, state, batches, lr, expect, label):
    """Run ``batches`` through ``step``, checking ``expect`` B3 launches per
    step; -> (state, per-step seconds, per-step metrics)."""
    times, losses = [], []
    for i, batch in enumerate(batches):
        before = b3_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch, lr, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        check(b3_launches() - before == expect,
              f"{label} step {i}: {b3_launches() - before} B3 launches, "
              f"expected {expect}")
        losses.append({k: float(v) for k, v in metrics.items()})
    return state, times, losses


def phase_av_training():
    from mla_tpu_torch.evals.metrics import make_eval_step, summarize_counts
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    b, n_warm, n_timed = AV_BATCH, 2, 5
    cfg = av_config(gs_flag=True, batch_size=b)
    t0 = time.perf_counter()
    model = build_classifier(cfg, seed=0)
    spec = optim.make_spec(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, cfg, spec, seed=0)
    check(all(p.is_cuda and p.dtype == torch.float32
              for p in state.params.values())
          and all(t.dtype == torch.float32 for t in
                  running_stats(model).values())
          and model.audio_net.compute_dtype == torch.bfloat16,
          "AV train state not float32 weights and statistics with bf16 "
          "compute on the card")
    rng = np.random.default_rng(1)
    batches = [av_batch(rng, b) for _ in range(n_warm + n_timed)]
    eval_batch = av_batch(rng, b)
    step = make_train_step(model, cfg, spec, len_dl=len(batches))
    lr = optim.lr_for_epoch(cfg, 0)
    flops_fwd, flops_b3 = av_conv_flops(model, batches[0])
    print(f"[av-train] built the AV classifier and its train state in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    others = {}
    for name, kw in (("joint_ogm_ge", {"modulation": "OGM_GE"}),
                     ("qmf", {"modulation": "QMF"})):
        c = av_config(batch_size=8, **kw)
        m = build_classifier(c, seed=0)
        s = optim.make_spec(c)
        others[name] = (m, c, s, create_train_state(m, c, s, n_data=64,
                                                    seed=0),
                        av_batch(rng, 8, n_data=64))
    per_step = 2 * 2 * B3_SITES        # 2 sub-steps x (forward + dx)

    # -- the main path: counters 0 just before, read just after ----------
    conv3x3.launches = 0
    state, times, losses = av_steps(step, state, batches, lr, per_step,
                                    "AV MLA")
    stats0 = running_stats(model)
    before = b3_launches()
    counts = make_eval_step(model, cfg)(eval_batch)
    check(b3_launches() - before == 2 * B3_SITES,
          f"AV eval: {b3_launches() - before} B3 launches")
    check(same_stats(stats0, running_stats(model)) and model.training,
          "the eval step changed a running statistic or the model's mode")
    check(float(counts["num"].sum()) == b, f"AV eval counts {counts['num']}")
    accuracy = summarize_counts(counts)
    other_losses = {}
    for name, (m, c, s, st, bt) in others.items():
        st, _, ls = av_steps(make_train_step(m, c, s, len_dl=1), st, [bt],
                             lr, per_step, name)
        other_losses[name] = ls[0]
        check(all(np.isfinite(v) for v in ls[0].values())
              and all_finite(st.params.values()),
              f"AV {name} step: non-finite loss or parameter")
    launches = conv3x3.launches
    # -- end of the main path ---------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    del others
    check(all(np.isfinite(v) for ls in losses for v in ls.values())
          and all_finite(state.params.values())
          and all_finite(running_stats(model).values()),
          f"non-finite AV loss, parameter or statistic: {losses}")
    med = float(np.median(times[n_warm:])) * 1e3
    flops = 3 * flops_fwd        # each sub-step: one encoder fwd + bwd
    share = flops / (med * 1e-3) / PEAK_FLOPS[torch.bfloat16]
    print(f"[av-train] conv FLOPs per MLA step at B={b}: {flops / 1e12:.3f} "
          f"TFLOP ({flops_b3 / flops_fwd * 100:.1f}% at the B3 sites); MLA "
          f"median {med:.2f} ms of {n_timed} steps, {b / med * 1e3:.1f} "
          f"clips/s, {share * 100:.2f}% of the bf16 peak; peak "
          f"{peak / 2**30:.2f} GiB; losses {losses[0]['loss']:.4f} -> "
          f"{losses[-1]['loss']:.4f}; {launches} B3 launches; eval "
          f"{accuracy}; joint OGM_GE / QMF {other_losses}", flush=True)
    profile = profile_call(lambda: step(state, batches[0], lr, 0),
                           match="conv3x3_")
    print(f"[trace] AV MLA step B={b}: wall {profile['wall_ms']:.2f} ms, "
          f"device busy {profile['device_ms']:.2f} ms "
          f"({100 * profile['busy_share']:.1f}%), B3 "
          f"{profile['match_ms']:.2f} ms over {profile['match_count']} "
          f"launches; top: " + json.dumps(profile["top"][:10]), flush=True)
    del state, model, step
    torch.cuda.empty_cache()

    # the step-level yardstick: the same steps with cuDNN in B3's place
    cfg_off = av_config(gs_flag=True, batch_size=b, pallas_conv="off")
    m_off = build_classifier(cfg_off, seed=0)
    st_off = create_train_state(m_off, cfg_off, spec, seed=0)
    _, t_off, _ = av_steps(make_train_step(m_off, cfg_off, spec, len(batches)),
                           st_off, batches, lr, 0, "AV MLA --pallas_conv off")
    med_off = float(np.median(t_off[n_warm:])) * 1e3
    print(f"[av-train] --pallas_conv off (cuDNN): MLA median {med_off:.2f} ms, "
          f"{b / med_off * 1e3:.1f} clips/s", flush=True)
    del m_off, st_off, batches
    torch.cuda.empty_cache()
    return {"batch": b, "step_ms": [t * 1e3 for t in times],
            "median_step_ms": med, "clips_per_s": b / med * 1e3,
            "off_step_ms": [t * 1e3 for t in t_off],
            "off_median_step_ms": med_off,
            "off_clips_per_s": b / med_off * 1e3, "peak_bytes": peak,
            "conv_flops": flops, "b3_flop_share": flops_b3 / flops_fwd,
            "bf16_peak_share": share, "losses": losses, "eval": accuracy,
            "other_losses": other_losses, "launches": launches,
            "profile": profile, "cpu_agreement": av_cpu_agreement()}


def av_cpu_agreement():
    """One MLA step at B=2, full width and depth, float32, --pallas_conv on:
    on the card (B3 and cuDNN) against the CPU (plain versions), from the
    same weights, statistics and batch. Relative L2 over all parameters,
    momentum buffers and BatchNorm running statistics."""
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    cfg = av_config(gs_flag=True, batch_size=2, compute_dtype="float32")
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_classifier(cfg, seed=1)
        spec = optim.make_spec(cfg)
        st = create_train_state(model, cfg, spec, seed=1, device=dev)
        batch = av_batch(np.random.default_rng(7), 2, device=dev)
        before = b3_launches()
        t = time.perf_counter()
        st, met = make_train_step(model, cfg, spec, len_dl=1)(
            st, batch, optim.lr_for_epoch(cfg, 0), 0)
        met = {k: float(v) for k, v in met.items()}
        n = b3_launches() - before
        check(n == (4 * B3_SITES if dev == "cuda" else 0),
              f"AV fp32 step on {dev}: {n} B3 launches")
        out[dev] = ({n: p.detach().cpu() for n, p in st.params.items()},
                    {n: m.cpu() for n, m in
                     st.opt_state["momentum"].items()},
                    {n: t.cpu() for n, t in running_stats(model).items()},
                    met, time.perf_counter() - t)
        del model, st
    torch.cuda.empty_cache()

    (pg, mg, sg, lg, tg), (pc, mc, sc, lc, tc) = out["cuda"], out["cpu"]
    worst = max((float(torch.linalg.norm(mg[n] - mc[n])
                       / torch.linalg.norm(mc[n])), n)
                for n in mc if bool(torch.any(mc[n] != 0)))
    res = {"params_rel_l2": rel_l2(pg, pc), "momentum_rel_l2": rel_l2(mg, mc),
           "momentum_worst_param": {"name": worst[1], "rel_l2": worst[0]},
           "running_stats_rel_l2": rel_l2(sg, sc),
           "loss_rel": {k: abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc},
           "losses_card": lg, "losses_cpu": lc, "step_s_card": tg,
           "step_s_cpu": tc}
    print(f"[av-train] fp32 MLA step B=2, card vs CPU: {json.dumps(res)}",
          flush=True)
    # the running statistics and losses come from the forward (sums in
    # another order: 1e-5); the momentum also from ReLU masks, which flip
    # where a ReLU input lies within rounding of 0 (one flip in a debug
    # step on the CPU moves a stem gradient by ~1%): 1e-2
    check(res["params_rel_l2"] <= 1e-5 and res["momentum_rel_l2"] <= 1e-2
          and res["running_stats_rel_l2"] <= 1e-5
          and max(res["loss_rel"].values()) <= 1e-4,
          f"the card's fp32 AV step drifts from the CPU's: {res}")
    return res


# ---------------------------------------------------------------- phase 8

# bounds on the int8 artifacts' fused logits against the bf16 artifact's
# from the same weights (n = 64): relative L2 (weight-only int8 rounds each
# weight to 1/254 of its channel's range; W8A8 also each activation row),
# and the share of rows whose argmax agrees (101 classes of random-weight
# logits lie close together). The upper edges of what was predicted before
# the first run: tight enough that a wrong route (a wrong W8A8 group width,
# a site's switch set wrongly) fails here, not only in the kernel rows.
INT8_REL_L2 = {"int8": 0.03, "int8_a8": 0.05}
INT8_ARGMAX_AGREE = 0.9


def q8_path_kernels():
    """The wrappers an int8 M3AE dispatch launches, by kernel."""
    from mla_tpu_torch.ops.attention import flash_attention_flat
    from mla_tpu_torch.ops.q8_matmul import (q8_matmul, q8_matmul_stacked,
                                             q8_mlp_stacked)
    return {"B4": q8_matmul, "B5": q8_matmul_stacked, "B6": q8_mlp_stacked,
            "B1f": flash_attention_flat}


def q8_counts():
    return {k: fn.launches for k, fn in q8_path_kernels().items()}


def zero_q8_counts():
    for fn in q8_path_kernels().values():
        fn.launches = 0


def per_dispatch(meta) -> dict:
    """Launches of one dispatch of a base int8 artifact (module notes)."""
    if not meta["config"]["scan_blocks"]:
        return {"B4": 97, "B5": 0, "B6": 0, "B1f": 24}
    mlp_skipped = {"mlp/fc1", "mlp/fc2"} & set(meta["a8_skip"])
    if meta["weights_dtype"] == "int8_a8" and mlp_skipped:
        return {"B4": 1, "B5": 96, "B6": 0, "B1f": 24}
    return {"B4": 1, "B5": 48, "B6": 24, "B1f": 24}


def delta(before):
    now = q8_counts()
    return {k: now[k] - before[k] for k in now}


def phase_int8_serving(work: Path):
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.runtime.export import export_serving, load_serving
    from mla_tpu_torch.runtime.serve import make_server, run_batch

    t0 = time.perf_counter()
    cfgs = {scan: MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                            dynamic=True, m3ae_size="base",
                            scan_blocks=scan).validate()
            for scan in (False, True)}
    model = build_classifier(cfgs[False], seed=0)      # phase 4's weights
    fp32_bytes = sum(t.numel() * t.element_size()
                     for t in model.state_dict().values())
    example = request(np.random.default_rng(5), 4)
    arts = {"bfloat16": export_serving(
        cfgs[False], model, str(work / "q8_bf16"), weights_dtype="bfloat16",
        example_batch=example)}
    for kind, dtype, scan in (("int8", "int8", False),
                              ("int8_scan", "int8", True),
                              ("int8_a8_scan", "int8_a8", True)):
        arts[kind] = export_serving(cfgs[scan], model, str(work / kind),
                                    weights_dtype=dtype,
                                    example_batch=example)
    del model
    print(f"[int8] exported the base M3AE four ways (int8_a8 calibrated on "
          f"the card) in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    reqs = {n: request(rng, n) for n in (1, 3, 64)}
    bf = load_serving(arts["bfloat16"])
    ref64 = run_batch(bf, reqs[64])["fused"]
    # the bf16 artifact's latency, the yardstick of int8 serving: 2 warm-up
    # and 10 timed dispatches per request size, as the int8 kinds below
    bf_rungs = {}
    for n, feats in reqs.items():
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_batch(bf, feats)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(time.perf_counter() - t)
        bf_rungs[n] = {"median_ms": float(np.median(times)) * 1e3,
                       "min_ms": float(np.min(times)) * 1e3}
    print("[int8] the bfloat16 artifact: " + json.dumps(bf_rungs), flush=True)
    del bf
    torch.cuda.empty_cache()
    out = {"fp32_bytes": fp32_bytes, "bfloat16_rungs": bf_rungs}
    for kind in ("int8", "int8_scan", "int8_a8_scan"):
        torch.cuda.reset_peak_memory_stats()
        srv = load_serving(arts[kind])               # cuda, bf16 compute
        meta = srv.meta
        want = per_dispatch(meta)
        dispatches, rungs = 0, {}
        # -- the main path: counters 0 just before, read just after -------
        zero_q8_counts()
        for n, feats in reqs.items():
            times = []
            for i in range(12):                   # 2 warm-up + 10 timed
                before = q8_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = run_batch(srv, feats)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                dispatches += 1
                got = delta(before)
                check(got == want, f"{kind} n={n}: launches {got} in one "
                                   f"dispatch, expected {want}")
                if i >= 2:
                    times.append(dt)
            check_logits(res, n, f"{kind} n={n}")
            med = float(np.median(times)) * 1e3
            rungs[n] = {"rung": srv._rung(n), "median_ms": med,
                        "min_ms": float(np.min(times)) * 1e3,
                        "rows_per_s": n / med * 1e3, "reps": len(times)}
            if n == 64:
                fused64 = res["fused"]
        httpd = make_server(srv, port=0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            before = q8_counts()
            res = post(f"http://127.0.0.1:{httpd.server_address[1]}",
                       {k: v[:2] for k, v in reqs[3].items()})
            check_logits(res, 2, f"{kind} HTTP")
            check(delta(before) == want, f"{kind} HTTP: launches "
                                         f"{delta(before)}")
            dispatches += 1
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=30)
        launches = q8_counts()
        # -- end of the main path -----------------------------------------
        peak = torch.cuda.max_memory_allocated()
        check(all(launches[k] == want[k] * dispatches for k in want),
              f"{kind}: {launches} launches over {dispatches} dispatches")
        rel = float(np.linalg.norm(fused64 - ref64) / np.linalg.norm(ref64))
        agree = float(np.mean(np.argmax(fused64, 1) == np.argmax(ref64, 1)))
        dtype = meta["weights_dtype"]
        profiles = {n: profile_call(lambda n=n: srv(reqs[n])) for n in (1, 64)}
        card3 = srv(reqs[3])
        del srv
        torch.cuda.empty_cache()
        cpu3 = load_serving(arts[kind], device="cpu",
                            compute_dtype="bfloat16")(reqs[3])
        rel_cpu = {k: float(np.linalg.norm(card3[k] - cpu3[k])
                            / np.linalg.norm(cpu3[k])) for k in cpu3}
        art_bytes = os.path.getsize(os.path.join(arts[kind], "weights.pt"))
        res = {"weights_dtype": dtype, "scan_blocks":
               meta["config"]["scan_blocks"], "a8_skip": meta["a8_skip"],
               "a8_site_rel_err": meta["a8_site_rel_err"],
               "per_dispatch": want, "dispatches": dispatches,
               "launches": launches, "rungs": rungs, "peak_bytes": peak,
               "rel_l2_vs_bf16": rel, "argmax_agree_vs_bf16": agree,
               "rel_l2_card_vs_cpu": rel_cpu, "artifact_bytes": art_bytes,
               "bytes_vs_fp32": art_bytes / fp32_bytes, "profiles": profiles}
        out[kind] = res
        print(f"[int8] {kind}: " + json.dumps(
            {k: v for k, v in res.items() if k != "profiles"}), flush=True)
        for n, p in profiles.items():
            print(f"[trace] {kind} n={n}: wall {p['wall_ms']:.2f} ms, device "
                  f"busy {p['device_ms']:.2f} ms ({100 * p['busy_share']:.1f}"
                  f"%); top: " + json.dumps(p["top"][:8]), flush=True)
        check(rel <= INT8_REL_L2[dtype] and agree >= INT8_ARGMAX_AGREE,
              f"{kind} logits drift from the bf16 artifact's: relative L2 "
              f"{rel}, argmax agreement {agree}")
        # bf16 compute on both sides: kernels against plain versions, and
        # the attention's bf16 rounding (phase 4's tolerance)
        check(all(v <= 3e-2 for v in rel_cpu.values()),
              f"{kind}: the card drifts from the CPU: {rel_cpu}")
    return out


# ---------------------------------------------------------------- phase 9

def counts_since(before):
    now = attention_counts()
    return {k: now[k] - before[k] for k in now}


# one step through the head route against the flat route, same weights and
# batch: B2 runs B1's arithmetic, so the prediction is bit for bit; the
# limits leave room for cuBLAS taking another algorithm on a differently
# aligned copy (bf16 compute)
ROUTE_PARAMS_REL_L2, ROUTE_LOSS_REL = 1e-5, 1e-3


def phase_head_training(flat_median_ms):
    """Phase 9: the M3AE MLA training path with the flat kernels off for the
    whole phase, as the JAX driver runs every step and eval of a run whose
    mesh has a model axis; restored on the way out."""
    from mla_tpu_torch.ops import attention
    with attention.flat_attention_route(False):
        return head_training(flat_median_ms)


def head_training(flat_median_ms):
    from mla_tpu_torch.core.config import MLAConfig
    from mla_tpu_torch.evals.metrics import make_eval_step, summarize_counts
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    b, n_steps, n_warm = TRAIN_BATCH, 7, 2
    cfg = MLAConfig(dataset="Food101", lorb="m3ae", gs_flag=True,
                    m3ae_size=TRAIN_SIZE, batch_size=b).validate()
    model = build_classifier(cfg, seed=0)
    per_pass = 2 * model.mae_a.config.depth
    spec = optim.make_spec(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, cfg, spec, seed=0)
    rng = np.random.default_rng(1)
    batches = [train_batch(rng, b) for _ in range(n_steps)]
    eval_batch = train_batch(rng, b)
    step = make_train_step(model, cfg, spec, len_dl=n_steps)
    lr = optim.lr_for_epoch(cfg, 0)
    want = {"B2f": per_pass, "B2b": per_pass, "B1f": 0, "B1b": 0}

    # -- the main path: counters 0 just before, read just after ----------
    for fn in attention_kernels().values():
        fn.launches = 0
    times, losses = [], []
    for i, batch in enumerate(batches):
        before = attention_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch, lr, i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = counts_since(before)
        check(got == want, f"head-route MLA step {i}: launches {got}, "
                           f"expected {want}")
        if i >= n_warm:
            times.append(dt)
        losses.append({k: float(v) for k, v in metrics.items()})
    before = attention_counts()
    counts = make_eval_step(model, cfg)(eval_batch)
    got = counts_since(before)
    check(got == {**want, "B2b": 0}, f"head-route eval: launches {got}")
    check(float(counts["num"].sum()) == b, f"eval counts {counts['num']}")
    accuracy = summarize_counts(counts)
    launches = attention_counts()
    # -- end of the main path ---------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for ls in losses for v in ls.values())
          and all_finite(state.params.values()),
          f"non-finite head-route loss or parameter: {losses}")
    med = float(np.median(times)) * 1e3
    print(f"[head-train] MLA B={b}, flat kernels off: median {med:.2f} ms of "
          f"{len(times)} steps (min {min(times) * 1e3:.2f}), "
          f"{b / med * 1e3:.1f} clips/s (flat route, phase 5: "
          f"{flat_median_ms:.2f} ms); peak {peak / 2**30:.2f} GiB; losses "
          f"{losses[0]['loss']:.4f} -> {losses[-1]['loss']:.4f}; launches "
          f"{launches}; eval {accuracy}", flush=True)
    profile = profile_call(lambda: step(state, batches[0], lr, 0))
    print(f"[trace] head-route MLA step B={b}: wall {profile['wall_ms']:.2f} "
          f"ms, device busy {profile['device_ms']:.2f} ms "
          f"({100 * profile['busy_share']:.1f}%); top: "
          + json.dumps(profile["top"][:8]), flush=True)
    del state, model, step
    torch.cuda.empty_cache()
    return {"batch": b, "step_ms": [t * 1e3 for t in times],
            "median_step_ms": med, "clips_per_s": b / med * 1e3,
            "flat_median_step_ms": flat_median_ms, "peak_bytes": peak,
            "losses": losses, "eval": accuracy, "launches": launches,
            "profile": profile,
            "route_agreement": route_agreement(cfg, spec, batches[0], lr),
            "cpu_agreement": cpu_agreement(head_launch_counts, "head-train")}


def route_agreement(cfg, spec, batch, lr):
    """One MLA step from the same seeded weights and batch through the head
    route and, with the switch on for that step, the flat route: losses and
    updated parameters compared."""
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.ops import attention
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    out = {}
    for flat in (False, True):
        with attention.flat_attention_route(flat):
            model = build_classifier(cfg, seed=0)
            st = create_train_state(model, cfg, spec, seed=0)
            before = attention_counts()
            st, met = make_train_step(model, cfg, spec, len_dl=1)(
                st, batch, lr, 0)
            torch.cuda.synchronize()
            got = counts_since(before)
        used = ("B1f", "B1b") if flat else ("B2f", "B2b")
        check(all(got[k] > 0 for k in used)
              and sum(got.values()) == sum(got[k] for k in used),
              f"route step (flat={flat}): launches {got}")
        out[flat] = ({n: p.detach().clone() for n, p in st.params.items()},
                     {k: float(v) for k, v in met.items()})
        del model, st
    (ph, lh), (pf, lf) = out[False], out[True]
    res = {"params_rel_l2": rel_l2(ph, pf),
           "bitwise_equal": all(torch.equal(ph[n], pf[n]) for n in pf)
           and lh == lf,
           "loss_rel": {k: abs(lh[k] - lf[k]) / abs(lf[k]) for k in lf},
           "losses_head": lh, "losses_flat": lf}
    del out, ph, pf
    torch.cuda.empty_cache()
    print(f"[head-train] one step, head route vs flat route: "
          f"{json.dumps(res)}", flush=True)
    check(res["params_rel_l2"] <= ROUTE_PARAMS_REL_L2
          and max(res["loss_rel"].values()) <= ROUTE_LOSS_REL,
          f"the head route's step drifts from the flat route's: {res}")
    return res


# ---------------------------------------------------------------- phase 10

# ln_dense on (the kernels) against off (the LayerNorm and Dense
# composition) through autograd, bf16 compute: outputs as B7f's plain
# comparison; gradients by relative L2, since autograd through the
# composition rounds dh to bf16 where the kernel law keeps it in fp32
# (about 2^-9 relative per element)
LN_PATH_GRAD_REL_L2 = 1e-2


def ln_path_inputs(site, b, s, seed):
    """The autograd leaves (x (B, S, C) bf16; the fp32 LN and Dense
    parameters) and dy (B, S, F) of one site."""
    c, f = LN_SITES[site]
    x, sc, bi, w, db, dy = ln_inputs(b * s, c, f, torch.bfloat16, seed)
    leaves = [x.view(b, s, c).requires_grad_()] + [
        t.requires_grad_() for t in (sc, bi, w, db)]
    return leaves, dy.view(b, s, f)


def ln_path_step(leaves, dy):
    """ln_dense forward and backward through autograd, bf16 compute."""
    from mla_tpu_torch.ops.fused_block import ln_dense
    y = ln_dense(*leaves, dtype=torch.bfloat16)
    return y, torch.autograd.grad(y, leaves, dy)


def phase_ln_dense():
    """Phase 10: the fused LayerNorm -> Dense op through its own entry point,
    ``ln_dense``, at the M3AE block's two sites on a B=64 batch of base-width
    token rows (16448), bf16 compute on fp32 parameters, forward and
    backward through autograd; with the switch on, then off."""
    from mla_tpu_torch.ops import fused_block as fbk
    b, s = TRAIN_BATCH, 257
    out = {}

    def counts():
        return fbk.ln_dense_fwd.launches, fbk.ln_dense_bwd.launches

    fbk.set_fused_ln_dense(True)
    try:
        # -- the main path: counters 0 just before, read just after ------
        fbk.ln_dense_fwd.launches = 0
        fbk.ln_dense_bwd.launches = 0
        for i, site in enumerate(LN_SITES):
            leaves, dy = ln_path_inputs(site, b, s, seed=10 + i)
            f0, b0 = counts()
            y_on, g_on = ln_path_step(leaves, dy)
            y_on = y_on.detach()
            torch.cuda.synchronize()
            on = (counts()[0] - f0, counts()[1] - b0)
            check(on == (1, 1), f"ln_dense {site}, switch on: launches "
                                f"(B7f, B7b) {on}, expected (1, 1)")
            fbk.set_fused_ln_dense(False)
            try:
                f0, b0 = counts()
                y_off, g_off = ln_path_step(leaves, dy)
                y_off = y_off.detach()
                torch.cuda.synchronize()
                off = (counts()[0] - f0, counts()[1] - b0)
            finally:
                fbk.set_fused_ln_dense(True)
            check(off == (0, 0), f"ln_dense {site}, switch off: launches "
                                 f"{off}")
            rel = [float(torch.linalg.norm(a.float() - o.float())
                         / torch.linalg.norm(o.float()))
                   for a, o in zip(g_on, g_off)]
            y_err, y_ok = ulp_err(y_on, y_off, *LN_TOL[torch.bfloat16]["y"])
            res = {"rows": b * s, "c": leaves[0].shape[-1],
                   "f": leaves[3].shape[0], "y_ok": y_ok,
                   "y_max_abs_err": y_err,
                   "grad_rel_l2": dict(zip(("dx", "dscale", "dbias", "dW",
                                            "dc"), rel)),
                   "grad_types_ok": all(gr.dtype == t.dtype for gr, t
                                        in zip(g_on, leaves)),
                   "finite": all_finite([y_on, *g_on]),
                   "launches_on": on, "launches_off": off}
            out[site] = res
            print(f"[ln_dense] {site}: " + json.dumps(res), flush=True)
            check(res["y_ok"] and res["grad_types_ok"] and res["finite"]
                  and max(rel) <= LN_PATH_GRAD_REL_L2,
                  f"ln_dense {site}: switch on drifts from off: {res}")
            del leaves, dy, y_on, g_on, y_off, g_off
        launches = counts()
        # -- end of the main path -----------------------------------------
        for i, site in enumerate(LN_SITES):     # forward + backward times
            leaves, dy = ln_path_inputs(site, b, s, seed=10 + i)
            out[site]["on_fwd_bwd_ms"] = time_cuda(
                lambda: ln_path_step(leaves, dy), 5)
            fbk.set_fused_ln_dense(False)
            try:
                out[site]["off_fwd_bwd_ms"] = time_cuda(
                    lambda: ln_path_step(leaves, dy), 5)
            finally:
                fbk.set_fused_ln_dense(True)
            print(f"[ln_dense] {site}: forward + backward, switch on "
                  f"{out[site]['on_fwd_bwd_ms']:.3f} ms, off "
                  f"{out[site]['off_fwd_bwd_ms']:.3f} ms", flush=True)
            del leaves, dy
    finally:
        fbk.set_fused_ln_dense(False)
    torch.cuda.empty_cache()
    return {"sites": out, "launches_fwd": launches[0],
            "launches_bwd": launches[1]}


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
    from mla_tpu_torch.device import set_matmul_precision
    set_matmul_precision()      # fp32 plain versions in full fp32, no TF32
    t_start = time.perf_counter()
    build_s, sass, q8_sass, conv_sass = phase_build()
    rows, bwd_rows = phase_kernels()
    head_rows, head_bwd_rows = phase_head_kernels()
    ln_rows, ln_bwd_rows = phase_ln_kernels()
    conv_rows, conv_dx_rows = phase_conv_kernels()
    q8_rows, mlp_rows = phase_q8_kernels()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        serving = phase_serving(work)
        av_serving = phase_av_serving(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    training = phase_training()
    av_training = phase_av_training()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        int8 = phase_int8_serving(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    head_training = phase_head_training(training["median_step_ms"])
    ln_path = phase_ln_dense()

    def main_shape(rs):
        return next(r for r in rs if r["shape"] == [64, 257, 12, 64]
                    and r["dtype"] == "bfloat16")

    fwd, bwd = main_shape(rows), main_shape(bwd_rows)
    common = {"route": "cuda", "at": "B=64 S=257 H=12 D=64 bf16"}
    kernels = [{"name": "flat_attention_fwd", **common,
                "source": "mla_tpu_torch/ops/csrc/flat_attention.cu",
                "replaces": "mla_tpu/ops/attention.py:322",
                # serving dispatches + training steps, eval, joint, QMF
                "launches": serving["launches"] + training["launches_fwd"],
                "max_abs_err": fwd["max_abs_err"],
                "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
                "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
                "library_ms": fwd["library_ms"],
                "repeat_bitwise": all(r["repeat_bitwise"] for r in rows),
                # over every case of phase 3 (both dtypes, D=80, S=9)
                "max_abs_err_all": max(r["max_abs_err"] for r in rows),
                "all_ok": all(r["ok"] for r in rows)},
               {"name": "flat_attention_bwd", **common,
                "source": "mla_tpu_torch/ops/csrc/flat_attention_bwd.cu",
                "replaces": "mla_tpu/ops/attention.py:386",
                "launches": training["launches_bwd"],
                "max_abs_err": bwd["max_abs_err"],
                "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
                # SDPA's backward alone; its forward + backward is set
                # beside B1f + B1b
                "library_ms": bwd["library_ms"],
                "library_device_ms": bwd["library_device_ms"],
                "library_fwd_bwd_ms": bwd["library_fwd_bwd_ms"],
                "fwd_plus_bwd_ms": bwd["fwd_plus_bwd_ms"],
                "tflops": bwd["tflops"],
                "repeat_bitwise": all(r["repeat_bitwise"] for r in bwd_rows),
                "max_abs_err_all": max(r["max_abs_err"] for r in bwd_rows),
                "all_ok": all(r["ok"] for r in bwd_rows)}]
    conv = next(r for r in conv_rows
                if r["name"] == "vis_l1" and r["dtype"] == "bfloat16")
    kernels.append({
        "name": "conv3x3", "route": "cuda",
        "at": "B=192 H=W=56 C=F=64 bf16 (visual layer 1)",
        "source": "mla_tpu_torch/ops/csrc/conv3x3.cu",
        "replaces": "mla_tpu/ops/conv3x3.py:95",
        # AV serving dispatches + AV training steps, eval, joint, QMF
        "launches": av_serving["launches"] + av_training["launches"],
        "max_abs_err": conv["max_abs_err"], "ms": conv["ms"],
        "device_ms": conv["device_ms"],
        "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
        "bound_by": conv["bound_by"], "library_ms": conv["library_ms"],
        "library_device_ms": conv["library_device_ms"],
        "tflops": conv["tflops"],
        "repeat_bitwise": all(r["repeat_bitwise"] for r in conv_rows),
        "max_abs_err_all": max(r["max_abs_err"] for r in conv_rows),
        "all_ok": all(r["ok"] for r in conv_rows + conv_dx_rows)})
    def q8_entry(name, replaces, rows_of, at, launches):
        """The weight-only row at ``at`` in the main fields, its W8A8 twin
        under a8_*; every case's error and verdict."""
        main_ = next(r for r in rows_of if at(r) and not r["a8"])
        twin = next(r for r in rows_of if at(r) and r["a8"])
        return {"name": name, "route": "cuda", "source": (
            "mla_tpu_torch/ops/csrc/q8_mlp.cu" if name == "q8_mlp_stacked"
            else "mla_tpu_torch/ops/csrc/q8_matmul.cu"),
                "replaces": replaces, "launches": launches,
                "at": f"{main_['rows']} rows, weight-only "
                      f"(a8_*: W8A8)",
                "max_abs_err": main_["max_abs_err"], "ms": main_["ms"],
                "plain_ms": main_["plain_ms"], "bound_ms": main_["bound_ms"],
                "bound_by": main_["bound_by"],
                "library_ms": main_["library_ms"],
                "a8_max_abs_err": twin["max_abs_err"], "a8_ms": twin["ms"],
                "a8_plain_ms": twin["plain_ms"],
                "a8_bound_ms": twin["bound_ms"],
                "a8_bound_by": twin["bound_by"],
                "a8_library_ms": twin["library_ms"],
                # W8A8 ms include the row quantization; this is it alone
                "a8_quantize_ms": twin["quantize_ms"],
                "tops": main_["tops"], "a8_tops": twin["tops"],
                "max_abs_err_all": max(r["max_abs_err"] for r in rows_of),
                "all_ok": all(r["ok"] for r in rows_of)}

    q8_total = {k: sum(int8[a]["launches"][k] for a in
                       ("int8", "int8_scan", "int8_a8_scan"))
                for k in ("B4", "B5", "B6", "B1f")}
    kernels[0]["launches"] += q8_total["B1f"]
    b4 = [r for r in q8_rows if not r["stacked"]]
    b5 = [r for r in q8_rows if r["stacked"]]
    kernels += [
        q8_entry("q8_matmul", "mla_tpu/ops/q8_matmul.py:138", b4,
                 lambda r: r["site"] == "qkv" and r["rows"] == 16448,
                 q8_total["B4"]),
        q8_entry("q8_matmul_stacked", "mla_tpu/ops/q8_matmul.py:217", b5,
                 lambda r: r["site"] == "qkv" and r["rows"] == 16448,
                 q8_total["B5"]),
        q8_entry("q8_mlp_stacked", "mla_tpu/ops/q8_matmul.py:435", mlp_rows,
                 lambda r: r["rows"] == 16448, q8_total["B6"])]
    hf, hb = main_shape(head_rows), main_shape(head_bwd_rows)
    kernels += [
        {"name": "head_attention", **common,
         "source": "mla_tpu_torch/ops/csrc/flat_attention.cu",
         "replaces": "mla_tpu/ops/attention.py:94",
         "launches": head_training["launches"]["B2f"],
         "max_abs_err": hf["max_abs_err"], "ms": hf["ms"],
         "plain_ms": hf["plain_ms"], "bound_ms": hf["bound_ms"],
         "bound_by": hf["bound_by"], "library_ms": hf["library_ms"],
         "repeat_bitwise": all(r["repeat_bitwise"] for r in head_rows),
         # over every case of phase 3 (both dtypes, D=80, S=9, S=1360)
         "max_abs_err_all": max(r["max_abs_err"] for r in head_rows),
         "all_ok": all(r["ok"] for r in head_rows)},
        {"name": "head_attention_bwd", **common,
         "source": "mla_tpu_torch/ops/csrc/flat_attention_bwd.cu",
         "replaces": "mla_tpu/ops/attention.py:200",
         "launches": head_training["launches"]["B2b"],
         "max_abs_err": hb["max_abs_err"], "ms": hb["ms"],
         "plain_ms": hb["plain_ms"], "bound_ms": hb["bound_ms"],
         "bound_by": hb["bound_by"], "library_ms": hb["library_ms"],
         "library_device_ms": hb["library_device_ms"],
         "library_fwd_bwd_ms": hb["library_fwd_bwd_ms"],
         "fwd_plus_bwd_ms": hb["fwd_plus_bwd_ms"],
         "tflops": hb["tflops"],
         "repeat_bitwise": all(r["repeat_bitwise"] for r in head_bwd_rows),
         "max_abs_err_all": max(r["max_abs_err"] for r in head_bwd_rows),
         "all_ok": all(r["ok"] for r in head_bwd_rows)}]

    def ln_main(rs):
        return next(r for r in rs if r["site"] == "qkv"
                    and r["rows"] == 16448 and r["dtype"] == "bfloat16")

    lf, lb = ln_main(ln_rows), ln_main(ln_bwd_rows)
    ln_common = {"route": "cuda", "at": "qkv site, 16448 x 768 -> 2304 bf16",
                 "source": "mla_tpu_torch/ops/csrc/ln_dense.cu"}
    kernels += [
        {"name": "ln_dense", **ln_common,
         "replaces": "mla_tpu/ops/fused_block.py:116",
         "launches": ln_path["launches_fwd"],
         "max_abs_err": lf["max_abs_err"], "ms": lf["ms"],
         "plain_ms": lf["plain_ms"], "bound_ms": lf["bound_ms"],
         "bound_by": lf["bound_by"], "library_ms": lf["library_ms"],
         "max_abs_err_all": max(r["max_abs_err"] for r in ln_rows),
         "all_ok": all(r["ok"] for r in ln_rows)},
        {"name": "ln_dense_bwd", **ln_common,
         "replaces": "mla_tpu/ops/fused_block.py:124",
         "launches": ln_path["launches_bwd"],
         "max_abs_err": lb["max_abs_err"], "ms": lb["ms"],
         "plain_ms": lb["plain_ms"], "bound_ms": lb["bound_ms"],
         "bound_by": lb["bound_by"], "library_ms": lb["library_ms"],
         "fwd_plus_bwd_ms": lb["fwd_plus_bwd_ms"],
         "max_abs_err_all": max(r["max_abs_err"] for r in ln_bwd_rows),
         "all_ok": all(r["ok"] for r in ln_bwd_rows)}]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "attention_build": sass, "q8_build": q8_sass,
        "conv_build": conv_sass,
        "kernel_cases": rows, "bwd_kernel_cases": bwd_rows,
        "head_kernel_cases": head_rows, "head_bwd_kernel_cases": head_bwd_rows,
        "ln_kernel_cases": ln_rows, "ln_bwd_kernel_cases": ln_bwd_rows,
        "conv_kernel_cases": conv_rows, "conv_dx_cases": conv_dx_rows,
        "q8_kernel_cases": q8_rows, "q8_mlp_cases": mlp_rows,
        "serving": serving, "training": training,
        "av_serving": av_serving, "av_training": av_training,
        "int8_serving": int8, "head_training": head_training,
        "ln_dense_path": ln_path,
        "seconds": time.perf_counter() - t_start}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
