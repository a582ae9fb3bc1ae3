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
              wgmma of its kind (HGMMA weight-only, IGMMA W8A8), every
              bf16 conv one (conv3x3_wgmma_kernel<...>) and every bf16
              ln_dense GEMM one (ln_dense_{fwd,dh,dw}_wgmma_kernel<...>)
              HGMMA and no HMMA, printed with its ptxas registers and
              spills (the fp32 FMA ones listed beside them).
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
11. driver  — CREMA-D trained end to end through the port's CLI
              (cli.parse_args, then driver.run on the card) from files on
              disk: synthetic.make_cremad writes 192 + 64 seeded clips (4
              JPEG frames at CREMA-D's 360x480 video size, a (129, 626)
              spectrogram each), and the adapter (cv2 over the loader's 8
              workers, or the C++ decoder where it builds),
              the loader (pinned host batches, non_blocking copies) and the
              on-device frame transform feed the steps. --gs_flag, B=64,
              bf16 compute, 224x224 crops of 256x256 frames: 2 epochs with
              --pallas_conv on and --save_last, B3 launched 52 times a step
              and 26 an eval batch (364 in all); eval-only from the best
              checkpoint (its accuracy within one test clip); --resume from
              `last` for a third epoch; the same 2 epochs on the default
              route (--pallas_conv auto: cuDNN, no B3); the B3 run again
              under torch.profiler, epoch 1 split by the driver's spans
              (train loop, steps, transform, the wait for the loader,
              evaluate; device busy share of the train loop). Then the
              loader alone over an epoch (clips/s), the transform's time
              per batch
              (CUDA events and device time) and the transform on the card
              against the CPU at the full batch (64 x 3 frames, float32,
              max abs <= 5e-5), and whether the C++ decoder was built.
12. m3ae driver — the base M3AE classifier (Food-101, 101 classes, 768
              wide, 12 blocks, 256 tokens) trained end to end through the
              port's CLI (cli.parse_args, then driver.run on the card) from
              files on disk: synthetic.make_m3ae writes 192 + 64 seeded
              samples (a 384x512 JPEG, Food-101's longest side, and a
              256-token cache each), and the M3AE adapter (cv2
              over 8 workers, or the C++ decoder where it builds), the
              loader and the on-device cubic + jitter transform (its
              draws from each batch's generator) feed the steps.
              --gs_flag -dynamic, B=64, bf16 compute, 256x256 crops of the
              288x288 decode: 2 epochs with --save_last; eval-only from
              the best checkpoint with --export_dir (its accuracy and its
              eval batch's logits equal, bit for bit, to the training
              run's at the saved epoch; the artifact's token feature
              int32; one request through load_serving/run_batch against
              the eval model's logits, relative L2 <= 3e-2); --resume
              from `last` for a third epoch; the 2 epochs again under
              torch.profiler for epoch 1's split; one epoch under
              --scan_blocks --remat_blocks with each --remat_policy (full,
              dots): peak memory against the run without remat; every
              step's losses and the epoch's eval logits equal, bit for
              bit, to epoch 0 of the run without remat, so the recomputed
              backward through B1f/B1b is held; then bare MLA steps of
              the three configurations in turns (2 rounds x 6 steps):
              wall, host and device ms a step; one MVSA epoch (3
              classes); --pretrained_v
              from a seeded reference-layout file the phase writes (mae_v
              equal to the file). Every train step
              must launch B1f and B1b 24 times each (48 and 24 under
              remat: the recomputation relaunches B1f), every eval batch
              B1f 24 times, each read just before and just after the
              call; B2f/B2b, the plain attention and SDPA never. Then the
              loader alone, the transform's time per batch and the
              transform on the card against the CPU at the full batch with
              the jitter's factors fed (max abs <= 5e-5).
13. families driver — the JAX package's other three classifier families
              through the same CLI and driver, at full width from seeded
              synthetic trees of 192 + 64 samples, B=64, bf16 compute,
              fp32 master weights: CLIP (Food-101, --clip --gs_flag, 512-d
              feature npys; no kernel, so B1f must read 0); CAV-MAE
              (CREMA-D, --lorb large --gs_flag --cav_augnois, 1024 x 128
              fbanks and 360x480 frames; 11 + 1 blocks, 512 audio and 196
              visual tokens, no padding mask): 2 epochs with --save_last,
              eval-only from the best checkpoint with --export_dir (the
              best epoch's accuracy and logits, bit for bit; one request
              served against the eval model, relative L2 <= 3e-2), bf16,
              int8 and int8_a8 artifacts (96 B4 a dispatch; fused logits
              at n=64 against the bf16 artifact's within phase 8's limits),
              --resume from `last`, one --cav_opti --cav_lrs epoch, the
              MLA run again traced (epoch 1's split), and the fbank
              transform's ms a batch and card-vs-CPU error with its draws
              fed (<= 5e-5); the IEMOCAP 3-modal classifier (--lorb m3ae
              --modal3 --gs_flag -dynamic, CAV-MAE audio beside base M3AE
              image and text): 2 epochs, eval-only with --export_dir and a
              served request, --scan_blocks int8 and int8_a8 artifacts (B4
              49, B5 48, B6 24 a dispatch), one QMF epoch under
              --mask_percent 0.5, the MLA run traced; then one fp32 B=2
              MLA step of CAV-MAE and of the 3-modal classifier on the
              card against the CPU (momentum relative L2 <= 1e-3). Every
              train step must launch B1f/B1b 24 + 24 (CAV-MAE) or 36 + 36
              (3-modal) times and every eval batch B1f 24 or 36 times,
              read just before and just after each call; B2f/B2b, the
              plain attention and SDPA never. Phase 3's attention rows
              include CAV-MAE's calls: B=64, H=12, D=64 at S=512 and
              S=196 with no mask, bf16 and fp32.
14. etl     — the port's offline ETL CLI (etl.cli.main, --device cuda) over
              raw media the phase writes: 192 + 64 CREMA-D-like clips, each
              a 16 kHz int16 wav of 2.0-3.5 s (one of 320 samples, shorter
              than a fbank frame) and a 360x480 30 fps MJPG video of 2.5 s
              (cv2 writes it without ffmpeg; mp4-to-wav runs over a tone
              that ffmpeg writes where an ffmpeg binary is on PATH, and
              the phase says so where none is). gen-txt (--test_frac 0.25) and
              gen-stat write the lists; video-frames (--fps 1) the frames;
              extract-spec the (129, 626) spectrograms of one root and
              extract-fbank the 1024 x 128 fbanks of a second root that
              shares the frames; extract-fbank --mix_dir --mix_lambda 0.3,
              extract-token --vocab and preprocess-iemo over 8 clips each.
              extract-spec, extract-fbank and the mixup on the card against
              the CPU over 8 clips (max abs <= 1e-3 in the log domain; the
              320-sample clip's fbank all zeros on both), files/s of each
              and one file under torch.profiler. Then the CLI trains from
              the ETL's trees: CREMA-D --lorb base --gs_flag --pallas_conv
              on, 1 epoch with --export_torch (B3 52 a step, 26 an eval
              batch: 182), CAV-MAE --lorb large --gs_flag, 1 epoch (B1f/B1b
              24 + 24 a step, 24 an eval batch);
              `python -m mla_tpu_torch.runtime.parity --reference ""` from
              the .pth (the eval-only branch: 26 B3, the training run's
              accuracy for the exported weights); FiLM and
              GatedFusion (width 512, B=64, each switch) on the card
              against the CPU (relative L2 <= 1e-5 fp32, <= 1e-2 bf16).

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
in bf16 and fp32, each run twice for bitwise equality, with the kernels'
device time alone (device_ms, torch.profiler) and the library pair's
(F.layer_norm + F.linear, forward and autograd backward:
library_device_ms), and B7b's dW row splits.

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
    lib = libs[KERNEL_SOURCES.index("ln_dense")]
    counts = sass_mma_counts(lib, ln_function)
    reports = ptxas_reports(lib.with_suffix(".log"), ln_function)
    ln = {f: {**counts.get(f, {}), **reports.get(f, {})}
          for f in sorted(set(counts) | set(reports))}
    print("[build] ln_dense: wgmma (HGMMA) and mma.sync (HMMA) instructions "
          "and the ptxas report per kernel function: " + json.dumps(ln),
          flush=True)
    # every bf16 GEMM (forward, dh, dW; one per x type and tile width) runs
    # wgmma and no mma.sync; the fp32 FMA ones and the row passes have none
    bf16 = {k: v for k, v in ln.items() if "_wgmma_" in k}
    check(len(bf16) == LN_WGMMA_FUNCTIONS and all(
        v.get("HGMMA", 0) > 0 and v.get("HMMA", 0) == 0
        for v in bf16.values()),
          f"a bf16 ln_dense GEMM kernel function has no wgmma instruction "
          f"(or an mma.sync one): {ln}")
    return secs, sass, q8, conv, ln


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


# csrc/ln_dense.cu's bf16 GEMMs: the forward <x bf16, 128 | 256>, dh <128 |
# 256>, dW <x bf16>
LN_WGMMA_FUNCTIONS = 4 + 2 + 2


def ln_function(mangled: str):
    """'ln_dense_fwd_wgmma_kernel<1, 256>' or 'ln_dense_reduce_kernel' for
    an ln_dense kernel function's mangled name, else None."""
    import re
    m = re.search(r"(ln_dense_[a-z_]+_kernel)(I(?:L[bi]\d+E)+E)?", mangled)
    if m is None:
        return None
    args = re.findall(r"L[bi](\d+)E", m[2] or "")
    return f"{m[1]}<{', '.join(args)}>" if args else m[1]


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
                   reps=20, no_mask=False):
    """B1f against its plain version; ``no_mask``: no padding mask (the
    CAV-MAE blocks' call), the kernel reading the zeros its wrapper
    allocates, SDPA called without a mask."""
    from mla_tpu_torch.ops.attention import (flash_attention_flat,
                                             flat_attention_reference)
    rng = np.random.default_rng(seed)
    c = h * d
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * c)).astype(
        np.float32)).to("cuda", dtype)
    mask_np = text_mask(rng, b, s)
    if fully_masked_row:
        mask_np[-1, :] = 1.0
    mask = None if no_mask else torch.from_numpy(mask_np).cuda()
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
    # the function reads no mask when it has none
    nbytes = b * s * 3 * c * es + (0 if no_mask else b * s * 4) \
        + b * s * c * es
    flops = 4 * b * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    q, k, v = (qkv[..., i * c:(i + 1) * c].view(b, s, h, d).transpose(1, 2)
               for i in range(3))
    bias = None if no_mask else (mask * -1e7).to(dtype)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
           "no_mask": no_mask,
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
                       reps=10, no_mask=False):
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
    mask = None if no_mask else torch.from_numpy(mask_np).cuda()
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
    nbytes = 2 * b * s * 3 * c * es + b * s * c * es \
        + (0 if no_mask else b * s * 4)
    # recomputed scores, dp, dq, dk, dv: five (S, S, D) products per head
    flops = 10 * b * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    q, k, v = (qkv[..., i * c:(i + 1) * c].view(b, s, h, d).transpose(1, 2)
               for i in range(3))
    g = do.view(b, s, h, d).transpose(1, 2)
    bias = None if no_mask else (mask * -1e7).to(dtype)[:, None, None, :]

    library_ms, library_fwd_bwd_ms, library_device_ms = time_sdpa_bwd(
        q, k, v, g, bias, reps)
    row = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
           "no_mask": no_mask,
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
            # CAV-MAE's blocks (phase 13): 512 audio tokens (1024 fbank
            # frames x 128 mel bins, 16x16 patches) and 196 visual ones
            # (224^2), no padding mask
            for s in (512, 196):
                out.append(case(64, s, 12, 64, dtype, seed=s, no_mask=True))
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


def kernel_device_breakdown(fn, name: str, calls: int = 10) -> dict:
    """kernel_device_ms of each kernel whose name holds ``name``, by the
    kernel's function name: where a multi-kernel call spends its time."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^.*::|\(.*$", "", e.key): e.self_device_time_total
            / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes: equal bits across two checkouts."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


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
    kernel = lambda: ln_dense_fwd(x, sc, bi, w, db, 1e-5, dtype)  # noqa: E731
    got = kernel()
    torch.cuda.synchronize()
    # no atomics, no split sums: a second call gives the same bits
    same = bool(torch.equal(got, kernel()))
    want = ln_dense_reference(x, sc, bi, w, db, 1e-5, dtype)
    es = x.element_size()
    wc, sc_c, bi_c, db_c = (t.to(dtype) for t in (w, sc, bi, db))
    library = lambda: F.linear(F.layer_norm(  # noqa: E731
        x, (c,), sc_c, bi_c), wc, db_c)
    err, ok = ulp_err(got, want, *LN_TOL[dtype]["y"])
    row = {"site": site, "rows": n, "c": c, "f": f,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": LN_TOL[dtype]["y"],
           "repeat_bitwise": same, "ok": ok and same,
           "digest": digest([got]),
           "ms": time_cuda(kernel, reps),
           # the statistics pass and the GEMM (bf16) or the FMA kernel
           # alone, without the weight's cast and the host
           "device_ms": kernel_device_ms(kernel, "ln_dense_"),
           "device_kernels": kernel_device_breakdown(kernel, "ln_dense_"),
           "plain_ms": time_cuda(lambda: ln_dense_reference(
               x, sc, bi, w, db, 1e-5, dtype), max(reps // 4, 3)),
           # yardstick only, never called by the port
           "library_ms": time_cuda(library, reps),
           "library_device_ms": kernel_device_ms(library),
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
    from mla_tpu_torch.ops import fused_block as fbk
    c, f = LN_SITES[site]
    x, sc, bi, w, db, dy = ln_inputs(n, c, f, dtype, seed)
    kernel = lambda: ln_dense_bwd(x, sc, bi, w, dy, 1e-5, dtype)  # noqa: E731
    got = kernel()
    again = kernel()
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
    library = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, dy, retain_graph=True)
    es = x.element_size()
    row = {"site": site, "rows": n, "c": c, "f": f,
           "dtype": str(dtype).replace("torch.", ""),
           # dW's row splits on this card (a checkout without them: None)
           "splits": fbk.ln_dense_bwd_splits(n, c, f, dtype)
           if hasattr(fbk, "ln_dense_bwd_splits") else None,
           "max_abs_err": max(errs.values()), "errs": errs, "oks": oks,
           "deterministic": same, "repeat_bitwise": same,
           "ok": all(oks.values()) and same,
           "digest": digest(got),
           "ms": time_cuda(kernel, reps),
           # the four or five kernels alone, without the weight's cast,
           # the scratch allocations and the host
           "device_ms": kernel_device_ms(kernel, "ln_dense_"),
           "device_kernels": kernel_device_breakdown(kernel, "ln_dense_"),
           "plain_ms": time_cuda(lambda: ln_dense_bwd_reference(
               x, sc, bi, w, dy, 1e-5, dtype), 3),
           "fwd_ms": time_cuda(lambda: ln_dense_fwd(x, sc, bi, w, db, 1e-5,
                                                    dtype), reps),
           # yardstick only: the library pair's autograd backward alone
           "library_ms": time_cuda(library, reps),
           "library_device_ms": kernel_device_ms(library),
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

# ---------------------------------------------------------------- phase 11

DRIVER_TRAIN, DRIVER_TEST = 192, 64   # 3 MLA steps + 1 eval batch an epoch
DRIVER_EPOCHS = 2
DRIVER_SPEC = (129, 626)              # the CREMA-D log-spectrogram
DRIVER_FRAME_HW = (360, 480)          # CREMA-D's video size (480 x 360)
DRIVER_WORKERS = 8                    # the CLI's default --num_workers
TRANSFORM_TOL = 5e-5                  # float32 after normalisation (x ~4.4)


def driver_argv(root: Path, ckpt: Path, *extra) -> list:
    """A user's command line of the port's CLI for the CREMA-D MLA run at
    bench.py:bench_tpu's configuration (--lorb base --gs_flag, B=64, bf16
    compute, 224x224 crops of 256x256 frames, 3 frames a clip)."""
    return ["--device", "cuda", "--train", "--dataset", "CREMAD",
            "--lorb", "base", "--gs_flag", "--batch_size", str(AV_BATCH),
            "--epochs", str(DRIVER_EPOCHS), "--data_root", str(root),
            "--ckpt_path", str(ckpt), "--num_workers", str(DRIVER_WORKERS),
            "--no-use_tensorboard", *extra]


def driver_run(argv, label):
    """cli.main's path (parse, then driver.run on the card), returning
    what run returns and the B3 launches it made (counter 0 just before,
    read just after)."""
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    from mla_tpu_torch.runtime.cli import parse_args
    from mla_tpu_torch.runtime.driver import run

    cfg, device = parse_args(argv)
    check(device == "cuda", f"{label}: device {device}")
    conv3x3.launches = 0
    t = time.perf_counter()
    state, result = run(cfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = conv3x3.launches
    summary = result.get("history", result)
    print(f"[driver] {label}: {wall:.2f} s, {launches} B3 launches; "
          f"{json.dumps(summary)}", flush=True)
    return cfg, state, result, launches, wall


def epoch_line(res):
    """Epoch 1: the train loop's time and rate (``train_s``, the steps'
    results read back), and the epoch's with its evaluation."""
    h = next(x for x in res["history"] if x["epoch"] == 1)
    return {"loss": h["loss"], "acc": h["acc"], "train_s": h["train_s"],
            "wall_s": h["wall_s"],
            "train_clips_per_s": DRIVER_TRAIN / h["train_s"],
            "epoch_clips_per_s": (DRIVER_TRAIN + DRIVER_TEST) / h["wall_s"]}


def epoch_split(prof, epoch: int) -> dict:
    """One epoch of a traced driver run, read from the driver's spans
    (``mla.train`` the train loop, ``mla.step`` each step's call,
    ``mla.transform`` each batch's device transform, ``mla.evaluate``):
    host ms of each; the rest of the train loop (waiting on the loader's
    producer, the copies' enqueue); the device's busy share of the train
    loop (the union of its kernels and copies over the loop's wall); the
    device ms launched inside the transform and eval spans (a step's
    backward runs on autograd's device thread, outside its span, so a
    step's device time is read from the union instead)."""
    from torch.autograd import DeviceType

    evs = list(prof.events())

    def spans(name, lo=None, hi=None):
        out = sorted((e for e in evs if e.name == name
                      and e.device_type == DeviceType.CPU),
                     key=lambda e: e.time_range.start)
        if lo is None:
            return out
        return [e for e in out
                if lo <= e.time_range.start and e.time_range.end <= hi]

    def host_ms(es):
        return sum(e.time_range.elapsed_us() for e in es) / 1e3

    def device_ms(es):
        return sum(e.device_time_total for e in es) / 1e3

    train = spans("mla.train")[epoch]
    lo, hi = train.time_range.start, train.time_range.end
    steps, tf = spans("mla.step", lo, hi), spans("mla.transform", lo, hi)
    ev = spans("mla.evaluate")[epoch]
    busy, end = 0.0, lo
    for a, b in sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                       for e in evs if e.device_type == DeviceType.CUDA
                       and not e.name.startswith("mla.")
                       and e.time_range.end > lo and e.time_range.start < hi):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    loop_ms = host_ms([train])
    return {"train_ms": loop_ms, "steps": len(steps),
            "step_host_ms": host_ms(steps),
            "transforms": len(tf), "transform_host_ms": host_ms(tf),
            "transform_device_ms": device_ms(tf),
            "loader_wait_ms": loop_ms - host_ms(steps) - host_ms(tf),
            "train_device_busy_ms": busy / 1e3,
            "train_device_busy_share": busy / 1e3 / loop_ms,
            "eval_ms": host_ms([ev]), "eval_device_ms": device_ms([ev])}


def phase_driver(work: Path):
    """Phase 11: CREMA-D trained end to end through the port's CLI and
    driver, from files on disk (synthetic.make_cremad, seeded), at full
    width and depth: 2 epochs with --pallas_conv on and --save_last (B3
    52 x 3 steps + 26 x 1 eval batch an epoch), eval-only from the best
    checkpoint, --resume from `last` for a third epoch, and the same 2
    epochs on the default route (--pallas_conv auto: cuDNN, no B3), and
    the B3 run once more under torch.profiler for epoch 1's split. Then
    the loader alone over an epoch, the transform's device time per batch,
    and the on-device transform against the CPU's at the full batch."""
    from mla_tpu_torch.data import native_loader, synthetic
    from mla_tpu_torch.data.datasets import build_adapter
    from mla_tpu_torch.data.pipeline import Loader, pad_rows
    from mla_tpu_torch.data.transforms import av_frames_transform
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib

    root = work / "cremad"
    t = time.perf_counter()
    synthetic.make_cremad(str(root), n_train=DRIVER_TRAIN, n_test=DRIVER_TEST,
                          spec_shape=DRIVER_SPEC, learnable=True,
                          frame_hw=DRIVER_FRAME_HW)
    native = native_loader.available()
    jpgs = list(root.glob("visual/*/Image-01-FPS/*/*.jpg"))
    jpg_kb = sum(f.stat().st_size for f in jpgs) / len(jpgs) / 1e3
    print(f"[driver] wrote the CREMA-D tree ({DRIVER_TRAIN} + {DRIVER_TEST} "
          f"clips, 4 {DRIVER_FRAME_HW} JPEG frames of {jpg_kb:.1f} kB on "
          f"average and a {DRIVER_SPEC} spectrogram each) in "
          f"{time.perf_counter() - t:.1f} s; native decoder built: {native}",
          flush=True)
    out = {"native_decoder": native, "frame_hw": list(DRIVER_FRAME_HW),
           "jpeg_kb": jpg_kb, "num_workers": DRIVER_WORKERS}

    # -- the main path: 2 epochs, B3 on ------------------------------------
    ck = work / "ck_on"
    cfg, state, res, launches, wall = driver_run(
        driver_argv(root, ck, "--pallas_conv", "on"), "train, B3 on")
    expect = (2 * 2 * B3_SITES * DRIVER_TRAIN // AV_BATCH
              + 2 * B3_SITES * DRIVER_TEST // AV_BATCH) * DRIVER_EPOCHS
    check(launches == expect, f"driver: {launches} B3 launches, {expect} "
          "expected (52 a step, 26 an eval batch)")
    hist = res["history"]
    check([h["epoch"] for h in hist] == [0, 1]
          and all(np.isfinite(h[k]) for h in hist
                  for k in ("loss", "loss_a", "loss_v", "acc")),
          f"driver history {hist}")
    check(all_finite(state.params.values()), "driver: non-finite parameter")
    best = sorted(n for n in os.listdir(ck) if n.startswith("best_model")
                  and not n.endswith(".json"))
    last = ck / "last"
    check(best and (ck / best[-1] / ckpt_lib.STATE_FILE).is_file()
          and (last / ckpt_lib.STATE_FILE).is_file()
          and ckpt_lib.load_meta(str(last))["saved_epoch"] == 1,
          f"driver checkpoints: {sorted(os.listdir(ck))}")
    out["on"] = {"epoch1": epoch_line(res), "launches": launches,
                 "run_s": wall, "best_acc": res["best_acc"],
                 "history": hist}
    del state

    # eval-only from the best checkpoint
    _, _, accs, ev_launches, _ = driver_run(
        [a for a in driver_argv(root, ck / best[-1], "--pallas_conv", "on")
         if a != "--train"], "eval-only, best checkpoint")
    check(ev_launches == 2 * B3_SITES * DRIVER_TEST // AV_BATCH,
          f"eval-only: {ev_launches} B3 launches")
    check(abs(accs["acc"] - res["best_acc"]) <= 1.0 / DRIVER_TEST + 1e-9,
          f"eval-only accuracy {accs['acc']} against the best "
          f"{res['best_acc']}")
    # --resume from `last` for a third epoch
    _, st3, res3, rs_launches, _ = driver_run(
        driver_argv(root, ck, "--pallas_conv", "on", "--resume", str(last),
                    "--epochs", str(DRIVER_EPOCHS + 1)), "resume, epoch 2")
    check([h["epoch"] for h in res3["history"]] == [2]
          and np.isfinite(res3["history"][0]["loss"])
          and all_finite(st3.params.values()), f"resume: {res3}")
    check(rs_launches == expect // DRIVER_EPOCHS,
          f"resume: {rs_launches} B3 launches")
    out.update(eval_only={"acc": accs["acc"], "launches": ev_launches},
               resume={"history": res3["history"], "launches": rs_launches})
    launches += ev_launches + rs_launches
    del st3
    torch.cuda.empty_cache()

    # -- the yardstick: the default route (auto = cuDNN) --------------------
    _, st_off, res_off, off_launches, off_wall = driver_run(
        driver_argv(root, work / "ck_auto"), "train, --pallas_conv auto")
    check(off_launches == 0, f"default route: {off_launches} B3 launches")
    check(all(np.isfinite(h["loss"]) for h in res_off["history"]),
          f"default route history {res_off['history']}")
    out["auto"] = {"epoch1": epoch_line(res_off),
                   "run_s": off_wall, "history": res_off["history"]}
    del st_off
    torch.cuda.empty_cache()

    # -- where epoch 1's time goes: the B3 run again, under torch.profiler -
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st_tr, res_tr, _, _ = driver_run(
            driver_argv(root, work / "ck_trace", "--pallas_conv", "on"),
            "train, B3 on, traced")
    split = epoch_split(prof, 1)
    check(split["steps"] == DRIVER_TRAIN // AV_BATCH
          and split["transforms"] == DRIVER_TRAIN // AV_BATCH
          and 0 < split["train_device_busy_share"] <= 1.0,
          f"trace of epoch 1: {split}")
    out["trace_epoch1"] = {**split, "wall_s": epoch_line(res_tr)["wall_s"]}
    del st_tr, prof
    torch.cuda.empty_cache()

    # -- the loader alone: host decode + pinned H2D + on-device transform --
    adapter = build_adapter(cfg, "train")
    loader = Loader(adapter, AV_BATCH, seed=0, num_workers=DRIVER_WORKERS,
                    device="cuda")
    for _ in loader.epoch(0):        # warm: file cache, pinned blocks
        pass
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = 0
    for batch in loader.epoch(1):
        n += int(batch["valid"].sum())
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t
    check(n == DRIVER_TRAIN, f"loader epoch: {n} clips")

    # -- the transform: device time per batch, card against CPU -----------
    # one batch's pieces: host IO + geometry (over the loader's workers),
    # pinned staging, the copy
    idx = list(range(AV_BATCH))
    t = time.perf_counter()
    with ThreadPoolExecutor(DRIVER_WORKERS) as pool:
        hb = pad_rows(adapter.batch_host(
            idx, [np.random.default_rng((0, 0, i)) for i in idx], pool.map),
            AV_BATCH, AV_BATCH, len(adapter))
    host_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    staged = loader._stage(hb)
    stage_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = {k: v.to("cuda", non_blocking=True) for k, v in staged.items()}
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t) * 1e3
    nbytes = sum(v.numel() * v.element_size() for v in staged.values())
    del on_card
    cpu = [torch.from_numpy(hb[k]) for k in ("frames", "boxes", "flip")]
    dev = [x.cuda() for x in cpu]

    def transform():
        return av_frames_transform(*dev, out=cfg.image_size or 224,
                                   out_dtype=torch.bfloat16)

    tf_ms = time_cuda(transform, reps=10)
    prof = profile_call(transform)
    got = av_frames_transform(*dev, out=224).float().cpu()
    want = av_frames_transform(*cpu, out=224)
    err = float((got - want).abs().max())
    check(err <= TRANSFORM_TOL, f"transform on the card against the CPU: "
          f"max abs {err:.3g} > {TRANSFORM_TOL}")
    train_s = out["on"]["epoch1"]["train_s"]
    out.update(loader={"epoch_s": loader_s,
                       "clips_per_s": DRIVER_TRAIN / loader_s,
                       "share_of_train_loop_on": loader_s / train_s,
                       "batch_host_ms": host_ms, "pin_ms": stage_ms,
                       "h2d_ms": h2d_ms, "h2d_bytes": nbytes},
               transform={"ms": tf_ms, "device_ms": prof["device_ms"],
                          "top": prof["top"][:6], "cpu_max_abs_err": err,
                          "tol": TRANSFORM_TOL},
               launches=launches)
    print(f"[driver] epoch 1, B3 on: {json.dumps(out['on']['epoch1'])}; "
          f"default route: {json.dumps(out['auto']['epoch1'])}", flush=True)
    print(f"[driver] epoch 1 traced (B3 on): "
          f"{json.dumps(out['trace_epoch1'])}", flush=True)
    print(f"[driver] loader alone: {loader_s:.3f} s an epoch, "
          f"{DRIVER_TRAIN / loader_s:.1f} clips/s "
          f"({100 * loader_s / train_s:.1f}% of epoch 1's train loop with "
          f"B3 on); one batch: host IO {host_ms:.1f} ms over "
          f"{DRIVER_WORKERS} workers, pinned staging {stage_ms:.1f} ms, copy "
          f"{h2d_ms:.2f} ms ({nbytes / 1e6:.1f} MB); transform "
          f"{tf_ms:.3f} ms a batch by CUDA events, device "
          f"{prof['device_ms']:.3f} ms; card vs CPU "
          f"max abs {err:.3g}; native decoder built: {native}", flush=True)
    return out



# ---------------------------------------------------------------- phase 12

M3AE_TRAIN, M3AE_TEST = 192, 64       # 3 MLA steps + 1 eval batch an epoch
M3AE_IMG_HW = (384, 512)              # Food-101's longest side is 512
M3AE_TOKENS = 256                     # the reference's token caches
M3AE_IMAGE = None                     # --image_size: None keeps 256 (288
                                      # decode); a rehearsal sets 32


def m3ae_argv(root: Path, ckpt: Path, *extra, dataset="Food101") -> list:
    """A user's command line of the port's CLI for the M3AE MLA run of
    PERF.md's M3AE training cell (--lorb m3ae --gs_flag -dynamic, B=64,
    bf16 compute, 256x256 crops)."""
    size = [] if M3AE_IMAGE is None else ["--image_size", str(M3AE_IMAGE)]
    return ["--device", "cuda", "--train", "--dataset", dataset,
            "--lorb", "m3ae", "--m3ae_size", TRAIN_SIZE, "--gs_flag",
            "-dynamic", "--batch_size", str(TRAIN_BATCH),
            "--compute_dtype", "bfloat16", "--epochs", str(DRIVER_EPOCHS),
            "--data_root", str(root), "--ckpt_path", str(ckpt),
            "--num_workers", str(DRIVER_WORKERS), "--no-use_tensorboard",
            *size, *extra]


class AttentionAudit:
    """The driver's run, watched: every train and eval step's B1f/B1b
    launches (read just before and just after the call), and each train
    step's losses and its span on the card's stream (CUDA events recorded
    around the call, read after the run: no synchronisation), through
    wrappers around the step factories the driver calls; every eval
    batch's logits (fused, then each modality's); calls of
    the plain attention (``attention_reference``,
    ``flat_attention_reference``) and of SDPA, which the card's path must
    never make."""

    def __init__(self):
        self.steps, self.evals, self.losses, self.plain = [], [], [], 0
        self.events, self.logits = [], []

    def __enter__(self):
        import torch.nn.functional as F
        from mla_tpu_torch.evals import metrics
        from mla_tpu_torch.ops import attention as attn
        from mla_tpu_torch.runtime import driver as drv

        self._saved = [(drv, "make_train_step", drv.make_train_step),
                       (drv, "make_eval_step", drv.make_eval_step),
                       (metrics, "eval_logits", metrics.eval_logits),
                       (attn, "attention_reference", attn.attention_reference),
                       (attn, "flat_attention_reference",
                        attn.flat_attention_reference),
                       (F, "scaled_dot_product_attention",
                        F.scaled_dot_product_attention)]
        audit = self

        def counted(make, into, losses):
            def factory(*a, **k):
                step = make(*a, **k)

                def run(*args, **kw):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)] if losses is not None else None
                    before = launch_counts()
                    if ev:
                        ev[0].record()
                    out = step(*args, **kw)
                    if ev:
                        ev[1].record()
                        audit.events.append(ev)
                    after = launch_counts()
                    into.append((after[0] - before[0], after[1] - before[1]))
                    if losses is not None:
                        losses.append({n: out[1][n].detach().clone()
                                       for n in ("loss", "loss_a", "loss_v")})
                    return out
                return run
            return factory

        def plain(fn):
            def call(*a, **k):
                audit.plain += 1
                return fn(*a, **k)
            return call

        def logits(fn):
            def call(*a, **k):
                out_m, fused = fn(*a, **k)
                audit.logits.append([fused.detach().clone()] + [
                    out_m[m].detach().clone() for m in sorted(out_m)])
                return out_m, fused
            return call

        drv.make_train_step = counted(drv.make_train_step, self.steps,
                                      self.losses)
        drv.make_eval_step = counted(drv.make_eval_step, self.evals, None)
        metrics.eval_logits = logits(metrics.eval_logits)
        for mod, name, fn in self._saved[3:]:
            setattr(mod, name, plain(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def step_ms(self):
        """Each train step's span on the stream, ms (after the run)."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def m3ae_driver_run(argv, label, per_step, per_eval=None):
    """cli.main's path (parse, then driver.run on the card) under an
    ``AttentionAudit``: every step must launch ``per_step`` (B1f, B1b) and
    every eval batch (``per_eval`` or depth x 2, 0) and nothing else; the
    run's B2f/B2b launches must be 0. Returns (cfg, state, result, audit,
    {B1f, B1b, ...} launches over the run, wall s, peak bytes)."""
    from mla_tpu_torch.runtime.cli import parse_args
    from mla_tpu_torch.runtime.driver import run

    cfg, device = parse_args(argv)
    check(device == "cuda", f"{label}: device {device}")
    depth = m3ae_depth()
    per_eval = per_eval or (2 * depth, 0)
    for fn in attention_kernels().values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with AttentionAudit() as audit:
        state, result = run(cfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = attention_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches["B2f"] == launches["B2b"] == 0 and audit.plain == 0,
          f"{label}: the head route or the plain attention ran: {launches}, "
          f"{audit.plain} plain calls")
    check(all(c == per_step for c in audit.steps),
          f"{label}: (B1f, B1b) per step {audit.steps}, {per_step} expected")
    check(all(c == per_eval for c in audit.evals),
          f"{label}: (B1f, B1b) per eval batch {audit.evals}, {per_eval} "
          "expected")
    check(launches["B1f"] == per_step[0] * len(audit.steps)
          + per_eval[0] * len(audit.evals)
          and launches["B1b"] == per_step[1] * len(audit.steps),
          f"{label}: {launches} over {len(audit.steps)} steps and "
          f"{len(audit.evals)} eval batches")
    summary = result.get("history", result)
    print(f"[m3ae] {label}: {wall:.2f} s, {len(audit.steps)} steps, "
          f"{len(audit.evals)} eval batches, B1f {launches['B1f']}, B1b "
          f"{launches['B1b']}, peak {peak / 2**30:.2f} GiB; "
          f"{json.dumps(summary)}", flush=True)
    return cfg, state, result, audit, launches, wall, peak


def remat_steps(cfgs: dict, rounds=2, n=6) -> dict:
    """Bare MLA steps of the phase's model under each remat policy
    (``cfgs``: policy or None -> config), in turns: ``rounds`` x policies,
    a fresh train state from seed 0 each, the same two batches. Per policy
    the median over rounds of a round's median past its first two steps:
    a step's wall ms (synchronised around it) and host ms (until the call
    returns), and the device ms of one profiled step."""
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(12)
    batches = [train_batch(rng, TRAIN_BATCH) for _ in range(2)]
    rows = {p: [] for p in cfgs}
    for _ in range(rounds):
        for p, cfg in cfgs.items():
            model = build_classifier(cfg, seed=0)
            spec = optim.make_spec(cfg)
            state = create_train_state(model, cfg, spec, seed=0)
            step = make_train_step(model, cfg, spec, len_dl=n + 1)
            lr = optim.lr_for_epoch(cfg, 0)
            wall, host = [], []
            for i in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, _ = step(state, batches[i % 2], lr, i)
                host.append(time.perf_counter() - t)
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t)
            dev = profile_call(lambda: step(state, batches[0], lr, n))
            rows[p].append((1e3 * np.median(wall[2:]),
                            1e3 * np.median(host[2:]), dev["device_ms"]))
            del model, state, step
            torch.cuda.empty_cache()
    return {p: {k: float(np.median([r[j] for r in rs])) for j, k in
                enumerate(("step_ms", "host_ms", "device_ms"))}
            for p, rs in rows.items()}


def same_logits(got, want) -> bool:
    """Two runs' eval logits (``AttentionAudit.logits``), bit for bit."""
    return len(got) == len(want) and all(
        len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        for a, b in zip(got, want))


def m3ae_depth() -> int:
    from mla_tpu_torch.models.m3ae import M3AE_CONFIGS
    return M3AE_CONFIGS[TRAIN_SIZE][1]


def m3ae_epoch_line(res, epoch=1):
    h = next(x for x in res["history"] if x["epoch"] == epoch)
    return {"loss": h["loss"], "acc": h["acc"], "train_s": h["train_s"],
            "wall_s": h["wall_s"],
            "train_samples_per_s": M3AE_TRAIN / h["train_s"],
            "epoch_samples_per_s": (M3AE_TRAIN + M3AE_TEST) / h["wall_s"]}


def write_reference_m3ae(path: Path, seed: int):
    """A seeded M3AE encoder checkpoint in the reference layout
    (DataParallel ``module.`` prefix, the reference's module names) at the
    phase's width; returns its state_dict."""
    from mla_tpu_torch.models.m3ae import M3AEConfig, M3AEEncoder
    enc = M3AEEncoder(M3AEConfig(TRAIN_SIZE)).to_empty(device="cpu")
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    sd = {"module." + k: v.clone() for k, v in enc.state_dict().items()}
    torch.save(sd, path)
    return sd


def phase_m3ae_driver(work: Path):
    """Phase 12: the M3AE image-text classifier trained end to end through
    the port's CLI and driver from files on disk (synthetic.make_m3ae,
    seeded: JPEGs at 384x512 and 256-token caches), at full width and
    depth: 2 epochs with --save_last, eval-only from the best checkpoint
    with --export_dir (one request through the artifact), --resume from
    `last` for a third epoch, the 2 epochs again under torch.profiler for
    epoch 1's split, one epoch under --remat_blocks 'full' and 'dots'
    (and bare steps of each policy in turns, timed), one MVSA epoch and
    --pretrained_v from a reference-layout file. Then
    the loader alone, the cubic + jitter transform's time per batch, and
    the transform on the card against the CPU at the full batch."""
    from mla_tpu_torch.data import native_loader, synthetic
    from mla_tpu_torch.data import transforms as T
    from mla_tpu_torch.data.datasets import build_adapter
    from mla_tpu_torch.data.pipeline import Loader, pad_rows
    from mla_tpu_torch.evals.metrics import eval_logits
    from mla_tpu_torch.ops import image as im
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib
    from mla_tpu_torch.runtime.cli import parse_args
    from mla_tpu_torch.runtime.export import load_serving
    from mla_tpu_torch.runtime.serve import run_batch

    depth = m3ae_depth()
    step_n = (2 * depth, 2 * depth)            # 2 sub-steps x depth blocks
    steps_an_epoch = -(-M3AE_TRAIN // TRAIN_BATCH)
    t = time.perf_counter()
    roots = {}
    for ds in ("Food101", "MVSA"):
        roots[ds] = work / ds
        synthetic.make_m3ae(str(roots[ds]), dataset=ds, n_train=M3AE_TRAIN,
                            n_test=M3AE_TEST, token_len=M3AE_TOKENS,
                            img_hw=M3AE_IMG_HW)
    native = native_loader.available()
    jpgs = list(roots["Food101"].glob("visual/*/*.jpg"))
    jpg_kb = sum(f.stat().st_size for f in jpgs) / len(jpgs) / 1e3
    print(f"[m3ae] wrote Food-101 and MVSA trees ({M3AE_TRAIN} + "
          f"{M3AE_TEST} samples each: a {M3AE_IMG_HW} JPEG of {jpg_kb:.1f} kB "
          f"on average and {M3AE_TOKENS} tokens) in "
          f"{time.perf_counter() - t:.1f} s; native decoder built: {native}",
          flush=True)
    out = {"native_decoder": native, "img_hw": list(M3AE_IMG_HW),
           "jpeg_kb": jpg_kb, "num_workers": DRIVER_WORKERS, "depth": depth}
    total = {"B1f": 0, "B1b": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def floats(losses):
        return [{k: float(v) for k, v in x.items()} for x in losses]

    def finite_history(hist, label):
        check(all(np.isfinite(h[k]) for h in hist
                  for k in ("loss", "loss_a", "loss_v", "acc")),
              f"{label}: history {hist}")

    # -- the main path: 2 epochs with --save_last ---------------------------
    ck = work / "ck"
    cfg, state, res, audit, launches, wall, peak = m3ae_driver_run(
        m3ae_argv(roots["Food101"], ck), "train", step_n)
    hist = res["history"]
    check([h["epoch"] for h in hist] == [0, 1]
          and len(audit.steps) == DRIVER_EPOCHS * steps_an_epoch
          and len(audit.evals) == DRIVER_EPOCHS * -(-M3AE_TEST // TRAIN_BATCH),
          f"train: epochs {hist}, {len(audit.steps)} steps")
    finite_history(hist, "train")
    check(all_finite(state.params.values()), "train: non-finite parameter")
    best = sorted(n for n in os.listdir(ck) if n.startswith("best_model")
                  and not n.endswith(".json"))
    last = ck / "last"
    check(bool(best) and (ck / best[-1] / ckpt_lib.STATE_FILE).is_file()
          and ckpt_lib.load_meta(str(last))["saved_epoch"] == 1,
          f"train checkpoints: {sorted(os.listdir(ck))}")
    first_loss = {k: float(v) for k, v in audit.losses[0].items()}
    epoch0_losses = audit.losses[:steps_an_epoch]
    eval_batches = len(audit.evals) // DRIVER_EPOCHS
    epoch_logits = [audit.logits[e * eval_batches:(e + 1) * eval_batches]
                    for e in range(DRIVER_EPOCHS)]
    step_ms = audit.step_ms()
    out["train"] = {"epoch1": m3ae_epoch_line(res), "launches": launches,
                    "run_s": wall, "peak_bytes": peak, "step_ms": step_ms,
                    # past the first step (allocator and library warm-up)
                    "step_ms_median": float(np.median(step_ms[1:])),
                    "best_acc": res["best_acc"], "history": hist,
                    "first_step_loss": first_loss}
    print(f"[m3ae] accuracy by epoch: {[h['acc'] for h in hist]}; epoch 1: "
          f"{json.dumps(out['train']['epoch1'])}", flush=True)
    add(launches)
    del state
    torch.cuda.empty_cache()

    # -- eval-only from the best checkpoint, exporting ----------------------
    art = work / "export"
    ev_argv = [a for a in m3ae_argv(roots["Food101"], ck / best[-1],
                                    "--export_dir", str(art))
               if a != "--train"]
    _, ev_state, accs, ev_audit, ev_launches, _, _ = m3ae_driver_run(
        ev_argv, "eval-only, best checkpoint, --export_dir", step_n)
    # the restored model is the trained one of the saved epoch: the same
    # accuracy and, bit for bit, the same logits on every eval batch
    saved = ckpt_lib.load_meta(str(ck / best[-1]))["saved_epoch"]
    check(not ev_audit.steps and accs["acc"] == res["best_acc"]
          and same_logits(ev_audit.logits, epoch_logits[saved]),
          f"eval-only accuracy {accs} against the best {res['best_acc']} "
          f"(epoch {saved}), or its logits differ from that epoch's")
    add(ev_launches)
    meta = json.loads((art / "meta.json").read_text())
    specs = meta["feature_specs"]
    check(specs["token"]["dtype"] == "int32"
          and specs["padding_mask"]["dtype"] == "float32",
          f"export: feature specs {specs}")
    side = M3AE_IMAGE or 256
    req = request(np.random.default_rng(12), 3, M3AE_TOKENS, side)
    flat_attention_fwd = attention_kernels()["B1f"]
    before = flat_attention_fwd.launches
    srv = load_serving(str(art), device="cuda")
    got = run_batch(srv, req)
    check(flat_attention_fwd.launches - before == 2 * depth,
          f"export: {flat_attention_fwd.launches - before} B1f launches a "
          "request")
    add({"B1f": flat_attention_fwd.launches - before, "B1b": 0})
    batch = {k: torch.from_numpy(v).cuda() for k, v in req.items()}
    batch["valid"] = torch.ones(3).cuda()
    ev_state.model.eval()
    with torch.inference_mode():
        before = flat_attention_fwd.launches
        out_m, fused = eval_logits(ev_state.model, cfg, batch,
                                   batch["valid"])
        total["B1f"] += flat_attention_fwd.launches - before
    want = {"fused": fused, "logits_a": out_m["a"], "logits_v": out_m["v"]}
    rel = {k: float(np.linalg.norm(got[k] - want[k].float().cpu().numpy())
                    / np.linalg.norm(want[k].float().cpu().numpy()))
           for k in want}
    check(all(v <= 3e-2 for v in rel.values()),
          f"export: the artifact's logits against the eval model's: {rel}")
    out["eval_only"] = {"acc": accs["acc"], "launches": ev_launches,
                        "feature_specs": specs, "export_rel_l2": rel}
    del srv, ev_state
    torch.cuda.empty_cache()

    # -- --resume from `last` for a third epoch ------------------------------
    _, st3, res3, _, rs_launches, _, _ = m3ae_driver_run(
        m3ae_argv(roots["Food101"], ck, "--resume", str(last), "--epochs",
                  str(DRIVER_EPOCHS + 1)), "resume, epoch 2", step_n)
    check([h["epoch"] for h in res3["history"]] == [2]
          and all_finite(st3.params.values()), f"resume: {res3}")
    finite_history(res3["history"], "resume")
    add(rs_launches)
    out["resume"] = {"history": res3["history"], "launches": rs_launches}
    del st3
    torch.cuda.empty_cache()
    # a base M3AE train state is 1.8 GB on disk: keep one run's at a time
    shutil.rmtree(ck, ignore_errors=True)

    # -- where epoch 1's time goes: the main run again, traced -------------
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st_tr, res_tr, _, tr_launches, _, _ = m3ae_driver_run(
            m3ae_argv(roots["Food101"], work / "ck_trace", "--no_save_last"),
            "train, traced", step_n)
    add(tr_launches)
    split = epoch_split(prof, 1)
    check(split["steps"] == steps_an_epoch
          and split["transforms"] == steps_an_epoch
          and 0 < split["train_device_busy_share"] <= 1.0,
          f"trace of epoch 1: {split}")
    out["trace_epoch1"] = {**split, "wall_s": m3ae_epoch_line(res_tr)["wall_s"]}
    del st_tr, prof
    torch.cuda.empty_cache()
    shutil.rmtree(work / "ck_trace", ignore_errors=True)

    # -- block remat: one epoch under each policy ---------------------------
    remat_argv = {None: m3ae_argv(roots["Food101"], work / "ck_remat")}
    out["remat"] = {}
    for policy in ("full", "dots"):
        remat_argv[policy] = m3ae_argv(
            roots["Food101"], work / "ck_remat", "--epochs", "1",
            "--no_save_last", "--scan_blocks", "--remat_blocks",
            "--remat_policy", policy)
        _, st, rr, ra, r_launches, r_wall, r_peak = m3ae_driver_run(
            remat_argv[policy], f"remat {policy}", (2 * step_n[0], step_n[1]))
        finite_history(rr["history"], f"remat {policy}")
        # the same weights and batches as epoch 0 without remat: every
        # step's losses (each after the last step's update) and the
        # epoch's eval logits must be equal bit for bit, so a wrong or
        # stale recomputation under the backward shows
        check(len(ra.losses) == len(epoch0_losses) and all(
            torch.equal(a[k], b[k]) for a, b in zip(ra.losses, epoch0_losses)
            for k in a) and same_logits(ra.logits, epoch_logits[0]),
            f"remat {policy}: the steps' losses {floats(ra.losses)} against "
            f"{floats(epoch0_losses)} without remat, or the epoch's eval "
            "logits differ")
        add(r_launches)
        out["remat"][policy] = {
            "epoch0": m3ae_epoch_line(rr, 0), "launches": r_launches,
            "run_s": r_wall, "peak_bytes": r_peak,
            "peak_over_no_remat": r_peak / peak,
            "first_step_loss": floats(ra.losses[:1])[0]}
        del st
        torch.cuda.empty_cache()
        shutil.rmtree(work / "ck_remat", ignore_errors=True)
    # the step under each policy, in turns on bare steps (the driver's
    # epochs are 3 steps beside the loader's threads: too few to time)
    steps = remat_steps({p: parse_args(a)[0] for p, a in remat_argv.items()})
    for p, r in steps.items():
        out["remat"].setdefault(p or "none", {}).update(
            r, **{f"{k}_over_no_remat": r[k] / steps[None][k] for k in r})

    # -- MVSA: one epoch, 3 classes ------------------------------------------
    _, st, rm, _, m_launches, _, _ = m3ae_driver_run(
        m3ae_argv(roots["MVSA"], work / "ck_mvsa", "--epochs", "1",
                  "--no_save_last", dataset="MVSA"), "MVSA", step_n)
    n_classes = int(st.model.fusion_module.fc_out.weight.shape[0])
    check(n_classes == 3, f"MVSA: {n_classes} classes")
    finite_history(rm["history"], "MVSA")
    add(m_launches)
    out["mvsa"] = {"history": rm["history"], "launches": m_launches}
    del st
    torch.cuda.empty_cache()
    shutil.rmtree(work / "ck_mvsa", ignore_errors=True)

    # -- --pretrained_v from a reference-layout file -------------------------
    pth = work / "m3ae_v.pth"
    sd = write_reference_m3ae(pth, seed=7)
    _, st, _, _, p_launches, _, _ = m3ae_driver_run(
        m3ae_argv(roots["Food101"], work / "ck_pre", "--epochs", "0",
                  "--pretrained_v", str(pth)), "--pretrained_v", step_n)
    live = st.model.state_dict()
    mismatched = [k for k, v in sd.items()
                  if not torch.equal(live["mae_v." + k[7:]].cpu(), v)]
    check(not mismatched, f"pretrained: mae_v differs from the file at "
          f"{mismatched[:5]}")
    out["pretrained"] = {"keys": len(sd), "launches": p_launches}
    del st, live
    torch.cuda.empty_cache()

    # -- the loader alone: host decode + pinned H2D + the transform ---------
    adapter = build_adapter(cfg, "train")
    loader = Loader(adapter, TRAIN_BATCH, seed=0, num_workers=DRIVER_WORKERS,
                    device="cuda")
    for _ in loader.epoch(0):        # warm: file cache, pinned blocks
        pass
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = 0
    for b in loader.epoch(1):
        n += int(b["valid"].sum())
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t
    check(n == M3AE_TRAIN, f"loader epoch: {n} samples")

    # -- the transform: time per batch, card against CPU -------------------
    idx = list(range(TRAIN_BATCH))
    t = time.perf_counter()
    with ThreadPoolExecutor(DRIVER_WORKERS) as pool:
        hb = pad_rows(adapter.batch_host(
            idx, [np.random.default_rng((0, 0, i)) for i in idx], pool.map),
            TRAIN_BATCH, TRAIN_BATCH, len(adapter))
    host_ms = (time.perf_counter() - t) * 1e3
    cpu = [torch.from_numpy(hb[k]) for k in ("image_u8", "boxes", "flip")]
    dev = [x.cuda() for x in cpu]
    gen = torch.Generator(device=dev[0].device).manual_seed(0)
    mean, std = im.IMAGENET_MEAN, im.IMAGENET_STD

    def transform():
        return T.image_batch_transform(*dev, gen, mean, std, out=side,
                                       method="cubic", jitter=True,
                                       out_dtype=torch.bfloat16)

    tf_ms = time_cuda(transform, reps=10)
    prof = profile_call(transform)
    f = torch.rand((TRAIN_BATCH, 3), generator=torch.Generator().manual_seed(
        1)) * 0.8 + 0.6
    order = torch.argsort(torch.rand(
        (TRAIN_BATCH, 3), generator=torch.Generator().manual_seed(2)), dim=1)
    law = T.color_jitter_batch
    T.color_jitter_batch = lambda g, x: T.apply_jitter(
        x, f.to(x.device), order.to(x.device))
    try:
        got = T.image_batch_transform(*dev, None, mean, std, out=side,
                                      method="cubic", jitter=True)
        want = T.image_batch_transform(*cpu, None, mean, std, out=side,
                                       method="cubic", jitter=True)
    finally:
        T.color_jitter_batch = law
    err = float((got.cpu() - want).abs().max())
    check(err <= TRANSFORM_TOL, f"cubic + jitter transform on the card "
          f"against the CPU: max abs {err:.3g} > {TRANSFORM_TOL}")
    train_s = out["train"]["epoch1"]["train_s"]
    out.update(loader={"epoch_s": loader_s,
                       "samples_per_s": M3AE_TRAIN / loader_s,
                       "share_of_train_loop": loader_s / train_s,
                       "batch_host_ms": host_ms},
               transform={"ms": tf_ms, "device_ms": prof["device_ms"],
                          "top": prof["top"][:6], "cpu_max_abs_err": err,
                          "tol": TRANSFORM_TOL},
               launches=total)
    print(f"[m3ae] epoch 1 traced: {json.dumps(out['trace_epoch1'])}",
          flush=True)
    print(f"[m3ae] remat: " + json.dumps(
        {p: {k: v for k, v in r.items() if k != "epoch0"}
         for p, r in out["remat"].items()}) + "; without remat: peak "
        f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[m3ae] loader alone: {loader_s:.3f} s an epoch, "
          f"{M3AE_TRAIN / loader_s:.1f} samples/s "
          f"({100 * loader_s / train_s:.1f}% of epoch 1's train loop); one "
          f"batch's host IO {host_ms:.1f} ms over {DRIVER_WORKERS} workers; "
          f"cubic + jitter transform {tf_ms:.3f} ms a batch by CUDA events, "
          f"device {prof['device_ms']:.3f} ms; card vs CPU max abs "
          f"{err:.3g}; launches {total}", flush=True)
    return out


# ---------------------------------------------------------------- phase 13

FAM_TRAIN, FAM_TEST = 192, 64          # 3 steps + 1 eval batch an epoch
FAM_BATCH = 64
FAM_AUDIO = 1024                       # CAV-MAE's fbank frames
FAM_CAV_BLOCKS = (11, 12)              # CAV-MAE base: 11 + 1 blocks
FAM_M3AE = "base"                      # the 3-modal family's M3AE encoders
FAM_TOKENS = 256                       # the reference's token caches
FAM_FRAME_HW = (360, 480)              # CREMA-D's / IEMOCAP's video frames
FAM_IMAGE = None                       # --image_size: None keeps 224 / 256


def family_argv(family: str, root: Path, ckpt: Path, *extra,
                gs: bool = True) -> list:
    """A user's command line of the port's CLI for one of the families of
    phase 13 (B=64, bf16 compute, full width): CLIP (Food-101, --clip),
    CAV-MAE (CREMA-D, --lorb large --cav_augnois) and the IEMOCAP 3-modal
    classifier (--lorb m3ae --modal3 -dynamic); MLA (--gs_flag) unless
    ``gs`` is off."""
    cav = ["--audio_length", str(FAM_AUDIO), "--cav_blocks",
           "%d,%d" % FAM_CAV_BLOCKS]
    fam = {"clip": ["--dataset", "Food101", "--clip"],
           "cav": ["--dataset", "CREMAD", "--lorb", "large", "--cav_augnois",
                   *cav],
           "modal3": ["--dataset", "IEMOCAP", "--lorb", "m3ae", "--modal3",
                      "-dynamic", "--m3ae_size", FAM_M3AE, *cav]}[family]
    size = [] if FAM_IMAGE is None else ["--image_size", str(FAM_IMAGE)]
    return ["--device", "cuda", "--train", *fam,
            *(["--gs_flag"] if gs else []), "--batch_size", str(FAM_BATCH),
            "--compute_dtype", "bfloat16", "--epochs", str(DRIVER_EPOCHS),
            "--data_root", str(root), "--ckpt_path", str(ckpt),
            "--num_workers", str(DRIVER_WORKERS), "--no-use_tensorboard",
            *size, *extra]


def family_blocks() -> dict:
    """Attention blocks a forward of each family's encoders runs."""
    from mla_tpu_torch.models.m3ae import M3AE_CONFIGS
    cav, m3ae = FAM_CAV_BLOCKS[1], M3AE_CONFIGS[FAM_M3AE][1]
    return {"clip": 0, "cav": 2 * cav, "modal3": cav + 2 * m3ae}


def family_epoch_line(res, epoch=1):
    h = next(x for x in res["history"] if x["epoch"] == epoch)
    return {"loss": h["loss"], "acc": h["acc"], "train_s": h["train_s"],
            "wall_s": h["wall_s"],
            "train_samples_per_s": FAM_TRAIN / h["train_s"],
            "epoch_samples_per_s": (FAM_TRAIN + FAM_TEST) / h["wall_s"]}


def family_request(family: str, rng, n: int) -> dict:
    """Serving features of one family at the reference shapes."""
    if family == "clip":
        return {k: rng.standard_normal((n, 512)).astype(np.float32)
                for k in ("token_feat", "image_feat")}
    side = FAM_IMAGE or (224 if family == "cav" else 256)
    out = {"fbank": rng.normal(-5.0, 4.0, (n, FAM_AUDIO, 128)).astype(
        np.float32),
        "image": rng.standard_normal((n, 3, side, side)).astype(np.float32)}
    if family == "modal3":
        out.update({k: v for k, v in request(rng, n, FAM_TOKENS, side).items()
                    if k in ("token", "padding_mask")})
    return out


def family_batch(family: str, rng, n: int, device) -> dict:
    rows = {**family_request(family, rng, n),
            "label": rng.integers(0, 6 if family == "cav" else 4, n),
            "valid": np.ones(n, np.float32)}
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in rows.items()}


def family_cpu_agreement(family: str, cfg):
    """One fp32 MLA step at B=2 and full width on the card (kernels)
    against the CPU (plain versions), from the same weights and batch
    (phase 5's comparison; momentum relative L2 <= 1e-3)."""
    from mla_tpu_torch.models.classifiers import build_classifier
    from mla_tpu_torch.train import optim
    from mla_tpu_torch.train.state import create_train_state
    from mla_tpu_torch.train.steps import make_train_step

    cfg = cfg.replace(batch_size=2, compute_dtype="float32")
    n = family_blocks()[family]
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_classifier(cfg, seed=1)
        spec = optim.make_spec(cfg)
        st = create_train_state(model, cfg, spec, seed=1, device=dev)
        batch = family_batch(family, np.random.default_rng(7), 2, dev)
        f0, b0 = launch_counts()
        t = time.perf_counter()
        st, met = make_train_step(model, cfg, spec, len_dl=1)(
            st, batch, optim.lr_for_epoch(cfg, 0), 0)
        met = {k: float(v) for k, v in met.items()}
        f1, b1 = launch_counts()
        check((f1 - f0, b1 - b0) == ((n, n) if dev == "cuda" else (0, 0)),
              f"{family} fp32 step on {dev}: {f1 - f0} / {b1 - b0} launches")
        out[dev] = ({k: p.detach().cpu() for k, p in st.params.items()},
                    {k: m.cpu() for k, m in st.opt_state["momentum"].items()},
                    met, time.perf_counter() - t)
        del model, st
    torch.cuda.empty_cache()
    (pg, mg, lg, tg), (pc, mc, lc, tc) = out["cuda"], out["cpu"]
    res = {"params_rel_l2": rel_l2(pg, pc), "momentum_rel_l2": rel_l2(mg, mc),
           "loss_rel": {k: abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc},
           "step_s_card": tg, "step_s_cpu": tc}
    print(f"[families] {family} fp32 MLA step B=2, card vs CPU: "
          f"{json.dumps(res)}", flush=True)
    check(res["params_rel_l2"] <= 1e-6 and res["momentum_rel_l2"] <= 1e-3
          and max(res["loss_rel"].values()) <= 1e-4,
          f"{family}: the card's fp32 step drifts from the CPU's: {res}")
    return res


def family_int8(family: str, cfg, model, work: Path, kinds) -> dict:
    """bf16, int8 and int8_a8 artifacts of ``model`` (the 3-modal family's
    in the stacked layout, --scan_blocks): each int8 kind serves n=64
    (counters 0 just before, read just after the dispatches) against the
    bf16 artifact's fused logits, phase 8's limits."""
    from mla_tpu_torch.runtime.export import export_serving, load_serving
    from mla_tpu_torch.runtime.serve import run_batch

    example = family_request(family, np.random.default_rng(5), 4)
    req = family_request(family, np.random.default_rng(6), 64)
    bf = load_serving(export_serving(cfg, model, str(work / "bf16"),
                                     weights_dtype="bfloat16",
                                     example_batch=example))
    ref = run_batch(bf, req)["fused"]
    del bf
    out = {}
    blocks = family_blocks()[family]
    for dtype in kinds:
        scan = family == "modal3"
        art = export_serving(cfg.replace(scan_blocks=scan), model,
                             str(work / dtype), weights_dtype=dtype,
                             example_batch=example)
        srv = load_serving(art)
        skip = set(srv.meta["a8_skip"])
        if family == "cav":
            want = {"B4": 4 * blocks, "B5": 0, "B6": 0, "B1f": blocks}
        elif dtype == "int8_a8" and {"mlp/fc1", "mlp/fc2"} & skip:
            want = {"B4": 4 * FAM_CAV_BLOCKS[1] + 1, "B5": 4 * (blocks - 12),
                    "B6": 0, "B1f": blocks}
        else:
            m3 = blocks - FAM_CAV_BLOCKS[1]
            want = {"B4": 4 * FAM_CAV_BLOCKS[1] + 1, "B5": 2 * m3, "B6": m3,
                    "B1f": blocks}
        zero_q8_counts()
        times = []
        for i in range(4):
            before = q8_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run_batch(srv, req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            got = delta(before)
            check(got == want, f"{family} {dtype}: launches {got} in one "
                               f"dispatch, expected {want}")
        launches = q8_counts()
        rel = float(np.linalg.norm(res["fused"] - ref) / np.linalg.norm(ref))
        agree = float(np.mean(np.argmax(res["fused"], 1)
                              == np.argmax(ref, 1)))
        out[dtype] = {"per_dispatch": want, "launches": launches,
                      "scan_blocks": scan, "a8_skip": sorted(skip),
                      "median_ms_n64": float(np.median(times[1:])) * 1e3,
                      "rel_l2_vs_bf16": rel, "argmax_agree_vs_bf16": agree}
        print(f"[families] {family} {dtype}: {json.dumps(out[dtype])}",
              flush=True)
        check(rel <= INT8_REL_L2[dtype] and agree >= INT8_ARGMAX_AGREE,
              f"{family} {dtype}: fused logits against the bf16 artifact's: "
              f"relative L2 {rel}, argmax agreement {agree}")
        del srv
        torch.cuda.empty_cache()
    return out


def family_serve_check(family: str, cfg, art: Path, model, label: str):
    """One request of 3 through the artifact (load_serving, run_batch)
    against the eval model's logits: relative L2 <= 3e-2; its B1f
    launches. -> (rel, launches)."""
    from mla_tpu_torch.evals.metrics import eval_logits
    from mla_tpu_torch.runtime.export import load_serving
    from mla_tpu_torch.runtime.serve import run_batch

    req = family_request(family, np.random.default_rng(12), 3)
    b1f = attention_kernels()["B1f"]
    before = b1f.launches
    srv = load_serving(str(art), device="cuda")
    got = run_batch(srv, req)
    served = b1f.launches - before
    check(served == family_blocks()[family],
          f"{label}: {served} B1f launches a request")
    batch = {k: torch.from_numpy(v).cuda() for k, v in req.items()}
    batch["valid"] = torch.ones(3).cuda()
    model.eval()
    with torch.inference_mode():
        out_m, fused = eval_logits(model, cfg, batch, batch["valid"])
    want = {"fused": fused, **{f"logits_{m}": o for m, o in out_m.items()}}
    rel = {k: float(np.linalg.norm(got[k] - want[k].float().cpu().numpy())
                    / np.linalg.norm(want[k].float().cpu().numpy()))
           for k in want}
    check(all(v <= 3e-2 for v in rel.values()),
          f"{label}: the artifact's logits against the eval model's: {rel}")
    del srv
    return rel, served


def phase_families_driver(work: Path):
    """Phase 13: the CLIP, CAV-MAE and IEMOCAP 3-modal families trained end
    to end through the port's CLI and driver from files on disk (seeded
    synthetic trees: 192 + 64 samples, 360x480 frames, 1024 x 128
    fbanks, 256-token caches, 512-d CLIP features) at full width (768;
    CAV-MAE 11 + 1 blocks, M3AE base 12), B=64, bf16 compute, fp32 master
    weights: each family's MLA run (2 epochs), and CAV-MAE's and the
    3-modal one's eval-only from the best checkpoint with --export_dir
    (one request served), CAV-MAE's --resume and --cav_opti --cav_lrs
    epochs, the 3-modal QMF epoch under --mask_percent 0.5, each MLA run
    again under torch.profiler (epoch 1's split); int8 and int8_a8
    artifacts of both; the fbank transform on the card against the CPU;
    one fp32 B=2 step of each against the CPU."""
    from mla_tpu_torch.data import synthetic
    from mla_tpu_torch.data import transforms as T
    from mla_tpu_torch.ops import specaug as sa
    from mla_tpu_torch.runtime import checkpoint as ckpt_lib

    blocks = family_blocks()
    steps_an_epoch = -(-FAM_TRAIN // FAM_BATCH)
    evals_an_epoch = -(-FAM_TEST // FAM_BATCH)
    t = time.perf_counter()
    roots = {f: work / f for f in ("clip", "cav", "modal3")}
    synthetic.make_clip(str(roots["clip"]), n_train=FAM_TRAIN,
                        n_test=FAM_TEST)
    synthetic.make_cremad(str(roots["cav"]), n_train=FAM_TRAIN,
                          n_test=FAM_TEST, fbank=True, fbank_len=FAM_AUDIO,
                          frame_hw=FAM_FRAME_HW)
    synthetic.make_iemocap(str(roots["modal3"]), n_train=FAM_TRAIN,
                           n_test=FAM_TEST, token_len=FAM_TOKENS,
                           fbank_len=FAM_AUDIO, frame_hw=FAM_FRAME_HW)
    print(f"[families] wrote the CLIP, CREMA-D fbank and IEMOCAP trees "
          f"({FAM_TRAIN} + {FAM_TEST} samples each) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    out = {"blocks": blocks}
    total = {"B1f": 0, "B1b": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def finite_history(hist, label, mods=("a", "v")):
        check(all(np.isfinite(h[k]) for h in hist for k in
                  ("loss", "acc") + tuple(f"loss_{m}" for m in mods)),
              f"{label}: history {hist}")

    def run(family, argv, label, per_step=None, per_eval=None):
        n = blocks[family]
        return m3ae_driver_run(argv, label, per_step or (n, n),
                               per_eval or (n, 0))

    def train(family, ck, *extra):
        cfg, st, res, audit, launches, wall, peak = run(
            family, family_argv(family, roots[family], ck, *extra),
            f"{family} train")
        hist = res["history"]
        check([h["epoch"] for h in hist] == list(range(DRIVER_EPOCHS))
              and len(audit.steps) == DRIVER_EPOCHS * steps_an_epoch
              and len(audit.evals) == DRIVER_EPOCHS * evals_an_epoch,
              f"{family} train: epochs {hist}, {len(audit.steps)} steps")
        finite_history(hist, f"{family} train",
                       ("a", "v", "t") if family == "modal3" else ("a", "v"))
        check(all_finite(st.params.values()),
              f"{family} train: non-finite parameter")
        step_ms = audit.step_ms()
        line = {"epoch1": family_epoch_line(res), "launches": launches,
                "run_s": wall, "peak_bytes": peak, "step_ms": step_ms,
                "step_ms_median": float(np.median(step_ms[1:])),
                "best_acc": res["best_acc"], "history": hist}
        print(f"[families] {family}: epoch 1 {json.dumps(line['epoch1'])}, "
              f"peak {peak / 2**30:.2f} GiB, steps {step_ms} ms", flush=True)
        add(launches)
        return cfg, st, res, audit, line

    def eval_only(family, ck, best, audit):
        """Eval-only from the best checkpoint with --export_dir: the best
        epoch's accuracy and logits bit for bit; one request served."""
        art = work / f"{family}_export"
        argv = [a for a in family_argv(family, roots[family], ck / best,
                                       "--export_dir", str(art))
                if a != "--train"]
        cfg, ev_state, accs, ev_audit, launches, _, _ = run(
            family, argv, f"{family} eval-only, --export_dir")
        saved = ckpt_lib.load_meta(str(ck / best))["saved_epoch"]
        logits = audit.logits[saved * evals_an_epoch:
                              (saved + 1) * evals_an_epoch]
        check(not ev_audit.steps and same_logits(ev_audit.logits, logits),
              f"{family} eval-only: its logits differ from epoch {saved}'s")
        add(launches)
        rel, served = family_serve_check(family, cfg, art, ev_state.model,
                                         f"{family} export")
        add({"B1f": served, "B1b": 0})
        return cfg, ev_state, accs, {"acc": accs["acc"],
                                     "launches": launches,
                                     "export_rel_l2": rel}

    def traced(family):
        """The MLA run again under torch.profiler: epoch 1 split by the
        driver's spans (phase 11's reading)."""
        from torch.profiler import ProfilerActivity, profile
        ck = work / f"ck_{family}_trace"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, st, r, _, launches, _, _ = run(
                family, family_argv(family, roots[family], ck,
                                    "--no_save_last"), f"{family} traced")
        add(launches)
        split = epoch_split(prof, 1)
        check(split["steps"] == steps_an_epoch
              and split["transforms"] == steps_an_epoch
              and 0 < split["train_device_busy_share"] <= 1.0,
              f"{family}: trace of epoch 1: {split}")
        print(f"[families] {family} epoch 1 traced: {json.dumps(split)}",
              flush=True)
        del st, prof
        torch.cuda.empty_cache()
        shutil.rmtree(ck, ignore_errors=True)
        return {**split, "wall_s": family_epoch_line(r)["wall_s"]}

    def best_of(ck):
        best = sorted(n for n in os.listdir(ck) if n.startswith("best_model")
                      and not n.endswith(".json"))
        check(bool(best) and (ck / best[-1] / ckpt_lib.STATE_FILE).is_file(),
              f"checkpoints: {sorted(os.listdir(ck))}")
        return best[-1]

    # -- CLIP: fusion over the features, no kernel --------------------------
    cfg, st, res, _, line = train("clip", work / "ck_clip", "--no_save_last")
    check(line["launches"]["B1f"] == 0 and line["launches"]["B1b"] == 0,
          f"clip: attention launches {line['launches']}")
    out["clip"] = line
    del st
    shutil.rmtree(work / "ck_clip", ignore_errors=True)

    # -- CAV-MAE: MLA with --cav_augnois, 2 epochs and --save_last ----------
    ck = work / "ck_cav"
    cfg, st, res, audit, line = train("cav", ck)
    del st
    torch.cuda.empty_cache()
    best = best_of(ck)
    check(ckpt_lib.load_meta(str(ck / "last"))["saved_epoch"]
          == DRIVER_EPOCHS - 1, "cav: the `last` checkpoint")
    cfg, ev_state, accs, line["eval_only"] = eval_only("cav", ck, best, audit)
    check(accs["acc"] == res["best_acc"], f"cav eval-only accuracy {accs} "
          f"against the best {res['best_acc']}")
    line["int8"] = family_int8("cav", cfg, ev_state.model, work / "cav_q8",
                               ("int8", "int8_a8"))
    del ev_state
    torch.cuda.empty_cache()
    _, st, r3, _, rs_launches, _, _ = run(
        "cav", family_argv("cav", roots["cav"], ck, "--resume",
                           str(ck / "last"), "--epochs",
                           str(DRIVER_EPOCHS + 1)), "cav resume")
    check([h["epoch"] for h in r3["history"]] == [DRIVER_EPOCHS],
          f"cav resume: {r3}")
    finite_history(r3["history"], "cav resume")
    add(rs_launches)
    line["resume"] = {"history": r3["history"], "launches": rs_launches}
    del st
    shutil.rmtree(ck, ignore_errors=True)
    _, st, ro, _, o_launches, _, _ = run(
        "cav", family_argv("cav", roots["cav"], work / "ck_opti", "--epochs",
                           "1", "--no_save_last", "--cav_opti", "--cav_lrs"),
        "cav --cav_opti --cav_lrs")
    finite_history(ro["history"], "cav --cav_opti")
    add(o_launches)
    line["cav_opti"] = {"history": ro["history"], "launches": o_launches}
    del st
    torch.cuda.empty_cache()
    shutil.rmtree(work / "ck_opti", ignore_errors=True)
    line["trace_epoch1"] = traced("cav")
    out["cav"] = line

    # -- the fbank transform: time a batch, card against CPU ----------------
    x = torch.from_numpy(family_request("cav", np.random.default_rng(3),
                                        FAM_BATCH)["fbank"])
    xd = x.cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tf_ms = time_cuda(lambda: T.cav_fbank_transform(xd, gen, True, True), 10)
    cpu_gen = torch.Generator().manual_seed(1)
    b, tt, f = x.shape
    draws = (sa.specaug_draws(cpu_gen, b, tt, f, "cpu"),
             sa.noise_roll_draws(cpu_gen, b, tt, f, "cpu"))

    def on(d, dev):
        return {k: (on(v, dev) if isinstance(v, dict) else v.to(dev))
                for k, v in d.items()}

    laws = sa.specaug_draws, sa.noise_roll_draws
    sa.specaug_draws = lambda g, b, t, f, dev, *a: on(draws[0], dev)
    sa.noise_roll_draws = lambda g, b, t, f, dev: on(draws[1], dev)
    try:
        got = T.cav_fbank_transform(xd, None, True, True)
        want = T.cav_fbank_transform(x, None, True, True)
    finally:
        sa.specaug_draws, sa.noise_roll_draws = laws
    err = float((got.cpu() - want).abs().max())
    check(err <= TRANSFORM_TOL, f"fbank transform on the card against the "
          f"CPU: max abs {err:.3g} > {TRANSFORM_TOL}")
    out["fbank_transform"] = {"ms": tf_ms, "cpu_max_abs_err": err,
                              "tol": TRANSFORM_TOL}

    # -- IEMOCAP 3-modal: MLA -dynamic, 2 epochs ----------------------------
    ck = work / "ck_modal3"
    cfg, st, res, audit, line = train("modal3", ck, "--no_save_last")
    del st
    torch.cuda.empty_cache()
    cfg, ev_state, accs, line["eval_only"] = eval_only("modal3", ck,
                                                       best_of(ck), audit)
    check(accs["acc"] == res["best_acc"], f"modal3 eval-only accuracy {accs}"
          f" against the best {res['best_acc']}")
    line["int8"] = family_int8("modal3", cfg, ev_state.model,
                               work / "modal3_q8", ("int8", "int8_a8"))
    del ev_state
    torch.cuda.empty_cache()
    shutil.rmtree(ck, ignore_errors=True)
    _, st, rq, qa, q_launches, _, _ = run(
        "modal3", family_argv("modal3", roots["modal3"], work / "ck_qmf",
                              "--epochs", "1", "--no_save_last",
                              "--modulation", "QMF", "--mask_percent", "0.5",
                              gs=False), "modal3 QMF, --mask_percent 0.5")
    finite_history(rq["history"], "modal3 QMF", ("a", "v", "t"))
    add(q_launches)
    line["qmf"] = {"history": rq["history"], "launches": q_launches}
    del st
    torch.cuda.empty_cache()
    shutil.rmtree(work / "ck_qmf", ignore_errors=True)
    line["trace_epoch1"] = traced("modal3")
    out["modal3"] = line

    # -- fp32 B=2 steps, card against CPU -----------------------------------
    from mla_tpu_torch.runtime.cli import parse_args
    for family in ("cav", "modal3"):
        c = parse_args(family_argv(family, roots[family], work / "unused"))[0]
        out[family]["cpu_agreement"] = family_cpu_agreement(family, c)
    out["launches"] = total
    print(f"[families] launches {total}; epoch 1 samples/s: " + json.dumps(
        {f: out[f]["epoch1"]["train_samples_per_s"]
         for f in ("clip", "cav", "modal3")}) + "; peak GiB: " + json.dumps(
        {f: out[f]["peak_bytes"] / 2**30 for f in ("clip", "cav", "modal3")})
        + f"; fbank transform {tf_ms:.3f} ms a batch, card vs CPU {err:.3g}",
        flush=True)
    return out


# ---------------------------------------------------------------- phase 14

ETL_TRAIN, ETL_TEST = 192, 64          # gen-txt --test_frac 0.25 of 256
ETL_SR = 16000
ETL_SECONDS = (2.0, 3.5)               # CREMA-D clips run 1-5 s
ETL_SHORT = 320                        # samples: shorter than one fbank frame
ETL_VIDEO = (75, 30.0)                 # frames, fps: 2.5 s at CREMA-D's 30 fps
ETL_CMP = 8                            # clips run on the card and on the CPU
ETL_TOL = 1e-3                         # log domain: the JAX goldens' atol
ETL_VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the a is of and to in it "
             "angry happy sad calm voice says word ##s ##ed ##ing").split()
FUSION_WIDTH, FUSION_CLASSES = 512, 101   # CLIP's feature width, Food-101
FUSION_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def etl(*argv, device="cuda") -> float:
    """One subcommand of the port's ETL CLI (``etl.cli.main``), on
    ``device`` where it takes one; its wall seconds."""
    from mla_tpu_torch.data.etl import cli as etl_cli
    t = time.perf_counter()
    etl_cli.main([*map(str, argv), *(("--device", device) if argv[0]
                                     in etl_cli.DEVICE_COMMANDS else ())])
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t


def etl_raw_media(raw: Path, n: int, seed: int = 14):
    """Seeded CREMA-D-like raw media under ``raw``: ``wav/<name>.wav`` (16
    kHz int16 mono, ETL_SECONDS long, a class tone in noise; clip 0 of
    ETL_SHORT samples), ``video/<name>.avi`` (MJPG, 360x480, ETL_VIDEO,
    a moving gradient with a class stripe: cv2 writes it without ffmpeg)
    and ``all.txt``, the CREMA-D datalist ('<name>.flv <label>'). The
    videos are written over 8 threads. Returns the names and labels."""
    import cv2
    from scipy.io import wavfile
    from mla_tpu_torch.data.synthetic import CREMAD_CLASSES

    rng = np.random.default_rng(seed)
    names = [f"10{i:03d}_ETL_{CREMAD_CLASSES[i % 6]}_XX" for i in range(n)]
    labels = [CREMAD_CLASSES[i % 6] for i in range(n)]
    for d in ("wav", "video"):
        (raw / d).mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        m = ETL_SHORT if i == 0 else int(ETL_SR * rng.uniform(*ETL_SECONDS))
        t = np.arange(m) / ETL_SR
        wave = 0.2 * np.sin(2 * np.pi * (150.0 + 60.0 * (i % 6)) * t) \
            + 0.05 * rng.standard_normal(m)
        wavfile.write(str(raw / "wav" / f"{name}.wav"), ETL_SR,
                      (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    (raw / "all.txt").write_text("".join(f"{n_}.flv {lab}\n"
                                         for n_, lab in zip(names, labels)))
    h, w = DRIVER_FRAME_HW
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 255],
                    -1).astype(np.uint8)

    def video(i):
        out = cv2.VideoWriter(str(raw / "video" / f"{names[i]}.avi"),
                              cv2.VideoWriter_fourcc(*"MJPG"), ETL_VIDEO[1],
                              (w, h))
        stripe = h // 6 * (i % 6)
        for k in range(ETL_VIDEO[0]):
            frame = np.roll(base, 4 * k + i, axis=1)
            frame[stripe:stripe + h // 6] = 230
            out.write(frame)
        out.release()

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(video, range(n)))
    return names, labels


def etl_link(names, src: Path, dst: Path, ext: str, rename=None):
    """``dst/<name><ext>`` -> ``src/<name or rename[name]><ext>``."""
    dst.mkdir(parents=True, exist_ok=True)
    for name in names:
        (dst / f"{name}{ext}").symlink_to(
            src / f"{(rename or {}).get(name, name)}{ext}")


def npy_max_diff(a: Path, b: Path) -> float:
    files = sorted(p.name for p in a.glob("*.npy"))
    check(files and files == sorted(p.name for p in b.glob("*.npy")),
          f"etl: {a} and {b} hold other files")
    return max(float(np.abs(np.load(a / f) - np.load(b / f)).max())
               for f in files)


def fusion_card_vs_cpu() -> dict:
    """FiLM and GatedFusion at CLIP's width, B=64, each switch: the card
    against the CPU from the same weights, fp32 and bf16 compute."""
    import copy
    from mla_tpu_torch.models import fusion

    rng = np.random.default_rng(14)
    x, y = (torch.from_numpy(rng.standard_normal(
        (FAM_BATCH, FUSION_WIDTH)).astype(np.float32)) for _ in range(2))
    out = {}
    for name, key in (("FiLM", "x_film"), ("GatedFusion", "x_gate")):
        for switch in (True, False):
            mod = getattr(fusion, name)(FUSION_WIDTH, FUSION_WIDTH,
                                        FUSION_CLASSES, **{key: switch})
            mod.reset_parameters(torch.Generator().manual_seed(14))
            card = copy.deepcopy(mod).cuda()
            for dt in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    want = mod(x.to(dt), y.to(dt))
                    got = card(x.cuda().to(dt), y.cuda().to(dt))
                check(all(g.dtype == dt and g.shape == w.shape
                          for g, w in zip(got, want))
                      and got[2].shape == (FAM_BATCH, FUSION_CLASSES),
                      f"{name} {key}={switch} {dt}: types or shapes")
                rel = rel_l2({i: g.float().cpu() for i, g in enumerate(got)},
                             {i: w.float() for i, w in enumerate(want)})
                label = f"{name} {key}={switch} {str(dt)[6:]}"
                check(rel <= FUSION_REL_L2[dt],
                      f"{label}: card vs CPU relative L2 {rel:.3e} > "
                      f"{FUSION_REL_L2[dt]}")
                out[label] = rel
    print(f"[etl] FiLM / GatedFusion card vs CPU relative L2: "
          f"{json.dumps(out)}", flush=True)
    return out


def phase_etl(work: Path):
    """Phase 14: the port's offline ETL CLI on the card over raw media the
    phase writes (ETL_TRAIN + ETL_TEST CREMA-D-like clips: wavs and 360x480
    MJPG videos), then training from what it wrote: gen-txt, gen-stat,
    video-frames, extract-spec (one root) and extract-fbank (a second root
    sharing the frames); extract-fbank with --mix_dir over 8 clips,
    extract-token --vocab, preprocess-iemo over 8 clips; extract-spec and
    extract-fbank again on the card and on the CPU over 8 clips (max abs
    <= ETL_TOL, the ETL_SHORT clip's fbank zeros on both), files/s, one
    profiled file. Then CREMA-D --lorb base --pallas_conv on, 1 epoch with
    --export_torch (52 B3 a step, 26 an eval batch), CAV-MAE --lorb large,
    1 epoch (24 + 24 B1f/B1b a step, 24 B1f an eval batch),
    ``runtime.parity --reference ""`` from the .pth (the driver's eval-only
    branch: 26 B3 an eval batch; the accuracy of the training run's own
    eval of the exported weights), and FiLM / GatedFusion on the card
    against the CPU."""
    from mla_tpu_torch.data.etl import cli as etl_cli
    from mla_tpu_torch.ops.conv3x3 import conv3x3
    from mla_tpu_torch.runtime import parity

    out = {"files": ETL_TRAIN + ETL_TEST}
    t = time.perf_counter()
    raw = work / "raw"
    names, labels = etl_raw_media(raw / "all", ETL_TRAIN + ETL_TEST)
    out["write_media_s"] = time.perf_counter() - t
    print(f"[etl] wrote {len(names)} wavs and {ETL_VIDEO[0]}-frame "
          f"{DRIVER_FRAME_HW} MJPG videos in {out['write_media_s']:.1f} s",
          flush=True)
    spec_root, fbank_root = work / "cremad_spec", work / "cremad_fbank"
    lists = spec_root / "lists"
    lists.mkdir(parents=True)
    times = {}
    times["gen-txt"] = etl("gen-txt", raw / "all" / "all.txt", work / "my",
                           "--test_frac", "0.25")
    for mode in ("train", "test"):
        os.replace(work / f"my_{mode}.txt", lists / f"my_{mode}_cre.txt")
    times["gen-stat"] = etl("gen-stat", lists / "my_train_cre.txt",
                            lists / "my_test_cre.txt",
                            "--out", lists / "stat_cre.txt")
    split = {m: [ln.split(".flv ")[0] for ln in
                 (lists / f"my_{m}_cre.txt").read_text().splitlines()]
             for m in ("train", "test")}
    check(len(split["train"]) == ETL_TRAIN and len(split["test"]) == ETL_TEST
          and sorted(split["train"] + split["test"]) == sorted(names)
          and (lists / "stat_cre.txt").read_text().split()
          == sorted(set(labels)), "etl: gen-txt / gen-stat lists")
    for k in ("video-frames", "extract-spec", "extract-fbank"):
        times[k] = 0.0
    for mode, ns in split.items():
        etl_link(ns, raw / "all" / "wav", raw / mode / "wav", ".wav")
        etl_link(ns, raw / "all" / "video", raw / mode / "video", ".avi")
        frames = spec_root / f"visual/{mode}_imgs/Image-01-FPS"
        times["video-frames"] += etl("video-frames", raw / mode / "video",
                                     frames, "--fps", "1")
        check(all(len(list((frames / n_).glob("*.jpg"))) == 3 for n_ in ns),
              f"etl: video-frames {mode}: not 3 frames a clip")
        times["extract-spec"] += etl("extract-spec", raw / mode / "wav",
                                     spec_root / f"audio/{mode}_fbank")
        times["extract-fbank"] += etl("extract-fbank", raw / mode / "wav",
                                      fbank_root / f"audio/{mode}_fbank")
    shutil.copytree(lists, fbank_root / "lists")
    (fbank_root / "visual").symlink_to(spec_root / "visual")
    for root, shape in ((spec_root, DRIVER_SPEC), (fbank_root, (1024, 128))):
        arrs = [np.load(p) for p in root.glob("audio/*_fbank/*.npy")]
        check(len(arrs) == len(names) and all(
            a.shape == shape and a.dtype == np.float32
            and np.isfinite(a).all() for a in arrs),
              f"etl: {root.name}: {len(arrs)} npys, not {shape} or finite")
    short_mode = "train" if names[0] in split["train"] else "test"
    check(not np.load(fbank_root / f"audio/{short_mode}_fbank/"
                      f"{names[0]}.npy").any(),
          f"etl: the {ETL_SHORT}-sample clip's fbank is not all zeros")
    rate = {k: len(names) / times[k] for k in
            ("video-frames", "extract-spec", "extract-fbank")}
    print(f"[etl] card: seconds {json.dumps(times)}; files/s "
          f"{json.dumps(rate)}", flush=True)
    out.update(seconds=times, files_per_s=rate)

    # mp4-to-wav runs ffmpeg, a binary the card machine may lack
    if shutil.which("ffmpeg") is None:
        print("[etl] mp4-to-wav not run: no ffmpeg binary on PATH",
              flush=True)
        out["mp4_to_wav"] = "not run: no ffmpeg"
    else:
        (raw / "mp4").mkdir()
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-f", "lavfi",
                        "-i", "sine=frequency=440:duration=1",
                        str(raw / "mp4" / "tone.mp4")], check=True)
        etl("mp4-to-wav", raw / "mp4", work / "mp4_wav")
        sr, wave = etl_cli._wavread(str(work / "mp4_wav" / "tone.wav"))
        check(sr == ETL_SR and abs(len(wave) - ETL_SR) < ETL_SR // 10,
              f"etl: mp4-to-wav wrote {len(wave)} samples at {sr} Hz")
        out["mp4_to_wav"] = len(wave)

    # waveform mixup over 8 clips, each blended with another clip's wav
    mixed = split["train"][:ETL_CMP]
    partner = dict(zip(mixed, split["train"][ETL_CMP:2 * ETL_CMP]))
    etl_link(mixed, raw / "all" / "wav", raw / "mix" / "wav", ".wav")
    etl_link(mixed, raw / "all" / "wav", raw / "mix" / "partner", ".wav",
             rename=partner)
    mix_args = ("--mix_dir", raw / "mix" / "partner", "--mix_lambda", "0.3")
    etl("extract-fbank", raw / "mix" / "wav", work / "mix_cuda", *mix_args)
    etl("extract-fbank", raw / "mix" / "wav", work / "mix_cpu", *mix_args,
        device="cpu")
    out["mix_max_abs"] = npy_max_diff(work / "mix_cuda", work / "mix_cpu")
    check(out["mix_max_abs"] <= ETL_TOL,
          f"etl: mixup card vs CPU {out['mix_max_abs']:.3e}")

    # tokens from a seeded TSV and a vocabulary the phase writes
    rng = np.random.default_rng(15)
    vocab = work / "vocab.txt"
    vocab.write_text("\n".join(ETL_VOCAB) + "\n")
    words = ETL_VOCAB[5:] + ["unknown", "Angry!"]
    captions = {n_: " ".join(rng.choice(words, int(rng.integers(0, 40))))
                for n_ in mixed}
    (work / "texts.tsv").write_text("".join(f"{n_}\t{c}\n"
                                            for n_, c in captions.items()))
    times["extract-token"] = etl("extract-token", work / "texts.tsv",
                                 work / "tok", "--vocab", vocab)
    toks = [np.load(work / "tok" / f"{n_}_{k}.npy") for n_ in mixed
            for k in ("token", "pm")]
    check(all(a.shape == (1, FAM_TOKENS) for a in toks)
          and {a.dtype for a in toks} == {np.dtype(np.int64),
                                          np.dtype(np.float32)},
          "etl: extract-token npys")

    # IEMOCAP's one-shot recipe over 8 clips; the train frames as faces
    iemo = work / "iemo_lists"
    iemo.mkdir()
    sep = " [split|sign] "
    (iemo / "my_train_iemo.txt").write_text("".join(
        f"{n_}.mp4{sep}{captions[n_]}{sep}ang\n" for n_ in mixed))
    times["preprocess-iemo"] = etl(
        "preprocess-iemo", iemo, raw / "all" / "wav",
        spec_root / "visual/train_imgs/Image-01-FPS", work / "iemo",
        "--splits", "train,dev", "--vocab", vocab)
    import cv2
    faces = sorted((work / "iemo/visual/train_imgs").glob("*/*.jpg"))
    check(len(faces) == 3 * ETL_CMP
          and cv2.imread(str(faces[0])).shape == (256, 256, 3)
          and len(list((work / "iemo/audio/train_fbank").glob("*.npy")))
          == ETL_CMP
          and len(list((work / "iemo/text_token/train_token").glob("*.npy")))
          == 2 * ETL_CMP
          and not (work / "iemo/audio/dev_fbank").exists(),
          "etl: preprocess-iemo layout")

    # the card against the CPU, over 8 clips with the short one
    cmp = names[:ETL_CMP]
    etl_link(cmp, raw / "all" / "wav", raw / "cmp" / "wav", ".wav")
    cmp_s, cmp_diff = {}, {}
    for kind in ("extract-spec", "extract-fbank"):
        for dev in ("cuda", "cpu"):
            cmp_s[f"{kind} {dev}"] = etl(kind, raw / "cmp" / "wav",
                                         work / f"{kind}_{dev}", device=dev)
        cmp_diff[kind] = npy_max_diff(work / f"{kind}_cuda",
                                      work / f"{kind}_cpu")
        check(cmp_diff[kind] <= ETL_TOL,
              f"etl: {kind} card vs CPU max abs {cmp_diff[kind]:.3e} > "
              f"{ETL_TOL}")
    for dev in ("cuda", "cpu"):
        check(not np.load(work / f"extract-fbank_{dev}" / f"{cmp[0]}.npy"
                          ).any(),
              f"etl: the short clip's fbank on {dev} is not all zeros")
    cmp_rate = {k: ETL_CMP / s for k, s in cmp_s.items()}
    print(f"[etl] card vs CPU over {ETL_CMP} clips: max abs "
          f"{json.dumps(cmp_diff)}; files/s {json.dumps(cmp_rate)}",
          flush=True)
    out.update(card_vs_cpu_max_abs=cmp_diff, cmp_files_per_s=cmp_rate)

    # one file's extract-fbank and extract-spec, profiled
    one = [split["train"][1]]
    etl_link(one, raw / "all" / "wav", raw / "one" / "wav", ".wav")
    prof = {}
    for kind in ("extract-fbank", "extract-spec"):
        p = profile_call(lambda: etl_cli.main(
            [kind, str(raw / "one" / "wav"), str(work / f"one_{kind}"),
             "--device", "cuda"]))
        prof[kind] = {k: p[k] for k in ("wall_ms", "device_ms",
                                        "busy_share")}
    print(f"[etl] one file profiled (host wall, device ms): "
          f"{json.dumps(prof)}", flush=True)
    out["one_file"] = prof
    shutil.rmtree(raw / "all" / "video")

    # -- training from the ETL's trees ------------------------------------
    pth = work / "av.pth"
    _, st, res, launches, wall = driver_run(
        driver_argv(spec_root, work / "ck_av", "--pallas_conv", "on",
                    "--epochs", "1", "--export_torch", str(pth)),
        "etl: CREMA-D from the spec tree, B3 on, 1 epoch")
    expect = 2 * 2 * B3_SITES * ETL_TRAIN // AV_BATCH \
        + 2 * B3_SITES * ETL_TEST // AV_BATCH
    check(launches == expect, f"etl: {launches} B3 launches, {expect} "
          "expected (52 a step, 26 an eval batch)")
    hist = res["history"]
    check(len(hist) == 1 and all(np.isfinite(hist[0][k]) for k in
                                 ("loss", "loss_a", "loss_v", "acc"))
          and all_finite(st.params.values()) and pth.is_file(),
          f"etl: CREMA-D history {hist}")
    del st
    b3 = launches
    out["av"] = {"launches": launches, "train_s": hist[0]["train_s"],
                 "wall_s": hist[0]["wall_s"], "run_s": wall,
                 "acc": hist[0]["acc"], "loss": hist[0]["loss"]}

    n = family_blocks()["cav"]
    cav_argv = ["--device", "cuda", "--train", "--dataset", "CREMAD",
                "--lorb", "large", "--audio_length", str(FAM_AUDIO),
                "--cav_blocks", "%d,%d" % FAM_CAV_BLOCKS, "--gs_flag",
                "--batch_size", str(FAM_BATCH), "--compute_dtype", "bfloat16",
                "--epochs", "1", "--data_root", str(fbank_root),
                "--ckpt_path", str(work / "ck_cav"), "--num_workers",
                str(DRIVER_WORKERS), "--no-use_tensorboard"]
    _, st, res, audit, cav_launches, wall, peak = m3ae_driver_run(
        cav_argv, "etl: CAV-MAE from the fbank tree, 1 epoch", (n, n), (n, 0))
    hist = res["history"]
    check(len(audit.steps) == -(-ETL_TRAIN // FAM_BATCH)
          and len(audit.evals) == -(-ETL_TEST // FAM_BATCH)
          and len(hist) == 1 and np.isfinite(hist[0]["loss"])
          and all_finite(st.params.values()),
          f"etl: CAV-MAE {len(audit.steps)} steps, history {hist}")
    del st
    out["cav"] = {"launches": cav_launches, "train_s": hist[0]["train_s"],
                  "wall_s": hist[0]["wall_s"], "run_s": wall,
                  "peak_bytes": peak, "acc": hist[0]["acc"],
                  "loss": hist[0]["loss"]}
    shutil.rmtree(work / "ck_av", ignore_errors=True)
    shutil.rmtree(work / "ck_cav", ignore_errors=True)

    # the parity eval (the driver's eval-only branch) from the exported .pth
    ev = [a for a in driver_argv(spec_root, pth, "--pallas_conv", "on")
          if a != "--train"]
    conv3x3.launches = 0
    report = parity.main(["--reference", "", *ev])
    par_launches = conv3x3.launches
    per_eval = 2 * B3_SITES * -(-ETL_TEST // AV_BATCH)
    check(par_launches == per_eval,
          f"etl: parity {par_launches} B3 launches, {per_eval} expected")
    check(report["reference"] is None
          and set(report["ours"]) == {"acc", "acc_a", "acc_v"}
          and report["config"]["ckpt"] == str(pth)
          and report["ours"]["acc"] == out["av"]["acc"],
          f"etl: parity's report {report} against the training run's eval "
          f"of the exported weights (acc {out['av']['acc']})")
    b3 += par_launches
    out["parity"] = {"ours": report["ours"], "launches": par_launches}
    print(f"[etl] CREMA-D train_s {out['av']['train_s']:.4f}, CAV-MAE "
          f"train_s {out['cav']['train_s']:.4f}; parity ours "
          f"{json.dumps(report['ours'])}, acc = the training run's eval",
          flush=True)

    out["fusion"] = fusion_card_vs_cpu()
    out["launches"] = {"B3": b3, "B1f": cav_launches["B1f"],
                       "B1b": cav_launches["B1b"]}
    out["phase_s"] = time.perf_counter() - t
    print(f"[etl] phase 14: {out['phase_s']:.1f} s, launches "
          f"{json.dumps(out['launches'])}", flush=True)
    return out


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
    build_s, sass, q8_sass, conv_sass, ln_sass = phase_build()
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
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        driver = phase_driver(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        m3ae_driver = phase_m3ae_driver(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        families = phase_families_driver(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        etl_phase = phase_etl(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def main_shape(rs):
        return next(r for r in rs if r["shape"] == [64, 257, 12, 64]
                    and r["dtype"] == "bfloat16")

    fwd, bwd = main_shape(rows), main_shape(bwd_rows)
    common = {"route": "cuda", "at": "B=64 S=257 H=12 D=64 bf16"}
    kernels = [{"name": "flat_attention_fwd", **common,
                "source": "mla_tpu_torch/ops/csrc/flat_attention.cu",
                "replaces": "mla_tpu/ops/attention.py:322",
                # serving dispatches + training steps, eval, joint, QMF;
                # int8 dispatches and phase 12's CLI runs are added below
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
                # training steps; phase 12's CLI runs are added below
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
        # AV serving dispatches + AV training steps, eval, joint, QMF +
        # the driver's runs (train, eval-only, resume); phase 14's (train
        # from the ETL's tree, parity from its .pth)
        "launches": av_serving["launches"] + av_training["launches"]
        + driver["launches"] + etl_phase["launches"]["B3"],
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
    # phase 12: the CLI's M3AE runs (train, eval-only and its export's
    # request, resume, remat under both policies, MVSA, the traced run)
    kernels[0]["launches"] += m3ae_driver["launches"]["B1f"]
    kernels[1]["launches"] += m3ae_driver["launches"]["B1b"]
    # phase 13: the CAV-MAE and 3-modal CLI runs (CLIP launches none) and
    # their int8 artifacts' dispatches
    kernels[0]["launches"] += families["launches"]["B1f"]
    kernels[1]["launches"] += families["launches"]["B1b"]
    for r in (r for fam in ("cav", "modal3")
              for r in families[fam]["int8"].values()):
        kernels[0]["launches"] += r["launches"]["B1f"]
        for k in ("B4", "B5", "B6"):
            q8_total[k] += r["launches"][k]
    # phase 14: CAV-MAE trained from the ETL's fbank tree
    kernels[0]["launches"] += etl_phase["launches"]["B1f"]
    kernels[1]["launches"] += etl_phase["launches"]["B1b"]
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
         "device_ms": lf["device_ms"],
         "plain_ms": lf["plain_ms"], "bound_ms": lf["bound_ms"],
         "bound_by": lf["bound_by"], "library_ms": lf["library_ms"],
         "library_device_ms": lf["library_device_ms"],
         "repeat_bitwise": all(r["repeat_bitwise"] for r in ln_rows),
         "max_abs_err_all": max(r["max_abs_err"] for r in ln_rows),
         "all_ok": all(r["ok"] for r in ln_rows)},
        {"name": "ln_dense_bwd", **ln_common,
         "replaces": "mla_tpu/ops/fused_block.py:124",
         "launches": ln_path["launches_bwd"],
         "max_abs_err": lb["max_abs_err"], "ms": lb["ms"],
         "device_ms": lb["device_ms"],
         "plain_ms": lb["plain_ms"], "bound_ms": lb["bound_ms"],
         "bound_by": lb["bound_by"], "library_ms": lb["library_ms"],
         "library_device_ms": lb["library_device_ms"],
         "repeat_bitwise": all(r["repeat_bitwise"] for r in ln_bwd_rows),
         "fwd_plus_bwd_ms": lb["fwd_plus_bwd_ms"],
         "max_abs_err_all": max(r["max_abs_err"] for r in ln_bwd_rows),
         "all_ok": all(r["ok"] for r in ln_bwd_rows)}]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "attention_build": sass, "q8_build": q8_sass,
        "conv_build": conv_sass, "ln_build": ln_sass,
        "kernel_cases": rows, "bwd_kernel_cases": bwd_rows,
        "head_kernel_cases": head_rows, "head_bwd_kernel_cases": head_bwd_rows,
        "ln_kernel_cases": ln_rows, "ln_bwd_kernel_cases": ln_bwd_rows,
        "conv_kernel_cases": conv_rows, "conv_dx_cases": conv_dx_rows,
        "q8_kernel_cases": q8_rows, "q8_mlp_cases": mlp_rows,
        "serving": serving, "training": training,
        "av_serving": av_serving, "av_training": av_training,
        "int8_serving": int8, "head_training": head_training,
        "ln_dense_path": ln_path, "driver": driver,
        "m3ae_driver": m3ae_driver, "families_driver": families,
        "etl": etl_phase,
        "seconds": time.perf_counter() - t_start}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
