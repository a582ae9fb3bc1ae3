// The fused int8 MLP of int8 and W8A8 serving for Hopper (sm_90a), plain C
// interface: B6.
//
// Replaces mla_tpu/ops/q8_matmul.py:_kernel_mlp_stacked and
// _kernel_mlp_stacked_a8 (behind _q8_mlp_pallas): on layer l of the stacks
// W1 (L, H, C) and W2 (L, C, H) int8 with per-output-channel scales s1
// (L, H), s2 (L, C), and that layer's biases b1 (H,), b2 (C,) in fp32,
//   weight-only: g = bf16(gelu(sum_c bf16(x) W1 (fp32) * s1 + b1))
//                out = bf16(sum_h g W2 (fp32) * s2 + b2)
//   W8A8:        t = (sum_c xq W1 (int32)) * xs * s1 + b1, g = gelu(t) fp32
//                per (row, group of bh columns): sg = max(max|g|, 1e-12)/127,
//                gq = clip(round-half-even(g / sg), -127, 127)
//                out = bf16((sum_groups (sum_h gq W2 (int32)) * sg) * s2 + b2)
// with exact GELU on erff (the TPU kernel's polynomial erf differs by less
// than 1.5e-7) and the layer id read on the device and clamped to [0, L-1].
// xq, xs come from mla_q8_quantize_rows (q8_matmul.cu).
//
// Design: the wgmma main loop of q8_gemm.cuh, launched for fc1 and fc2. The
// TPU kernel keeps a (rows x bh) hidden tile in VMEM between its fc1 and
// fc2 products; on an SM a useful row count times bh = 1536 fp32 columns,
// plus the (rows x C) accumulator, does not fit 227 KB, and the W8A8 law
// needs the max over a whole bh group before it can quantize any of it,
// which no single output tile of fc1 sees. So fc1 (scale + bias + GELU
// epilogue) writes the hidden to device memory: bf16 for weight-only, read
// back by fc2 as its bf16 operand. W8A8 takes route (i): fc1 writes the
// fp32 hidden, the row quantizer runs over it viewed as (M * H / bh, bh)
// rows, one warp per (row, group), writing the int8 hidden and the (M,
// H / bh) group scales, and fc2 is a pure s8 x s8 product that flushes its
// int32 sums per group (A_S8G). No division runs inside a product loop, and
// the quantizer is the law's own kernel. Traffic of the hidden at rung 64
// (16448 rows, H = 3072): weight-only 101 MB written and read (30 us at
// 3.35 TB/s); W8A8 202 MB written, 202 MB read and 50 MB written by the
// quantizer, 50 MB read (150 us), beside 155 GFLOP (157 us at the bf16
// peak, 78 us at the int8 peak).
#include "q8_gemm.cuh"

namespace {

using namespace q8;

constexpr float kSqrt1_2 = 0.7071067811865476f;

__device__ __forceinline__ float gelu(float t) {
  return __fmul_rn(__fmul_rn(0.5f, t),
                   __fadd_rn(1.f, erff(__fmul_rn(t, kSqrt1_2))));
}

// weight-only fc1: bf16(gelu(acc * s1 + b1))
struct EpiGeluBf16 {
  using Out = __nv_bfloat16;
  static constexpr bool kRowScale = false;
  static __device__ __forceinline__ Out apply(float v, float s, float b,
                                              float) {
    return __float2bfloat16_rn(gelu(__fadd_rn(__fmul_rn(v, s), b)));
  }
};

// W8A8 fc1: gelu(acc * xs * s1 + b1) in fp32
struct EpiGeluF32 {
  using Out = float;
  static constexpr bool kRowScale = true;
  static __device__ __forceinline__ Out apply(int v, float s, float b,
                                              float r) {
    return gelu(
        __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(v), r), s), b));
  }
};

// fc2, both kinds: bf16(acc * s2 + b2)
struct EpiBias {
  using Out = __nv_bfloat16;
  static constexpr bool kRowScale = false;
  static __device__ __forceinline__ Out apply(float v, float s, float b,
                                              float) {
    return __float2bfloat16_rn(__fadd_rn(__fmul_rn(v, s), b));
  }
};

}  // namespace

// x: (M, C) bf16 (a8 == 0) or int8 rows with their fp32 scales xs (a8 != 0);
// w1 (L, H, C), w2 (L, C, H) int8; s1 (L, H), s2 (L, C), b1 (H,), b2 (C,)
// fp32; layer: int32 in device memory. hidden: (M, H) scratch, bf16
// (weight-only) or fp32 (a8); a8 only: hq (M, H) int8 and hs (M, H / bh)
// fp32 scratch; out: (M, C) bf16. C, H multiples of 128, bh a multiple of
// 128 dividing H. Returns the CUDA error of the launches (0 when they were
// accepted).
extern "C" int mla_q8_mlp(const void* x, const void* xs, const void* w1,
                          const void* s1, const void* b1, const void* w2,
                          const void* s2, const void* b2, const void* layer,
                          int L, void* hidden, void* hq, void* hs, void* out,
                          int M, int C, int H, int bh, int a8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* li = static_cast<const int*>(layer);
  const auto* w1q = static_cast<const int8_t*>(w1);
  const auto* w2q = static_cast<const int8_t*>(w2);
  Args fc1{static_cast<const float*>(s1), static_cast<const float*>(b1),
           static_cast<const float*>(xs), li, hidden, L, M, H, C, 0};
  Args fc2{static_cast<const float*>(s2), static_cast<const float*>(b2),
           nullptr, li, out, L, M, C, H, 0};
  int e;
  if (a8) {
    e = gemm<A_S8, EpiGeluF32>(x, w1q, fc1, st);
    if (e != 0) return e;
    e = quantize_rows(hidden, static_cast<int8_t*>(hq),
                      static_cast<float*>(hs), M * (H / bh), bh, true, st);
    if (e != 0) return e;
    fc2.xs = static_cast<const float*>(hs);
    fc2.group = bh;
    return gemm<A_S8G, EpiBias>(hq, w2q, fc2, st);
  }
  e = gemm<A_BF16, EpiGeluBf16>(x, w1q, fc1, st);
  if (e != 0) return e;
  return gemm<A_BF16, EpiBias>(hidden, w2q, fc2, st);
}
