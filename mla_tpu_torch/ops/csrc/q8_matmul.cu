// int8 GEMMs of int8 and W8A8 serving for Hopper (sm_90a), plain C interface:
// B4 and B5, and the row quantization of W8A8 activations.
//
// Replaces mla_tpu/ops/q8_matmul.py:_kernel and _kernel_a8 (B4, behind
// _q8_matmul_pallas) and _kernel_stacked and _kernel_stacked_a8 (B5, behind
// _q8_stacked_pallas). B5 is B4 on layer l of an (L, N, K) stack: the layer
// id arrives as an int32 scalar in device memory, read and clamped to
// [0, L-1] by every block (the TPU kernel's scalar-prefetch index map) and
// handed to the weight's TMA loads as their third coordinate, so the launch
// never waits on the host for it.
//
// Semantics (x (M, K), W (N, K) int8, s (N,) fp32, out (M, N) bf16):
//   weight-only: out = bf16(sum_k bf16(x)[m, k] * W[n, k] (fp32) * s[n])
//   W8A8:        out = bf16(bf16(sum_k xq[m, k] * W[n, k] (int32) * s[n])
//                           * xs[m])
// where xq, xs are x quantized per row by mla_q8_quantize_rows. The W8A8
// output rounds twice, as the JAX package's kernel flush and wrapper do.
//
// Row quantization (the XLA ops around the JAX kernel, quantize_rows): one
// warp per row finds its max |x| and writes clip(round-half-even(x / xs),
// -127, 127) with xs = max(max|x|, 1e-12)/127, holding the row in registers
// in between (rows of up to 3072 bf16 values; longer ones are read twice).
//
// Design: the persistent wgmma kernel of q8_gemm.cuh (TMA ring, one
// producer thread, two consumer warpgroups, TMA-store epilogue; weight-only
// converts each weight element to bf16 once per block and feeds it as
// wgmma's register operand). Bound at the qkv site of rung 64 (16448 rows,
// K = 768, N = 2304): 58 GFLOP, 59 us at the bf16 peak (weight-only), 29 us
// at the int8 peak (W8A8), against ~100 MB of traffic, 30 us: both kinds
// are bound by operations at large rungs, and by the launch and the host
// at rung 1.
#include "q8_gemm.cuh"

namespace {

using namespace q8;

// weight-only: bf16(acc * s)
struct EpiScale {
  using Out = __nv_bfloat16;
  static constexpr bool kRowScale = false;
  static __device__ __forceinline__ Out apply(float v, float s, float, float) {
    return __float2bfloat16_rn(__fmul_rn(v, s));
  }
};

// W8A8: bf16(bf16(acc * s) * xs)
struct EpiA8 {
  using Out = __nv_bfloat16;
  static constexpr bool kRowScale = true;
  static __device__ __forceinline__ Out apply(int v, float s, float,
                                              float r) {
    return __float2bfloat16_rn(__fmul_rn(
        __bfloat162float(
            __float2bfloat16_rn(__fmul_rn(static_cast<float>(v), s))),
        r));
  }
};

}  // namespace

// x: (M, K) bf16 (fp32 when f32 != 0); xq: (M, K) int8; xs: (M,) fp32.
// K % 64 == 0, 16-byte aligned rows. Returns the launch's CUDA error.
extern "C" int mla_q8_quantize_rows(const void* x, void* xq, void* xs, int M,
                                    int K, int f32, void* stream) {
  return quantize_rows(x, static_cast<int8_t*>(xq), static_cast<float*>(xs),
                       M, K, f32 != 0, static_cast<cudaStream_t>(stream));
}

// x: (M, K) bf16 (a8 == 0) or int8 rows with their fp32 scales xs (a8 != 0);
// w: (L, N, K) int8 and scale (L, N) fp32, layer l = clamp(*layer, 0, L-1)
// (layer null: l = 0, B4); out: (M, N) bf16. K % 64 == 0, N % 128 == 0,
// 16-byte aligned. Returns the launch's CUDA error (0 when it was accepted).
extern "C" int mla_q8_matmul(const void* x, const void* xs, const void* w,
                             const void* scale, const void* layer, int L,
                             void* out, int M, int K, int N, int a8,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args args{static_cast<const float*>(scale), nullptr,
            static_cast<const float*>(xs), static_cast<const int*>(layer),
            out, L, M, N, K, 0};
  const auto* wq = static_cast<const int8_t*>(w);
  if (a8) return gemm<A_S8, EpiA8>(x, wq, args, st);
  return gemm<A_BF16, EpiScale>(x, wq, args, st);
}
