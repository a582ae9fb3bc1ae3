// int8 GEMMs of int8 and W8A8 serving for Hopper (sm_90a), plain C interface:
// B4 and B5, and the row quantization of W8A8 activations.
//
// Replaces mla_tpu/ops/q8_matmul.py:_kernel and _kernel_a8 (B4, behind
// _q8_matmul_pallas) and _kernel_stacked and _kernel_stacked_a8 (B5, behind
// _q8_stacked_pallas). B5 is B4 on layer l of an (L, N, K) stack: the layer
// id arrives as an int32 scalar in device memory, read and clamped to
// [0, L-1] by every block (the TPU kernel's scalar-prefetch index map), so
// the launch never waits on the host for it.
//
// Semantics (x (M, K), W (N, K) int8, s (N,) fp32, out (M, N) bf16):
//   weight-only: out = bf16(sum_k bf16(x)[m, k] * W[n, k] (fp32) * s[n])
//   W8A8:        out = bf16(bf16(sum_k xq[m, k] * W[n, k] (int32) * s[n])
//                           * xs[m])
// where xq, xs are x quantized per row by mla_q8_quantize_rows. The W8A8
// output rounds twice, as the JAX package's kernel flush and wrapper do.
//
// Row quantization (the XLA ops around the JAX kernel, quantize_rows): one
// warp per row reads it twice, for its max |x| and then to write
// clip(round-half-even(x / xs), -127, 127) with xs = max(max|x|, 1e-12)/127.
//
// Design: the mma.sync main loop of q8_gemm.cuh, 128 x 128 tiles (64 x 128
// when fewer than two waves of 128-row tiles would fill the SMs: pick_bm), two
// cp.async stages. Bound at the qkv site of rung 64 (16448 rows, K = 768,
// N = 2304): 58 GFLOP, 59 us at the bf16 peak (weight-only), 29 us at the
// int8 peak (W8A8), against ~100 MB of traffic, 30 us: both kinds are
// bound by operations at large rungs and by bytes (the weight) at rung 1.
// mma.sync cannot reach the wgmma peak; wgmma and TMA are the later step.
#include "q8_gemm.cuh"

namespace {

using namespace q8;

constexpr int kRowsPerBlock = 8;  // rows quantized per 256-thread block

template <bool F32>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const void* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;
  constexpr int V = 8;  // values per 16-byte (bf16) or two 16-byte (fp32) loads
  auto load8 = [&](int c, float* v) {
    if (F32) {
      const float4* p = reinterpret_cast<const float4*>(
          static_cast<const float*>(x) + static_cast<size_t>(m) * K + c * V);
      float4 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      uint4 u = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(x) + static_cast<size_t>(m) * K)[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  };
  const int chunks = K / V;
  float amax = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[V];
    load8(c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, 1e-12f) / 127.f;
  if (lane == 0) xs[m] = s;
  for (int c = lane; c < chunks; c += 32) {
    float v[V];
    load8(c, v);
    uint2 q;
    q.x = quant_byte(v[0], s) | (quant_byte(v[1], s) << 8) |
          (quant_byte(v[2], s) << 16) | (quant_byte(v[3], s) << 24);
    q.y = quant_byte(v[4], s) | (quant_byte(v[5], s) << 8) |
          (quant_byte(v[6], s) << 16) | (quant_byte(v[7], s) << 24);
    reinterpret_cast<uint2*>(xq + static_cast<size_t>(m) * K)[c] = q;
  }
}

template <int BM, int KIND>
__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const void* __restrict__ x, const float* __restrict__ xs,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const int* __restrict__ layer, int L,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  int l = layer ? *layer : 0;
  l = min(max(l, 0), L - 1);
  w += static_cast<size_t>(l) * N * K;
  scale += static_cast<size_t>(l) * N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  auto epi = [&](int row, int col, auto v0, auto v1) {
    if (row >= M) return;
    const float s0 = scale[col], s1 = scale[col + 1];
    float o0, o1;
    if constexpr (KIND == A_BF16) {
      o0 = __fmul_rn(v0, s0);
      o1 = __fmul_rn(v1, s1);
    } else {  // bf16(bf16(acc * s) * xs)
      const float r = xs[row];
      o0 = __fmul_rn(__bfloat162float(__float2bfloat16_rn(
                         __fmul_rn(static_cast<float>(v0), s0))), r);
      o1 = __fmul_rn(__bfloat162float(__float2bfloat16_rn(
                         __fmul_rn(static_cast<float>(v1), s1))), r);
    }
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + col) =
        pack_bf16x2(o0, o1);
  };
  gemm_tile<BM, KIND>(x, w, M, K, N, m0, n0, nullptr, 0, epi);
}

template <int KIND>
void launch(const void* x, const float* xs, const int8_t* w, const float* s,
            const int* layer, int L, __nv_bfloat16* out, int M, int K, int N,
            cudaStream_t st) {
  if (pick_bm(M, N) == 128) {
    dim3 grid((M + 127) / 128, N / BN);
    q8_matmul_kernel<128, KIND><<<grid, kThreads, 0, st>>>(x, xs, w, s, layer,
                                                          L, out, M, K, N);
  } else {
    dim3 grid((M + 63) / 64, N / BN);
    q8_matmul_kernel<64, KIND><<<grid, kThreads, 0, st>>>(x, xs, w, s, layer,
                                                         L, out, M, K, N);
  }
}

}  // namespace

// x: (M, K) bf16 (fp32 when f32 != 0); xq: (M, K) int8; xs: (M,) fp32.
// K % 64 == 0, 16-byte aligned rows. Returns the launch's CUDA error.
extern "C" int mla_q8_quantize_rows(const void* x, void* xq, void* xs, int M,
                                    int K, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  if (f32)
    quantize_rows_kernel<true><<<grid, kThreads, 0, st>>>(
        x, static_cast<int8_t*>(xq), static_cast<float*>(xs), M, K);
  else
    quantize_rows_kernel<false><<<grid, kThreads, 0, st>>>(
        x, static_cast<int8_t*>(xq), static_cast<float*>(xs), M, K);
  return static_cast<int>(cudaGetLastError());
}

// x: (M, K) bf16 (a8 == 0) or int8 rows with their fp32 scales xs (a8 != 0);
// w: (L, N, K) int8 and scale (L, N) fp32, layer l = clamp(*layer, 0, L-1)
// (layer null: l = 0, B4); out: (M, N) bf16. K % 64 == 0, N % 128 == 0.
// Returns the launch's CUDA error (0 when it was accepted).
extern "C" int mla_q8_matmul(const void* x, const void* xs, const void* w,
                             const void* scale, const void* layer, int L,
                             void* out, int M, int K, int N, int a8,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* s = static_cast<const float*>(scale);
  const auto* li = static_cast<const int*>(layer);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (a8)
    launch<A_S8>(x, static_cast<const float*>(xs), wq, s, li, L, o, M, K, N,
                 st);
  else
    launch<A_BF16>(x, nullptr, wq, s, li, L, o, M, K, N, st);
  return static_cast<int>(cudaGetLastError());
}
