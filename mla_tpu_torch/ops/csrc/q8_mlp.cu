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
// Design: two launches, not one. The TPU kernel keeps a (rows x bh) hidden
// tile in VMEM between its fc1 and fc2 products; on an SM a useful row count
// times bh = 1536 fp32 columns, plus the (rows x C) accumulator, does not fit
// 227 KB, and the W8A8 law needs the max over a whole bh group before it can
// quantize any of it, which no single output tile of fc1 sees. So fc1 (the
// q8_gemm.cuh main loop with a scale + bias + GELU epilogue) writes the
// hidden to device memory - bf16 for weight-only, fp32 for W8A8 together
// with each (row, group)'s max |g|, merged by atomicMax on the float bits
// (a group spans whole 128-column tiles: bh is a multiple of 128). fc2 reads
// it back - for W8A8 quantizing each 64-wide k-stage with its group's scale
// on the way into shared memory and flushing the int32 sums into fp32 at
// each group boundary - and applies the scale + bias epilogue. The hidden
// round trip costs M * H * 4 bytes (bf16) or 8 bytes (fp32) of traffic:
// 101 / 202 MB at rung 64 (16448 rows, H = 3072), 30 / 60 us at 3.35 TB/s,
// beside 155 GFLOP (157 us at the bf16 peak, 78 us at the int8 peak).
#include "q8_gemm.cuh"

namespace {

using namespace q8;

constexpr float kSqrt1_2 = 0.7071067811865476f;

__device__ __forceinline__ float gelu(float t) {
  return __fmul_rn(__fmul_rn(0.5f, t),
                   __fadd_rn(1.f, erff(__fmul_rn(t, kSqrt1_2))));
}

__device__ __forceinline__ int clamp_layer(const int* layer, int L) {
  return min(max(*layer, 0), L - 1);
}

// fc1: hidden = gelu(x . W1[l]^T * s1 + b1), bf16 (weight-only) or fp32 plus
// the (row, group) max |g| (W8A8).
template <int BM, int KIND>
__global__ void __launch_bounds__(kThreads)
fc1_kernel(const void* __restrict__ x, const float* __restrict__ xs,
           const int8_t* __restrict__ w1, const float* __restrict__ s1,
           const float* __restrict__ b1, const int* __restrict__ layer, int L,
           void* __restrict__ hidden, unsigned* __restrict__ gmax, int M,
           int C, int H, int bh) {
  const int l = clamp_layer(layer, L);
  w1 += static_cast<size_t>(l) * H * C;
  s1 += static_cast<size_t>(l) * H;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this thread's rows are base + {0, 8, 16, 24}
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = m0 + (warp % Tile<BM>::WARPS_M) * 32 + (lane >> 2);
  float rmax[4] = {0.f, 0.f, 0.f, 0.f};
  auto epi = [&](int row, int col, auto v0, auto v1) {
    float t0, t1;
    if constexpr (KIND == A_BF16) {
      t0 = __fadd_rn(__fmul_rn(v0, s1[col]), b1[col]);
      t1 = __fadd_rn(__fmul_rn(v1, s1[col + 1]), b1[col + 1]);
    } else {
      const float r = row < M ? xs[row] : 0.f;
      t0 = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(v0), r),
                               s1[col]), b1[col]);
      t1 = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(v1), r),
                               s1[col + 1]), b1[col + 1]);
    }
    const float g0 = gelu(t0), g1 = gelu(t1);
    if (row >= M) return;
    const size_t at = static_cast<size_t>(row) * H + col;
    if constexpr (KIND == A_BF16) {
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(hidden) + at) =
          pack_bf16x2(g0, g1);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(hidden) + at) =
          make_float2(g0, g1);
      const int i = (row - base) >> 3;
      rmax[i] = fmaxf(rmax[i], fmaxf(fabsf(g0), fabsf(g1)));
    }
  };
  gemm_tile<BM, KIND>(x, w1, M, C, H, m0, n0, nullptr, 0, epi);
  if constexpr (KIND != A_BF16) {
    const int ng = H / bh, grp = n0 / bh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = rmax[i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int row = base + 8 * i;
      if ((lane & 3) == 0 && row < M)
        atomicMax(gmax + static_cast<size_t>(row) * ng + grp,
                  __float_as_uint(v));
    }
  }
}

// fc2: out = bf16(hidden . W2[l]^T * s2 + b2); W8A8 quantizes the fp32
// hidden per (row, group) on its way in (q8_gemm.cuh A_F32Q).
template <int BM, int KIND>
__global__ void __launch_bounds__(kThreads)
fc2_kernel(const void* __restrict__ hidden, const unsigned* __restrict__ gmax,
           const int8_t* __restrict__ w2, const float* __restrict__ s2,
           const float* __restrict__ b2, const int* __restrict__ layer, int L,
           __nv_bfloat16* __restrict__ out, int M, int C, int H, int bh) {
  const int l = clamp_layer(layer, L);
  w2 += static_cast<size_t>(l) * C * H;
  s2 += static_cast<size_t>(l) * C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  auto epi = [&](int row, int col, float v0, float v1) {
    if (row >= M) return;
    const float o0 = __fadd_rn(__fmul_rn(v0, s2[col]), b2[col]);
    const float o1 = __fadd_rn(__fmul_rn(v1, s2[col + 1]), b2[col + 1]);
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * C + col) =
        pack_bf16x2(o0, o1);
  };
  gemm_tile<BM, KIND>(hidden, w2, M, H, C, m0, n0, gmax, bh, epi);
}

template <int KIND, int BM>
void fc1(const void* x, const float* xs, const int8_t* w1, const float* s1,
         const float* b1, const int* layer, int L, void* hidden,
         unsigned* gmax, int M, int C, int H, int bh, cudaStream_t st) {
  dim3 grid((M + BM - 1) / BM, H / BN);
  fc1_kernel<BM, KIND><<<grid, kThreads, 0, st>>>(x, xs, w1, s1, b1, layer, L,
                                                 hidden, gmax, M, C, H, bh);
}

}  // namespace

// x: (M, C) bf16 (a8 == 0) or int8 rows with their fp32 scales xs (a8 != 0);
// w1 (L, H, C), w2 (L, C, H) int8; s1 (L, H), s2 (L, C), b1 (H,), b2 (C,)
// fp32; layer: int32 in device memory. hidden: (M, H) scratch, bf16
// (weight-only) or fp32 (a8); gmax: (M, H / bh) 32-bit scratch (a8 only);
// out: (M, C) bf16. C, H multiples of 128, bh a multiple of 128 dividing H.
// Returns the CUDA error of the launches (0 when they were accepted).
extern "C" int mla_q8_mlp(const void* x, const void* xs, const void* w1,
                          const void* s1, const void* b1, const void* w2,
                          const void* s2, const void* b2, const void* layer,
                          int L, void* hidden, void* gmax, void* out, int M,
                          int C, int H, int bh, int a8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w1q = static_cast<const int8_t*>(w1);
  const auto* w2q = static_cast<const int8_t*>(w2);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* s2f = static_cast<const float*>(s2);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* li = static_cast<const int*>(layer);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* gm = static_cast<unsigned*>(gmax);
  const bool big = pick_bm(M, H) == 128;
  if (a8) {
    cudaError_t e = cudaMemsetAsync(
        gm, 0, static_cast<size_t>(M) * (H / bh) * sizeof(unsigned), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const auto* xsf = static_cast<const float*>(xs);
    if (big)
      fc1<A_S8, 128>(x, xsf, w1q, s1f, b1f, li, L, hidden, gm, M, C, H, bh, st);
    else
      fc1<A_S8, 64>(x, xsf, w1q, s1f, b1f, li, L, hidden, gm, M, C, H, bh, st);
    cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return static_cast<int>(e1);
    dim3 grid((M + 63) / 64, C / BN);
    fc2_kernel<64, A_F32Q><<<grid, kThreads, 0, st>>>(hidden, gm, w2q, s2f,
                                                      b2f, li, L, o, M, C, H,
                                                      bh);
  } else {
    if (big)
      fc1<A_BF16, 128>(x, nullptr, w1q, s1f, b1f, li, L, hidden, nullptr, M,
                       C, H, H, st);
    else
      fc1<A_BF16, 64>(x, nullptr, w1q, s1f, b1f, li, L, hidden, nullptr, M,
                      C, H, H, st);
    cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return static_cast<int>(e1);
    if (pick_bm(M, C) == 128) {
      dim3 grid((M + 127) / 128, C / BN);
      fc2_kernel<128, A_BF16><<<grid, kThreads, 0, st>>>(
          hidden, nullptr, w2q, s2f, b2f, li, L, o, M, C, H, H);
    } else {
      dim3 grid((M + 63) / 64, C / BN);
      fc2_kernel<64, A_BF16><<<grid, kThreads, 0, st>>>(
          hidden, nullptr, w2q, s2f, b2f, li, L, o, M, C, H, H);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
