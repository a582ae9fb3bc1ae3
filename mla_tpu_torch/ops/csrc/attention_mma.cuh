// The tensor-core building blocks of the bf16 attention kernels
// (flat_attention.cu, the forward; flat_attention_bwd.cu, the backward), for
// sm_90a: cp.async staging of bf16 rows into shared memory, ldmatrix, and
// mma.sync m16n8k16 with fp32 accumulation. Both sources include this one
// header; its text is part of both libraries' build hash (_build.py).
//
// Fragment coordinates, as the PTX ISA gives them for m16n8k16: lane =
// 4 * g + t holds rows g and g + 8 and columns 2t, 2t + 1 (+ 8) of each
// 16 x 16 A tile and 16 x 8 accumulator tile; for ldmatrix, lane = 8 * mi +
// mr gives the address of row mr of matrix mi.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; each lane gives one row address
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Sum over the 4 threads of a quad (neighbouring lanes). Every lane of the
// warp must call it.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Rows r0 .. r0+ROWS-1 of one plane (D bf16 each, `row_bytes` apart) -> a
// shared tile of rows D + 8 halves apart, by cp.async from the block's NTH
// threads; rows past S are zero.
template <int D, int ROWS, int NTH>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const char* plane,
                                           long long row_bytes, int r0,
                                           int S) {
  constexpr int P = D + 8, CPR = D / 8;   // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NTH) {
    const int r = idx / CPR, c = idx % CPR;
    const int j = r0 + r;
    const bool ok = j < S;
    cp_async16(dst + r * P + 8 * c,
               plane + (ok ? j : 0) * row_bytes + 16 * c, ok);
  }
}

// src[r0 .. r0+ROWS-1] -> dst by cp.async; entries past S are zero
template <int ROWS, int NTH>
__device__ __forceinline__ void stage_floats(float* dst, const float* src,
                                             int r0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += NTH) {
    const int j = r0 + r;
    cp_async4(dst + r, src + (j < S ? j : 0), j < S);
  }
}

// The A fragments (m16n8k16, one per 16 columns) of rows m0 .. m0+15 of a
// plane; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (*f)[4], const char* plane,
                                       long long row_bytes, int m0, int S,
                                       int g, int t) {
  const int r0 = m0 + g, r1 = r0 + 8;
  const char* p0 = plane + r0 * row_bytes + 4 * t;
  const char* p1 = plane + r1 * row_bytes + 4 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 32 * kk;                  // byte column of the k-step
    f[kk][0] = r0 < S ? __ldg(reinterpret_cast<const unsigned*>(p0 + c)) : 0u;
    f[kk][1] = r1 < S ? __ldg(reinterpret_cast<const unsigned*>(p1 + c)) : 0u;
    f[kk][2] = r0 < S ? __ldg(reinterpret_cast<const unsigned*>(p0 + c + 16))
                      : 0u;
    f[kk][3] = r1 < S ? __ldg(reinterpret_cast<const unsigned*>(p1 + c + 16))
                      : 0u;
  }
}

// acc[j] (j < CK/8: tile rows c0 + 8j ..) += A . T[c0 .., :]^T, A the 16 x D
// fragments `a`, T a staged tile; 16 tile rows at a time while they hold
// one of the nc real rows.
template <int D, int CK>
__device__ __forceinline__ void product_nt(float (*acc)[4],
                                           const uint32_t (*a)[4],
                                           const uint16_t* T, int c0, int nc,
                                           int mi, int mr) {
  constexpr int P = D + 8;
#pragma unroll
  for (int jp = 0; jp < CK / 16; ++jp) {
    if (jp * 16 < nc) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        // matrices: (n, k), (n, k + 8), (n + 8, k), (n + 8, k + 8)
        uint32_t r[4];
        ldsm_x4<false>(r, &T[(c0 + 16 * jp + (mi >> 1) * 8 + mr) * P +
                             16 * kd + (mi & 1) * 8]);
        mma_bf16(acc[2 * jp], a[kd], r[0], r[1]);
        mma_bf16(acc[2 * jp + 1], a[kd], r[2], r[3]);
      }
    }
  }
}

// acc[n] (n < D/8) += X . T[c0 .. c0+CK-1, :], X the 16 x CK fragments `x`
// (one per 16 tile rows), 16 tile rows at a time while they hold one of the
// nc real rows.
template <int D, int CK>
__device__ __forceinline__ void product_nn(float (*acc)[4],
                                           const uint32_t (*x)[4],
                                           const uint16_t* T, int c0, int nc,
                                           int mi, int mr) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < CK / 16; ++kk) {
    if (kk * 16 < nc) {
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        // matrices: (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
        uint32_t r[4];
        ldsm_x4<true>(r, &T[(c0 + 16 * kk + (mi & 1) * 8 + mr) * P +
                            16 * jd + (mi >> 1) * 8]);
        mma_bf16(acc[2 * jd], x[kk], r[0], r[1]);
        mma_bf16(acc[2 * jd + 1], x[kk], r[2], r[3]);
      }
    }
  }
}

// fp32 accumulator fragments of a 16 x CK block -> its bf16 A fragments
template <int CK>
__device__ __forceinline__ void to_a(uint32_t (*x)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < CK / 16; ++kk) {
    x[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    x[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    x[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    x[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

}  // namespace
