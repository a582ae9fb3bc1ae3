// The int8 GEMM main loop shared by q8_matmul.cu (B4, B5) and q8_mlp.cu (B6),
// for Hopper (sm_90a).
//
// C[M, N] = A[M, K] . W[N, K]^T with W int8 (PyTorch's Linear layout: one
// row of K weights per output channel). Two operand kinds:
//  - A bf16 (weight-only): mma.sync m16n8k16 bf16 x bf16 -> fp32; the int8
//    weights are converted to bf16 (exact, |q| <= 127) on the way from
//    shared memory into the B fragments.
//  - A int8 (W8A8): mma.sync m16n8k32 s8 x s8 -> exact int32.
// A third kind, A fp32 with per-(row, group) maxima, serves the W8A8 MLP's
// fc2: each 64-wide k-stage of the fp32 hidden is quantized to int8 on its
// way into shared memory, and the int32 sums are flushed into fp32
// accumulators times the row's group scale at every group boundary.
//
// Block tile BM x 128 (BM = 128 or 64), 8 warps, each warp 32 x (128 / (8 /
// (BM / 32))); every k-stage moves 64 bytes of each A row and 32 (bf16
// path) or 64 (int8 path) bytes of each W row through two shared-memory
// stages filled by cp.async (16-byte chunks, rows past M zero-filled).
// Rows are padded to 80 bytes, which makes the fragment loads free of bank
// conflicts. The epilogue is a functor called with each thread's pairs of
// adjacent output columns.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace q8 {

constexpr int kThreads = 256;
constexpr int BN = 128;
constexpr int ROW = 80;  // bytes of one padded shared-memory row (64 + 16)

enum AKind { A_BF16 = 0, A_S8 = 1, A_F32Q = 2 };

constexpr int kSMs = 132;  // the H100 SXM's streaming multiprocessors

// The tile height BM for an M x N output: 128 when 128-row tiles fill the
// SMs at least twice over, else 64 (more blocks for small outputs).
inline int pick_bm(int M, int N) {
  return ((M + 127) / 128) * (N / BN) >= 2 * kSMs ? 128 : 64;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two int8 weights (k, k+1) -> a bf16x2 register, lower k in the low half
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t v) {
  float lo = static_cast<float>(static_cast<int8_t>(v & 0xff));
  float hi = static_cast<float>(static_cast<int8_t>((v >> 8) & 0xff));
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// q = clip(round-half-even(v / s), -127, 127) as one byte
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  float q = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xff;
}

// Per-thread geometry of a BM x 128 tile computed by 8 warps.
template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;  // columns per warp
  static constexpr int MT = 2;             // m16 tiles per warp
  static constexpr int NT = WN / 8;        // n8 tiles per warp
};

// The main loop. A: (M, K) rows of a_bytes bytes each element-wise as the
// kind says; W: (N, K) int8. acc receives the sums of k in [0, K) (for
// A_F32Q: the group-scaled fp32 sums). Then epi(row, col, v0, v1) is called
// for each pair of adjacent columns the thread owns (rows may exceed M: the
// functor skips them).
//
// A_F32Q arguments: gmax (M, K / kgroup) uint32 bit patterns of the groups'
// max |a| (non-negative floats); the stage of k-tile kt quantizes with
// s = max(gmax, 1e-12) / 127 of group kt*64 / kgroup.
template <int BM, int KIND, typename Epi>
__device__ __forceinline__ void gemm_tile(const void* __restrict__ A,
                                          const int8_t* __restrict__ W, int M,
                                          int K, int N, int m0, int n0,
                                          const uint32_t* __restrict__ gmax,
                                          int kgroup, Epi epi) {
  using T = Tile<BM>;
  constexpr bool S8 = KIND != A_BF16;
  constexpr int WROW = S8 ? 64 : 32;        // W bytes per row per stage
  constexpr int KSTAGE = S8 ? 64 : 32;      // k per stage
  constexpr int A_CHUNKS = BM * 4 / kThreads;
  constexpr int W_CHUNKS = BN * (WROW / 16) / kThreads;
  using Acc = typename std::conditional<S8, int, float>::type;

  __shared__ __align__(128) uint8_t As[2][BM * ROW];
  __shared__ __align__(128) uint8_t Ws[2][BN * ROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* a8 = static_cast<const uint8_t*>(A);
  const size_t a_row_bytes = static_cast<size_t>(K) * (KIND == A_BF16 ? 2 : 1);

  Acc acc[T::MT][T::NT][4];
  float facc[T::MT][T::NT][4];  // A_F32Q only (otherwise optimised away)
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  if constexpr (KIND == A_F32Q) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) facc[i][j][e] = 0.f;
  }

  // A_F32Q: this thread quantizes 64 * BM / 256 consecutive floats of one row
  // per stage (BM = 64: 16 floats, one 16-byte store).
  constexpr int QF = 64 * BM / kThreads;
  const int q_row = tid / (64 / QF), q_col = (tid % (64 / QF)) * QF;
  const float* af = static_cast<const float*>(A);
  float4 qv[QF / 4];

  auto load_w = [&](int kt, int s) {
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      int id = tid + i * kThreads;
      int row = id / (WROW / 16), c = id % (WROW / 16);
      cp_async16(&Ws[s][row * ROW + c * 16],
                 W + static_cast<size_t>(n0 + row) * K + kt * KSTAGE + c * 16,
                 true);
    }
  };
  auto load_a = [&](int kt, int s) {
    if (KIND == A_F32Q) {
      const int m = m0 + q_row;
      const bool ok = m < M;
      const float* src = af + static_cast<size_t>(ok ? m : 0) * K +
                         kt * 64 + q_col;
#pragma unroll
      for (int i = 0; i < QF / 4; ++i)
        qv[i] = ok ? reinterpret_cast<const float4*>(src)[i]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        int id = tid + i * kThreads;
        int row = id >> 2, c = id & 3;
        int m = m0 + row;
        bool ok = m < M;
        const uint8_t* src =
            ok ? a8 + static_cast<size_t>(m) * a_row_bytes + kt * 64 + c * 16
               : a8;
        cp_async16(&As[s][row * ROW + c * 16], src, ok);
      }
    }
  };
  // A_F32Q: quantize the registers loaded by load_a into stage s
  auto store_a = [&](int kt, int s) {
    if (KIND == A_F32Q) {
      const int m = m0 + q_row;
      const int ng = K / kgroup;
      float sc = 1.f;
      if (m < M)
        sc = fmaxf(__uint_as_float(gmax[static_cast<size_t>(m) * ng +
                                        (kt * 64) / kgroup]),
                   1e-12f) / 127.f;
      uint32_t w[QF / 4];
#pragma unroll
      for (int i = 0; i < QF / 4; ++i)
        w[i] = quant_byte(qv[i].x, sc) | (quant_byte(qv[i].y, sc) << 8) |
               (quant_byte(qv[i].z, sc) << 16) | (quant_byte(qv[i].w, sc) << 24);
      uint8_t* dst = &As[s][q_row * ROW + q_col];
#pragma unroll
      for (int i = 0; i < QF / 16; ++i)
        *reinterpret_cast<uint4*>(dst + 16 * i) =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    }
  };
  // A_F32Q: acc (int32 sums of one group) -> facc, times each row's scale
  auto flush_group = [&](int grp) {
    const int ng = K / kgroup;
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        float sc = 0.f;
        if (m < M)
          sc = fmaxf(__uint_as_float(gmax[static_cast<size_t>(m) * ng + grp]),
                     1e-12f) / 127.f;
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            facc[i][j][2 * h + e] = __fadd_rn(
                facc[i][j][2 * h + e],
                __fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), sc));
            acc[i][j][2 * h + e] = 0;
          }
      }
    }
  };

  const int KT = K / KSTAGE;
  const int stages_per_group = KIND == A_F32Q ? kgroup / 64 : 0;
  load_w(0, 0);
  load_a(0, 0);
  store_a(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      load_w(kt + 1, s ^ 1);
      load_a(kt + 1, s ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* as = As[s];
    const uint8_t* ws = Ws[s];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // two mma k-steps per stage
      uint32_t af_[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const uint8_t* r0 = as + (wm * 32 + i * 16 + g) * ROW + kk * 32;
        const uint8_t* r1 = r0 + 8 * ROW;
        // bf16: 4 bytes = k pair t*2; int8: 4 bytes = k quad t*4
        af_[i][0] = ld32(r0 + t * 4);
        af_[i][1] = ld32(r1 + t * 4);
        af_[i][2] = ld32(r0 + 16 + t * 4);
        af_[i][3] = ld32(r1 + 16 + t * 4);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const uint8_t* wr = ws + (wn * T::WN + j * 8 + g) * ROW;
        uint32_t bf[2];
        if (S8) {
          bf[0] = ld32(wr + kk * 32 + t * 4);
          bf[1] = ld32(wr + kk * 32 + 16 + t * 4);
        } else {
          bf[0] = s8x2_to_bf16x2(ld16(wr + kk * 16 + t * 2));
          bf[1] = s8x2_to_bf16x2(ld16(wr + kk * 16 + 8 + t * 2));
        }
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          if constexpr (S8)
            mma_s8(reinterpret_cast<int*>(acc[i][j]), af_[i], bf);
          else
            mma_bf16(reinterpret_cast<float*>(acc[i][j]), af_[i], bf);
        }
      }
    }
    if constexpr (KIND == A_F32Q) {
      if (kt + 1 < KT) store_a(kt + 1, s ^ 1);
    }
    __syncthreads();
    if constexpr (KIND == A_F32Q) {
      if ((kt + 1) % stages_per_group == 0) flush_group(kt / stages_per_group);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
        const int col = n0 + wn * T::WN + j * 8 + t * 2;
        if constexpr (KIND == A_F32Q)
          epi(row, col, facc[i][j][2 * h], facc[i][j][2 * h + 1]);
        else
          epi(row, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

}  // namespace q8
