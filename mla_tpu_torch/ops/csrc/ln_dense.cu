// LayerNorm fused with the next Dense, forward and backward, for Hopper
// (sm_90a), plain C interface.
//
// Replaces mla_tpu/ops/fused_block.py: _ln_dense_kernel (B7f, behind
// ln_dense_pallas) and _ln_dense_bwd_dx_kernel + _ln_dense_bwd_dw_kernel
// (B7b, behind ln_dense_pallas_bwd). x is (N, C) in bf16 or fp32; the LN
// scale and bias are (C,) fp32; the Dense weight is (F, C) in the compute
// type (PyTorch's Linear layout; the JAX kernel's is (C, F)); its bias is
// (F,) fp32.
//
// Semantics (flax's LayerNorm and Dense, as the TPU kernels compute them):
// per row, fp32 statistics on the raw input, mean m = E[x] and the fast
// variance v = max(E[x^2] - m^2, 0), r = 1 / sqrt(v + eps); the LN output
// h = (x - m) * (r * scale) + bias in fp32 (each operation rounded, no
// fused multiply-add), rounded to the compute type; y = h . W^T with fp32
// accumulation, rounded to the compute type, plus the bias rounded to it,
// the sum rounded again. Backward, with dh = dy . W (fp32):
// dscale = sum_rows dh * xhat, dbias = sum_rows dh (xhat = (x - m) * r),
// dx = r * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) with dxh = dh * scale,
// dW = dy^T . h (h rounded to dy's type, fp32 sums), dc = sum_rows dy.
//
// Design.
//  - Forward, one launch (ln_dense_fwd_kernel): a block owns a tile of rows
//    and output columns. It first computes its rows' statistics (one warp a
//    row), then runs the GEMM over k-tiles of C; each A tile is normalized
//    on its way from x into shared memory and rounded to the compute type,
//    so the LN output never goes to device memory, which is the point of the
//    TPU kernel.
//  - Backward, four launches on the stream. The TPU kernel's dx step holds
//    a whole row block and all of W in VMEM and carries dscale/dbias from
//    one grid step to the next; on Hopper a block holds neither, and blocks
//    run in no order. So: (1) dh = dy . W as a GEMM into an fp32 scratch
//    (N, C); (2) a row pass (one warp a row) that recomputes the statistics
//    (kept for step 3), writes dx, and sums dh * xhat and dh per column into
//    per-block partials; (3) dW = dy^T . h as a GEMM over K = N rows, h
//    recomputed from x and the statistics on its way into shared memory,
//    the blocks of the first column tile also summing dc from the dy tiles
//    they stage; (4) the partials summed per column in block order. Every
//    sum runs in a fixed order, with no atomics: the gradients are the same
//    from run to run.
//  - GEMMs: bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulation,
//    fragments by ldmatrix, transposed where an operand's k is its slow
//    axis), 128 x 128 block tiles, 8 warps of 64 x 32, k-tiles of 32; fp32
//    on the FMA pipes, 64 x 64 tiles, 4 x 4 outputs a thread. Tiles pass
//    through shared memory once per k-tile with no pipelining: the simple
//    first version.
//
// Bounds at the M3AE training shape (N = 16448 rows, C = 768; the qkv site
// F = 2304, the fc1 site F = 3072), bf16: B7f moves x, W and y (25.3 + 3.5
// + 75.8 MB at F = 2304), 31 us at 3.35 TB/s, and does 2*N*C*F = 58.2 GFLOP,
// 59 us at the bf16 tensor-core peak: bound by operations. B7b reads x, dy
// and W and writes dx and dW (fp32), and does two such GEMMs: bound by
// operations too.
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // GEMM blocks
constexpr int BK = 32;          // k per tile
constexpr int kRowWarps = 4;    // row pass: warps per block
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kRowWarps * kRowsPerWarp;

// ---------------------------------------------------------------- elements

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// 8 consecutive elements at element index `idx` of `p` -> fp32
template <bool BF16>
__device__ __forceinline__ void load8(const void* p, size_t idx, float* v) {
  if constexpr (BF16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(p) + idx));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);      // low half = lower index
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + idx);
    const float4 a = __ldg(q), b = __ldg(q + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// x rounded to the compute type, kept as fp32
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <bool BF16>
__device__ __forceinline__ void store1(void* p, size_t idx, float x) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(p)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[idx] = x;
}

// ------------------------------------------------------------ statistics

// Mean and 1/sqrt(var + eps) of row `row` of x (N, C), computed by one warp
// (every lane gets them): fp32 sums of x and x^2 over the lanes' 8-wide
// pieces, then a fixed butterfly across the warp.
template <bool XB>
__device__ __forceinline__ void row_stats(const void* x, int row, int C,
                                          float eps, float& mean,
                                          float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    load8<XB>(x, static_cast<size_t>(row) * C + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s = __fadd_rn(s, v[i]);
      ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  }
  mean = __fdiv_rn(s, static_cast<float>(C));
  const float var = fmaxf(
      __fsub_rn(__fdiv_rn(ss, static_cast<float>(C)), __fmul_rn(mean, mean)),
      0.f);
  rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// ---------------------------------------------------------- tile loaders
//
// A loader fills a TR x TC tile whose origin is (r0, c0) of a row-major
// source matrix, 8 consecutive columns at a time (the source's column count
// is a multiple of 8; pieces past its edges are zero), handing each piece
// to put(tile row, tile column, 8 values).

template <bool BF16>
struct Copy {                 // a (rows, cols) matrix as it is
  const void* p;
  int rows, cols;

  template <int TR, int TC, class Put>
  __device__ __forceinline__ void fill(int r0, int c0, Put put) const {
    constexpr int CPR = TC / 8;
    for (int id = threadIdx.x; id < TR * CPR; id += kThreads) {
      const int r = id / CPR, c = (id % CPR) * 8;
      const int gr = r0 + r, gc = c0 + c;
      float v[8];
      if (gr < rows && gc < cols) {
        load8<BF16>(p, static_cast<size_t>(gr) * cols + gc, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      put(r, c, v);
    }
  }
};

template <bool XB>
struct Norm {                 // the LN output h of x (rows, cols), in fp32
  const void* x;
  const float* scale;
  const float* bias;
  const float* mean;          // mean[row - stat_base], rstd[row - stat_base]
  const float* rstd;
  int rows, cols, stat_base;

  template <int TR, int TC, class Put>
  __device__ __forceinline__ void fill(int r0, int c0, Put put) const {
    constexpr int CPR = TC / 8;
    for (int id = threadIdx.x; id < TR * CPR; id += kThreads) {
      const int r = id / CPR, c = (id % CPR) * 8;
      const int gr = r0 + r, gc = c0 + c;
      float v[8];
      if (gr < rows && gc < cols) {
        load8<XB>(x, static_cast<size_t>(gr) * cols + gc, v);
        const float m = mean[gr - stat_base], rs = rstd[gr - stat_base];
        float s[8], b[8];
        load8<false>(scale, gc, s);
        load8<false>(bias, gc, b);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], m), __fmul_rn(rs, s[i])),
                           b[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      put(r, c, v);
    }
  }
};

// --------------------------------------------------------- bf16 tensor cores

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// C[m0.., n0..] (128 x 128) = sum over k < K of A[m][k] B[k][n], bf16
// operands, fp32 sums. A_MN: A's source is k-major by rows (A[m][k] at
// source row k, column m), else m-major (source row m, column k); likewise
// B_MN for B (source row k, column n; else row n, column k). The tiles sit
// in shared memory as their sources lie (rows padded by 16 bytes, which
// keeps ldmatrix free of bank conflicts) and ldmatrix transposes the k-major
// ones. hook(k0, a_at) runs once per k-tile after it is staged, with
// a_at(k, m) reading the staged A. epi(row, col, value) takes each sum.
template <bool A_MN, bool B_MN, class LA, class LB, class Hook, class Epi>
__device__ __forceinline__ void mma_gemm(int K, int m0, int n0, const LA& la,
                                         const LB& lb, Hook hook, Epi epi) {
  constexpr int BM = 128, BN = 128;
  constexpr int PA = A_MN ? BM + 8 : BK + 8;   // halves per staged row
  constexpr int RA = A_MN ? BK : BM;           // staged rows
  constexpr int PB = B_MN ? BN + 8 : BK + 8;
  constexpr int RB = B_MN ? BK : BN;
  __shared__ __align__(16) uint16_t As[RA * PA];
  __shared__ __align__(16) uint16_t Bs[RB * PB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;     // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int mi = lane >> 3, mr = lane & 7;     // ldmatrix: matrix, its row

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto put_a = [&](int r, int c, const float* v) {
    *reinterpret_cast<uint4*>(&As[r * PA + c]) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  };
  auto put_b = [&](int r, int c, const float* v) {
    *reinterpret_cast<uint4*>(&Bs[r * PB + c]) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  };
  auto a_at = [&](int k, int m) {
    return bf16_bits_to_float(A_MN ? As[k * PA + m] : As[m * PA + k]);
  };

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tiles
    if constexpr (A_MN) la.template fill<BK, BM>(k0, m0, put_a);
    else la.template fill<BM, BK>(m0, k0, put_a);
    if constexpr (B_MN) lb.template fill<BK, BN>(k0, n0, put_b);
    else lb.template fill<BN, BK>(n0, k0, put_b);
    __syncthreads();
    hook(k0, a_at);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // matrices: (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)
        const int m = wm * 64 + i * 16 + (mi & 1) * 8;
        const int k = kk + (mi >> 1) * 8;
        if constexpr (A_MN) ldsm_x4<true>(af[i], &As[(k + mr) * PA + m]);
        else ldsm_x4<false>(af[i], &As[(m + mr) * PA + k]);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        // matrices: (n, k), (n, k + 8), (n + 8, k), (n + 8, k + 8)
        const int n = wn * 32 + jp * 16 + (mi >> 1) * 8;
        const int k = kk + (mi & 1) * 8;
        uint32_t r4[4];
        if constexpr (B_MN) ldsm_x4<true>(r4, &Bs[(k + mr) * PB + n]);
        else ldsm_x4<false>(r4, &Bs[(n + mr) * PB + k]);
        bfr[2 * jp][0] = r4[0];
        bfr[2 * jp][1] = r4[1];
        bfr[2 * jp + 1][0] = r4[2];
        bfr[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + g + 8 * h;
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        epi(row, col, acc[i][j][2 * h]);
        epi(row, col + 1, acc[i][j][2 * h + 1]);
      }
}

// ------------------------------------------------------------- fp32 FMA

// The same contract as mma_gemm in fp32 on the FMA pipes: 64 x 64 tiles,
// staged k-major ([k][m], [k][n]) whatever the source, each thread 4 x 4
// outputs 16 apart (so a warp's shared-memory reads never conflict).
template <bool A_MN, bool B_MN, class LA, class LB, class Hook, class Epi>
__device__ __forceinline__ void fma_gemm(int K, int m0, int n0, const LA& la,
                                         const LB& lb, Hook hook, Epi epi) {
  constexpr int BM = 64, BN = 64;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto put_a = [&](int r, int c, const float* v) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (A_MN) As[r][c + i] = v[i];
      else As[c + i][r] = v[i];
    }
  };
  auto put_b = [&](int r, int c, const float* v) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (B_MN) Bs[r][c + i] = v[i];
      else Bs[c + i][r] = v[i];
    }
  };
  auto a_at = [&](int k, int m) { return As[k][m]; };

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    if constexpr (A_MN) la.template fill<BK, BM>(k0, m0, put_a);
    else la.template fill<BM, BK>(m0, k0, put_a);
    if constexpr (B_MN) lb.template fill<BK, BN>(k0, n0, put_b);
    else lb.template fill<BN, BK>(n0, k0, put_b);
    __syncthreads();
    hook(k0, a_at);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epi(m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

template <bool CB>
constexpr int kTile = CB ? 128 : 64;   // block tile: mma_gemm's, fma_gemm's

template <bool CB, bool A_MN, bool B_MN, class LA, class LB, class Hook,
          class Epi>
__device__ __forceinline__ void gemm(int K, int m0, int n0, const LA& la,
                                     const LB& lb, Hook hook, Epi epi) {
  if constexpr (CB) mma_gemm<A_MN, B_MN>(K, m0, n0, la, lb, hook, epi);
  else fma_gemm<A_MN, B_MN>(K, m0, n0, la, lb, hook, epi);
}

// --------------------------------------------------------------- kernels

// B7f: out (N, F) = LN(x) . W^T + dbias. Block (row tile, column tile).
template <bool XB, bool CB>
__global__ void __launch_bounds__(kThreads)
ln_dense_fwd_kernel(const void* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, const void* __restrict__ w,
                    const float* __restrict__ dbias, void* __restrict__ out,
                    int N, int C, int F, float eps) {
  constexpr int T = kTile<CB>;
  __shared__ float mean_s[T], rstd_s[T];
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < T; r += kThreads / 32) {
    float m = 0.f, rs = 1.f;
    if (m0 + r < N) row_stats<XB>(x, m0 + r, C, eps, m, rs);
    if (lane == 0) { mean_s[r] = m; rstd_s[r] = rs; }
  }
  __syncthreads();
  const Norm<XB> la{x, scale, bias, mean_s, rstd_s, N, C, m0};
  const Copy<CB> lb{w, F, C};
  gemm<CB, false, false>(
      C, m0, n0, la, lb, [](int, auto) {},
      [&](int row, int col, float v) {
        if (row < N && col < F)
          store1<CB>(out, static_cast<size_t>(row) * F + col,
                     rnd<CB>(rnd<CB>(v) + rnd<CB>(dbias[col])));
      });
}

// B7b step 1: dh (N, C) fp32 = dy (N, F) . W (F, C).
template <bool CB>
__global__ void __launch_bounds__(kThreads)
ln_dense_dh_kernel(const void* __restrict__ dy, const void* __restrict__ w,
                   float* __restrict__ dh, int N, int C, int F) {
  constexpr int T = kTile<CB>;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const Copy<CB> la{dy, N, F};
  const Copy<CB> lb{w, F, C};
  gemm<CB, false, true>(
      F, m0, n0, la, lb, [](int, auto) {},
      [&](int row, int col, float v) {
        if (row < N && col < C) dh[static_cast<size_t>(row) * C + col] = v;
      });
}

// B7b step 2: per row, the statistics (to mean/rstd for step 3) and dx;
// per block, the column sums of dh * xhat and dh over its rows (to part).
template <bool XB>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_dense_rows_kernel(const void* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ dh, void* __restrict__ dx,
                     float* __restrict__ mean, float* __restrict__ rstd,
                     float* __restrict__ part, int N, int C, float eps) {
  extern __shared__ float col[];   // [warp][2][C]: sums of dh * xhat, dh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ds_w = col + warp * 2 * C;
  float* db_w = ds_w + C;
  for (int c = lane; c < C; c += 32) { ds_w[c] = 0.f; db_w[c] = 0.f; }
  __syncwarp();
  const int r_first = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r_first + i;
    if (row >= N) break;
    float m, rs;
    row_stats<XB>(x, row, C, eps, m, rs);
    if (lane == 0) { mean[row] = m; rstd[row] = rs; }
    const size_t base = static_cast<size_t>(row) * C;
    float s1 = 0.f, s2 = 0.f;   // sums of dxh and dxh * xhat
    for (int c = lane * 8; c < C; c += 256) {
      float v[8], d[8], s[8];
      load8<XB>(x, base + c, v);
      load8<false>(dh, base + c, d);
      load8<false>(scale, c, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = __fmul_rn(__fsub_rn(v[e], m), rs);
        const float dxh = __fmul_rn(d[e], s[e]);
        s1 = __fadd_rn(s1, dxh);
        s2 = __fadd_rn(s2, __fmul_rn(dxh, xh));
        ds_w[c + e] = __fadd_rn(ds_w[c + e], __fmul_rn(d[e], xh));
        db_w[c + e] = __fadd_rn(db_w[c + e], d[e]);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float mdxh = __fdiv_rn(s1, static_cast<float>(C));
    const float mdxhx = __fdiv_rn(s2, static_cast<float>(C));
    for (int c = lane * 8; c < C; c += 256) {
      float v[8], d[8], s[8];
      load8<XB>(x, base + c, v);
      load8<false>(dh, base + c, d);
      load8<false>(scale, c, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = __fmul_rn(__fsub_rn(v[e], m), rs);
        const float dxh = __fmul_rn(d[e], s[e]);
        store1<XB>(dx, base + c + e,
                   __fmul_rn(rs, __fsub_rn(__fsub_rn(dxh, mdxh),
                                           __fmul_rn(xh, mdxhx))));
      }
    }
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kRowWarps * 32) {
    float ds = 0.f, db = 0.f;
    for (int w2 = 0; w2 < kRowWarps; ++w2) {   // warps in order
      ds = __fadd_rn(ds, col[w2 * 2 * C + c]);
      db = __fadd_rn(db, col[w2 * 2 * C + C + c]);
    }
    out[c] = ds;
    out[C + c] = db;
  }
}

// B7b step 3: dW (F, C) fp32 = dy^T . h, K = N rows; h from x and the
// statistics of step 2, rounded to dy's type. The blocks of column tile 0
// also sum dc (F,) = sum over rows of dy, from the dy tiles they stage.
template <bool XB, bool CB>
__global__ void __launch_bounds__(kThreads)
ln_dense_dw_kernel(const void* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, const void* __restrict__ dy,
                   float* __restrict__ dw, float* __restrict__ dc, int N,
                   int C, int F) {
  constexpr int T = kTile<CB>;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const Copy<CB> la{dy, N, F};
  const Norm<XB> lb{x, scale, bias, mean, rstd, N, C, 0};
  const bool sum_dc = blockIdx.y == 0 && threadIdx.x < T;
  float dcs = 0.f;
  gemm<CB, true, true>(
      N, m0, n0, la, lb,
      [&](int, auto a_at) {
        if (sum_dc)
          for (int k = 0; k < BK; ++k)
            dcs = __fadd_rn(dcs, a_at(k, static_cast<int>(threadIdx.x)));
      },
      [&](int row, int col, float v) {
        if (row < F && col < C) dw[static_cast<size_t>(row) * C + col] = v;
      });
  if (sum_dc && m0 + static_cast<int>(threadIdx.x) < F)
    dc[m0 + threadIdx.x] = dcs;
}

// B7b step 4: dscale, dbias (C,) = the partials of step 2 summed in block
// order.
__global__ void ln_dense_reduce_kernel(const float* __restrict__ part,
                                       int blocks, int C,
                                       float* __restrict__ ds,
                                       float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f, b = 0.f;
  for (int i = 0; i < blocks; ++i) {
    s = __fadd_rn(s, part[static_cast<size_t>(i) * 2 * C + c]);
    b = __fadd_rn(b, part[static_cast<size_t>(i) * 2 * C + C + c]);
  }
  ds[c] = s;
  db[c] = b;
}

template <bool XB, bool CB>
int fwd(const void* x, const float* scale, const float* bias, const void* w,
        const float* dbias, void* out, int N, int C, int F, float eps,
        cudaStream_t st) {
  constexpr int T = kTile<CB>;
  const dim3 grid((N + T - 1) / T, (F + T - 1) / T);
  ln_dense_fwd_kernel<XB, CB><<<grid, kThreads, 0, st>>>(
      x, scale, bias, w, dbias, out, N, C, F, eps);
  return (int)cudaGetLastError();
}

template <bool XB, bool CB>
int bwd(const void* x, const float* scale, const float* bias, const void* w,
        const void* dy, void* dx, float* ds, float* db, float* dw, float* dc,
        float* dh, float* stats, float* part, int N, int C, int F,
        float eps, cudaStream_t st) {
  constexpr int T = kTile<CB>;
  cudaError_t err;
  ln_dense_dh_kernel<CB><<<dim3((N + T - 1) / T, (C + T - 1) / T), kThreads,
                           0, st>>>(dy, w, dh, N, C, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_dense_rows_kernel<XB><<<blocks, kRowWarps * 32,
                             kRowWarps * 2 * C * sizeof(float), st>>>(
      x, scale, dh, dx, stats, stats + N, part, N, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ln_dense_dw_kernel<XB, CB><<<dim3((F + T - 1) / T, (C + T - 1) / T),
                               kThreads, 0, st>>>(
      x, scale, bias, stats, stats + N, dy, dw, dc, N, C, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ln_dense_reduce_kernel<<<(C + 127) / 128, 128, 0, st>>>(part, blocks, C,
                                                          ds, db);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, C) bf16 (x_bf16) or fp32; scale, bias: (C,) fp32; w: (F, C) and
// out: (N, F) in the compute type (c_bf16: bf16, else fp32); dbias: (F,)
// fp32. C and F multiples of 32, all pointers 16-byte aligned. Launches
// once on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mla_ln_dense_fwd(const void* x, const void* scale,
                                const void* bias, const void* w,
                                const void* dbias, void* out, int N, int C,
                                int F, int x_bf16, int c_bf16, float eps,
                                void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const float* d = static_cast<const float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return c_bf16 ? fwd<true, true>(x, s, b, w, d, out, N, C, F, eps, st)
                  : fwd<true, false>(x, s, b, w, d, out, N, C, F, eps, st);
  return c_bf16 ? fwd<false, true>(x, s, b, w, d, out, N, C, F, eps, st)
                : fwd<false, false>(x, s, b, w, d, out, N, C, F, eps, st);
}

// The forward's operands and dy: (N, F) in the compute type. Writes dx
// (N, C) in x's type and, in fp32, ds, db (C,), dw (F, C), dc (F,).
// Scratch, fp32: dh (N * C), stats (2 * N), part (2 * C * ceil(N / 32)).
// C <= 1536. Launches four times on `stream` and returns the first non-zero
// cudaGetLastError() (0 = launched).
extern "C" int mla_ln_dense_bwd(const void* x, const void* scale,
                                const void* bias, const void* w,
                                const void* dy, void* dx, void* ds, void* db,
                                void* dw, void* dc, void* dh, void* stats,
                                void* part, int N, int C, int F, int x_bf16,
                                int c_bf16, float eps, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* f[7] = {static_cast<float*>(ds), static_cast<float*>(db),
                 static_cast<float*>(dw), static_cast<float*>(dc),
                 static_cast<float*>(dh), static_cast<float*>(stats),
                 static_cast<float*>(part)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLA_BWD(XB, CB)                                                     \
  bwd<XB, CB>(x, s, b, w, dy, dx, f[0], f[1], f[2], f[3], f[4], f[5], f[6], \
              N, C, F, eps, st)
  if (x_bf16) return c_bf16 ? MLA_BWD(true, true) : MLA_BWD(true, false);
  return c_bf16 ? MLA_BWD(false, true) : MLA_BWD(false, false);
#undef MLA_BWD
}
