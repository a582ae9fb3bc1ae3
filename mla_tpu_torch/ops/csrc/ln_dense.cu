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
// bf16 compute: three GEMMs on wgmma, fed by TMA (hopper.cuh). Each is a
// persistent kernel, one block per SM walking its tiles, with one producer
// thread that keeps a ring of shared-memory stages full (64 k a stage; for
// dW a producer warp also copies each stage's row statistics) and two
// consumer warpgroups of 64 output rows each; tile widths (and dW's row
// splits) from the card's SM count.
//  - Forward, two launches. ln_dense_stats_kernel writes each row's (mean,
//    rstd) once (one warp a row) into a (2, N) fp32 scratch, so no column
//    tile recomputes them. ln_dense_fwd_wgmma_kernel computes y = h . W^T
//    with the rows as wgmma's M, the reverse of q8_gemm.cuh's W . X^T, so
//    that the normalised operand is the register A operand: a stage brings
//    the raw x tile (128 rows x 64 of C, in x's type) and the W tile (BN
//    rows of W x 64, K-major as W lies), each consumer thread reads its A
//    fragment's raw x from shared memory, applies (x - m) * (r * scale) +
//    bias with its two rows' statistics held in registers, rounds to bf16
//    and feeds wgmma m64nBNk16; the LN output never reaches device memory.
//    Epilogue: rnd(rnd(acc) + rnd(dbias)), stmatrix into a 128-byte-swizzled
//    staging box, TMA store (which clips the ragged row and column tiles).
//    A second set of A registers, to build one stage's while the previous
//    stage's products run, made ptxas serialize the wgmmas (C7513) and ran
//    slower: each warpgroup waits for its products before the next stage.
//  - Backward, five launches: (1) dh = dy . W (fp32 scratch (N, C)) on
//    wgmma from shared memory, dy the K-major A operand and W, which is
//    MN-major for this product, read with wgmma's B transpose flag; (2) the
//    row pass (one warp a row, each row read once into registers):
//    statistics (kept for step 3), dx, and per-block column sums of dh *
//    xhat and dh; (3) dW = dy^T . h over K = N rows, computed as dW^T = h^T
//    . dy: the reduction runs over rows, so both operands are MN-major, and
//    h needs the LN applied; as in the forward, each consumer thread makes
//    its register A fragments of h^T from the staged raw x tile (read
//    transposed by ldmatrix), and dy is the MN-major B operand. Making h in
//    shared memory instead, for wgmma to read from there, was measured
//    slower: both warpgroups read the whole tile, after a barrier across
//    them each stage. The rows are split
//    so that tiles x splits fill the card; each split writes fp32 partials
//    (or dW itself), and the same threads sum dc from the staged dy tiles,
//    each column tile over its share of the stages; (4) the row pass's
//    partials summed per column in block order; (5) the dc partials, and
//    with more than one split the dW partials, summed in order. No atomics:
//    every sum runs in a fixed order and the gradients are the same from
//    run to run.
//  - Out-of-bounds rows and columns arrive as zeros (TMA's fill): rows past
//    N take statistics (0, 0) and columns past C a zero scale and bias, so
//    their h stays finite and their products with the zero-filled W, dy or
//    x come out as exactly 0.
//
// fp32 compute: the FMA pipes (TF32 stays off, as the port states for every
// fp32 product), one block per (row tile, column tile), 64 x 64 tiles
// staged through shared memory once per k-tile of 32: the forward computes
// its rows' statistics per block, the backward runs the four steps above.
//
// Bounds at the M3AE training shape (N = 16448 rows, C = 768; the qkv site
// F = 2304, the fc1 site F = 3072), bf16: B7f moves x, W and y (25.3 + 3.5
// + 75.8 MB at F = 2304), 31 us at 3.35 TB/s, and does 2*N*C*F = 58.2 GFLOP,
// 59 us at the bf16 tensor-core peak: bound by operations. B7b reads x, dy
// and W and writes dx and dW (fp32), and does two such GEMMs: bound by
// operations too. The backward's dh scratch (50.5 MB written and read at
// qkv) and the row pass are memory-bound steps on top of that.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;   // fp32 GEMM blocks
constexpr int BK = 32;          // fp32: k per tile
constexpr int kRowWarps = 4;    // row pass: warps per block
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kRowWarps * kRowsPerWarp;

// ---------------------------------------------------------------- elements

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

// x rounded to bf16, kept as fp32
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ void store1(void* p, size_t idx, float x) {
  if constexpr (BF16)
    static_cast<__nv_bfloat16*>(p)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[idx] = x;
}

// the LN output of one value: (x - m) * (r * s) + b, each operation rounded
__device__ __forceinline__ float ln1(float x, float m, float r, float s,
                                     float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), __fmul_rn(r, s)), b);
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

struct Copy {                 // an fp32 (rows, cols) matrix as it is
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
        load8<false>(p, static_cast<size_t>(gr) * cols + gc, v);
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
        for (int i = 0; i < 8; ++i) v[i] = ln1(v[i], m, rs, s[i], b[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
      put(r, c, v);
    }
  }
};

// ------------------------------------------------------------- fp32 FMA

// C[m0.., n0..] (64 x 64) = sum over k < K of A[m][k] B[k][n] on the FMA
// pipes. A_MN: A's source is k-major by rows (A[m][k] at source row k,
// column m), else m-major (source row m, column k); likewise B_MN for B
// (source row k, column n; else row n, column k). Tiles are staged k-major
// ([k][m], [k][n]) whatever the source, each thread 4 x 4 outputs 16 apart
// (so a warp's shared-memory reads never conflict). hook(k0, a_at) runs
// once per k-tile after it is staged, with a_at(k, m) reading the staged A.
// epi(row, col, value) takes each sum.
constexpr int kTile = 64;

template <bool A_MN, bool B_MN, class LA, class LB, class Hook, class Epi>
__device__ __forceinline__ void fma_gemm(int K, int m0, int n0, const LA& la,
                                         const LB& lb, Hook hook, Epi epi) {
  constexpr int BM = kTile, BN = kTile;
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

// ------------------------------------------------------- fp32 kernels

// B7f, fp32: out (N, F) = LN(x) . W^T + dbias. Block (row tile, column
// tile); the block computes its rows' statistics first.
template <bool XB>
__global__ void __launch_bounds__(kThreads)
ln_dense_fwd_kernel(const void* __restrict__ x,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, const void* __restrict__ w,
                    const float* __restrict__ dbias, float* __restrict__ out,
                    int N, int C, int F, float eps) {
  constexpr int T = kTile;
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
  const Copy lb{w, F, C};
  fma_gemm<false, false>(
      C, m0, n0, la, lb, [](int, auto) {},
      [&](int row, int col, float v) {
        if (row < N && col < F)
          out[static_cast<size_t>(row) * F + col] = v + dbias[col];
      });
}

// B7b step 1, fp32: dh (N, C) = dy (N, F) . W (F, C).
__global__ void __launch_bounds__(kThreads)
ln_dense_dh_kernel(const void* __restrict__ dy, const void* __restrict__ w,
                   float* __restrict__ dh, int N, int C, int F) {
  constexpr int T = kTile;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const Copy la{dy, N, F};
  const Copy lb{w, F, C};
  fma_gemm<false, true>(
      F, m0, n0, la, lb, [](int, auto) {},
      [&](int row, int col, float v) {
        if (row < N && col < C) dh[static_cast<size_t>(row) * C + col] = v;
      });
}

// B7b step 3, fp32: dW (F, C) = dy^T . h, K = N rows; h from x and the
// statistics of step 2. The blocks of column tile 0 also sum dc (F,) = sum
// over rows of dy, from the dy tiles they stage.
template <bool XB>
__global__ void __launch_bounds__(kThreads)
ln_dense_dw_kernel(const void* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, const void* __restrict__ dy,
                   float* __restrict__ dw, float* __restrict__ dc, int N,
                   int C, int F) {
  constexpr int T = kTile;
  const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
  const Copy la{dy, N, F};
  const Norm<XB> lb{x, scale, bias, mean, rstd, N, C, 0};
  const bool sum_dc = blockIdx.y == 0 && threadIdx.x < T;
  float dcs = 0.f;
  fma_gemm<true, true>(
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

// ------------------------------------------------ the row passes (both)

// The forward's statistics (bf16 compute): stats[row] = mean, stats[N +
// row] = rstd, one warp a row (row_stats, the same bits as the row pass).
template <bool XB>
__global__ void __launch_bounds__(256)
ln_dense_stats_kernel(const void* __restrict__ x, float* __restrict__ stats,
                      int N, int C, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= N) return;
  float m, rs;
  row_stats<XB>(x, row, C, eps, m, rs);
  if ((threadIdx.x & 31) == 0) {
    stats[row] = m;
    stats[N + row] = rs;
  }
}

// B7b step 2: per row, the statistics (to mean/rstd for step 3) and dx;
// per block, the column sums of dh * xhat and dh over its rows (to part).
// A warp takes 8 rows one after another; a lane holds its CH chunks of 8
// columns (c = 8 lane + 256 j) of the row's x and dh, and of scale, in
// registers, so each row is read once; the sums run in row_stats' order.
template <bool XB, int CH>
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
  float sc[CH][8];
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if (lane * 8 + 256 * j < C) load8<false>(scale, lane * 8 + 256 * j, sc[j]);
  const int r_first = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r_first + i;
    if (row >= N) break;
    const size_t base = static_cast<size_t>(row) * C;
    float v[CH][8], d[CH][8];
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (lane * 8 + 256 * j < C) {
        load8<XB>(x, base + lane * 8 + 256 * j, v[j]);
        load8<false>(dh, base + lane * 8 + 256 * j, d[j]);
      }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (lane * 8 + 256 * j < C)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s = __fadd_rn(s, v[j][e]);
          ss = __fadd_rn(ss, __fmul_rn(v[j][e], v[j][e]));
        }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    }
    const float m = __fdiv_rn(s, static_cast<float>(C));
    const float var = fmaxf(
        __fsub_rn(__fdiv_rn(ss, static_cast<float>(C)), __fmul_rn(m, m)),
        0.f);
    const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (lane == 0) { mean[row] = m; rstd[row] = rs; }
    float s1 = 0.f, s2 = 0.f;   // sums of dxh and dxh * xhat
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane * 8 + 256 * j;
      if (c < C)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = __fmul_rn(__fsub_rn(v[j][e], m), rs);
          const float dxh = __fmul_rn(d[j][e], sc[j][e]);
          s1 = __fadd_rn(s1, dxh);
          s2 = __fadd_rn(s2, __fmul_rn(dxh, xh));
          ds_w[c + e] = __fadd_rn(ds_w[c + e], __fmul_rn(d[j][e], xh));
          db_w[c + e] = __fadd_rn(db_w[c + e], d[j][e]);
        }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float mdxh = __fdiv_rn(s1, static_cast<float>(C));
    const float mdxhx = __fdiv_rn(s2, static_cast<float>(C));
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane * 8 + 256 * j;
      if (c < C)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = __fmul_rn(__fsub_rn(v[j][e], m), rs);
          const float dxh = __fmul_rn(d[j][e], sc[j][e]);
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

// the row pass for C <= 256 * CH (C <= MAX_C = 1536: CH <= 6)
template <bool XB>
int rows(const void* x, const float* scale, const float* dh, void* dx,
         float* st, float* part, int N, int C, float eps, cudaStream_t s) {
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = kRowWarps * 2 * C * sizeof(float);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kRowWarps * 32, smem, s>>>(x, scale, dh, dx, st, st + N,
                                                 part, N, C, eps);
    return static_cast<int>(cudaGetLastError());
  };
  switch ((C + 255) / 256) {
    case 1: return run(ln_dense_rows_kernel<XB, 1>);
    case 2: return run(ln_dense_rows_kernel<XB, 2>);
    case 3: return run(ln_dense_rows_kernel<XB, 3>);
    case 4: return run(ln_dense_rows_kernel<XB, 4>);
    case 5: return run(ln_dense_rows_kernel<XB, 5>);
    case 6: return run(ln_dense_rows_kernel<XB, 6>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7b step 4: dscale, dbias (C,) = the partials of step 2 summed in block
// order, one output a thread (the loads unrolled ahead of the adds, whose
// order is fixed).
__global__ void ln_dense_reduce_kernel(const float* __restrict__ part,
                                       int blocks, int C,
                                       float* __restrict__ ds,
                                       float* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // ds[i], db[i - C]
  if (i >= 2 * C) return;
  float s = 0.f;
#pragma unroll 32
  for (int b = 0; b < blocks; ++b)
    s = __fadd_rn(s, part[static_cast<size_t>(b) * 2 * C + i]);
  if (i < C) ds[i] = s;
  else db[i - C] = s;
}

// B7b step 5 (bf16): dW (F * C values, when it has split partials) and dc
// (F) = their partials ([nw][F * C], [nc][F]) summed in order, 4 values a
// thread.
__global__ void ln_dense_split_sum_kernel(const float* __restrict__ wpart,
                                          int nw,
                                          const float* __restrict__ cpart,
                                          int nc, int FC, int F,
                                          float* __restrict__ dw,
                                          float* __restrict__ dc) {
  int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int nfc = nw > 0 ? FC : 0;
  const float* src;
  float* dst;
  int stride, n;
  if (i < nfc) {
    src = wpart + i;
    dst = dw + i;
    stride = FC;
    n = nw;
  } else if (i < nfc + F) {
    i -= nfc;
    src = cpart + i;
    dst = dc + i;
    stride = F;
    n = nc;
  } else {
    return;
  }
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < n; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(
        src + static_cast<size_t>(k) * stride);
    a.x = __fadd_rn(a.x, v.x);
    a.y = __fadd_rn(a.y, v.y);
    a.z = __fadd_rn(a.z, v.z);
    a.w = __fadd_rn(a.w, v.w);
  }
  *reinterpret_cast<float4*>(dst) = a;
}

// --------------------------------------------------- bf16: wgmma + TMA

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kWgThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int KS = 64;                            // k per stage
constexpr int BOX = 64 * 128;                     // a 64 x 128-byte box

// the ring's slots and bytes: `extra` bytes beside the ring, 1024 of slack
// to align the ring to the 128-byte swizzle's 1024-byte period
template <int SB, int EXTRA>
struct Ring {
  static constexpr int FREE = kSmemMax - 1024 - EXTRA - 2 * 8 * 8;
  static constexpr int S = FREE / SB > 8 ? 8 : FREE / SB;
  static constexpr int BYTES = 1024 + S * SB + EXTRA + 2 * S * 8;
  static_assert(S >= 2 && BYTES <= kSmemMax, "ring too large");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int S) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(m))
               : "memory");
}

// B7f, bf16: a stage holds the raw x tile (128 rows x 64 columns; bf16 one
// box, fp32 two boxes of 32 columns, 128-byte rows, 128-byte swizzle) and
// the W tile (BN rows x 64, one box); two staging boxes per consumer
// warpgroup for the epilogue.
template <bool XB, int BN>
struct FwdLayout {
  static constexpr int XT = 128 * KS * (XB ? 2 : 4);
  static constexpr int SB = XT + BN * 128;
  static constexpr int STG = 2 * kConsumers * BOX;
  using R = Ring<SB, STG>;
};

// out (N, F) bf16 = rnd(rnd(LN(x) . W^T) + rnd(dbias)), tiles of 128 rows
// x BN columns, row tiles slowest (the column tiles of a row tile run
// together, so its x comes from L2). Consumer warpgroup wg owns rows 64 wg
// .. 64 wg + 63 of a tile; accumulator i of a thread is (row 16 warp + g +
// 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1)) of its 64 x BN.
template <bool XB, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
ln_dense_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tx,
                          __grid_constant__ const CUtensorMap tw,
                          __grid_constant__ const CUtensorMap to,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const float* __restrict__ dbias,
                          const float* __restrict__ stats, int N, int C,
                          int F) {
  using L = FwdLayout<XB, BN>;
  using R = typename L::R;
  constexpr int NR = BN / 2;                   // accumulators per thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* stg = smem + R::S * L::SB;
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + L::STG);
  uint64_t* empty = full + R::S;

  const int tid = threadIdx.x;
  const int KT = (C + KS - 1) / KS;
  const int tiles_n = (F + BN - 1) / BN;
  const int tiles = (N + 127) / 128 * tiles_n;
  init_ring(full, empty, R::S);

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      prefetch_map(&tx);
      prefetch_map(&tw);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * 128, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % R::S;
          mbar_wait(&empty[s], ((it / R::S) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::SB);
          uint8_t* st = smem + s * L::SB;
          tma_load_2d(st, &tx, &full[s], kt * KS, m0);
          if constexpr (!XB)
            tma_load_2d(st + 128 * 128, &tx, &full[s], kt * KS + 32, m0);
          tma_load_2d(st + L::XT, &tw, &full[s], kt * KS, n0);
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl = 64 * wg + 16 * warp + g;    // rows rl, rl + 8 of a tile
    const bool leader = (tid & 127) == 0;
    uint8_t* my_stg = stg + wg * 2 * BOX;
    int it = 0, chunk = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * 128, n0 = (tile % tiles_n) * BN;
      float mean[2], rs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + rl + 8 * h;
        mean[h] = row < N ? stats[row] : 0.f;
        rs[h] = row < N ? stats[N + row] : 0.f;
      }
      float acc[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % R::S;
        mbar_wait(&full[s], (it / R::S) & 1);
        const uint8_t* st = smem + s * L::SB;
        // this thread's A fragments: rows rl (+8), k pairs (2t, 2t+1) and
        // (2t+8, 2t+9) of each 16-wide step, normalised and rounded; the
        // 128-byte swizzle puts 16-byte chunk q of row r at q ^ (r & 7),
        // and r & 7 = g
        uint32_t af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {
            const int cl = 16 * ks + 8 * hc + 2 * t;   // column in the stage
            const int c = kt * KS + cl;
            float2 sc = make_float2(0.f, 0.f), bi = sc;
            if (c < C) {
              sc = __ldg(reinterpret_cast<const float2*>(scale + c));
              bi = __ldg(reinterpret_cast<const float2*>(bias + c));
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rl + 8 * h;
              float v0, v1;
              if constexpr (XB) {
                const uint32_t u = *reinterpret_cast<const uint32_t*>(
                    st + r * 128 + (((cl >> 3) ^ g) << 4) + (cl & 7) * 2);
                v0 = __uint_as_float(u << 16);
                v1 = __uint_as_float(u & 0xffff0000u);
              } else {
                const float2 f = *reinterpret_cast<const float2*>(
                    st + (cl >> 5) * (128 * 128) + r * 128 +
                    ((((cl & 31) >> 2) ^ g) << 4) + (cl & 3) * 4);
                v0 = f.x;
                v1 = f.y;
              }
              af[ks][h + 2 * hc] =
                  pack_bf16x2(ln1(v0, mean[h], rs[h], sc.x, bi.x),
                              ln1(v1, mean[h], rs[h], sc.y, bi.y));
            }
          }
        const uint64_t dw = desc_sw128(st + L::XT);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<BN>::bf16_rs(acc, af[ks], dw + 2 * ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      // ---- epilogue: 64 columns at a time, rnd(rnd(acc) + rnd(dbias))
      // into one of this warpgroup's two staging boxes (stmatrix: matrices
      // (j, h) of 8 rows x 8 columns, two j's at a time; row r of matrix (j,
      // h) is row 16 warp + 8h + r of the box, 16 bytes at chunk j of its
      // 128-byte row, swizzled with r), then a TMA store that clips rows
      // past N and columns past F, double-buffered
      const int mat = lane >> 3, r = lane & 7;
      const int jj = mat >> 1, hh = mat & 1;
#pragma unroll
      for (int q = 0; q < BN / 64; ++q, ++chunk) {
        uint8_t* buf = my_stg + (chunk & 1) * BOX;
        // the store that read this buffer two chunks ago is done with it
        if (leader) bulk_wait_read<1>();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int jc = 8 * q + j + (u >> 1);       // 8-column block
            const int i = 4 * jc + 2 * (u & 1);
            const int col = n0 + 8 * jc + 2 * t;
            float2 d = make_float2(0.f, 0.f);
            if (col < F) d = __ldg(reinterpret_cast<const float2*>(dbias + col));
            v[u] = pack_bf16x2(__fadd_rn(rnd_bf16(acc[i]), rnd_bf16(d.x)),
                               __fadd_rn(rnd_bf16(acc[i + 1]), rnd_bf16(d.y)));
          }
          const int row = 16 * warp + 8 * hh + r;
          stmatrix_x4(buf + row * 128 + (((j + jj) ^ r) << 4), v[0], v[1],
                      v[2], v[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (leader) {
          if (m0 + 64 * wg < N && n0 + 64 * q < F)
            tma_store_2d(&to, buf, n0 + 64 * q, m0 + 64 * wg);
          bulk_commit();
        }
      }
    }
    if (leader) bulk_wait_read<0>();
  }
}

// B7b step 1, bf16: dh (N, C) fp32 = dy (N, F) . W (F, C), tiles of 128 rows
// x BN columns of C, row tiles slowest. A stage holds the dy tile (128 rows
// x 64 of F, K-major, one box) and the W tile (64 rows of F x BN columns,
// BN / 64 boxes of 64 columns: MN-major for this product, read with the B
// transpose flag). One stage's products stay in flight while the next
// stage's are issued. The fp32 sums go straight from the registers to dh.
template <int BN>
struct DhLayout {
  static constexpr int SB = 128 * 128 + BN * 128;
  using R = Ring<SB, 0>;
};

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
ln_dense_dh_wgmma_kernel(__grid_constant__ const CUtensorMap tdy,
                         __grid_constant__ const CUtensorMap tw,
                         float* __restrict__ dh, int N, int C, int F) {
  using L = DhLayout<BN>;
  using R = typename L::R;
  constexpr int NR = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::S * L::SB);
  uint64_t* empty = full + R::S;

  const int tid = threadIdx.x;
  const int KT = (F + KS - 1) / KS;
  const int tiles_n = (C + BN - 1) / BN;
  const int tiles = (N + 127) / 128 * tiles_n;
  init_ring(full, empty, R::S);

  const int wg = tid / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      prefetch_map(&tdy);
      prefetch_map(&tw);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * 128, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % R::S;
          mbar_wait(&empty[s], ((it / R::S) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::SB);
          uint8_t* st = smem + s * L::SB;
          tma_load_2d(st, &tdy, &full[s], kt * KS, m0);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(st + 128 * 128 + b * BOX, &tw, &full[s], n0 + 64 * b,
                        kt * KS);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * 128, n0 = (tile % tiles_n) * BN;
      float acc[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      fence_regs(acc);
      int held = -1;          // the stage whose products may still run
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % R::S;
        mbar_wait(&full[s], (it / R::S) & 1);
        const uint8_t* st = smem + s * L::SB;
        const uint64_t da = desc_sw128(st + wg * 64 * 128);
        const uint64_t db = desc_sw128_mn(st + 128 * 128, BOX);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<BN>::template bf16_ss<1>(acc, da + 2 * ks, db + 128 * ks);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[held]);
#pragma unroll
      for (int i = 0; i < NR; i += 2) {
        const int row = m0 + 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int col = n0 + 8 * (i >> 2) + 2 * t;
        if (row < N && col < C)
          *reinterpret_cast<float2*>(dh + static_cast<size_t>(row) * C + col) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

// B7b step 3, bf16: dW (F, C) = dy^T . h over the rows, computed as its
// transpose dW^T = h^T . dy so that the normalised operand is wgmma's
// register A operand, as in the forward: tiles of 128 columns of C (wgmma's
// M, 64 a consumer warpgroup) x 256 columns of F (wgmma's N), the rows (K)
// cut into `splits` runs of whole 64-row stages (split slowest, so the
// blocks that run together share their rows in L2). A stage holds the raw x
// tile (64 rows x 128 of C: bf16 two boxes of 64 columns, fp32 four of 32)
// and the dy tile (64 rows x 256 of F, four boxes of 64 columns: MN-major
// for this product, read with the B transpose flag); a warp of the
// producer's warpgroup copies the stage's 64 means and rstds from the row
// pass's statistics into shared memory beside the ring (rows past N take
// (0, 0), so h stays finite there). Each consumer thread builds its A
// fragments from the raw x tile (ldmatrix.trans for bf16 x: the tile's rows
// are A's k), applies the LN with its two columns' scale and bias held in
// registers and each row's statistics, rounds to bf16, and issues wgmma
// m64n256k16. No consumer waits on the other warpgroup. dc: the unit of
// column tile ct sums dy over the stages kt of its split with kt % tiles_c
// == ct (the work spread over the column tiles), a thread over two columns
// and the rows of one parity in order, the parities added in order at the
// end: one partial per (split, column tile), summed in that order by the
// split sum. dW: each split writes its fp32 sums, transposed back, to its
// partial, or to dw when there is one split.
template <bool XB>
struct DwLayout {
  static constexpr int BM = 128, BN = 256;
  static constexpr int XT = XB ? 2 * BOX : 4 * BOX;  // raw x
  static constexpr int SB = XT + 4 * BOX;            // + dy
  static constexpr int ST = 2 * KS * 4;              // a stage's statistics
  static constexpr int DC = 2 * BN * 4;              // dc's two row groups
  static constexpr int FREE = kSmemMax - 1024 - DC - 2 * 8 * 8;
  static constexpr int S = FREE / (SB + ST) > 8 ? 8 : FREE / (SB + ST);
  static constexpr int BYTES = 1024 + S * (SB + ST) + DC + 2 * S * 8;
  static_assert(S >= 2 && BYTES <= kSmemMax, "ring too large");
};

template <bool XB>
__global__ void __launch_bounds__(kWgThreads, 1)
ln_dense_dw_wgmma_kernel(__grid_constant__ const CUtensorMap tx,
                         __grid_constant__ const CUtensorMap tdy,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ stats,
                         float* __restrict__ dw, float* __restrict__ wpart,
                         float* __restrict__ cpart, int splits, int N, int C,
                         int F) {
  using L = DwLayout<XB>;
  constexpr int BM = L::BM, BN = L::BN;
  constexpr int NR = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* sst = reinterpret_cast<float*>(smem + L::S * L::SB);  // [S][2][64]
  float* dcs = sst + L::S * 2 * KS;                             // [2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(dcs + 2 * BN);
  uint64_t* empty = full + L::S;

  const int tid = threadIdx.x;
  const int KT = (N + KS - 1) / KS;             // 64-row stages
  const int tiles_c = (C + BM - 1) / BM;
  const int tiles = tiles_c * ((F + BN - 1) / BN);
  const int units = tiles * splits;
  if (tid == 0) {
    for (int s = 0; s < L::S; ++s) {
      mbar_init(&full[s], 1 + 32);             // the TMA thread, the stats warp
      mbar_init(&empty[s], 4 * kConsumers);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pw = (tid >> 5) & 3, lane = tid & 31;
    if (pw < 2) {   // warp 0: TMA (one thread); warp 1: the statistics
      if (pw == 0 && lane == 0) {
        prefetch_map(&tx);
        prefetch_map(&tdy);
      }
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int sp = u / tiles, tile = u % tiles;
        const int c0 = (tile % tiles_c) * BM, f0 = (tile / tiles_c) * BN;
        const int k_end = KT * (sp + 1) / splits;
        for (int kt = KT * sp / splits; kt < k_end; ++kt, ++it) {
          const int s = it % L::S;
          if (pw == 0) {
            if (lane == 0) {
              mbar_wait(&empty[s], ((it / L::S) & 1) ^ 1);
              mbar_expect_tx(&full[s], L::SB);
              uint8_t* st = smem + s * L::SB;
#pragma unroll
              for (int b = 0; b < L::XT / BOX; ++b)
                tma_load_2d(st + b * BOX, &tx, &full[s],
                            c0 + b * (XB ? 64 : 32), kt * KS);
#pragma unroll
              for (int b = 0; b < 4; ++b)
                tma_load_2d(st + L::XT + b * BOX, &tdy, &full[s],
                            f0 + 64 * b, kt * KS);
            }
          } else {
            mbar_wait(&empty[s], ((it / L::S) & 1) ^ 1);
            float* dst = sst + s * 2 * KS;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = kt * KS + lane + 32 * h;
              dst[lane + 32 * h] = n < N ? stats[n] : 0.f;
              dst[KS + lane + 32 * h] = n < N ? stats[N + n] : 0.f;
            }
            mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int mq = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row
    const int dcol = tid & 127, dpar = tid >> 7;  // dc: columns 2 dcol, +1
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int sp = u / tiles, tile = u % tiles;
      const int ct = tile % tiles_c;
      const int c0 = ct * BM, f0 = (tile / tiles_c) * BN;
      // this thread's A rows (columns of C): cl and cl + 8 of the tile
      const int cl = 64 * wg + 16 * warp + g;
      float sc[2], bi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + cl + 8 * h;
        sc[h] = c < C ? scale[c] : 0.f;
        bi[h] = c < C ? bias[c] : 0.f;
      }
      float dc0 = 0.f, dc1 = 0.f;
      float acc[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      fence_regs(acc);
      const int k_end = KT * (sp + 1) / splits;
      for (int kt = KT * sp / splits; kt < k_end; ++kt, ++it) {
        const int s = it % L::S;
        mbar_wait(&full[s], (it / L::S) & 1);
        const uint8_t* st = smem + s * L::SB;
        const float* sm = sst + s * 2 * KS;
        // A fragments of 16 rows (k) each: registers (c cl, rows 2t, 2t+1),
        // (c cl + 8, rows 2t, 2t+1), (c cl, rows 2t+8, 2t+9), (c cl + 8,
        // rows 2t+8, 2t+9) of the step, x read transposed
        uint32_t af[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float v[4][2];
          if constexpr (XB) {
            // matrix q: rows 16 ks + 8 (q >> 1) .., columns cl - g + 8 (q & 1)
            // .. of the tile, in box wg at 16-byte chunk 2 warp + (q & 1)
            const int row = 16 * ks + 8 * (mq >> 1) + mr;
            uint32_t raw[4];
            ldmatrix_x4_trans(raw, st + wg * BOX + row * 128 +
                                       (((2 * warp + (mq & 1)) ^ (row & 7))
                                        << 4));
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              v[q][0] = __uint_as_float(raw[q] << 16);
              v[q][1] = __uint_as_float(raw[q] & 0xffff0000u);
            }
          } else {
            // fp32: element (row k, column c) at box c / 32, 16-byte chunk
            // ((c & 31) >> 2) ^ (k & 7), word c & 3
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int k = 16 * ks + 8 * (q >> 1) + 2 * t + e;
                const int c = cl + 8 * (q & 1);
                v[q][e] = *reinterpret_cast<const float*>(
                    st + (c >> 5) * BOX + k * 128 +
                    ((((c & 31) >> 2) ^ (k & 7)) << 4) + (c & 3) * 4);
              }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = 16 * ks + 8 * (q >> 1) + 2 * t;
            const float2 m = *reinterpret_cast<const float2*>(sm + k);
            const float2 r = *reinterpret_cast<const float2*>(sm + KS + k);
            af[ks][q] = pack_bf16x2(
                ln1(v[q][0], m.x, r.x, sc[q & 1], bi[q & 1]),
                ln1(v[q][1], m.y, r.y, sc[q & 1], bi[q & 1]));
          }
        }
        const uint64_t db = desc_sw128_mn(st + L::XT, BOX);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<BN>::template bf16_rs<1>(acc, af[ks], db + 128 * ks);
        wgmma_commit();
        if (kt % tiles_c == ct) {
          // dc: dy (row, columns 2 dcol, +1) at box dcol / 32, 16-byte
          // chunk ((dcol & 31) >> 2) ^ (row & 7), word dcol & 3; rows of
          // parity dpar in order (zeros past N)
          const uint8_t* dy = st + L::XT + (dcol >> 5) * BOX + (dcol & 3) * 4;
#pragma unroll 8
          for (int row = dpar; row < KS; row += 2) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                dy + row * 128 + ((((dcol & 31) >> 2) ^ (row & 7)) << 4));
            dc0 = __fadd_rn(dc0, __uint_as_float(w << 16));
            dc1 = __fadd_rn(dc1, __uint_as_float(w & 0xffff0000u));
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
      }

      // dW: accumulator i is (column c0 + cl + 8 ((i >> 1) & 1) of C, row
      // f0 + 8 (i >> 2) + 2t + (i & 1) of F), stored transposed
      float* out_w = splits == 1 ? dw
                                 : wpart + static_cast<size_t>(sp) * F * C;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int c = c0 + cl + 8 * ((i >> 1) & 1);
        const int f = f0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (c < C && f < F) out_w[static_cast<size_t>(f) * C + c] = acc[i];
      }
      // dc: the two row parities of each column, added in order
      dcs[dpar * BN + 2 * dcol] = dc0;
      dcs[dpar * BN + 2 * dcol + 1] = dc1;
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
      if (f0 + tid < F)
        cpart[(static_cast<size_t>(sp) * tiles_c + ct) * F + f0 + tid] =
            __fadd_rn(dcs[tid], dcs[BN + tid]);
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    }
  }
}

// ------------------------------------------------------------------ host

// The forward's and dh's tile width: the fewest waves x (BN + 64) over the
// card's SM count, where 64 stands for a tile's fixed cost (ring fill,
// epilogue); the wider on a tie (as q8_gemm.cuh's pick_bx).
inline int pick_bn(int M, int N, int sms) {
  auto cost = [&](int bn) {
    const long long tiles =
        static_cast<long long>((M + 127) / 128) * ((N + bn - 1) / bn);
    return (tiles + sms - 1) / sms * (bn + 64);
  };
  return cost(128) < cost(256) ? 128 : 256;
}

// dW's row splits: the fewest of 1..8 (and no more than the 64-row stages)
// that minimises an estimate of its time: waves x (stages per split + 4 of
// fixed cost) x one 64-row stage of one 128 x 256 tile at the SM's share
// of the bf16 peak (4.2 MFLOP, 0.56 us on 132 SMs), plus, with more than
// one split, the partials' bytes (written once, read once by the split
// sum, which writes dW) at 3.35 TB/s.
inline int dw_splits(int N, int C, int F, int sms) {
  const int kt = (N + KS - 1) / KS;
  const long long tiles =
      static_cast<long long>((F + 255) / 256) * ((C + 127) / 128);
  const double stage_s = 2.0 * 128 * 256 * KS / (989e12 / sms);
  const double bytes_s = 4.0 * F * C / 3.35e12;
  int best = 1;
  double best_cost = -1.0;
  for (int s = 1; s <= 8 && s <= kt; ++s) {
    const long long waves = (tiles * s + sms - 1) / sms;
    const double cost = waves * ((kt + s - 1) / s + 4) * stage_s +
                        (s > 1 ? (2 * s + 1) * bytes_s : 0.0);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// the opt-in shared memory of a kernel, set once per device
template <class K>
cudaError_t opt_in(K kernel, int bytes, unsigned long long& ready) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && ((ready >> dev) & 1)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return e;
}

bool map_bf16(CUtensorMap* m, const void* p, int rows, int cols, int box_c,
              int box_r) {
  return make_map(m, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 0, rows, cols,
                  box_c, box_r, CU_TENSOR_MAP_SWIZZLE_128B);
}

// x in its type: 128-byte box rows (bf16 64 columns, fp32 32)
template <bool XB>
bool map_x(CUtensorMap* m, const void* p, int rows, int cols, int box_r) {
  if constexpr (XB) return map_bf16(m, p, rows, cols, 64, box_r);
  return make_map(m, p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 0, rows, cols,
                  32, box_r, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool XB>
int stats(const void* x, float* st, int N, int C, float eps,
          cudaStream_t s) {
  ln_dense_stats_kernel<XB><<<(N + 7) / 8, 256, 0, s>>>(x, st, N, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool XB, int BN>
int fwd_bf16(const void* x, const float* scale, const float* bias,
             const void* w, const float* dbias, void* out, float* st, int N,
             int C, int F, int sms, cudaStream_t s) {
  using L = FwdLayout<XB, BN>;
  static unsigned long long ready = 0;
  cudaError_t e = opt_in(ln_dense_fwd_wgmma_kernel<XB, BN>, L::R::BYTES,
                         ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tx, tw, to;
  if (!map_x<XB>(&tx, x, N, C, 128) || !map_bf16(&tw, w, F, C, 64, BN) ||
      !map_bf16(&to, out, N, F, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + 127) / 128 * ((F + BN - 1) / BN);
  ln_dense_fwd_wgmma_kernel<XB, BN><<<tiles < sms ? tiles : sms, kWgThreads,
                                      L::R::BYTES, s>>>(
      tx, tw, to, scale, bias, dbias, st, N, C, F);
  return static_cast<int>(cudaGetLastError());
}

template <bool XB>
int fwd(const void* x, const float* scale, const float* bias, const void* w,
        const float* dbias, void* out, float* st, int N, int C, int F,
        float eps, int c_bf16, cudaStream_t s) {
  if (!c_bf16) {
    const dim3 grid((N + kTile - 1) / kTile, (F + kTile - 1) / kTile);
    ln_dense_fwd_kernel<XB><<<grid, kThreads, 0, s>>>(
        x, scale, bias, w, dbias, static_cast<float*>(out), N, C, F, eps);
    return static_cast<int>(cudaGetLastError());
  }
  int rc = stats<XB>(x, st, N, C, eps, s);
  if (rc != 0) return rc;
  const int sms = sm_count();
  return pick_bn(N, F, sms) == 256
             ? fwd_bf16<XB, 256>(x, scale, bias, w, dbias, out, st, N, C, F,
                                 sms, s)
             : fwd_bf16<XB, 128>(x, scale, bias, w, dbias, out, st, N, C, F,
                                 sms, s);
}

template <int BN>
int dh_bf16(const void* dy, const void* w, float* dh, int N, int C, int F,
            int sms, cudaStream_t s) {
  using L = DhLayout<BN>;
  static unsigned long long ready = 0;
  cudaError_t e = opt_in(ln_dense_dh_wgmma_kernel<BN>, L::R::BYTES, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tdy, tw;
  if (!map_bf16(&tdy, dy, N, F, 64, 128) || !map_bf16(&tw, w, F, C, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + 127) / 128 * ((C + BN - 1) / BN);
  ln_dense_dh_wgmma_kernel<BN><<<tiles < sms ? tiles : sms, kWgThreads,
                                 L::R::BYTES, s>>>(tdy, tw, dh, N, C, F);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 values of dW's split partials: dW per split when there is more
// than one, and dc per (split, column tile of 128)
inline long long dw_part_floats(int splits, int C, int F) {
  return (splits > 1 ? static_cast<long long>(splits) * F * C : 0) +
         static_cast<long long>(splits) * ((C + 127) / 128) * F;
}

template <bool XB>
int dw_bf16(const void* x, const float* scale, const float* bias,
            const float* st, const void* dy, float* dw, float* dc,
            float* wpart, int splits, int N, int C, int F, int sms,
            cudaStream_t s) {
  using L = DwLayout<XB>;
  static unsigned long long ready = 0;
  cudaError_t e = opt_in(ln_dense_dw_wgmma_kernel<XB>, L::BYTES, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tx, tdy;
  if (!map_x<XB>(&tx, x, N, C, 64) || !map_bf16(&tdy, dy, N, F, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_c = (C + L::BM - 1) / L::BM;
  float* cpart = wpart + (splits > 1 ? static_cast<size_t>(splits) * F * C : 0);
  const int units = (F + L::BN - 1) / L::BN * tiles_c * splits;
  ln_dense_dw_wgmma_kernel<XB><<<units < sms ? units : sms, kWgThreads,
                                 L::BYTES, s>>>(
      tx, tdy, scale, bias, st, dw, wpart, cpart, splits, N, C, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int quads = ((splits > 1 ? F * C : 0) + F) / 4;
  ln_dense_split_sum_kernel<<<(quads + 255) / 256, 256, 0, s>>>(
      wpart, splits > 1 ? splits : 0, cpart, splits * tiles_c, F * C, F, dw,
      dc);
  return static_cast<int>(cudaGetLastError());
}

template <bool XB>
int bwd(const void* x, const float* scale, const float* bias, const void* w,
        const void* dy, void* dx, float* ds, float* db, float* dw, float* dc,
        float* dh, float* st, float* part, float* wpart, int splits, int N,
        int C, int F, float eps, int c_bf16, cudaStream_t s) {
  constexpr int T = kTile;
  int rc;
  const int sms = c_bf16 ? sm_count() : 0;
  if (c_bf16) {
    rc = pick_bn(N, C, sms) == 256 ? dh_bf16<256>(dy, w, dh, N, C, F, sms, s)
                                   : dh_bf16<128>(dy, w, dh, N, C, F, sms, s);
  } else {
    ln_dense_dh_kernel<<<dim3((N + T - 1) / T, (C + T - 1) / T), kThreads, 0,
                         s>>>(dy, w, dh, N, C, F);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  if ((rc = rows<XB>(x, scale, dh, dx, st, part, N, C, eps, s)) != 0)
    return rc;
  if (c_bf16) {
    rc = dw_bf16<XB>(x, scale, bias, st, dy, dw, dc, wpart, splits, N, C, F,
                     sms, s);
  } else {
    ln_dense_dw_kernel<XB><<<dim3((F + T - 1) / T, (C + T - 1) / T),
                             kThreads, 0, s>>>(x, scale, bias, st, st + N, dy,
                                               dw, dc, N, C, F);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_dense_reduce_kernel<<<(2 * C + 127) / 128, 128, 0, s>>>(part, blocks, C,
                                                             ds, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, C) bf16 (x_bf16) or fp32; scale, bias: (C,) fp32; w: (F, C) and
// out: (N, F) in the compute type (c_bf16: bf16, else fp32); dbias: (F,)
// fp32; stats: (2 * N) fp32 scratch (bf16 compute only; may be null
// otherwise). C and F multiples of 32, all pointers 16-byte aligned.
// Launches on `stream` (bf16: the statistics, then the GEMM; fp32: once)
// and returns the first non-zero cudaGetLastError() (0 = launched; a tensor
// map the driver refuses gives cudaErrorInvalidValue).
extern "C" int mla_ln_dense_fwd(const void* x, const void* scale,
                                const void* bias, const void* w,
                                const void* dbias, void* out, void* stats,
                                int N, int C, int F, int x_bf16, int c_bf16,
                                float eps, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const float* d = static_cast<const float*>(dbias);
  float* st = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return x_bf16 ? fwd<true>(x, s, b, w, d, out, st, N, C, F, eps, c_bf16, cs)
                : fwd<false>(x, s, b, w, d, out, st, N, C, F, eps, c_bf16,
                             cs);
}

// The scratch of the bf16 backward's dW GEMM at this shape on the current
// device: sets *splits to its row splits and returns the fp32 values of
// their partials (under fp32 compute: 1 and 0). The caller allocates them
// and passes both to mla_ln_dense_bwd.
extern "C" long long mla_ln_dense_bwd_scratch(int N, int C, int F,
                                              int c_bf16, int* splits) {
  *splits = c_bf16 ? dw_splits(N, C, F, sm_count()) : 1;
  return c_bf16 ? dw_part_floats(*splits, C, F) : 0;
}

// The forward's operands and dy: (N, F) in the compute type. Writes dx
// (N, C) in x's type and, in fp32, ds, db (C,), dw (F, C), dc (F,).
// Scratch, fp32: dh (N * C), stats (2 * N), part (2 * C * ceil(N / 32)),
// wpart (bf16 compute: the values mla_ln_dense_bwd_scratch returns, with
// its splits). C <= 1536 (the row pass's shared memory). Launches four
// (bf16: five) times on `stream` and returns the first non-zero
// cudaGetLastError() (0 = launched).
extern "C" int mla_ln_dense_bwd(const void* x, const void* scale,
                                const void* bias, const void* w,
                                const void* dy, void* dx, void* ds, void* db,
                                void* dw, void* dc, void* dh, void* stats,
                                void* part, void* wpart, int splits, int N,
                                int C, int F, int x_bf16, int c_bf16,
                                float eps, void* stream) {
  if (splits < 1 || (c_bf16 && wpart == nullptr) || (!c_bf16 && splits > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* f[8] = {static_cast<float*>(ds), static_cast<float*>(db),
                 static_cast<float*>(dw), static_cast<float*>(dc),
                 static_cast<float*>(dh), static_cast<float*>(stats),
                 static_cast<float*>(part), static_cast<float*>(wpart)};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define MLA_BWD(XB)                                                        \
  bwd<XB>(x, s, b, w, dy, dx, f[0], f[1], f[2], f[3], f[4], f[5], f[6],    \
          f[7], splits, N, C, F, eps, c_bf16, cs)
  return x_bf16 ? MLA_BWD(true) : MLA_BWD(false);
#undef MLA_BWD
}
