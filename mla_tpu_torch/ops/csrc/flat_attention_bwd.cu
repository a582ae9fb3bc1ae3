// Masked attention backward for Hopper (sm_90a), plain C interface, on two
// memory layouts that share one pair of kernels per element type.
//
// Flat layout: replaces mla_tpu/ops/attention.py:_attn_bwd_kernel_flat (the
// Pallas TPU kernel behind flash_attention_flat_bwd, tied to the forward by
// the custom VJP _flat_mha). It reads q, k and v by column out of the fused
// qkv projection (B, S, 3C) and the output gradient dO (B, S, C), and writes
// d(qkv) (B, S, 3C) in the forward's column layout: dq at column h*D, dk at
// C + h*D, dv at 2C + h*D. No concatenate runs after it
// (mla_flat_attention_bwd).
//
// Head layout: replaces mla_tpu/ops/attention.py:_attn_bwd_kernel_heads (the
// Pallas TPU kernel behind flash_attention_bwd, tied to flash_attention by
// the custom VJP _flash_mha): q, k, v, dO, dq, dk and dv are (B, H, S, D)
// tensors (mla_head_attention_bwd). The layouts differ only in the strides
// of each (batch row, head) plane, which the kernels take; the arithmetic is
// the same for both, so the two routes give the same bits.
//
// Semantics: the VJP of attention_reference with the TPU kernel's rounding
// points. Per head, scores = (q . k) * scale in fp32; where mask[b, key] > 0
// the scaled score is REPLACED by -1e7; P = softmax in fp32; dp = dO . v^T
// and delta_i = sum_j p_ij dp_ij in fp32 (not dO . O: O is rounded); ds =
// p * (dp - delta), 0 at a masked key (the reference's mask replaces the
// score, so its gradient is 0 there, even on a row whose keys are all
// masked), rounded to the input type before the dq and dk products; P
// rounded to the input type before the dv product; fp32 accumulation. Keys
// and queries stop at S: no padding key enters a sum (the TPU kernels pad S
// to a multiple of 8 and differ on a fully masked row). There is no length
// limit: the TPU kernel holds three (S, S) fp32 blocks in VMEM and the JAX
// package takes the VJP of the reference beyond 1024 tokens; these kernels
// stream tiles at every S, with one law at every length.
//
// Bound at the training shape (B=64, S=257, C=768, H=12, D=64, bf16): the
// kernel must read qkv and dO and the mask and write d(qkv), 176.9 MB, i.e.
// 52.8 us at 3.35 TB/s; its 10*B*H*S^2*D = 32.5 GFLOP (scores, dp, dq, dk,
// dv) take 32.8 us at the bf16 tensor-core peak. So it is bound by memory
// traffic.
//
// Design. The TPU kernel holds a head's whole (S, S) score block in VMEM. A
// Hopper block cannot, and blocks run in no order, so the work is split
// into two launches on the same stream, neither using atomics (the
// gradients repeat bit for bit from call to call):
//   1. query rows: one block per (64 queries, head, batch row). A first sweep
//      over the keys gives each row's max, sum and delta with an online
//      softmax (delta is rescaled with the sum); they go to a small fp32
//      buffer. A second sweep recomputes P and ds and accumulates dq.
//   2. key rows: one block per (64 keys, head, batch row). One sweep over
//      the queries, reading their max, sum and delta back, accumulates dk and
//      dv for the block's keys.
// That is 9 (S, S, D) products a head: scores and dp in each of the three
// sweeps, then dq, dk and dv.
//
// bf16 runs on the tensor cores (mma_bwd_*_kernel): each of a block's 4
// warps owns 16 rows and holds their two operands (q and dO, or k and v) as
// mma.sync m16n8k16 A fragments in registers, with its dq (or dk and dv)
// accumulating in fp32 fragments. The streamed 64-row tiles (k and v, or q
// and dO) stay bf16 in shared memory, rows padded by 16 bytes so ldmatrix
// reads them without bank conflicts, and load with cp.async into two
// buffers, the next tile while the current one is multiplied. A warp takes
// the tile 32 keys (queries) at a time: the scores and dp (in the key
// kernel their transposes, keys as rows) come out of the tensor cores as
// fp32 accumulator fragments, become P and ds in registers, are rounded to
// bf16 and feed the next product directly as its A fragment (ldmatrix.trans
// gives the tile as B), so P and ds never touch shared or device memory.
// Exponentials are taken base 2 (ex2.approx, as __expf does): a score is
// one fma, s * scale*log2(e) + 0, or 0 * s + (-1e7*log2(e) at a masked key,
// -inf past S), with the per-key multiplier and addend set once per 8 keys.
// A ragged tail (S = 257 = 4*64 + 1) costs one 16-row step, not a tile: the
// products stop at the last 16 keys (queries) that hold a real one, and a
// warp whose 16 rows all lie past S only helps load. The cp.async, ldmatrix
// and mma.sync helpers and the tile products are attention_mma.cuh's,
// shared with the forward (flat_attention.cu).
//
// fp32 stays on the FP32 FMA pipes (fma_bwd_*_kernel), since the port runs
// fp32 products in full fp32: each row (query or key) belongs to 4
// neighbouring threads, each holding a quarter of the head dim in
// registers; dot products are summed across the 4 with two warp shuffles;
// the streamed fp32 tiles are read as warp-wide broadcasts.
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr float kMasked = -1e7f;

// Byte strides of one operand: batch row, head, sequence row.
struct Strides {
  long long b, h, s;
};

// The operands of both launches: q, k, v and their gradients share the
// strides `in`, dO has `os`. `stats` holds, per (batch row, head, query),
// the row max, then the row sum, then delta, each as one B*H*S block; the
// bf16 kernels keep the max of the scores times log2(e) and 1/sum.
struct Args {
  const char* q;
  const char* k;
  const char* v;
  const char* dout;
  const float* mask;
  char* dq;
  char* dk;
  char* dv;
  float* stats;
  int S, H;
  Strides in, os;
  float scale;
};

// ============================================================ fp32: FMA

constexpr int RT = 64;          // rows (queries or keys) a block owns
constexpr int TT = 64;          // rows per streamed shared-memory tile
constexpr int TPR = 4;          // threads per row
constexpr int NT = RT * TPR;    // threads per block
constexpr int CH = 8;           // keys per online-softmax update

__device__ __forceinline__ float4 load4(const char* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                     __uint_as_float(u.z), __uint_as_float(u.w));
}

__device__ __forceinline__ void store4(char* p, const float* f) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                 __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// Rows r0 .. r0+TT-1 of one (batch row, head) plane of D-element rows at
// `plane`, `row_bytes` apart -> fp32 tile; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const char* plane,
                                          long long row_bytes, int r0, int S) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < TT * C4; idx += NT) {
    const int r = idx / C4, c = idx % C4;
    const int j = r0 + r;
    *reinterpret_cast<float4*>(&dst[r][4 * c]) =
        j < S ? load4(plane + j * row_bytes + 16 * c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// This thread's quarter of a row: 16-byte pieces g = c*TPR + part.
template <int D>
__device__ __forceinline__ void load_own(float* dst, const char* row, int part,
                                         bool live) {
  constexpr int NC = D / (4 * TPR);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 f = live ? load4(row + 16 * (c * TPR + part))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * c] = f.x; dst[4 * c + 1] = f.y;
    dst[4 * c + 2] = f.z; dst[4 * c + 3] = f.w;
  }
}

template <int D>
__device__ __forceinline__ void store_own(char* row, const float* src,
                                          int part, float mul) {
  constexpr int NC = D / (4 * TPR);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = src[4 * c + i] * mul;
    store4(row + 16 * (c * TPR + part), f);
  }
}

// dot of this thread's quarter `own` with the same quarter of tile row `t`
template <int D>
__device__ __forceinline__ float dot_part(const float* own, const float* t,
                                          int part) {
  constexpr int NC = D / (4 * TPR);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(t + 4 * (c * TPR + part));
    acc = fmaf(own[4 * c], x.x, acc);
    acc = fmaf(own[4 * c + 1], x.y, acc);
    acc = fmaf(own[4 * c + 2], x.z, acc);
    acc = fmaf(own[4 * c + 3], x.w, acc);
  }
  return acc;
}

// own += a * (this thread's quarter of tile row `t`)
template <int D>
__device__ __forceinline__ void axpy_part(float* own, float a, const float* t,
                                          int part) {
  constexpr int NC = D / (4 * TPR);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(t + 4 * (c * TPR + part));
    own[4 * c] = fmaf(a, x.x, own[4 * c]);
    own[4 * c + 1] = fmaf(a, x.y, own[4 * c + 1]);
    own[4 * c + 2] = fmaf(a, x.z, own[4 * c + 2]);
    own[4 * c + 3] = fmaf(a, x.w, own[4 * c + 3]);
  }
}

// Launch 1: per query row, max / sum / delta (to `stats`), then dq.
template <int D>
__global__ void __launch_bounds__(NT)
fma_bwd_dq_kernel(const Args args) {
  constexpr int NC = D / (4 * TPR);
  static_assert(D % (4 * TPR) == 0, "head dim must split into 4 quarters");

  __shared__ __align__(16) float Ks[TT][D];
  __shared__ __align__(16) float Vs[TT][D];
  __shared__ float Ms[TT];

  const int S = args.S;
  const float scale = args.scale;
  const int part = threadIdx.x % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * RT + threadIdx.x / TPR;
  const bool live = qi < S;
  const long long plane = b * args.in.b + h * args.in.h;  // this (b, h)'s rows
  const long long oplane = b * args.os.b + h * args.os.h;
  const char* kp = args.k + plane;
  const char* vp = args.v + plane;
  const float* mrow = args.mask + (long long)b * S;

  float q[4 * NC], g[4 * NC];
  load_own<D>(q, args.q + plane + qi * args.in.s, part, live);
  load_own<D>(g, args.dout + oplane + qi * args.os.s, part, live);

  auto load_kv = [&](int k0) {
    __syncthreads();  // the previous tile has been read by every thread
    load_tile<D>(Ks, kp, args.in.s, k0, S);
    load_tile<D>(Vs, vp, args.in.s, k0, S);
    for (int r = threadIdx.x; r < TT; r += NT)
      Ms[r] = k0 + r < S ? mrow[k0 + r] : 0.f;
    __syncthreads();
  };

  // sweep 1: running max m, sum l, and a = sum_j exp(s_j - m) dp_j
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int k0 = 0; k0 < S; k0 += TT) {
    load_kv(k0);
    const int nk = min(TT, S - k0);
    for (int c0 = 0; c0 < nk; c0 += CH) {
      // key c0 is real, so every chunk has a finite maximum
      float s[CH], dp[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int r = c0 + u;
        const float sd = quad_sum(dot_part<D>(q, Ks[r], part));
        dp[u] = quad_sum(dot_part<D>(g, Vs[r], part));
        float sc = sd * scale;
        if (Ms[r] > 0.f) sc = kMasked;  // replace the scaled score
        if (r >= nk) sc = -INFINITY;    // past S: weight exactly 0
        s[u] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float mnew = fmaxf(m, cmax);
      const float corr = expf(m - mnew);  // 0 on the first chunk
      l *= corr;
      a *= corr;
      m = mnew;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const float e = expf(s[u] - m);
        l += e;
        a = fmaf(e, dp[u], a);
      }
    }
  }
  const float delta = a / l;
  if (live && part == 0) {
    const long long n = (long long)gridDim.z * args.H * S;
    const long long i = ((long long)b * args.H + h) * S + qi;
    args.stats[i] = m;
    args.stats[n + i] = l;
    args.stats[2 * n + i] = delta;
  }

  // sweep 2: dq = scale * sum_j ds_ij k_j
  float dq[4 * NC];
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) dq[i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += TT) {
    load_kv(k0);
    const int nk = min(TT, S - k0);
    for (int r = 0; r < nk; ++r) {
      if (Ms[r] > 0.f) continue;  // ds = 0 at a masked key (same for all)
      const float sd = quad_sum(dot_part<D>(q, Ks[r], part));
      const float dp = quad_sum(dot_part<D>(g, Vs[r], part));
      const float p = expf(sd * scale - m) / l;
      const float ds = p * (dp - delta);
      axpy_part<D>(dq, ds, Ks[r], part);
    }
  }
  if (live) store_own<D>(args.dq + plane + qi * args.in.s, dq, part, scale);
}

// Launch 2: per key row, dk and dv over all queries (reads `stats`).
template <int D>
__global__ void __launch_bounds__(NT)
fma_bwd_dkdv_kernel(const Args args) {
  constexpr int NC = D / (4 * TPR);
  static_assert(D % (4 * TPR) == 0, "head dim must split into 4 quarters");

  __shared__ __align__(16) float Qs[TT][D];
  __shared__ __align__(16) float Gs[TT][D];
  __shared__ float Sm[TT], Sl[TT], Sd[TT];

  const int S = args.S;
  const float scale = args.scale;
  const int part = threadIdx.x % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = blockIdx.x * RT + threadIdx.x / TPR;
  const bool live = kj < S;
  const long long plane = b * args.in.b + h * args.in.h;  // this (b, h)'s rows
  const long long oplane = b * args.os.b + h * args.os.h;
  const bool masked = live && args.mask[(long long)b * S + kj] > 0.f;
  const long long n = (long long)gridDim.z * args.H * S;
  const float* st = args.stats + ((long long)b * args.H + h) * S;

  float k[4 * NC], v[4 * NC], dk[4 * NC], dv[4 * NC];
  load_own<D>(k, args.k + plane + kj * args.in.s, part, live);
  load_own<D>(v, args.v + plane + kj * args.in.s, part, live);
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) { dk[i] = 0.f; dv[i] = 0.f; }

  for (int i0 = 0; i0 < S; i0 += TT) {
    __syncthreads();
    load_tile<D>(Qs, args.q + plane, args.in.s, i0, S);
    load_tile<D>(Gs, args.dout + oplane, args.os.s, i0, S);
    for (int r = threadIdx.x; r < TT; r += NT) {
      const bool in = i0 + r < S;
      Sm[r] = in ? st[i0 + r] : 0.f;
      Sl[r] = in ? st[n + i0 + r] : 1.f;
      Sd[r] = in ? st[2 * n + i0 + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(TT, S - i0);
    for (int r = 0; r < nq; ++r) {
      const float sd = quad_sum(dot_part<D>(k, Qs[r], part));
      const float dp = quad_sum(dot_part<D>(v, Gs[r], part));
      const float sc = masked ? kMasked : sd * scale;
      const float p = expf(sc - Sm[r]) / Sl[r];
      const float ds = masked ? 0.f : p * (dp - Sd[r]);
      axpy_part<D>(dv, p, Gs[r], part);
      axpy_part<D>(dk, ds, Qs[r], part);
    }
  }
  if (live) {
    store_own<D>(args.dk + plane + kj * args.in.s, dk, part, scale);
    store_own<D>(args.dv + plane + kj * args.in.s, dv, part, 1.f);
  }
}

// ====================================================== bf16: tensor cores

constexpr int BR = 64;          // rows (queries or keys) a block owns
constexpr int BT = 64;          // rows per streamed shared-memory tile
constexpr int CK = 32;          // tile rows a warp takes at a time
constexpr int NTH = 128;        // 4 warps of 16 rows
// The bf16 kernels take exponentials base 2: scores scaled by scale*log2(e)
// (a masked one replaced by -1e7*log2(e)), row maxima in that unit, so one
// ex2 gives exp(s - m).
constexpr float kMasked2 = kMasked * kLog2e;

// rows m0 + g and m0 + g + 8 of accumulator fragments (D/8 of them), times
// mul, rounded to bf16 -> a plane; rows past S are not written
template <int D>
__device__ __forceinline__ void store_rows(char* plane, long long row_bytes,
                                           int m0, int S,
                                           const float (*acc)[4], float mul,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + g + 8 * r;
    if (row < S) {
      char* p = plane + row * row_bytes + 4 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + 16 * j) =
            pack_bf16x2(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
    }
  }
}

// Launch 1: per query row, max / 1/sum / delta (to `stats`), then dq.
template <int D>
__global__ void __launch_bounds__(NTH)
mma_bwd_dq_kernel(const Args args) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int P = D + 8, NJ = CK / 8;
  __shared__ __align__(16) uint16_t Ks[2][BT * P];
  __shared__ __align__(16) uint16_t Vs[2][BT * P];
  __shared__ __align__(16) float Ms[2][BT];

  const int S = args.S;
  const float scale2 = args.scale * kLog2e;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, its row
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR + 16 * warp; // this warp's first query
  const bool active = q0 < S;                 // the same for the whole warp
  const long long plane = b * args.in.b + h * args.in.h;
  const long long oplane = b * args.os.b + h * args.os.h;
  const float* mrow = args.mask + (long long)b * S;
  const int nt = (S + BT - 1) / BT;

  // tile `it` of the two sweeps (both walk the keys) -> buffer `buf`
  auto stage = [&](int it, int buf) {
    const int k0 = (it % nt) * BT;
    stage_rows<D, BT, NTH>(Ks[buf], args.k + plane, args.in.s, k0, S);
    stage_rows<D, BT, NTH>(Vs[buf], args.v + plane, args.in.s, k0, S);
    stage_floats<BT, NTH>(Ms[buf], mrow, k0, S);
    cp_async_commit();
  };
  stage(0, 0);

  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_a<D>(qf, args.q + plane, args.in.s, q0, S, g, t);
  load_a<D>(gf, args.dout + oplane, args.os.s, q0, S, g, t);

  // rows g and g + 8: running max, this lane's share of the sum and of
  // a = sum_j exp(s_j - m) dp_j; after sweep 1, 1/sum and delta
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int it = 0; it < 2 * nt; ++it) {
    const int buf = it & 1;
    if (it + 1 < 2 * nt) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active && it == nt) {     // sweep 1 done: the rows' statistics
      const long long n = (long long)gridDim.z * args.H * S;
      const long long i0 = ((long long)b * args.H + h) * S;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lt = quad_sum(l[r]), at = quad_sum(a[r]);
        a[r] = at / lt;           // delta
        l[r] = 1.f / lt;
        const int row = q0 + g + 8 * r;
        if (t == 0 && row < S) {
          args.stats[i0 + row] = m[r];
          args.stats[n + i0 + row] = l[r];
          args.stats[2 * n + i0 + row] = a[r];
        }
      }
    }
    if (active) {
      const int nk = min(BT, S - (it % nt) * BT);
      const uint16_t* K = Ks[buf];
      const uint16_t* V = Vs[buf];
      const float* M = Ms[buf];
      for (int c0 = 0; c0 < nk; c0 += CK) {
        const int nc = min(CK, nk - c0);
        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
        product_nt<D, CK>(s, qf, K, c0, nc, mi, mr);
        product_nt<D, CK>(dp, gf, V, c0, nc, mi, mr);
        // this lane's keys (2 of every 8): the score is s * mul + add.
        // Sweep 1: the scaled score, kMasked2 at a masked key, -inf past S.
        // Sweep 2 needs ds alone, 0 at both: -inf.
        float mul[NJ][2], add[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = c0 + 8 * j + 2 * t + u;
            const bool past = col >= nk, masked = !past && M[col] > 0.f;
            mul[j][u] = past || masked ? 0.f : scale2;
            add[j][u] = past || (masked && it >= nt) ? -INFINITY
                        : masked ? kMasked2 : 0.f;
          }
        if (it < nt) {            // sweep 1: online max, sum and a
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float& x = s[j][2 * r + u];
                x = fmaf(x, mul[j][u], add[j][u]);
                mx = fmaxf(mx, x);
              }
            // key c0 is real, so every chunk has a finite maximum
            const float mnew = fmaxf(m[r], quad_max(mx));
            const float corr = ex2(m[r] - mnew);   // 0 on the first chunk
            l[r] *= corr;
            a[r] *= corr;
            m[r] = mnew;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float ex = ex2(s[j][2 * r + u] - mnew);
                l[r] += ex;
                a[r] = fmaf(ex, dp[j][2 * r + u], a[r]);
              }
          }
        } else {                  // sweep 2: ds, then dq += ds . K
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, u = e & 1;
              const float p =
                  ex2(fmaf(s[j][e], mul[j][u], add[j][u]) - m[r]) * l[r];
              s[j][e] = p * (dp[j][e] - a[r]);
            }
          uint32_t dsf[CK / 16][4];
          to_a<CK>(dsf, s);
          product_nn<D, CK>(dq, dsf, K, c0, nc, mi, mr);
        }
      }
    }
    __syncthreads();              // the buffer is free for the next stage
  }
  if (active)
    store_rows<D>(args.dq + plane, args.in.s, q0, S, dq, args.scale, g, t);
}

// Launch 2: per key row, dk and dv over all queries (reads `stats`).
template <int D>
__global__ void __launch_bounds__(NTH)
mma_bwd_dkdv_kernel(const Args args) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int P = D + 8, NJ = CK / 8;
  __shared__ __align__(16) uint16_t Qs[2][BT * P];
  __shared__ __align__(16) uint16_t Gs[2][BT * P];
  __shared__ __align__(16) float Ss[2][3][BT];  // max, 1/sum, delta

  const int S = args.S;
  const float scale2 = args.scale * kLog2e;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BR + 16 * warp;  // this warp's first key
  const bool active = k0 < S;
  const long long plane = b * args.in.b + h * args.in.h;
  const long long oplane = b * args.os.b + h * args.os.h;
  const long long n = (long long)gridDim.z * args.H * S;
  const float* st = args.stats + ((long long)b * args.H + h) * S;
  const int nt = (S + BT - 1) / BT;

  // query tile `it` -> buffer `buf`; a query past S has zero q and dO rows
  // and zero statistics (1/sum = 0), so its P and ds are exactly 0
  auto stage = [&](int it, int buf) {
    const int i0 = it * BT;
    stage_rows<D, BT, NTH>(Qs[buf], args.q + plane, args.in.s, i0, S);
    stage_rows<D, BT, NTH>(Gs[buf], args.dout + oplane, args.os.s, i0, S);
#pragma unroll
    for (int w = 0; w < 3; ++w) stage_floats<BT, NTH>(Ss[buf][w], st + w * n, i0, S);
    cp_async_commit();
  };
  stage(0, 0);

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, args.k + plane, args.in.s, k0, S, g, t);
  load_a<D>(vf, args.v + plane, args.in.s, k0, S, g, t);
  // rows g and g + 8: the score is s * mul + add (kMasked2 at a masked key)
  float mul[2], add[2];
  bool masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + g + 8 * r;
    masked[r] = key < S && args.mask[(long long)b * S + key] > 0.f;
    mul[r] = masked[r] ? 0.f : scale2;
    add[r] = masked[r] ? kMasked2 : 0.f;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk[j][e] = 0.f; dv[j][e] = 0.f; }

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    if (it + 1 < nt) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int nq = min(BT, S - it * BT);
      const uint16_t* Q = Qs[buf];
      const uint16_t* G = Gs[buf];
      const float* Sm = Ss[buf][0];
      const float* Sl = Ss[buf][1];
      const float* Sd = Ss[buf][2];
      for (int c0 = 0; c0 < nq; c0 += CK) {
        const int nc = min(CK, nq - c0);
        // keys as rows: s^T = K . Q^T, dp^T = V . dO^T
        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
        product_nt<D, CK>(s, kf, Q, c0, nc, mi, mr);
        product_nt<D, CK>(dp, vf, G, c0, nc, mi, mr);
        // P^T into s, ds^T into dp (0 at a masked key)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = c0 + 8 * j + 2 * t + u;
            const float mc = Sm[col], lc = Sl[col], dc = Sd[col];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + u;
              const float p = ex2(fmaf(s[j][e], mul[r], add[r]) - mc) * lc;
              dp[j][e] = masked[r] ? 0.f : p * (dp[j][e] - dc);
              s[j][e] = p;
            }
          }
        uint32_t pf[CK / 16][4], dsf[CK / 16][4];
        to_a<CK>(pf, s);
        to_a<CK>(dsf, dp);
        product_nn<D, CK>(dv, pf, G, c0, nc, mi, mr);   // dv += P^T . dO
        product_nn<D, CK>(dk, dsf, Q, c0, nc, mi, mr);  // dk += ds^T . Q
      }
    }
    __syncthreads();
  }
  if (active) {
    store_rows<D>(args.dk + plane, args.in.s, k0, S, dk, args.scale, g, t);
    store_rows<D>(args.dv + plane, args.in.s, k0, S, dv, 1.f, g, t);
  }
}

// ================================================================ launch

template <int D>
int launch(const Args& a, int B, bool bf16, cudaStream_t stream) {
  if (bf16) {
    const dim3 grid((a.S + BR - 1) / BR, a.H, B);
    mma_bwd_dq_kernel<D><<<grid, NTH, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mma_bwd_dkdv_kernel<D><<<grid, NTH, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((a.S + RT - 1) / RT, a.H, B);
  fma_bwd_dq_kernel<D><<<grid, NT, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fma_bwd_dkdv_kernel<D><<<grid, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Element strides -> byte strides, then the head-dim instantiation.
int dispatch(Args a, int B, int D, int bf16, void* stream) {
  const long long bytes = bf16 ? 2 : 4;
  a.in = {a.in.b * bytes, a.in.h * bytes, a.in.s * bytes};
  a.os = {a.os.b * bytes, a.os.h * bytes, a.os.s * bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, B, bf16 != 0, st);
    case 64: return launch<64>(a, B, bf16 != 0, st);
    case 80: return launch<80>(a, B, bf16 != 0, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// qkv: (B, S, 3C) contiguous, fp32 or bf16, 16-byte aligned; dout: (B, S, C)
// of the same type; mask: (B, S) fp32, 1 = padded key; dqkv: (B, S, 3C) of
// qkv's type, fully written; stats: 3*B*H*S fp32 scratch. Launches twice on
// `stream` and returns the first non-zero cudaGetLastError() (0 = launched).
extern "C" int mla_flat_attention_bwd(const void* qkv, const void* dout,
                                      const void* mask, void* dqkv,
                                      void* stats, int B, int S, int H, int D,
                                      int bf16, float scale, void* stream) {
  const long long C = (long long)H * D;
  const long long third = C * (bf16 ? 2 : 4);
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  const Args a = {in, in + third, in + 2 * third,
                  static_cast<const char*>(dout),
                  static_cast<const float*>(mask), out, out + third,
                  out + 2 * third, static_cast<float*>(stats), S, H,
                  {S * 3 * C, D, 3 * C}, {S * C, D, C}, scale};
  return dispatch(a, B, D, bf16, stream);
}

// q, k, v, dout: (B, H, S, D) contiguous, fp32 or bf16, all of one type,
// 16-byte aligned; mask: (B, S) fp32, 1 = padded key; dq, dk, dv: (B, H, S,
// D) of that type, fully written; stats: 3*B*H*S fp32 scratch. Launches
// twice on `stream` and returns the first non-zero cudaGetLastError().
extern "C" int mla_head_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* mask, void* dq, void* dk,
                                      void* dv, void* stats, int B, int S,
                                      int H, int D, int bf16, float scale,
                                      void* stream) {
  const Strides hs = {(long long)H * S * D, (long long)S * D, D};
  const Args a = {static_cast<const char*>(q), static_cast<const char*>(k),
                  static_cast<const char*>(v),
                  static_cast<const char*>(dout),
                  static_cast<const float*>(mask), static_cast<char*>(dq),
                  static_cast<char*>(dk), static_cast<char*>(dv),
                  static_cast<float*>(stats), S, H, hs, hs, scale};
  return dispatch(a, B, D, bf16, stream);
}
