// Flat-layout masked attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces mla_tpu/ops/attention.py:_attn_bwd_kernel_flat (the Pallas TPU
// kernel behind flash_attention_flat_bwd, tied to the forward by the custom
// VJP _flat_mha). It reads q, k and v by column out of the fused qkv
// projection (B, S, 3C) and the output gradient dO (B, S, C), and writes
// d(qkv) (B, S, 3C) in the forward's column layout: dq at column h*D, dk at
// C + h*D, dv at 2C + h*D. No concatenate runs after it.
//
// Semantics: the VJP of attention_reference with the TPU kernel's rounding
// points. Per head, scores = (q . k) * scale in fp32; where mask[b, key] > 0
// the scaled score is REPLACED by -1e7; P = softmax in fp32; dp = dO . v^T
// and delta_i = sum_j p_ij dp_ij in fp32; ds = p * (dp - delta), 0 at a
// masked key (the reference's mask replaces the score, so its gradient is
// 0 there, even on a row whose keys are all masked), rounded to the input
// type before the dq and dk products; P rounded to the input type before the
// dv product; fp32 accumulation. Keys and queries stop at S: no padding key
// enters a sum (the TPU kernel pads S to a multiple of 8 and differs on a
// fully masked row).
//
// Design. The TPU kernel holds a head's whole (S, S) score block in VMEM. A
// Hopper block cannot, and blocks run in no order, so the work is split
// into two launches on the same stream, neither using atomics:
//   1. query rows: one block per (64 queries, head, batch row). A first sweep
//      over the keys gives each row's max, sum and delta with an online
//      softmax (delta is rescaled with the sum); they go to a small fp32
//      buffer. A second sweep recomputes P and ds and accumulates dq.
//   2. key rows: one block per (64 keys, head, batch row). One sweep over
//      the queries, reading their max, sum and delta back, accumulates dk and
//      dv for the block's keys.
// Each row (query or key) belongs to 4 neighbouring threads, each holding a
// quarter of the head dim in registers (so q, dO and dq, or k, v, dk and dv,
// stay in registers at D = 80); dot products are summed across the 4 with
// two warp shuffles. The streamed tiles (64 rows) sit in shared memory as
// fp32 and are read as warp-wide broadcasts, the 4 quarters of a row in
// interleaved 16-byte pieces so the reads do not conflict. The products run
// on the FP32 FMA pipes, not the tensor cores: this is the simple first
// version.
//
// Bound at the training shape (B=64, S=257, C=768, H=12, D=64, bf16): the
// kernel must read qkv and dO and the mask and write d(qkv), 176.9 MB, i.e.
// 52.8 us at 3.35 TB/s; its 10*B*H*S^2*D = 32.5 GFLOP take 32.8 us at the
// bf16 tensor-core peak. So it is bound by memory traffic; on the FMA pipes
// used here (the recompute adds 2*B*H*S^2*D more) the operations dominate.
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int RT = 64;          // rows (queries or keys) a block owns
constexpr int TT = 64;          // rows per streamed shared-memory tile
constexpr int TPR = 4;          // threads per row
constexpr int NT = RT * TPR;    // threads per block
constexpr int CH = 8;           // keys per online-softmax update
constexpr float kMasked = -1e7f;

// Element formats, moved 4 elements at a time.
template <bool BF16> struct Elem;

template <> struct Elem<false> {  // fp32: 16 bytes
  static constexpr int BYTES = 4;
  __device__ static __forceinline__ float4 load4(const char* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                       __uint_as_float(u.z), __uint_as_float(u.w));
  }
  __device__ static __forceinline__ void store4(char* p, const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static __forceinline__ float round(float x) { return x; }
};

template <> struct Elem<true> {  // bf16: 8 bytes
  static constexpr int BYTES = 2;
  __device__ static __forceinline__ float4 load4(const char* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),  // low half = lower index
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  __device__ static __forceinline__ uint32_t pack2(float a, float b) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
    return lo | (hi << 16);
  }
  __device__ static __forceinline__ void store4(char* p, const float* f) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f[0], f[1]),
                                              pack2(f[2], f[3]));
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// Sum over the 4 threads of a row (neighbouring lanes). Every lane of the
// warp must call it.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Rows r0 .. r0+TT-1 of one head's D columns (starting at byte `col`) of a
// (B, S, *) row-major slab at `base` with `row_bytes` per row -> fp32 tile;
// rows past S are zero.
template <bool BF16, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const char* base,
                                          long long row_bytes, long long col,
                                          int r0, int S) {
  using E = Elem<BF16>;
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < TT * C4; idx += NT) {
    const int r = idx / C4, c = idx % C4;
    const int j = r0 + r;
    *reinterpret_cast<float4*>(&dst[r][4 * c]) =
        j < S ? E::load4(base + j * row_bytes + col + 4 * c * E::BYTES)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// This thread's quarter of a row: 16-byte pieces g = c*TPR + part.
template <bool BF16, int D>
__device__ __forceinline__ void load_own(float* dst, const char* row, int part,
                                         bool live) {
  using E = Elem<BF16>;
  constexpr int NC = D / (4 * TPR);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 f = live ? E::load4(row + 4 * (c * TPR + part) * E::BYTES)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * c] = f.x; dst[4 * c + 1] = f.y;
    dst[4 * c + 2] = f.z; dst[4 * c + 3] = f.w;
  }
}

template <bool BF16, int D>
__device__ __forceinline__ void store_own(char* row, const float* src,
                                          int part, float mul) {
  using E = Elem<BF16>;
  constexpr int NC = D / (4 * TPR);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = src[4 * c + i] * mul;
    E::store4(row + 4 * (c * TPR + part) * E::BYTES, f);
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
template <bool BF16, int D>
__global__ void __launch_bounds__(NT)
flat_attention_bwd_dq_kernel(const char* __restrict__ qkv,
                             const char* __restrict__ dout,
                             const float* __restrict__ mask,
                             char* __restrict__ dqkv,
                             float* __restrict__ stats, int S, int H,
                             float scale) {
  using E = Elem<BF16>;
  constexpr int NC = D / (4 * TPR);
  static_assert(D % (4 * TPR) == 0, "head dim must split into 4 quarters");

  __shared__ __align__(16) float Ks[TT][D];
  __shared__ __align__(16) float Vs[TT][D];
  __shared__ float Ms[TT];

  const int part = threadIdx.x % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * RT + threadIdx.x / TPR;
  const bool live = qi < S;
  const int C = H * D;
  const long long row3 = 3LL * C * E::BYTES;   // qkv / dqkv row stride
  const long long row1 = (long long)C * E::BYTES;
  const char* base = qkv + (long long)b * S * row3;
  const char* obase = dout + (long long)b * S * row1;
  const long long q_col = (long long)h * D * E::BYTES;
  const long long k_col = (long long)(C + h * D) * E::BYTES;
  const long long v_col = (long long)(2 * C + h * D) * E::BYTES;
  const float* mrow = mask + (long long)b * S;

  float q[4 * NC], g[4 * NC];
  load_own<BF16, D>(q, base + qi * row3 + q_col, part, live);
  load_own<BF16, D>(g, obase + qi * row1 + q_col, part, live);

  auto load_kv = [&](int k0) {
    __syncthreads();  // the previous tile has been read by every thread
    load_tile<BF16, D>(Ks, base, row3, k_col, k0, S);
    load_tile<BF16, D>(Vs, base, row3, v_col, k0, S);
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
        const float sd = row_sum(dot_part<D>(q, Ks[r], part));
        dp[u] = row_sum(dot_part<D>(g, Vs[r], part));
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
    const long long n = (long long)gridDim.z * H * S;
    const long long i = ((long long)b * H + h) * S + qi;
    stats[i] = m;
    stats[n + i] = l;
    stats[2 * n + i] = delta;
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
      const float sd = row_sum(dot_part<D>(q, Ks[r], part));
      const float dp = row_sum(dot_part<D>(g, Vs[r], part));
      const float p = expf(sd * scale - m) / l;
      const float ds = E::round(p * (dp - delta));
      axpy_part<D>(dq, ds, Ks[r], part);
    }
  }
  if (live) store_own<BF16, D>(dqkv + (long long)b * S * row3 + qi * row3 +
                                   q_col, dq, part, scale);
}

// Launch 2: per key row, dk and dv over all queries (reads `stats`).
template <bool BF16, int D>
__global__ void __launch_bounds__(NT)
flat_attention_bwd_dkdv_kernel(const char* __restrict__ qkv,
                               const char* __restrict__ dout,
                               const float* __restrict__ mask,
                               char* __restrict__ dqkv,
                               const float* __restrict__ stats, int S, int H,
                               float scale) {
  using E = Elem<BF16>;
  constexpr int NC = D / (4 * TPR);
  static_assert(D % (4 * TPR) == 0, "head dim must split into 4 quarters");

  __shared__ __align__(16) float Qs[TT][D];
  __shared__ __align__(16) float Gs[TT][D];
  __shared__ float Sm[TT], Sl[TT], Sd[TT];

  const int part = threadIdx.x % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = blockIdx.x * RT + threadIdx.x / TPR;
  const bool live = kj < S;
  const int C = H * D;
  const long long row3 = 3LL * C * E::BYTES;
  const long long row1 = (long long)C * E::BYTES;
  const char* base = qkv + (long long)b * S * row3;
  const char* obase = dout + (long long)b * S * row1;
  const long long q_col = (long long)h * D * E::BYTES;
  const long long k_col = (long long)(C + h * D) * E::BYTES;
  const long long v_col = (long long)(2 * C + h * D) * E::BYTES;
  const bool masked = live && mask[(long long)b * S + kj] > 0.f;
  const long long n = (long long)gridDim.z * H * S;
  const float* st = stats + ((long long)b * H + h) * S;

  float k[4 * NC], v[4 * NC], dk[4 * NC], dv[4 * NC];
  load_own<BF16, D>(k, base + kj * row3 + k_col, part, live);
  load_own<BF16, D>(v, base + kj * row3 + v_col, part, live);
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) { dk[i] = 0.f; dv[i] = 0.f; }

  for (int i0 = 0; i0 < S; i0 += TT) {
    __syncthreads();
    load_tile<BF16, D>(Qs, base, row3, q_col, i0, S);
    load_tile<BF16, D>(Gs, obase, row1, q_col, i0, S);
    for (int r = threadIdx.x; r < TT; r += NT) {
      const bool in = i0 + r < S;
      Sm[r] = in ? st[i0 + r] : 0.f;
      Sl[r] = in ? st[n + i0 + r] : 1.f;
      Sd[r] = in ? st[2 * n + i0 + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(TT, S - i0);
    for (int r = 0; r < nq; ++r) {
      const float sd = row_sum(dot_part<D>(k, Qs[r], part));
      const float dp = row_sum(dot_part<D>(v, Gs[r], part));
      const float sc = masked ? kMasked : sd * scale;
      const float p = expf(sc - Sm[r]) / Sl[r];
      const float ds = masked ? 0.f : E::round(p * (dp - Sd[r]));
      axpy_part<D>(dv, E::round(p), Gs[r], part);
      axpy_part<D>(dk, ds, Qs[r], part);
    }
  }
  if (live) {
    char* row = dqkv + (long long)b * S * row3 + kj * row3;
    store_own<BF16, D>(row + k_col, dk, part, scale);
    store_own<BF16, D>(row + v_col, dv, part, 1.f);
  }
}

template <bool BF16, int D>
int launch(const void* qkv, const void* dout, const float* mask, void* dqkv,
           float* stats, int B, int S, int H, float scale,
           cudaStream_t stream) {
  const dim3 grid((S + RT - 1) / RT, H, B);
  flat_attention_bwd_dq_kernel<BF16, D><<<grid, NT, 0, stream>>>(
      static_cast<const char*>(qkv), static_cast<const char*>(dout), mask,
      static_cast<char*>(dqkv), stats, S, H, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flat_attention_bwd_dkdv_kernel<BF16, D><<<grid, NT, 0, stream>>>(
      static_cast<const char*>(qkv), static_cast<const char*>(dout), mask,
      static_cast<char*>(dqkv), stats, S, H, scale);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch_d(const void* qkv, const void* dout, const float* mask,
               void* dqkv, float* stats, int B, int S, int H, int D,
               float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<BF16, 16>(qkv, dout, mask, dqkv, stats, B, S, H, scale, st);
    case 64: return launch<BF16, 64>(qkv, dout, mask, dqkv, stats, B, S, H, scale, st);
    case 80: return launch<BF16, 80>(qkv, dout, mask, dqkv, stats, B, S, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
  const float* m = static_cast<const float*>(mask);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<true>(qkv, dout, m, dqkv, st, B, S, H, D, scale, s)
              : dispatch_d<false>(qkv, dout, m, dqkv, st, B, S, H, D, scale, s);
}
