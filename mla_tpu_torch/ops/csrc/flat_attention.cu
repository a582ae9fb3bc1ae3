// Masked attention forward for Hopper (sm_90a), plain C interface, on two
// memory layouts that share one kernel per element type.
//
// Flat layout: replaces mla_tpu/ops/attention.py:_attn_kernel_flat (the
// Pallas TPU kernel behind flash_attention_flat). It reads q, k and v by
// column straight out of the fused qkv projection (B, S, 3C) and writes
// (B, S, C) in the layout the output projection consumes, so no transpose
// runs before or after it (mla_flat_attention_fwd).
//
// Head layout: replaces mla_tpu/ops/attention.py:_attn_kernel_heads and the
// q-blockwise _attn_kernel (the Pallas TPU kernels behind flash_attention):
// q, k, v and the output are (B, H, S, D) tensors (mla_head_attention_fwd).
//
// The layouts differ only in addressing: each (batch row, head) reads a
// plane of S rows of D elements, at row stride 3C (flat, column offset h*D)
// or D (head, plane offset (b*H + h)*S*D). The kernels take those strides
// and their arithmetic is the same for both, so the two routes give the same
// bits.
//
// Semantics (same as attention_reference in the JAX package and the original
// PyTorch model): per head, scores = (q . k) * scale in fp32; where
// mask[b, key] > 0 the scaled score is REPLACED by -1e7 (not added to, and not
// -inf); softmax in fp32; the probabilities are rounded to the input type
// before the PV product; fp32 accumulation. The key loop stops at S, so no
// padding key ever enters the sum: a row whose keys are all masked gives the
// mean of V over the S real keys (the TPU kernels pad S to a multiple of 8
// and average over the padded length there instead). The TPU's q-blockwise
// kernel, taken there for sequences whose scores outgrow VMEM, upcasts q, k
// and v and never rounds P; these kernels stream key tiles with no length
// limit and keep the one law at every S. The probabilities are rounded
// unnormalised, at the running maximum of the key tile (bf16: 64 keys; fp32:
// 8 keys), and the division by the row sum comes at the end; the TPU kernel
// normalises, then rounds.
//
// Bound at the serving shape (B=64, S=257, C=768, H=12, D=64, bf16): the
// kernel must read qkv (64*257*2304*2 B) and the mask and write out
// (64*257*768*2 B), 101 MB, i.e. 30 us at 3.35 TB/s; its 4*B*H*S^2*D =
// 13.0 GFLOP take 13 us at the bf16 tensor-core peak (26 us at mma.sync's,
// about half of it). So the kernel is bound by memory traffic, as long as
// its products run on the tensor cores. The head layout moves the same
// bytes.
//
// bf16: the tensor cores (mma_fwd_kernel). A block of 4 warps owns 64 query
// rows of one (batch row, head), 16 rows a warp, held as mma.sync m16n8k16 A
// fragments in registers for the whole key loop. The 64-key tiles of K and V
// and the mask tile stay bf16 (fp32) in shared memory, rows padded by 16
// bytes so ldmatrix reads them without bank conflicts, and load with
// cp.async into two buffers: the next tile loads while the current one is
// multiplied. Per tile a warp takes S = Q.K^T out of the tensor cores (K the
// B operand by ldmatrix) as fp32 accumulator fragments; scale and mask cost
// one fma per score, s * scale*log2(e) + 0 at a real key, 0 * s +
// (-1e7*log2(e)) at a masked one, -inf past S; the online softmax keeps the
// row maximum and sum per tile (the maximum reduced across the 4 threads of
// a quad by shuffles, the sum kept per thread and reduced at the end), with
// ex2.approx as the exponential. P is rounded to bf16 from the accumulator
// fragments straight into the A fragments of P.V (V the B operand by
// ldmatrix.trans), so it never touches shared or device memory; O
// accumulates in fp32 fragments. A ragged tail (S = 257 = 4*64 + 1) costs
// one 16-key step, not a tile: the products stop at the last 16 keys that
// hold a real one, and a warp whose 16 query rows all lie past S only helps
// load. Full tiles take a second instantiation of the tile body, with no
// checks against S. The epilogue multiplies O by 1/sum, rounds it to bf16
// and stages it through shared memory, so each thread writes 16 bytes at a
// time. The tensor-core helpers are attention_mma.cuh's, shared with the
// backward. What keeps it from the bytes bound is latency: at 4 warps a
// scheduler (128 registers a thread) the products, the softmax and the
// tile loads of one warp run largely in series, and wider warps (32 rows)
// or more of them (fewer registers, with spills) were slower (PERF.md 6).
//
// fp32 stays on the FP32 FMA pipes (fma_fwd_kernel), since the port runs
// fp32 products in full fp32 (no TF32, device.set_matmul_precision): one
// block per (q-tile of 64 rows, head, batch row), one thread per query row
// holding q and the output accumulator in registers; key/value tiles of 64
// rows are staged through shared memory and read as warp-wide broadcasts; an
// online softmax (fp32 running max and sum) updates once per chunk of 8 keys.
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr float kMasked = -1e7f;

// Byte strides of one operand: batch row, head, sequence row.
struct Strides {
  long long b, h, s;
};

// ============================================================ fp32: FMA

constexpr int QT = 64;  // query rows per block (one per thread)
constexpr int KT = 64;  // keys per shared-memory tile
constexpr int CH = 8;   // keys per online-softmax update

// 16 bytes of fp32 at `src` -> `dst` (16-byte aligned).
__device__ __forceinline__ void load16(const char* src, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                  __uint_as_float(u.z), __uint_as_float(u.w));
}

template <int D>
__global__ void __launch_bounds__(QT)
fma_fwd_kernel(const char* __restrict__ q_in, const char* __restrict__ k_in,
               const char* __restrict__ v_in, const float* __restrict__ mask,
               char* __restrict__ out, int S, Strides in, Strides os,
               float scale) {
  constexpr int CHUNKS = D / 4;  // 16-byte pieces per head row
  static_assert(D % 4 == 0, "head dim must fill 16-byte pieces");
  __shared__ __align__(16) float Ks[KT][D];
  __shared__ __align__(16) float Vs[KT][D];
  __shared__ float Ms[KT];

  const int t = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = blockIdx.x * QT + t;
  const bool live = qi < S;
  const long long plane = b * in.b + h * in.h;  // this (b, h)'s rows
  const char* kp = k_in + plane;
  const char* vp = v_in + plane;
  const float* mrow = mask + (long long)b * S;

  float q[D];
  if (live) {
    const char* qr = q_in + plane + qi * in.s;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) load16(qr + c * 16, &q[4 * c]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = 0.f;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max of the scaled, masked scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous tile has been read by every thread
    for (int idx = t; idx < KT * CHUNKS; idx += QT) {
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      const int j = k0 + r;
      if (j < S) {
        load16(kp + j * in.s + c * 16, &Ks[r][c * 4]);
        load16(vp + j * in.s + c * 16, &Vs[r][c * 4]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) { Ks[r][c * 4 + i] = 0.f; Vs[r][c * 4 + i] = 0.f; }
      }
    }
    for (int r = t; r < KT; r += QT) {
      const int j = k0 + r;
      Ms[r] = j < S ? mrow[j] : 0.f;
    }
    __syncthreads();

    const int nk = min(KT, S - k0);  // real keys in this tile
    for (int c0 = 0; c0 < nk; c0 += CH) {
      // Key c0 is real, so every chunk has a finite maximum.
      float s[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int r = c0 + u;
        const float4* kr = reinterpret_cast<const float4*>(Ks[r]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 k4 = kr[d4];
          dot = fmaf(q[4 * d4 + 0], k4.x, dot);
          dot = fmaf(q[4 * d4 + 1], k4.y, dot);
          dot = fmaf(q[4 * d4 + 2], k4.z, dot);
          dot = fmaf(q[4 * d4 + 3], k4.w, dot);
        }
        float sc = dot * scale;
        if (Ms[r] > 0.f) sc = kMasked;   // replace the scaled score
        if (r >= nk) sc = -INFINITY;     // past S: weight exactly 0
        s[u] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float mnew = fmaxf(m, cmax);
      const float corr = expf(m - mnew);  // 0 on the first chunk
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
      m = mnew;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const float p = expf(s[u] - m);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs[c0 + u]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 v4 = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, v4.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, v4.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, v4.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, v4.w, acc[4 * d4 + 3]);
        }
      }
    }
  }

  if (live) {
    char* orow = out + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      *reinterpret_cast<uint4*>(orow + c * 16) = make_uint4(
          __float_as_uint(acc[4 * c] / l), __float_as_uint(acc[4 * c + 1] / l),
          __float_as_uint(acc[4 * c + 2] / l),
          __float_as_uint(acc[4 * c + 3] / l));
  }
}

// ====================================================== bf16: tensor cores

constexpr int BR = 64;    // query rows a block owns, 16 a warp
constexpr int BT = 64;    // keys per staged tile: one online-softmax step
constexpr int NTH = 128;  // 4 warps
// Exponentials are taken base 2: scores scaled by scale*log2(e) (a masked
// one replaced by -1e7*log2(e)), row maxima in that unit, so one ex2 gives
// exp(s - m).
constexpr float kMasked2 = kMasked * kLog2e;

template <int D>
__global__ void __launch_bounds__(NTH)
mma_fwd_kernel(const char* __restrict__ q_in, const char* __restrict__ k_in,
               const char* __restrict__ v_in, const float* __restrict__ mask,
               char* __restrict__ out, int S, Strides in, Strides os,
               float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int P = D + 8, NJ = BT / 8, CPR = D / 8;
  __shared__ __align__(16) uint16_t Ks[2][BT * P];
  __shared__ __align__(16) uint16_t Vs[2][BT * P];
  __shared__ __align__(16) float Ms[2][BT];

  const float scale2 = scale * kLog2e;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: matrix, its row
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR + 16 * warp; // this warp's first query
  const bool active = q0 < S;                 // the same for the whole warp
  const long long plane = b * in.b + h * in.h;
  const float* mrow = mask + (long long)b * S;
  const int nt = (S + BT - 1) / BT;

  // key tile `it` -> buffer `buf`
  auto stage = [&](int it, int buf) {
    const int k0 = it * BT;
    stage_rows<D, BT, NTH>(Ks[buf], k_in + plane, in.s, k0, S);
    stage_rows<D, BT, NTH>(Vs[buf], v_in + plane, in.s, k0, S);
    stage_floats<BT, NTH>(Ms[buf], mrow, k0, S);
    cp_async_commit();
  };
  stage(0, 0);

  uint32_t qf[D / 16][4];
  load_a<D>(qf, q_in + plane, in.s, q0, S, g, t);

  // rows g and g + 8: running max, this lane's share of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

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
      // one tile; on a full one (all but a ragged last) the checks
      // against the last real key fold away at compile time
      auto tile = [&](auto full) {
        const int nk = decltype(full)::value ? BT : S - it * BT;
        const float* M = Ms[buf];
        float s[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        product_nt<D, BT>(s, qf, Ks[buf], 0, nk, mi, mr);
        // this lane's keys (2 of every 8): the score is s * mul + add, the
        // scaled score at a real key, kMasked2 at a masked one, -inf past S
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          // the mask entries of this lane's two keys, in one load (fewer
          // registers than two: 4 blocks an SM at D = 64)
          const float2 mk = *reinterpret_cast<const float2*>(M + 8 * j + 2 * t);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = 8 * j + 2 * t + u;
            const bool past = col >= nk;
            const bool masked = !past && (u ? mk.y : mk.x) > 0.f;
            const float mul = past || masked ? 0.f : scale2;
            const float add = past ? -INFINITY : masked ? kMasked2 : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = s[j][2 * r + u];
              x = fmaf(x, mul, add);
              mx[r] = fmaxf(mx[r], x);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // key 0 of the tile is real, so every tile has a finite maximum
          const float mnew = fmaxf(m[r], quad_max(mx[r]));
          const float corr = ex2(m[r] - mnew);  // 0 on the first tile
          m[r] = mnew;
          l[r] *= corr;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][2 * r] *= corr;
            o[j][2 * r + 1] *= corr;
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float& x = s[j][2 * r + u];
              x = ex2(x - mnew);                // unnormalised P
              l[r] += x;
            }
        }
        // P, rounded to bf16, is the A operand of O += P . V
        uint32_t pf[BT / 16][4];
        to_a<BT>(pf, s);
        product_nn<D, BT>(o, pf, Vs[buf], 0, nk, mi, mr);
      };
      if (S - it * BT >= BT)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    }
    __syncthreads();                          // the buffer is free again
  }

  // O / sum -> bf16, staged in the warp's 16 rows of Ks[0] (every warp has
  // passed the last barrier), then 16 bytes a thread into the plane
  if (active) {
    uint16_t* st = Ks[0] + 16 * warp * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(st + (g + 8 * r) * P + 8 * j + 2 * t) =
            pack_bf16x2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
    __syncwarp();
    char* op = out + b * os.b + h * os.h;
    for (int idx = lane; idx < 16 * CPR; idx += 32) {
      const int r = idx / CPR, c = idx % CPR;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(op + (q0 + r) * os.s + 16 * c) =
            *reinterpret_cast<const uint4*>(st + r * P + 8 * c);
    }
  }
}

// ================================================================ launch

template <int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int S, int H, bool bf16, Strides in, Strides os,
           float scale, cudaStream_t stream) {
  const char* qc = static_cast<const char*>(q);
  const char* kc = static_cast<const char*>(k);
  const char* vc = static_cast<const char*>(v);
  char* oc = static_cast<char*>(out);
  if (bf16)
    mma_fwd_kernel<D><<<dim3((S + BR - 1) / BR, H, B), NTH, 0, stream>>>(
        qc, kc, vc, mask, oc, S, in, os, scale);
  else
    fma_fwd_kernel<D><<<dim3((S + QT - 1) / QT, H, B), QT, 0, stream>>>(
        qc, kc, vc, mask, oc, S, in, os, scale);
  return (int)cudaGetLastError();
}

// Element strides -> byte strides, then the head-dim instantiation.
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             void* out, int B, int S, int H, int D, int bf16, Strides in,
             Strides os, float scale, void* stream) {
  const long long bytes = bf16 ? 2 : 4;
  in = {in.b * bytes, in.h * bytes, in.s * bytes};
  os = {os.b * bytes, os.h * bytes, os.s * bytes};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, m, out, B, S, H, bf16, in, os, scale, st);
    case 64: return launch<64>(q, k, v, m, out, B, S, H, bf16, in, os, scale, st);
    case 80: return launch<80>(q, k, v, m, out, B, S, H, bf16, in, os, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// qkv: (B, S, 3C) contiguous, fp32 or bf16, 16-byte aligned; mask: (B, S)
// fp32, 1 = padded key; out: (B, S, C) of qkv's type. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int mla_flat_attention_fwd(const void* qkv, const void* mask,
                                      void* out, int B, int S, int H, int D,
                                      int bf16, float scale, void* stream) {
  const long long C = (long long)H * D;
  const char* base = static_cast<const char*>(qkv);
  const long long third = C * (bf16 ? 2 : 4);
  return dispatch(base, base + third, base + 2 * third, mask, out, B, S, H, D,
                  bf16, {S * 3 * C, D, 3 * C}, {S * C, D, C}, scale, stream);
}

// q, k, v, out: (B, H, S, D) contiguous, fp32 or bf16, 16-byte aligned, all
// of one type; mask: (B, S) fp32, 1 = padded key. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int mla_head_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int B, int S, int H, int D,
                                      int bf16, float scale, void* stream) {
  const Strides hs = {(long long)H * S * D, (long long)S * D, D};
  return dispatch(q, k, v, mask, out, B, S, H, D, bf16, hs, hs, scale,
                  stream);
}
