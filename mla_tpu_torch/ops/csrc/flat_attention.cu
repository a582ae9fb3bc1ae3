// Masked attention forward for Hopper (sm_90a), plain C interface, on two
// memory layouts that share one kernel.
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
// or D (head, plane offset (b*H + h)*S*D). The kernel takes those strides
// and its arithmetic is the same for both.
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
// and v and never rounds P; this kernel keys through tiles with no length
// limit and keeps the one law at every S.
//
// Design. One block per (q-tile of 64 rows, head, batch row); one thread per
// query row, holding q and the output accumulator in registers. Key/value
// tiles of 64 rows are staged through shared memory as fp32 and read as
// warp-wide broadcasts. An online softmax (fp32 running max and sum) updates
// once per chunk of 8 keys. The products run on the FP32 FMA pipes, not the
// tensor cores: this is the simple first version.
//
// Bound at the serving shape (B=64, S=257, C=768, H=12, D=64, bf16): the
// kernel must read qkv (64*257*2304*2 B) and the mask and write out
// (64*257*768*2 B), 101 MB, i.e. 30 us at 3.35 TB/s; its 4*B*H*S^2*D =
// 13.0 GFLOP take 13 us at the bf16 tensor-core peak. So the kernel is bound
// by memory traffic, and a tensor-core version (mma/wgmma) is what would get
// it there; on the FMA pipes used here the operations dominate instead. The
// head layout moves the same bytes.
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;  // query rows per block (one per thread)
constexpr int KT = 64;  // keys per shared-memory tile
constexpr int CH = 8;   // keys per online-softmax update
constexpr float kMasked = -1e7f;

// Byte strides of one operand: batch row, head, sequence row.
struct Strides {
  long long b, h, s;
};

// Element formats, moved 16 bytes at a time.
template <bool BF16> struct Elem;

template <> struct Elem<false> {  // fp32
  static constexpr int V = 4;       // elements per 16 bytes
  static constexpr int BYTES = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static __forceinline__ float round(float x) { return x; }
};

template <> struct Elem<true> {  // bf16
  static constexpr int V = 8;
  static constexpr int BYTES = 2;
  __device__ static __forceinline__ void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);            // low half = lower index
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    unpack2(u.x, f); unpack2(u.y, f + 2); unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  __device__ static __forceinline__ uint32_t pack2(float a, float b) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
    return lo | (hi << 16);
  }
  __device__ static __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// 16 bytes of elements at `src` -> fp32 at `dst` (16-byte aligned).
template <bool BF16>
__device__ __forceinline__ void load16(const char* src, float* dst) {
  using E = Elem<BF16>;
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  float f[E::V];
  E::unpack(u, f);
#pragma unroll
  for (int i = 0; i < E::V; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

template <bool BF16, int D>
__global__ void __launch_bounds__(QT)
attention_fwd_kernel(const char* __restrict__ q_in,
                     const char* __restrict__ k_in,
                     const char* __restrict__ v_in,
                     const float* __restrict__ mask, char* __restrict__ out,
                     int S, Strides in, Strides os, float scale) {
  using E = Elem<BF16>;
  constexpr int V = E::V;
  constexpr int CHUNKS = D / V;  // 16-byte pieces per head row
  static_assert(D % V == 0 && D % 4 == 0, "head dim must fill 16-byte pieces");

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
    for (int c = 0; c < CHUNKS; ++c) {
      float f[V];
      E::unpack(__ldg(reinterpret_cast<const uint4*>(qr + c * 16)), f);
#pragma unroll
      for (int i = 0; i < V; ++i) q[c * V + i] = f[i];
    }
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
        load16<BF16>(kp + j * in.s + c * 16, &Ks[r][c * V]);
        load16<BF16>(vp + j * in.s + c * 16, &Vs[r][c * V]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) { Ks[r][c * V + i] = 0.f; Vs[r][c * V + i] = 0.f; }
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
        const float pr = E::round(p);  // P in the input type before PV
        const float4* vr = reinterpret_cast<const float4*>(Vs[c0 + u]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 v4 = vr[d4];
          acc[4 * d4 + 0] = fmaf(pr, v4.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pr, v4.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pr, v4.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pr, v4.w, acc[4 * d4 + 3]);
        }
      }
    }
  }

  if (live) {
    char* orow = out + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float f[V];
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = acc[c * V + i] / l;
      *reinterpret_cast<uint4*>(orow + c * 16) = E::pack(f);
    }
  }
}

template <bool BF16, int D>
void launch(const void* q, const void* k, const void* v, const float* mask,
            void* out, int B, int S, int H, Strides in, Strides os,
            float scale, cudaStream_t stream) {
  const dim3 grid((S + QT - 1) / QT, H, B);
  attention_fwd_kernel<BF16, D><<<grid, QT, 0, stream>>>(
      static_cast<const char*>(q), static_cast<const char*>(k),
      static_cast<const char*>(v), mask, static_cast<char*>(out), S, in, os,
      scale);
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
#define MLA_CASE(DD)                                                        \
  case DD:                                                                  \
    if (bf16)                                                               \
      launch<true, DD>(q, k, v, m, out, B, S, H, in, os, scale, st);        \
    else                                                                    \
      launch<false, DD>(q, k, v, m, out, B, S, H, in, os, scale, st);       \
    break;
  switch (D) {
    MLA_CASE(16)
    MLA_CASE(64)
    MLA_CASE(80)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MLA_CASE
  return (int)cudaGetLastError();
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
