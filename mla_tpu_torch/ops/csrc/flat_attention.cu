// Flat-layout masked attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces mla_tpu/ops/attention.py:_attn_kernel_flat (the Pallas TPU kernel
// behind flash_attention_flat). It reads q, k and v by column straight out of
// the fused qkv projection (B, S, 3C) and writes (B, S, C) in the layout the
// output projection consumes, so no transpose runs before or after it.
//
// Semantics (same as attention_reference in the JAX package and the original
// PyTorch model): per head, scores = (q . k) * scale in fp32; where
// mask[b, key] > 0 the scaled score is REPLACED by -1e7 (not added to, and not
// -inf); softmax in fp32; the probabilities are rounded to the input type
// before the PV product; fp32 accumulation. The key loop stops at S, so no
// padding key ever enters the sum: a row whose keys are all masked gives the
// mean of V over the S real keys (the TPU kernel pads S to a multiple of 8
// and averages over the padded length there instead).
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
// it there; on the FMA pipes used here the operations dominate instead.
#include <math.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;  // query rows per block (one per thread)
constexpr int KT = 64;  // keys per shared-memory tile
constexpr int CH = 8;   // keys per online-softmax update
constexpr float kMasked = -1e7f;

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
flat_attention_fwd_kernel(const char* __restrict__ qkv,
                          const float* __restrict__ mask,
                          char* __restrict__ out, int S, int H, float scale) {
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
  const int C = H * D;
  const long long row_bytes = 3LL * C * E::BYTES;  // qkv row stride
  const char* base = qkv + (long long)b * S * row_bytes;
  const long long k_off = (long long)(C + h * D) * E::BYTES;
  const long long v_off = (long long)(2 * C + h * D) * E::BYTES;
  const float* mrow = mask + (long long)b * S;

  float q[D];
  if (live) {
    const char* qr = base + qi * row_bytes + (long long)h * D * E::BYTES;
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
        const char* row = base + j * row_bytes + c * 16;
        load16<BF16>(row + k_off, &Ks[r][c * V]);
        load16<BF16>(row + v_off, &Vs[r][c * V]);
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
    char* orow = out + ((long long)b * S + qi) * C * E::BYTES +
                 (long long)h * D * E::BYTES;
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
void launch(const void* qkv, const float* mask, void* out, int B, int S, int H,
            float scale, cudaStream_t stream) {
  const dim3 grid((S + QT - 1) / QT, H, B);
  flat_attention_fwd_kernel<BF16, D><<<grid, QT, 0, stream>>>(
      static_cast<const char*>(qkv), mask, static_cast<char*>(out), S, H,
      scale);
}

template <bool BF16>
int dispatch_d(const void* qkv, const float* mask, void* out, int B, int S,
               int H, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch<BF16, 16>(qkv, mask, out, B, S, H, scale, stream); break;
    case 64: launch<BF16, 64>(qkv, mask, out, B, S, H, scale, stream); break;
    case 80: launch<BF16, 80>(qkv, mask, out, B, S, H, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, S, 3C) contiguous, fp32 or bf16, 16-byte aligned; mask: (B, S)
// fp32, 1 = padded key; out: (B, S, C) of qkv's type. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int mla_flat_attention_fwd(const void* qkv, const void* mask,
                                      void* out, int B, int S, int H, int D,
                                      int bf16, float scale, void* stream) {
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<true>(qkv, m, out, B, S, H, D, scale, st)
              : dispatch_d<false>(qkv, m, out, B, S, H, D, scale, st);
}
