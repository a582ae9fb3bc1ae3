// The int8 GEMM main loop shared by q8_matmul.cu (B4, B5) and q8_mlp.cu (B6),
// for Hopper (sm_90a): TMA loads into a ring of shared-memory stages, one
// producer thread, two consumer warpgroups on wgmma. The Hopper building
// blocks it uses (barriers, TMA, the wgmma wrappers, tensor maps) are in
// hopper.cuh, shared with conv3x3.cu.
//
// Every product is out[M, N] = X[M, K] . W[N, K]^T with W int8 in PyTorch's
// Linear layout (one row of K weights per output channel), on layer l of an
// (L, N, K) stack, l read on the device. A block computes the transposed
// tile out^T[n0 : n0 + 128, m0 : m0 + BX] = W . X^T: each consumer
// warpgroup owns 64 weight rows (wgmma's M) and all BX rows of X (wgmma's
// N: 64, 128 or 256), so the weight is wgmma's A operand and a per-output-
// channel scale is a per-row scale of the accumulator. Three kinds:
//  - A_BF16 (weight-only): X bf16. Each stage brings 64 k: 128-byte X rows
//    (TMA's 128-byte swizzle, wgmma's shared-memory B operand) and 64-byte
//    weight rows (64-byte swizzle). Each consumer thread reads its own
//    A-fragment bytes of the weight tile, converts them to bf16 in registers
//    (exact, |q| <= 127) and feeds them to wgmma m64nBXk16 as the register A
//    operand: every weight element is converted once per block, by one
//    thread. Sums in fp32.
//  - A_S8 (W8A8): X int8 (rows quantized by quantize_rows_kernel). Each stage
//    brings 128 k, 128-byte rows of both operands, both read by wgmma
//    m64nBXk32 s8.s8 from shared memory: exact int32 sums.
//  - A_S8G: A_S8 whose int32 sums are flushed into fp32 accumulators at
//    every boundary of `group` k, times the group scale of each X row
//    ((M, K / group) fp32): the W8A8 MLP's fc2 over its re-quantized hidden.
// Rows of X past M and k past K arrive as zeros (TMA's out-of-bounds fill).
// The ring holds as many stages as 227 KB allow (4-8).
//
// Persistent: one block per SM walks its tiles; the producer runs on into
// the next tile's stages while the consumers finish a tile. The epilogue
// maps each accumulator to the output type (the Epi functor), writes 64 rows
// of X at a time into one of two staging buffers laid out as TMA's
// 128-byte-swizzled boxes (stmatrix for bf16), and one thread stores each
// chunk with TMA, which clips rows past M; the stores drain while the next
// chunk and tile proceed. Tile width BX (64, 128 or 256 rows of X): the one
// that minimises waves x (BX + 64) over the card's SM count (pick_bx), so
// rung 1 (257 rows) gets 64-wide tiles on more SMs and rung 64 (16448)
// 256-wide ones.
//
// Bound (rung 64, qkv site 16448 x 768 x 2304, one H100 SXM): 58 GFLOP, 59
// us at the bf16 peak and 29 us at the int8 peak, ~100 MB of traffic (30
// us): bound by operations. Both consumer warpgroups run the epilogue
// while the tensor cores wait; at K = 768 that is the largest cost after
// the products (measured times: PERF.md).
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace q8 {

using namespace hopper;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int BW = 64 * kConsumers;               // weight rows per block

enum AKind { A_BF16 = 0, A_S8 = 1, A_S8G = 2 };

// k per stage: 128 bytes of an X row
template <int KIND>
__host__ __device__ constexpr int k_stage() {
  return KIND == A_BF16 ? 64 : 128;
}

// Shared memory of a (KIND, BX) block whose output elements take OB bytes:
// the stage ring (X tile, then the weight tile), two staging buffers of 64
// output rows, the X rows' scales, then the ring's full/empty barriers.
template <int KIND, int BX, int OB>
struct Ring {
  static constexpr int XB = BX * 128;
  static constexpr int WB = BW * (KIND == A_BF16 ? 64 : 128);
  static constexpr int SB = XB + WB;
  // a staging buffer: 64 rows x 128 columns, as 128-byte-wide TMA boxes
  // of 64 rows (128-byte swizzle)
  static constexpr int CHUNK = 64 * BW * OB;
  static constexpr int FREE = kSmemMax - 1024 - 2 * CHUNK - 4 * 256 - 8 * 16;
  static constexpr int S = FREE / SB > 8 ? 8 : FREE / SB;
  // 1024 of slack to align the ring to the 128-byte swizzle's 1024-byte
  // period
  static constexpr int BYTES = 1024 + S * SB + 2 * CHUNK + 4 * 256 + 2 * S * 8;
  static_assert(S >= 2 && BYTES <= kSmemMax, "ring too large");
};

// ---------------------------------------------------------------- device

// two int8 weights (k, k+1) in the low half of v -> a bf16x2 register,
// lower k in the low half. q + 128 goes into the mantissa of 2^23, so
// 2^23 + 128 subtracts back to q exactly.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t v) {
  const uint32_t u = v ^ 0x8080u;
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  return pack_bf16x2(lo, hi);
}

__device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// q = clip(round-half-even(v / s), -127, 127) as one byte (an IEEE
// division: a reciprocal multiply moves results off the plain version's)
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  float q = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xff;
}

// ------------------------------------------------------- row quantization

constexpr int kQuantThreads = 256;
constexpr int kRowsPerBlock = kQuantThreads / 32;  // one warp per row

// xs[m] = max(max|x[m]|, 1e-12) / 127, xq[m] = quant_byte(x[m], xs[m]); one
// warp per row, K % 8 == 0. With KEEP > 0 the row, at most 32 x KEEP
// 8-value chunks, stays in the warp's registers between its max and its
// bytes and is read once; KEEP = 0 reads it twice.
template <bool F32, int KEEP>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const void* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int M, int K) {
  using Raw = typename std::conditional<F32, float4[2], uint4>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;
  const int chunks = K / 8;
  auto load = [&](int c, Raw& r) {
    if constexpr (F32) {
      const float4* p = reinterpret_cast<const float4*>(
          static_cast<const float*>(x) + static_cast<size_t>(m) * K + c * 8);
      r[0] = p[0];
      r[1] = p[1];
    } else {
      r = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(x) + static_cast<size_t>(m) * K)[c];
    }
  };
  auto unpack = [&](const Raw& r, float* v) {
    if constexpr (F32) {
      v[0] = r[0].x; v[1] = r[0].y; v[2] = r[0].z; v[3] = r[0].w;
      v[4] = r[1].x; v[5] = r[1].y; v[6] = r[1].z; v[7] = r[1].w;
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  };
  auto store = [&](int c, const float* v, float s) {
    uint2 q;
    q.x = quant_byte(v[0], s) | (quant_byte(v[1], s) << 8) |
          (quant_byte(v[2], s) << 16) | (quant_byte(v[3], s) << 24);
    q.y = quant_byte(v[4], s) | (quant_byte(v[5], s) << 8) |
          (quant_byte(v[6], s) << 16) | (quant_byte(v[7], s) << 24);
    reinterpret_cast<uint2*>(xq + static_cast<size_t>(m) * K)[c] = q;
  };
  auto amax_of = [&](float a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    return a;
  };
  float amax = 0.f;
  if constexpr (KEEP > 0) {
    Raw keep[KEEP];
#pragma unroll
    for (int i = 0; i < KEEP; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        load(c, keep[i]);
        float v[8];
        unpack(keep[i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
    const float s = fmaxf(amax_of(amax), 1e-12f) / 127.f;
    if (lane == 0) xs[m] = s;
#pragma unroll
    for (int i = 0; i < KEEP; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float v[8];
        unpack(keep[i], v);
        store(c, v, s);
      }
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      Raw r;
      float v[8];
      load(c, r);
      unpack(r, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    const float s = fmaxf(amax_of(amax), 1e-12f) / 127.f;
    if (lane == 0) xs[m] = s;
    for (int c = lane; c < chunks; c += 32) {
      Raw r;
      float v[8];
      load(c, r);
      unpack(r, v);
      store(c, v, s);
    }
  }
}

template <bool F32>
int quantize_rows_keep(const void* x, int8_t* xq, float* xs, int M, int K,
                       cudaStream_t st) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  const int per_lane = (K / 8 + 31) / 32;  // 8-value chunks a lane reads
  auto run = [&](auto kernel) {
    kernel<<<grid, kQuantThreads, 0, st>>>(x, xq, xs, M, K);
  };
  if (per_lane <= 1) run(quantize_rows_kernel<F32, 1>);
  else if (per_lane <= 2) run(quantize_rows_kernel<F32, 2>);
  else if (per_lane <= 3) run(quantize_rows_kernel<F32, 3>);
  else if (per_lane <= 4) run(quantize_rows_kernel<F32, 4>);
  else if (per_lane <= 6) run(quantize_rows_kernel<F32, 6>);
  else if (per_lane <= 12 && !F32) run(quantize_rows_kernel<F32, 12>);
  else run(quantize_rows_kernel<F32, 0>);
  return static_cast<int>(cudaGetLastError());
}

inline int quantize_rows(const void* x, int8_t* xq, float* xs, int M, int K,
                         bool f32, cudaStream_t st) {
  if (M == 0) return 0;
  return f32 ? quantize_rows_keep<true>(x, xq, xs, M, K, st)
             : quantize_rows_keep<false>(x, xq, xs, M, K, st);
}

// ---------------------------------------------------------------- GEMM

struct Args {
  const float* scale;  // (L, N): per output channel of each layer
  const float* bias;   // (N,), or null
  const float* xs;     // A_S8: (M,) row scales; A_S8G: (M, K / group)
  const int* layer;    // the int32 layer id on the device, or null (l = 0)
  void* out;           // (M, N) of Epi::Out
  int L, M, N, K, group;
};

// The Epi functor: `Out`, `kRowScale` (whether apply gets xs[m] as r), and
// Out apply(v, s, b, r) for the accumulator v (fp32, or int32 for A_S8) of
// output (m, n) with s = scale[l, n], b = bias[n] (0 without a bias).
//
// Persistent: block b computes tiles b, b + gridDim.x, ... (row tiles
// fastest). The producer runs through the k-stages of all of them, so the
// next tile's first stages load while the consumers run the epilogue, and
// the epilogue's TMA stores drain while the next tile computes.
template <int KIND, int BX, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(__grid_constant__ const CUtensorMap tx,
            __grid_constant__ const CUtensorMap tw,
            __grid_constant__ const CUtensorMap to, const Args a) {
  using Out = typename Epi::Out;
  using R = Ring<KIND, BX, sizeof(Out)>;
  using Acc = typename std::conditional<KIND == A_BF16, float, int>::type;
  constexpr int KS = k_stage<KIND>();
  constexpr int NR = BX / 2;                   // accumulators per thread
  constexpr int BOXC = 128 / sizeof(Out);      // columns of a store box
  static_assert(KIND != A_S8G || BX <= 128, "A_S8G holds two accumulators");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stg = smem + R::S * R::SB;          // two staging buffers
  float* sxs = reinterpret_cast<float*>(stg + 2 * R::CHUNK);
  uint64_t* full = reinterpret_cast<uint64_t*>(sxs + 256);
  uint64_t* empty = full + R::S;

  const int tid = threadIdx.x;
  const int l = a.layer ? min(max(*a.layer, 0), a.L - 1) : 0;
  const int KT = (a.K + KS - 1) / KS;
  const int tiles_m = (a.M + BX - 1) / BX;
  const int tiles = tiles_m * (a.N / BW);
  if (tid == 0) {
    for (int s = 0; s < R::S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tw))
                   : "memory");
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * BX, n0 = (tile / tiles_m) * BW;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % R::S;
          mbar_wait(&empty[s], ((it / R::S) & 1) ^ 1);
          mbar_expect_tx(&full[s], R::SB);
          uint8_t* st = smem + s * R::SB;
          tma_load_2d(st, &tx, &full[s], kt * KS, m0);
          tma_load_3d(st + R::XB, &tw, &full[s], kt * KS, n0, l);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns weight rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // accumulator i of this thread is (row nl + 8 ((i >> 1) & 1), column
    // 8 (i >> 2) + 2t + (i & 1)) of the transposed tile
    const int nl = 64 * wg + 16 * warp + g;
    int it = 0, chunk = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * BX, n0 = (tile / tiles_m) * BW;
      Acc acc[NR];
      float facc[KIND == A_S8G ? NR : 1];
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0;
#pragma unroll
      for (int i = 0; i < (KIND == A_S8G ? NR : 1); ++i) facc[i] = 0.f;
      fence_regs(acc);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % R::S;
        mbar_wait(&full[s], (it / R::S) & 1);
        const uint8_t* st = smem + s * R::SB;
        const uint64_t dx = desc_sw128(st);
        if constexpr (KIND == A_BF16) {
          // this thread's A fragments: rows r and r + 8, k pairs (2t, 2t+1)
          // and (2t+8, 2t+9) of each 16-wide step; the 64-byte swizzle puts
          // 16-byte chunk ks of row r at ks ^ ((r >> 1) & 3) = ks ^ (g >> 1)
          const uint8_t* wr = st + R::XB + nl * 64 + 2 * t;
          uint32_t af[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint8_t* p = wr + ((ks ^ (g >> 1)) << 4);
            af[ks][0] = s8x2_to_bf16x2(ld_u16(p));
            af[ks][1] = s8x2_to_bf16x2(ld_u16(p + 8 * 64));
            af[ks][2] = s8x2_to_bf16x2(ld_u16(p + 8));
            af[ks][3] = s8x2_to_bf16x2(ld_u16(p + 8 * 64 + 8));
          }
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            Wgmma<BX>::bf16_rs(acc, af[ks], dx + 2 * ks);
        } else {
          const uint64_t dw = desc_sw128(st + R::XB + wg * 64 * 128);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            Wgmma<BX>::s8_ss(acc, dw + 2 * ks, dx + 2 * ks);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
        if constexpr (KIND == A_S8G) {
          // the int32 sums of one group, times each X row's group scale
          if (((kt + 1) * KS) % a.group == 0 || kt + 1 == KT) {
            const int ng = a.K / a.group, grp = kt * KS / a.group;
            float sg[BX / 4];
#pragma unroll
            for (int j = 0; j < BX / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = m0 + 8 * j + 2 * t + e;
                sg[2 * j + e] =
                    m < a.M ? a.xs[static_cast<size_t>(m) * ng + grp] : 0.f;
              }
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              facc[i] = __fadd_rn(
                  facc[i],
                  __fmul_rn(static_cast<float>(acc[i]),
                            sg[2 * (i >> 2) + (i & 1)]));
              acc[i] = 0;
            }
            fence_regs(acc);
          }
        }
      }

      // ---- epilogue: 64 rows of X at a time into a staging buffer, then
      // TMA stores (rows past M are clipped), double-buffered
      if constexpr (Epi::kRowScale)
        if (tid < BX) sxs[tid] = m0 + tid < a.M ? a.xs[m0 + tid] : 0.f;
      float sc[2], bi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + nl + 8 * h;
        sc[h] = a.scale[static_cast<size_t>(l) * a.N + n];
        bi[h] = a.bias ? a.bias[n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < BX / 64; ++q, ++chunk) {
        uint8_t* buf = stg + (chunk & 1) * R::CHUNK;
        // the store that read this buffer two chunks ago is done with it
        if (tid == 0) bulk_wait_read<1>();
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
        auto value = [&](int i) {
          const int ml = 8 * (i >> 2) + 2 * t + (i & 1);
          const float r = Epi::kRowScale ? sxs[ml] : 1.f;
          const int h = (i >> 1) & 1;
          if constexpr (KIND == A_S8G)
            return Epi::apply(facc[i], sc[h], bi[h], r);
          else
            return Epi::apply(acc[i], sc[h], bi[h], r);
        };
        if constexpr (sizeof(Out) == 2) {
          // matrices (j, h) of 8 columns of X x 8 weight rows, two j's a
          // stmatrix: row r of matrix (j, h) is X row 8 (j - 8q) + r of the
          // chunk, 16 bytes at 16-byte chunk 2 warp + h of box wg (swizzled)
          const int mat = lane >> 3, r = lane & 7;
          const int jj = mat >> 1, hh = mat & 1;
          uint8_t* row = buf + wg * (64 * 128);
#pragma unroll
          for (int j = 8 * q; j < 8 * q + 8; j += 2) {
            uint32_t v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int i = 4 * (j + (u >> 1)) + 2 * (u & 1);
              const Out lo = value(i), hi = value(i + 1);
              v[u] = static_cast<uint32_t>(
                         *reinterpret_cast<const uint16_t*>(&lo)) |
                     (static_cast<uint32_t>(
                          *reinterpret_cast<const uint16_t*>(&hi))
                      << 16);
            }
            const int ml = 8 * (j - 8 * q + jj) + r;
            stmatrix_x4_trans(row + ml * 128 + (((2 * warp + hh) ^ r) << 4),
                              v[0], v[1], v[2], v[3]);
          }
        } else {
          // fp32: element (ml, n) at box n / 32, row ml, byte 4 (n % 32),
          // 16-byte chunk swizzled with ml & 7
#pragma unroll
          for (int j = 8 * q; j < 8 * q + 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int i = 4 * j + 2 * h + e;
                const int ml = 8 * (j - 8 * q) + 2 * t + e;
                const int n = nl + 8 * h, nb = n & 31;
                *reinterpret_cast<Out*>(buf + (n >> 5) * (64 * 128) +
                                        ml * 128 +
                                        (((nb >> 2) ^ (ml & 7)) << 4) +
                                        (nb & 3) * 4) = value(i);
              }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
        if (tid == 0 && m0 + 64 * q < a.M) {
#pragma unroll
          for (int b = 0; b < BW / BOXC; ++b)
            tma_store_2d(&to, buf + b * (64 * 128), n0 + b * BOXC,
                         m0 + 64 * q);
        }
        if (tid == 0) bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_read<0>();
  }
}

// ------------------------------------------------------------------ host


// The tile width: fewest waves x (BX + 64), where 64 stands for a tile's
// fixed cost (ring fill, epilogue); the wider tile on a tie.
inline int pick_bx(int M, int N, int sms, int max_bx) {
  int best = 64;
  long long best_cost = -1;
  for (int bx = max_bx; bx >= 64; bx /= 2) {
    const long long tiles =
        static_cast<long long>((M + bx - 1) / bx) * (N / BW);
    const long long cost = (tiles + sms - 1) / sms * (bx + 64);
    if (best_cost < 0 || cost < best_cost) {
      best = bx;
      best_cost = cost;
    }
  }
  return best;
}

// One launch: x (M, K) bf16 (A_BF16) or int8; w (L, N, K) int8; one
// persistent block per SM, or per tile when there are fewer.
template <int KIND, int BX, class Epi>
int launch_bx(const void* x, const int8_t* w, const Args& a, int sms,
              cudaStream_t st) {
  using Out = typename Epi::Out;
  using R = Ring<KIND, BX, sizeof(Out)>;
  constexpr int KS = k_stage<KIND>();
  static unsigned long long ready = 0;  // devices with the smem opt-in set
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !((ready >> dev) & 1)) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<KIND, BX, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready |= 1ull << dev;
  }
  const bool f32 = sizeof(Out) == 4;
  CUtensorMap tx, tw, to;
  if (!make_map(&tx, x,
                KIND == A_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                KIND == A_BF16 ? 2 : 1, 0, a.M, a.K, KS, BX,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.L, a.N, a.K, KS,
                BW,
                KIND == A_BF16 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&to, a.out,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                f32 ? 4 : 2, 0, a.M, a.N, f32 ? 32 : 64, 64,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.M + BX - 1) / BX * (a.N / BW);
  gemm_kernel<KIND, BX, Epi><<<tiles < sms ? tiles : sms, kThreads, R::BYTES,
                               st>>>(tx, tw, to, a);
  return static_cast<int>(cudaGetLastError());
}

// out = Epi(X . W[l]^T) with the tile width pick_bx chooses. N % 128 == 0,
// K % 64 == 0 (A_S8G: group % 128 == 0, K % group == 0).
template <int KIND, class Epi>
int gemm(const void* x, const int8_t* w, const Args& a, cudaStream_t st) {
  if (a.M == 0) return 0;
  const int sms = sm_count();
  const int bx = pick_bx(a.M, a.N, sms, KIND == A_S8G ? 128 : 256);
  if constexpr (KIND != A_S8G)
    if (bx == 256) return launch_bx<KIND, 256, Epi>(x, w, a, sms, st);
  if (bx == 128) return launch_bx<KIND, 128, Epi>(x, w, a, sms, st);
  return launch_bx<KIND, 64, Epi>(x, w, a, sms, st);
}

}  // namespace q8
