// Stride-1 SAME 3x3 convolution, C == F, for Hopper (sm_90a), plain C
// interface.
//
// Replaces mla_tpu/ops/conv3x3.py:_kernel_flat (the Pallas TPU kernel behind
// _conv3x3_pallas, the ResNet-18 body convs). It reads the activations in
// NHWC (a PyTorch channels_last tensor) and writes NHWC, so the cuDNN convs
// around it (stem, strided and 1x1 projections) need no transposes.
//
// Semantics: out[b, h, w, f] = sum over (ky, kx, c) of
//   x[b, h + ky - 1, w + kx - 1, c] * wt[ky, kx, c, f]
// with zeros outside the image (padding 1), operands in the input type and
// fp32 accumulation, output rounded to the input type. The same function
// computes dx in the backward, on the 180-degree rotated, channel-swapped
// weight (the wrapper makes that weight).
//
// Design: an implicit GEMM, M = B*H*W output pixels, N = F, K = 9*C, with
// the weight packed by the wrapper as a row-major (9*C, F) matrix (HWIO
// flattened). A K tile of 32 never crosses a tap because C is a multiple of
// 64, so every row of an A tile is 32 contiguous channels of one input pixel,
// or zeros where the tap falls outside the image (the halo is handled at
// load time: cp.async with a source size of 0 writes zeros). Nothing of the
// TPU kernel's width-window packing is carried over.
//  - bf16: tiles of 128 pixels x BN filters (BN = 64 for F = 64, else 128),
//    K in steps of 32, two shared-memory stages filled by cp.async, eight
//    warps each computing 32 x BN/2 on the tensor cores with WMMA 16x16x16
//    fragments and fp32 accumulators.
//  - fp32: the FP32 FMA pipes (TF32 stays off, as the port states for every
//    fp32 product): 64 x 64 tiles, K in steps of 16, 4 x 4 outputs a thread.
//
// Bound at visual layer 1 (B = 192 frames, 56 x 56, C = F = 64, bf16): it
// must read x (77 MB) and the weight and write out (77 MB), 154 MB, 46 us
// at 3.35 TB/s, and do 2*M*9*C*F = 44.4 GFLOP, 45 us at the 989 TFLOP/s bf16
// peak: both limits are close, so reuse of each loaded pixel across the
// filters (the BN-wide tile) and across the nine taps (the L2 cache) and the
// tensor-core rate both matter. WMMA (mma.sync) cannot reach the wgmma peak;
// a wgmma/TMA pipeline is the later step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

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

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

constexpr int BM = 128;           // output pixels per block
constexpr int BK = 32;            // K per stage (one tap, 32 channels)
constexpr int PAD = 8;            // bf16 elements of row padding (16 bytes)
constexpr int AS = BK + PAD;      // A row stride in shared memory

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wt,
                    __nv_bfloat16* __restrict__ out, int B, int H, int W,
                    int C, int F) {
  constexpr int BS = BN + PAD;    // B row stride in shared memory
  constexpr int WN = BN / 2;      // filters per warp
  constexpr int FM = 2;           // 16-row fragments per warp (32 rows)
  constexpr int FN = WN / 16;     // 16-column fragments per warp
  constexpr int B_CHUNKS = BK * BN / 8 / kThreads;   // 16-byte loads/thread
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * AS];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * BS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // This thread's two A rows (pixels) and its 16-byte chunk of the 32
  // channels of each.
  const int chunk = tid & 3;
  int ph[2], pw[2];
  const __nv_bfloat16* pbase[2];
  bool pvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int m = m0 + (tid >> 2) + r * 64;
    pvalid[r] = m < M;
    int mm = pvalid[r] ? m : 0;
    int b = mm / HW, rem = mm - b * HW;
    ph[r] = rem / W;
    pw[r] = rem - ph[r] * W;
    pbase[r] = x + static_cast<size_t>(b) * HW * C + chunk * 8;
  }

  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * BK;
    const int tap = k0 / C;
    const int c0 = k0 - tap * C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int ih = ph[r] + dy, iw = pw[r] + dx;
      bool ok = pvalid[r] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      const __nv_bfloat16* src =
          ok ? pbase[r] + (static_cast<size_t>(ih) * W + iw) * C + c0 : x;
      cp_async16(&As[s][((tid >> 2) + r * 64) * AS + chunk * 8], src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      int id = tid + i * kThreads;
      int row = id / (BN / 8), col = (id % (BN / 8)) * 8;
      cp_async16(&Bs[s][row * BS + col],
                 wt + static_cast<size_t>(k0 + row) * F + n0 + col, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = 9 * C / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) load_tile(kt + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[s][(wm * 32 + i * 16) * AS + kk], AS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[s][kk * BS + wn * WN + j * 16], BS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: each warp stages one 16x16 fp32 fragment at a time in its own
  // 1 KB of the (now idle) A buffer and writes it as bf16, 8 values (16
  // bytes) a lane, rows beyond M skipped.
  float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * WN + j * 16 + c8;
      if (m < M) {
        const float* v = stage + r * 16 + c8;
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * F + n) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- fp32

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   float* __restrict__ out, int B, int H, int W, int C,
                   int F) {
  __shared__ __align__(16) float As[FBK][FBM + 4];   // transposed: [k][m]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  // A load: row tid/4 of the tile, channels (tid%4)*4 .. +4 of the K step.
  const int arow = tid >> 2, acol = (tid & 3) * 4;
  const int am = m0 + arow;
  const bool avalid = am < M;
  int ab = 0, ah = 0, aw = 0;
  if (avalid) {
    ab = am / HW;
    int rem = am - ab * HW;
    ah = rem / W;
    aw = rem - ah * W;
  }
  const float* abase = x + static_cast<size_t>(ab) * HW * C + acol;
  // B load: row tid/16 of the K step, filters (tid%16)*4 .. +4.
  const int brow = tid >> 4, bcol = (tid & 15) * 4;
  // Compute: rows ty*4 .. +4, filters tx*4 .. +4.
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4] = {};
  const int KT = 9 * C / FBK;
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * FBK;
    const int tap = k0 / C;
    const int c0 = k0 - tap * C;
    const int ih = ah + tap / 3 - 1, iw = aw + tap % 3 - 1;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (avalid && ih >= 0 && ih < H && iw >= 0 && iw < W)
      av = *reinterpret_cast<const float4*>(
          abase + (static_cast<size_t>(ih) * W + iw) * C + c0);
    const float4 bv = *reinterpret_cast<const float4*>(
        wt + static_cast<size_t>(k0 + brow) * F + n0 + bcol);
    As[acol + 0][arow] = av.x;
    As[acol + 1][arow] = av.y;
    As[acol + 2][arow] = av.z;
    As[acol + 3][arow] = av.w;
    *reinterpret_cast<float4*>(&Bs[brow][bcol]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * F + n0 +
                                 tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// x: (B, H, W, C) NHWC; wt: (9*C, F) row-major, the HWIO weight flattened;
// out: (B, H, W, F) NHWC; all of one type (bf16 when bf16 != 0, else fp32),
// 16-byte aligned. C == F in {64, 128, 256, 512} (the wrapper checks).
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int mla_conv3x3_fwd(const void* x, const void* wt, void* out,
                               int B, int H, int W, int C, int F, int bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  if (bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(wt);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (F == 64) {
      dim3 grid((M + BM - 1) / BM, F / 64);
      conv3x3_bf16_kernel<64><<<grid, kThreads, 0, st>>>(xb, wb, ob, B, H, W,
                                                          C, F);
    } else {
      dim3 grid((M + BM - 1) / BM, F / 128);
      conv3x3_bf16_kernel<128><<<grid, kThreads, 0, st>>>(xb, wb, ob, B, H,
                                                           W, C, F);
    }
  } else {
    dim3 grid((M + FBM - 1) / FBM, F / FBN);
    conv3x3_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<float*>(out), B, H, W, C, F);
  }
  return static_cast<int>(cudaGetLastError());
}
