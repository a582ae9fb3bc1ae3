// Stride-1 SAME 3x3 convolution, C == F, for Hopper (sm_90a), plain C
// interface.
//
// Replaces mla_tpu/ops/conv3x3.py:_kernel_flat (the Pallas TPU kernel behind
// _conv3x3_pallas, the ResNet-18 body convs). It reads the activations in
// NHWC (a PyTorch channels_last tensor) and writes NHWC, so the cuDNN convs
// around it (stem, strided and 1x1 projections) need no transposes.
//
// Semantics: out[b, h, w, f] = sum over (ky, kx, c) of
//   x[b, h + ky - 1, w + kx - 1, c] * wt[f, ky, kx, c]
// with zeros outside the image (padding 1), operands in the input type and
// fp32 accumulation, output rounded once to the input type. The wrapper
// packs the weight K-major, (F, 9*C) with k = (ky*3 + kx)*C + c. The same
// function computes dx in the backward, the conv on the 180-degree
// rotated, channel-swapped weight: the wrapper packs w channel-swapped,
// (C, 9*F), and the kernel reads tap 8 - t for tap t (rot != 0), so the
// rotation costs no copy.
//
// bf16: an implicit GEMM on wgmma, fed by TMA. M = B*H*W output pixels,
// N = F, K = 9*C, computed transposed as in q8_gemm.cuh: out^T = W . X^T,
// the weight is wgmma's A operand (64 filters a consumer warpgroup) and a
// tile of pixels its B operand (N = 128 or 256 pixels), both read
// from shared memory with the 128-byte swizzle. A k-stage is one tap
// (ky, kx) and 64 channels: the pixel tile comes from one TMA im2col load
// of a (C, W, H, B) map whose bounding box is the output pixels' top-left
// taps, with (kx, ky) as the load's offsets, so the tile runs flat over
// B*H*W across image rows and images (the odd widths 157, 79, 40, 20, 7
// waste nothing) and the zero padding is TMA's out-of-bounds fill (no
// per-thread address or halo checks); the weight tile is a tiled TMA load
// of the (F, 9*C) matrix. One producer thread keeps a ring of as many stages
// as 227 KB allow (4 or 6) full; two consumer warpgroups run wgmma m64nBXk16
// with fp32 accumulators and keep one stage's products in flight while the
// next stage's are issued (wgmma.wait_group 1), releasing each stage when
// its products are done. F >= 128: the two warpgroups take 64 filters each
// of one BX-pixel tile (every loaded pixel serves 128 filters); F = 64:
// both take the 64 filters, each its own half of a 2*BX-pixel tile.
// Persistent: one block per SM walks its tiles, filter tiles fastest, so
// the blocks that share a pixel tile run together and its nine taps come
// from L2. Tile width BX: 128 at F = 64; at F >= 128 256 or 128, from the
// card's SM count (pick_bx), so that layers with few tiles (vis_l2-l4,
// aud_l3) take 128 and fill more SMs in fewer ragged waves. The epilogue
// rounds each fp32 sum once to bf16, writes 64 pixels x 64 filters at a
// time through stmatrix.trans into a 128-byte-swizzled staging buffer (two
// a warpgroup) and stores it with TMA, which clips pixels past M.
// Nothing of the TPU kernel's width-window packing is carried over.
//
// fp32: the FP32 FMA pipes (TF32 stays off, as the port states for every
// fp32 product): 64 x 64 tiles, K in steps of 16, 4 x 4 outputs a thread;
// only the B=2 card-against-CPU checks run it.
//
// Bound at visual layer 1 (B = 192 frames, 56 x 56, C = F = 64, bf16): it
// must read x (77 MB) and the weight and write out (77 MB), 154 MB, 46 us
// at 3.35 TB/s, and do 2*M*9*C*F = 44.4 GFLOP, 45 us at the 989 TFLOP/s bf16
// peak: both limits are close. Every visual layer does the same 44.4 GFLOP;
// from layer 2 on the operations bound it (vis_l4: 19 MB, 6 us of traffic).
// Each pixel is loaded nine times (once a tap) from L2 into shared memory,
// and at C = 64 once per 64 filters: at layer 1 the loads, not the tensor
// cores, are what the tile design has to feed (measured: PERF.md).
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kF32Threads = 256;

// ---------------------------------------------------------------- bf16

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int KC = 64;                            // channels per k-stage

// The shared memory of a (BX, FB) block: FB = 2 filter groups of 64 (the
// warpgroups split the filters of one BX-pixel tile) or 1 (they split a
// 2*BX-pixel tile). The ring of stages (pixel tile, then weight tile), two
// staging buffers a consumer warpgroup (64 pixels x 64 filters of bf16),
// then the ring's full/empty barriers.
template <int BX, int FB>
struct Ring {
  static constexpr int TP = BX * (kConsumers / FB);  // pixels of a tile
  static constexpr int TF = 64 * FB;                 // filters of a tile
  static constexpr int XB = TP * KC * 2;
  static constexpr int SB = XB + TF * KC * 2;
  static constexpr int STG = 64 * 64 * 2;
  static constexpr int FREE =
      kSmemMax - 1024 - 2 * kConsumers * STG - 2 * 8 * 8;
  static constexpr int S = FREE / SB > 8 ? 8 : FREE / SB;
  // 1024 of slack to align the ring to the 128-byte swizzle's 1024-byte
  // period
  static constexpr int BYTES = 1024 + S * SB + 2 * kConsumers * STG + 2 * S * 8;
  static_assert(S >= 2 && BYTES <= kSmemMax, "ring too large");
};

template <int BX, int FB>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(__grid_constant__ const CUtensorMap tx,
                     __grid_constant__ const CUtensorMap tw,
                     __grid_constant__ const CUtensorMap to, int B, int H,
                     int W, int C, int F, int rot) {
  using R = Ring<BX, FB>;
  constexpr int NR = BX / 2;                   // accumulators per thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stg = smem + R::S * R::SB;
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 2 * kConsumers * R::STG);
  uint64_t* empty = full + R::S;

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int M = B * HW;
  const int CB = C / KC;
  const int KT = 9 * CB;
  const int tiles_n = F / R::TF;
  const int tiles = (M + R::TP - 1) / R::TP * tiles_n;
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
        const int m0 = (tile / tiles_n) * R::TP;
        const int n0 = (tile % tiles_n) * R::TF;
        // the tile's first pixel; its top-left tap is (w - 1, h - 1)
        const int b = m0 / HW, rem = m0 - b * HW;
        const int h = rem / W, w = rem - h * W;
        for (int tap = 0; tap < 9; ++tap) {
          const uint16_t kx = static_cast<uint16_t>(tap % 3);
          const uint16_t ky = static_cast<uint16_t>(tap / 3);
          for (int cb = 0; cb < CB; ++cb, ++it) {
            const int s = it % R::S;
            mbar_wait(&empty[s], ((it / R::S) & 1) ^ 1);
            mbar_expect_tx(&full[s], R::SB);
            uint8_t* st = smem + s * R::SB;
            tma_load_im2col_4d(st, &tx, &full[s], cb * KC, w - 1, h - 1, b,
                               kx, ky);
            tma_load_2d(st + R::XB, &tw, &full[s],
                        (rot ? 8 - tap : tap) * C + cb * KC, n0);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns filter group wg % FB and pixel
    // group wg / FB of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int fg = wg % FB, pg = wg / FB;
    const bool leader = (tid & 127) == 0;
    uint8_t* my_stg = stg + wg * 2 * R::STG;
    int it = 0, chunk = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * R::TP + pg * BX;  // this group's
      const int n0 = (tile % tiles_n) * R::TF + fg * 64;
      float acc[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      fence_regs(acc);
      int held = -1;          // the stage whose products may still run
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % R::S;
        mbar_wait(&full[s], (it / R::S) & 1);
        const uint8_t* st = smem + s * R::SB;
        const uint64_t dx = desc_sw128(st + pg * BX * KC * 2);
        const uint64_t dw = desc_sw128(st + R::XB + fg * 64 * KC * 2);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
          Wgmma<BX>::bf16_ss(acc, dw + 2 * ks, dx + 2 * ks);
        wgmma_commit();
        // the previous stage's products are done: free its slot
        wgmma_wait<1>();
        fence_regs(acc);
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[held]);

      // ---- epilogue: 64 pixels at a time, rounded once to bf16, into one
      // of this warpgroup's two staging buffers, then a TMA store (pixels
      // past M are clipped), double-buffered. Accumulator i of this thread
      // is (filter 16 warp + g + 8 ((i >> 1) & 1), pixel 8 (i >> 2) + 2t +
      // (i & 1)) of the transposed tile; stmatrix.trans writes matrices
      // (j, h) of 8 pixels x 8 filters, two j's at a time: row r of matrix
      // (j, h) is pixel 8 (j - 8q) + r of the chunk, 16 bytes at 16-byte
      // chunk 2 warp + h of its 128-byte row (swizzled with r).
      const int mat = lane >> 3, r = lane & 7;
      const int jj = mat >> 1, hh = mat & 1;
#pragma unroll
      for (int q = 0; q < BX / 64; ++q, ++chunk) {
        uint8_t* buf = my_stg + (chunk & 1) * R::STG;
        // the store that read this buffer two chunks ago is done with it
        if (leader) bulk_wait_read<1>();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
        for (int j = 8 * q; j < 8 * q + 8; j += 2) {
          uint32_t v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = 4 * (j + (u >> 1)) + 2 * (u & 1);
            v[u] = pack_bf16x2(acc[i], acc[i + 1]);
          }
          const int ml = 8 * (j - 8 * q + jj) + r;
          stmatrix_x4_trans(buf + ml * 128 + (((2 * warp + hh) ^ r) << 4),
                            v[0], v[1], v[2], v[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (leader) {
          if (m0 + 64 * q < M) tma_store_2d(&to, buf, n0, m0 + 64 * q);
          bulk_commit();
        }
      }
    }
    if (leader) bulk_wait_read<0>();
  }
}

// The tile width. F = 64: BX = 128 (two warpgroups' 128 pixels, 256 a
// tile). F >= 128: BX = 256 or 128 pixels, whichever gives fewer waves x
// (BX + 16) over the card's SM count, the wider on a tie; 16 pixels of work
// stand for a tile's fixed cost (ring fill, epilogue), as measured at
// vis_l2, where 1176 tiles of 128 ran in 0.96x the time of 588 of 256.
// Narrower tiles lost at every CREMA-D shape (PERF.md).
inline int pick_bx(int M, int F, int sms) {
  if (F == 64) return 128;
  auto cost = [&](int bx) {
    const long long tiles = (M + bx - 1LL) / bx * (F / 128);
    return (tiles + sms - 1) / sms * (bx + 16);
  };
  return cost(128) < cost(256) ? 128 : 256;
}

template <int BX, int FB>
int launch_bf16(const void* x, const void* wt, void* out, int B, int H,
                int W, int C, int F, int rot, int sms, cudaStream_t st) {
  using R = Ring<BX, FB>;
  static unsigned long long ready = 0;  // devices with the smem opt-in set
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !((ready >> dev) & 1)) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<BX, FB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready |= 1ull << dev;
  }
  const int M = B * H * W;
  CUtensorMap tx, tw, to;
  if (!make_im2col_map(&tx, x, B, H, W, C, R::TP) ||
      !make_map(&tw, wt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 0, F, 9 * C,
                KC, R::TF, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&to, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 0, M, F, 64,
                64, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (M + R::TP - 1) / R::TP * (F / R::TF);
  conv3x3_wgmma_kernel<BX, FB><<<tiles < sms ? tiles : sms, kThreads,
                                  R::BYTES, st>>>(tx, tw, to, B, H, W, C, F,
                                                  rot);
  return static_cast<int>(cudaGetLastError());
}

int conv_bf16(const void* x, const void* wt, void* out, int B, int H, int W,
              int C, int F, int rot, cudaStream_t st) {
  const int sms = sm_count();
  const int bx = pick_bx(B * H * W, F, sms);
  auto run = [&](auto launch) {
    return launch(x, wt, out, B, H, W, C, F, rot, sms, st);
  };
  if (F == 64) return run(launch_bf16<128, 1>);
  return bx == 256 ? run(launch_bf16<256, 2>) : run(launch_bf16<128, 2>);
}

// ---------------------------------------------------------------- fp32

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(kF32Threads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   float* __restrict__ out, int B, int H, int W, int C,
                   int F, int rot) {
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
  // B load: filter tid/4 of the tile, k (tid%4)*4 .. +4 of the K step (the
  // (F, 9*C) weight is K-major, like A's pixel rows).
  const int bf = tid >> 2, bk = (tid & 3) * 4;
  const float* bbase = wt + static_cast<size_t>(n0 + bf) * 9 * C + bk;
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
        bbase + (rot ? 8 - tap : tap) * C + c0);
    As[acol + 0][arow] = av.x;
    As[acol + 1][arow] = av.y;
    As[acol + 2][arow] = av.z;
    As[acol + 3][arow] = av.w;
    Bs[bk + 0][bf] = bv.x;
    Bs[bk + 1][bf] = bv.y;
    Bs[bk + 2][bf] = bv.z;
    Bs[bk + 3][bf] = bv.w;
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

// x: (B, H, W, C) NHWC; wt: (F, 9*C) row-major, K-major (k = (ky*3 + kx)*C
// + c), tap t read as tap 8 - t when rot != 0; out: (B, H, W, F) NHWC; all
// of one type (bf16 when bf16 != 0, else fp32), 16-byte aligned. C == F in
// {64, 128, 256, 512} (the wrapper checks). Returns the CUDA error of the
// launch (0 when it was accepted; a tensor map the driver refuses gives
// cudaErrorInvalidValue).
extern "C" int mla_conv3x3_fwd(const void* x, const void* wt, void* out,
                               int B, int H, int W, int C, int F, int rot,
                               int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return conv_bf16(x, wt, out, B, H, W, C, F, rot, st);
  const int M = B * H * W;
  dim3 grid((M + FBM - 1) / FBM, F / FBN);
  conv3x3_f32_kernel<<<grid, kF32Threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<float*>(out), B, H, W, C, F, rot);
  return static_cast<int>(cudaGetLastError());
}
