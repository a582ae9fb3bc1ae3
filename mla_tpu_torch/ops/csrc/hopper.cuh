// Hopper (sm_90a) building blocks shared by the port's wgmma kernels: the
// int8 GEMMs (q8_gemm.cuh, behind q8_matmul.cu and q8_mlp.cu) and the 3x3
// conv (conv3x3.cu). Shared-memory barriers (mbarrier), TMA loads (tiled and
// im2col) and stores, the 128-byte-swizzled wgmma operand descriptor, wgmma
// wrappers (bf16 with A from registers or shared memory, s8.s8 from shared
// memory), stmatrix, and the driver's tensor-map encoders looked up through
// the CUDA runtime (no -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kSmemMax = 232448;  // opt-in shared memory of one block

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(n)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// An im2col load from a 4-D (C, W, H, N) map: a column of the map's
// pixelsPerColumn pixels that starts at (w, h, n) and walks the map's
// bounding box (W fastest, then H, then N), channels c .. c + the map's
// channelsPerPixel of each pixel read at (w + ow, h + oh); what falls
// outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load_im2col_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c,
                                                   int w, int h, int n,
                                                   uint16_t ow, uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from accumulator fragments (thread: row lane / 4,
// columns 2 (lane % 4) + {0, 1}), each stored transposed: lane 8q + r
// gives the address of row r of matrix q, which receives column r
__device__ __forceinline__ void stmatrix_x4_trans(void* p, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(smem_u32(p)),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// at most N of this warpgroup's committed product groups still run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A K-major wgmma operand in shared memory: 128-byte rows written by TMA
// with the 128-byte swizzle, 8-row groups 1024 bytes apart (SBO), LBO
// unused; +2 advances it by 32 bytes (one k16 bf16 / k32 int8 step).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma wrappers: D (64 x N) += A (64 x k) . B^T (B: N x k, K-major in
// shared memory). bf16_rs: k16, A bf16 in registers, fp32 D; bf16_ss (N =
// 128, 256): k16, A bf16 in shared memory, fp32 D; s8_ss: k32, A int8 in
// shared memory, int32 D.
#define WG_D8(c, d, i)                                                    \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
      c(d[i + 6]), c(d[i + 7])
#define WG_D32(c, d) \
  WG_D8(c, d, 0), WG_D8(c, d, 8), WG_D8(c, d, 16), WG_D8(c, d, 24)
#define WG_D64(c, d)                                                   \
  WG_D8(c, d, 0), WG_D8(c, d, 8), WG_D8(c, d, 16), WG_D8(c, d, 24),    \
      WG_D8(c, d, 32), WG_D8(c, d, 40), WG_D8(c, d, 48), WG_D8(c, d, 56)
#define WG_D128(c, d)                                                    \
  WG_D64(c, d), WG_D8(c, d, 64), WG_D8(c, d, 72), WG_D8(c, d, 80),       \
      WG_D8(c, d, 88), WG_D8(c, d, 96), WG_D8(c, d, 104), WG_D8(c, d, 112), \
      WG_D8(c, d, 120)

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void bf16_rs(float* d, const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : WG_D32("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
  static __device__ __forceinline__ void s8_ss(int* d, uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p;\n}\n"
        : WG_D32("+r", d)
        : "l"(a), "l"(b));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void bf16_ss(float* d, uint64_t a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_D64("+f", d)
        : "l"(a), "l"(b));
  }
  static __device__ __forceinline__ void bf16_rs(float* d, const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : WG_D64("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
  static __device__ __forceinline__ void s8_ss(int* d, uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p;\n}\n"
        : WG_D64("+r", d)
        : "l"(a), "l"(b));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void bf16_ss(float* d, uint64_t a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : WG_D128("+f", d)
        : "l"(a), "l"(b));
  }
  static __device__ __forceinline__ void bf16_rs(float* d, const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}"
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : WG_D128("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
  static __device__ __forceinline__ void s8_ss(int* d, uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p;\n}\n"
        : WG_D128("+r", d)
        : "l"(a), "l"(b));
  }
};

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// a driver function, looked up through the CUDA runtime (no -lcuda); null
// when the driver does not have it
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                       &q) != cudaSuccess)
    p = nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) != cudaSuccess)
    p = nullptr;
#endif
  return p;
}

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

inline EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// A 2-D (rows, cols) or, with layers > 0, 3-D (layers, rows, cols)
// row-major tensor of `esize`-byte elements, moved in boxes of box_c x
// box_r (x 1).
inline bool make_map(CUtensorMap* map, const void* base,
                     CUtensorMapDataType type, int esize, int layers,
                     int rows, int cols, int box_c, int box_r,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = static_cast<cuuint64_t>(esize);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(layers)};
  const cuuint64_t strides[2] = {cols * es, static_cast<cuuint64_t>(rows) *
                                                cols * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, layers > 0 ? 3 : 2, const_cast<void*>(base), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SM count (cached per device)
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 1;
  if (dev < 64) cache[dev] = n;
  return n;
}

// A 4-D NHWC bf16 tensor (B, H, W, C) read by im2col loads of `pixels`
// pixels x 64 channels (128-byte rows, 128-byte swizzle) for a stride-1
// SAME 3x3 conv: the bounding box's corners at -1 (lower) and -1 (upper)
// make its W x H positions the output pixels' top-left taps (w - 1, h - 1),
// and a load's offsets (kx, ky) in 0..2 pick the tap
inline bool make_im2col_map(CUtensorMap* map, const void* base, int B, int H,
                            int W, int C, int pixels) {
  const EncodeIm2col fn = encode_im2col();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * 2;
  const cuuint64_t strides[3] = {row, row * W, row * W * H};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, lower, upper, 64, static_cast<cuuint32_t>(pixels),
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
