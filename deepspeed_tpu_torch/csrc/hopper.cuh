// Hopper (sm_90a) building blocks shared by mixed_gemm.cu and
// grouped_matmul.cu: cp.async, mma.sync and ldmatrix, mbarriers, TMA tile
// copies with the tensor-map encoder looked up in the driver, and wgmma with
// its 128-byte-swizzled shared-memory operands.  Everything lives in an
// anonymous namespace: each source that includes the header gets its own
// copy, and no symbol leaves the shared library but the C entry points.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in the driver
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same product of f16 fragments (f16 x f16 products are exact in f32)
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 or mma_f16 by the fragments' element type E
template <typename E>
__device__ __forceinline__ void mma_tc(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

// an f32 sum stored in an output of type T (f32, bf16 or f16), rounded to
// nearest even
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// columns n, n + 1 of one output row (8-byte aligned for f32, 4 for bf16
// and f16)
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(__half* p, float v0, float v1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// --- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// one arrival on `bar` that also expects `bytes` more bytes of copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box of `map` at (x0 inner, x1 outer) into shared memory, its
// bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int x0, int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x0), "r"(x1)
      : "memory");
}

// the same for a 3-d map, at (x0 inner, x1, x2 outer)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x0, int x1, int x2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x0), "r"(x1), "r"(x2)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The accumulators are written by asynchronous wgmma: an empty asm that
// reads and writes each keeps the compiler from moving their uses across
// the wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The descriptor of a K-major wgmma operand in shared memory in the
// 128-byte swizzle mode: rows of 128 bytes (64 bf16 or 128 int8 elements),
// 8-row atoms 1024 bytes apart, the 16-byte chunk j of row r stored at chunk
// j ^ (r % 8) (as TMA's 128-byte swizzle writes it; atoms 1024-byte
// aligned).  A k-step (16 bf16 or 32 int8 elements) inside the row starts 32
// bytes further on.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// byte c of row r of a 128-byte-row tile in that swizzle mode
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], E (bf16 or f16) -> f32: A from
// registers (per warp the m16n8k16 A fragment of its 16 rows), B K-major in
// shared memory.  Each thread holds D's rows gr, gr + 8 of its warp's 16
// and columns 8j + 2tq, +1 as d[4j .. 4j + 3] (the m16n8 layout, j < 8).
#define DS_WGMMA_M64N64K16(TYPE)                                                             \
  asm volatile(                                                                              \
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                                         \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
        "+f"(d[31])                                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  if constexpr (std::is_same<E, __half>::value)
    DS_WGMMA_M64N64K16("f16");
  else
    DS_WGMMA_M64N64K16("bf16");
}
#undef DS_WGMMA_M64N64K16

// --- host: tensor maps -------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in the driver once (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of a row-major array of `rank` (2 or 3) dimensions, dims[0]
// innermost, whose outer dimensions are pitch[0] (and pitch[1]) bytes
// apart, in boxes of box[0 .. rank); elements past the array read as zeros.
bool tile_map_nd(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                 const uint64_t* dims, const uint64_t* pitch, const uint32_t* box,
                 CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], steps[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    if (i + 1 < rank) s[i] = pitch[i];
  }
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), d, s, b, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA map of a row-major (rows, cols) array whose rows are `pitch`
// bytes apart, in boxes of box_rows x box_cols.
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
              uint64_t rows, uint64_t pitch, uint32_t box_cols, uint32_t box_rows,
              CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows}, pitches[1] = {pitch};
  const uint32_t box[2] = {box_cols, box_rows};
  return tile_map_nd(map, type, base, 2, dims, pitches, box, swizzle);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

}  // namespace
