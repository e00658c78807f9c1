// Quantized-weight GEMMs for serving, written for Hopper (sm_90a).
//
//   mixed_gemm_kernel  replaces deepspeed_tpu/ops/pallas/mixed_gemm.py
//                      _mixed_gemm_kernel (entry mixed_gemm):
//                      y (M, N) = x (M, K) @ dequant(W).  Per K-group g, each
//                      code becomes f32, is multiplied by the group's scale
//                      scales[g, n] and rounded to bf16; x is rounded to bf16;
//                      the (exact) bf16 products are summed in f32 and y is
//                      written in x's dtype (bf16 or f32).  Codes: int8
//                      (K, N); int4 (K/2, N), byte row r holding K-rows 2r
//                      (low nibble) and 2r+1 (high nibble), both signed; fp6
//                      e3m2 (3K/4, N), bytes (b0, b1, b2) of a column holding
//                      four K-rows c0 = b0 & 63, c1 = b0 >> 6 | (b1 & 15) << 2,
//                      c2 = b1 >> 4 | (b2 & 3) << 4, c3 = b2 >> 2.
//   int8_gemm_kernel   replaces mixed_gemm.py _int8_gemm_kernel (entry
//                      int8_gemm): W8A8.  x arrives quantized per (row,
//                      K-group) by the caller (codes int8 (M, K), scales
//                      transposed to (K/group, M) f32); per group the int8 x
//                      int8 product is summed exactly in int32, then
//                      acc += f32(i32) * xs[g, m] * ws[g, n] in that order,
//                      with no contraction into an FMA (__fmul_rn /
//                      __fadd_rn), group by group: the plain version's
//                      arithmetic to the bit.
//
// Both use the tensor cores through mma.sync (m16n8k16 bf16 -> f32 for the
// mixed GEMM, m16n8k32 s8 -> s32 for W8A8).  bf16 x bf16 products are exact
// in f32, so against the plain version only the summation order differs
// (the tensor cores' f32 accumulation truncates where IEEE addition rounds,
// so the difference grows with K; see the tolerances of the callers).
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOP/s int8):
// at decode (M = 8 rows) the kernels read each weight byte once for 2 M
// flops, far below the ~295 flops/byte ridge: bound by the bytes of the
// codes (a llama3-8b w_in at int8: 58.7 MB, 17.5 us).  At a 256-row mixed
// step they do 512 flops per code byte (int8), past the ridge: bound by
// operations (the same w_in: 30 GFLOP, 30.4 us in bf16, 15.2 us in int8).
// What the mixed GEMM does about each:
//   * every block owns a BM x BN output tile and walks K in BK-deep tiles (a
//     tile never spans two groups, so it carries one scale row), with a ring
//     of stages kept in flight by cp.async so that the code stream does not
//     wait on one round trip per tile;
//   * split-K: when the output tiles alone cannot fill the card (a 4096-wide
//     projection at decode has 32 of them for 132 SMs), blockIdx.z takes a
//     contiguous share of the K-groups and writes f32 partial sums to a
//     workspace that splitk_reduce_kernel adds in order into the output;
//   * decode rows (M <= 16, mixed_gemm_kernel): 16 x 128 tiles, 128 K-rows a
//     stage, each row of a code tile 128 contiguous bytes; the codes stay
//     packed in shared memory and are dequantized straight into the mma B
//     fragments in registers (each element by one thread, once);
//   * larger M (mixed_gemm_mma_kernel): 128 x 128 tiles for 8 warps; each
//     tile's codes are dequantized once, by the whole block, into a bf16
//     tile in shared memory, which every warp reads with ldmatrix (x as
//     well, converted to bf16 first when it is f32).
// wgmma, TMA and a persistent schedule are later work.
//
// Ragged M, N and K edges are masked here (rows >= M and columns >= N are
// loaded as zeros and never stored; a group that BK does not divide ends in
// a partial tile, zero-filled), so any M, any N and K = G * group work.
// Loads whose source is not 16-byte aligned (odd N, odd K) go through
// registers byte by byte; the rest by cp.async.
//
// Every C entry point launches on the caller's stream, allocates nothing
// (the caller passes the split-K workspace), and returns cudaGetLastError()
// after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 16;  // bytes of padding after every shared-memory row
constexpr int kMaxSmem = 227 * 1024;

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

// Copies a ROWS x ROW_BYTES tile (ROW_BYTES a multiple of 16) from global
// memory, rows src_stride bytes apart, to shared memory, rows dst_stride
// apart.  Row r >= valid_rows and byte c >= valid_bytes of a row are written
// as zeros and never read.
template <int ROWS, int ROW_BYTES>
__device__ __forceinline__ void load_tile(uint8_t* dst, int dst_stride, const uint8_t* src,
                                          long long src_stride, int valid_rows,
                                          int valid_bytes) {
  static_assert(ROW_BYTES % 16 == 0, "16-byte chunks");
  constexpr int kPerRow = ROW_BYTES / 16;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | (uintptr_t)src_stride) & 15) == 0;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow, c = (i % kPerRow) * 16;
    uint8_t* d = dst + r * dst_stride + c;
    if (r >= valid_rows || c >= valid_bytes) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint8_t* s = src + r * src_stride + c;
    if (aligned && c + 16 <= valid_bytes) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) d[b] = c + b < valid_bytes ? s[b] : 0;
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// two values as one register of packed bf16: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x elements (k, k+1) of one row of the staged x tile, as packed bf16
__device__ __forceinline__ uint32_t x_pair(const float* row, int k) {
  const float2 v = *reinterpret_cast<const float2*>(row + k);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t x_pair(const __nv_bfloat16* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}

// e3m2 (bias 3): subnormal m * 2^-4, normal (1 + m/4) * 2^(e-3), sign in bit
// 5; the power of two is built from its bits (exact, as the reference)
__device__ __forceinline__ float fp6_value(int c) {
  const int m = c & 3, e = (c >> 2) & 7;
  const float mag = e == 0 ? (float)m * 0.0625f
                           : (1.0f + (float)m * 0.25f) * __int_as_float((e - 3 + 127) << 23);
  return (c & 32) ? -mag : mag;
}

// Code rows per K-row, as a fraction num/den: int8 1/1, int4 1/2, fp6 3/4.
template <int BITS>
struct Pack;
template <>
struct Pack<8> {
  static constexpr int num = 1, den = 1;
};
template <>
struct Pack<4> {
  static constexpr int num = 1, den = 2;
};
template <>
struct Pack<6> {
  static constexpr int num = 3, den = 4;
};

// The dequantized bf16 pair (k, k+1) of column n (k even) of a staged code
// tile whose rows are `stride` bytes apart: code * scale in f32, rounded once
// to f32 and once to bf16, as _mixed_gemm_kernel computes it.
template <int BITS>
__device__ __forceinline__ uint32_t w_pair(const uint8_t* cs, int stride, int k, int n, float s);

template <>
__device__ __forceinline__ uint32_t w_pair<8>(const uint8_t* cs, int stride, int k, int n,
                                              float s) {
  const float v0 = (float)(int8_t)cs[k * stride + n];
  const float v1 = (float)(int8_t)cs[(k + 1) * stride + n];
  return pack_bf16(__fmul_rn(v0, s), __fmul_rn(v1, s));
}

template <>
__device__ __forceinline__ uint32_t w_pair<4>(const uint8_t* cs, int stride, int k, int n,
                                              float s) {
  const int b = (int8_t)cs[(k >> 1) * stride + n];
  const int lo = ((b & 15) ^ 8) - 8, hi = b >> 4;
  return pack_bf16(__fmul_rn((float)lo, s), __fmul_rn((float)hi, s));
}

template <>
__device__ __forceinline__ uint32_t w_pair<6>(const uint8_t* cs, int stride, int k, int n,
                                              float s) {
  const uint8_t* col = cs + (k >> 2) * 3 * stride + n;  // b0 of k's quad
  int c0, c1;
  if ((k & 3) == 0) {
    const int b0 = col[0], b1 = col[stride];
    c0 = b0 & 63;
    c1 = (b0 >> 6) | ((b1 & 15) << 2);
  } else {
    const int b1 = col[stride], b2 = col[2 * stride];
    c0 = (b1 >> 4) | ((b2 & 3) << 4);
    c1 = b2 >> 2;
  }
  return pack_bf16(__fmul_rn(fp6_value(c0), s), __fmul_rn(fp6_value(c1), s));
}

// Signed byte i of a 32-bit word, as f32.
__device__ __forceinline__ float sbyte(uint32_t w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}

// Writes K-row k, columns n..n+3 of the bf16 weight tile (rows `row` bytes
// apart): v[i] * s[i] rounded once to f32, then to bf16.
__device__ __forceinline__ void put4(uint8_t* wt, int row, int k, int n, const float (&v)[4],
                                     const float4& s) {
  uint2 w;
  w.x = pack_bf16(__fmul_rn(v[0], s.x), __fmul_rn(v[1], s.y));
  w.y = pack_bf16(__fmul_rn(v[2], s.z), __fmul_rn(v[3], s.w));
  *reinterpret_cast<uint2*>(wt + k * row + n * 2) = w;
}

// Dequantizes one unit of a staged code tile (code rows `cs` bytes apart by
// `stride`) into the bf16 weight tile: the K-rows that one group of code
// rows holds (int8 1, int4 2, fp6 4) at columns n..n+3, read as one 32-bit
// word per code row.
template <int BITS>
struct Unit;

template <>
struct Unit<8> {
  static constexpr int kRows = 1;  // K-rows per unit
  static __device__ __forceinline__ void dequant(const uint8_t* cs, int stride, int u, int n,
                                                 const float4& s, uint8_t* wt, int row) {
    const uint32_t c = *reinterpret_cast<const uint32_t*>(cs + u * stride + n);
    const float v[4] = {sbyte(c, 0), sbyte(c, 1), sbyte(c, 2), sbyte(c, 3)};
    put4(wt, row, u, n, v, s);
  }
};

template <>
struct Unit<4> {
  static constexpr int kRows = 2;
  static __device__ __forceinline__ void dequant(const uint8_t* cs, int stride, int u, int n,
                                                 const float4& s, uint8_t* wt, int row) {
    const uint32_t c = *reinterpret_cast<const uint32_t*>(cs + u * stride + n);
    float lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = (int8_t)(c >> (8 * i));
      lo[i] = (float)(((b & 15) ^ 8) - 8);  // K-row 2u, signed low nibble
      hi[i] = (float)(b >> 4);              // K-row 2u + 1, signed high nibble
    }
    put4(wt, row, 2 * u, n, lo, s);
    put4(wt, row, 2 * u + 1, n, hi, s);
  }
};

template <>
struct Unit<6> {
  static constexpr int kRows = 4;
  static __device__ __forceinline__ void dequant(const uint8_t* cs, int stride, int u, int n,
                                                 const float4& s, uint8_t* wt, int row) {
    const uint8_t* p = cs + 3 * u * stride + n;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + stride);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * stride);
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b0 = (w0 >> (8 * i)) & 255, b1 = (w1 >> (8 * i)) & 255,
                b2 = (w2 >> (8 * i)) & 255;
      v[0][i] = fp6_value(b0 & 63);
      v[1][i] = fp6_value((b0 >> 6) | ((b1 & 15) << 2));
      v[2][i] = fp6_value((b1 >> 4) | ((b2 & 3) << 4));
      v[3][i] = fp6_value(b2 >> 2);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) put4(wt, row, 4 * u + r, n, v[r], s);
  }
};

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

// Block tiling: BM x BN outputs per block, BK K-rows per pipeline stage,
// WM x WN warps each owning a (BM/WM) x (BN/WN) sub-tile.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tiling {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16;  // 16-row mma tiles per warp
  static constexpr int NT = BN / WN / 8;   // 8-column mma tiles per warp
  static_assert(MT >= 1 && NT >= 1 && BN % 16 == 0, "tiling");
};

// ---------------------------------------------------------------------------
// mixed GEMM (W8A16 / W4A16 / W6A16)
// ---------------------------------------------------------------------------

// The K-groups [g_lo, g_hi) of split z of `splits`.
__device__ __forceinline__ void split_groups(int K, int group, int splits, int& g_lo,
                                             int& g_hi) {
  const int G = K / group, z = blockIdx.z;
  g_lo = (int)((long long)z * G / splits);
  g_hi = (int)((long long)(z + 1) * G / splits);
}

// Copies K-tile t of a split (x rows, code rows, the group's scale row) into
// stage `st` (layout: x tile, then code tile, then scale row).
template <typename XT, int BITS, int BM, int BN, int BK>
__device__ __forceinline__ void load_mixed_tile(uint8_t* st, int x_row, int c_row,
                                                const XT* x, const uint8_t* codes,
                                                const float* scales, int M, int N, int K,
                                                int group, int m0, int n0, int g_lo, int t) {
  constexpr int kCRows = BK * Pack<BITS>::num / Pack<BITS>::den;
  const int tiles_per_group = (group + BK - 1) / BK;
  const int g = g_lo + t / tiles_per_group, kin = (t % tiles_per_group) * BK;
  const int k0 = g * group + kin, vk = min(BK, group - kin);
  const long long x_stride = (long long)K * sizeof(XT);
  load_tile<BM, BK * (int)sizeof(XT)>(
      st, x_row,
      reinterpret_cast<const uint8_t*>(x) + (long long)m0 * x_stride + k0 * sizeof(XT),
      x_stride, M - m0, vk * (int)sizeof(XT));
  const long long row0 = (long long)k0 * Pack<BITS>::num / Pack<BITS>::den;
  load_tile<kCRows, BN>(st + BM * x_row, c_row, codes + row0 * N + n0, N,
                        vk * Pack<BITS>::num / Pack<BITS>::den, N - n0);
  load_tile<1, BN * 4>(st + BM * x_row + kCRows * c_row, 0,
                       reinterpret_cast<const uint8_t*>(scales + (long long)g * N + n0), 0, 1,
                       (N - n0) * 4);
}

// Stores a warp's MT x NT mma accumulators: to `out` in XT when the K range
// is whole, else as f32 partial sums to split blockIdx.z of `ws`.
template <typename XT, int MT, int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[MT][NT][4], XT* out, float* ws,
                                         int splits, int M, int N, int r0, int c0) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  float* part = ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + i * 16 + gr + (e >> 1) * 8, c = c0 + j * 8 + tq * 2 + (e & 1);
        if (r >= M || c >= N) continue;
        if (splits == 1)
          out[(long long)r * N + c] = from_float<XT>(acc[i][j][e]);
        else
          part[(long long)r * N + c] = acc[i][j][e];
      }
}

template <typename XT, int BITS, typename TL>
struct MixedSmem {
  static constexpr int kXRow = TL::BK * (int)sizeof(XT) + kPad;
  static constexpr int kCRows = TL::BK * Pack<BITS>::num / Pack<BITS>::den;
  static constexpr int kCRow = TL::BN + kPad;
  static constexpr int kXBytes = TL::BM * kXRow;
  static constexpr int kCBytes = kCRows * kCRow;
  static constexpr int kStage = kXBytes + kCBytes + TL::BN * 4;
  static constexpr int kBytes = kStage * TL::STAGES;
};

// Decode rows: codes dequantized straight into the B fragments (registers).
template <typename XT, int BITS, typename TL>
__global__ void __launch_bounds__(TL::kThreads)
    mixed_gemm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ scales, XT* __restrict__ out,
                      float* __restrict__ ws, int M, int N, int K, int group, int splits) {
  using SM = MixedSmem<XT, BITS, TL>;
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, MT = TL::MT, NT = TL::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int g_lo, g_hi;
  split_groups(K, group, splits, g_lo, g_hi);
  const int tiles = (g_hi - g_lo) * ((group + BK - 1) / BK);
  auto load = [&](int t) {
    load_mixed_tile<XT, BITS, BM, BN, BK>(smem + (t % TL::STAGES) * SM::kStage, SM::kXRow,
                                          SM::kCRow, x, codes, scales, M, N, K, group, m0,
                                          n0, g_lo, t);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  const int gr = lane >> 2, tq = lane & 3;  // mma fragment row group, thread in quad
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + TL::STAGES - 1 < tiles) load(t + TL::STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (t % TL::STAGES) * SM::kStage;
    const uint8_t* cs = st + SM::kXBytes;
    const float* ss = reinterpret_cast<const float*>(st + SM::kXBytes + SM::kCBytes);
    float sc[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j] = ss[wn * (BN / TL::WN) + j * 8 + gr];
#pragma unroll 4
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * (BM / TL::WM) + i * 16 + gr;
        const XT* x0 = reinterpret_cast<const XT*>(st + r * SM::kXRow);
        const XT* x8 = reinterpret_cast<const XT*>(st + (r + 8) * SM::kXRow);
        const int k = ks + tq * 2;
        a[i][0] = x_pair(x0, k);
        a[i][1] = x_pair(x8, k);
        a[i][2] = x_pair(x0, k + 8);
        a[i][3] = x_pair(x8, k + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * (BN / TL::WN) + j * 8 + gr;
        const int k = ks + tq * 2;
        const uint32_t b0 = w_pair<BITS>(cs, SM::kCRow, k, n, sc[j]);
        const uint32_t b1 = w_pair<BITS>(cs, SM::kCRow, k + 8, n, sc[j]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  store_acc<XT, MT, NT>(acc, out, ws, splits, M, N, m0 + wm * (BM / TL::WM),
                        n0 + wn * (BN / TL::WN));
}

// Larger M: 128 x 128 tiles, 8 warps of 64 x 32, two blocks per SM; each
// K-tile's codes are dequantized once into a bf16 tile in shared memory
// ([k][n], read with ldmatrix.trans), x read with ldmatrix ([m][k], bf16).
// (128 x 256 tiles of 64 x 64 warps, one block per SM, measured 10-17%
// slower at llama3-8b's shapes.)
template <typename XT, int BITS>
struct MmaSmem {
  static constexpr int BM = 128, BN = 128, BK = 64, WM = 2, WN = 4, STAGES = 3;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int kXRow = BK * (int)sizeof(XT) + kPad;  // staged raw x
  static constexpr int kCRows = BK * Pack<BITS>::num / Pack<BITS>::den;
  static constexpr int kCRow = BN + kPad;
  static constexpr int kStage = BM * kXRow + kCRows * kCRow + BN * 4;
  static constexpr int kWRow = (BN + 8) * 2;   // bf16 weight tile row: 272 bytes
  static constexpr int kXbRow = (BK + 8) * 2;  // bf16 x tile row: 144 bytes
  static constexpr bool kXIsBf16 = sizeof(XT) == 2;
  static constexpr int kBytes =
      STAGES * kStage + BK * kWRow + (kXIsBf16 ? 0 : BM * kXbRow);
  static_assert(!kXIsBf16 || kXRow == kXbRow, "bf16 x is read in place");
};

template <typename XT, int BITS>
__global__ void __launch_bounds__(MmaSmem<XT, BITS>::kThreads)
    mixed_gemm_mma_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                          const float* __restrict__ scales, XT* __restrict__ out,
                          float* __restrict__ ws, int M, int N, int K, int group, int splits) {
  using L = MmaSmem<XT, BITS>;
  constexpr int BM = L::BM, BN = L::BN, BK = L::BK, MT = L::MT, NT = L::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wtile = smem + L::STAGES * L::kStage;
  uint8_t* xtile = wtile + BK * L::kWRow;  // f32 x only
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int g_lo, g_hi;
  split_groups(K, group, splits, g_lo, g_hi);
  const int tiles = (g_hi - g_lo) * ((group + BK - 1) / BK);
  auto load = [&](int t) {
    load_mixed_tile<XT, BITS, BM, BN, BK>(smem + (t % L::STAGES) * L::kStage, L::kXRow,
                                          L::kCRow, x, codes, scales, M, N, K, group, m0, n0,
                                          g_lo, t);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / L::WN, wn = warp % L::WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // tile t is in; every warp is done with the bf16 tiles of t - 1
    if (t + L::STAGES - 1 < tiles) load(t + L::STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (t % L::STAGES) * L::kStage;
    const uint8_t* cs = st + BM * L::kXRow;
    const float* ss = reinterpret_cast<const float*>(cs + L::kCRows * L::kCRow);
    // the weight tile, dequantized once: code * scale in f32, then bf16,
    // four columns of one unit of code rows per step
    constexpr int kUnits = BK / Unit<BITS>::kRows * (BN / 4);
    for (int p = threadIdx.x; p < kUnits; p += L::kThreads) {
      const int u = p / (BN / 4), n = (p % (BN / 4)) * 4;
      Unit<BITS>::dequant(cs, L::kCRow, u, n, *reinterpret_cast<const float4*>(ss + n), wtile,
                          L::kWRow);
    }
    if constexpr (!L::kXIsBf16) {
      for (int p = threadIdx.x; p < BM * BK / 4; p += L::kThreads) {
        const int m = p / (BK / 4), k = (p % (BK / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(st + m * L::kXRow + k * 4);
        *reinterpret_cast<uint2*>(xtile + m * L::kXbRow + k * 2) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
    }
    __syncthreads();
    const uint8_t* xa = L::kXIsBf16 ? st : xtile;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * (BM / L::WM) + i * 16 + (lane & 15);
        ldmatrix_x4(a[i], xa + r * L::kXbRow + (ks + (lane >> 4) * 8) * 2);
      }
      uint32_t b[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * (BN / L::WN) + jj * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, wtile + k * L::kWRow + n * 2);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  store_acc<XT, MT, NT>(acc, out, ws, splits, M, N, m0 + wm * (BM / L::WM),
                        n0 + wn * (BN / L::WN));
}

// out = sum over the splits of ws, added in split order, in XT.
template <typename XT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, XT* __restrict__ out,
                                     long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int z = 1; z < splits; ++z) acc = __fadd_rn(acc, ws[z * mn + i]);
    out[i] = from_float<XT>(acc);
  }
}

// ---------------------------------------------------------------------------
// W8A8 int8 GEMM
// ---------------------------------------------------------------------------

template <typename TL>
struct Int8Smem {
  static constexpr int kXRow = TL::BK + kPad;
  static constexpr int kWRow = TL::BN + kPad;
  static constexpr int kXBytes = TL::BM * kXRow;
  static constexpr int kWBytes = TL::BK * kWRow;
  static constexpr int kStage = kXBytes + kWBytes + TL::BM * 4 + TL::BN * 4;
  static constexpr int kBytes = kStage * TL::STAGES;
};

// needs group % BK == 0, so that a tile lies in one group
template <typename XT, typename TL>
__global__ void __launch_bounds__(TL::kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ xc, const float* __restrict__ xs_t,
                     const int8_t* __restrict__ wc, const float* __restrict__ ws,
                     XT* __restrict__ out, int M, int N, int K, int group) {
  using SM = Int8Smem<TL>;
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, MT = TL::MT, NT = TL::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tiles_per_group = group / BK;
  const int tiles = K / BK;

  auto load = [&](int t) {
    uint8_t* st = smem + (t % TL::STAGES) * SM::kStage;
    const int k0 = t * BK, g = t / tiles_per_group;
    load_tile<BM, BK>(st, SM::kXRow, reinterpret_cast<const uint8_t*>(xc) + (long long)m0 * K + k0,
                      K, M - m0, BK);
    load_tile<BK, BN>(st + SM::kXBytes, SM::kWRow,
                      reinterpret_cast<const uint8_t*>(wc) + (long long)k0 * N + n0, N, BK,
                      N - n0);
    uint8_t* sc = st + SM::kXBytes + SM::kWBytes;
    load_tile<1, BM * 4>(sc, 0, reinterpret_cast<const uint8_t*>(xs_t + (long long)g * M + m0), 0,
                         1, (M - m0) * 4);
    load_tile<1, BN * 4>(sc + BM * 4, 0,
                         reinterpret_cast<const uint8_t*>(ws + (long long)g * N + n0), 0, 1,
                         (N - n0) * 4);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  const int gr = lane >> 2, tq = lane & 3;
  int iacc[MT][NT][4];
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[i][j][e] = 0;
        acc[i][j][e] = 0.0f;
      }

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<TL::STAGES - 2>();
    __syncthreads();
    if (t + TL::STAGES - 1 < tiles) load(t + TL::STAGES - 1);
    cp_async_commit();

    const uint8_t* st = smem + (t % TL::STAGES) * SM::kStage;
    const uint8_t* wsm = st + SM::kXBytes;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * (BM / TL::WM) + i * 16 + gr;
        const uint8_t* x0 = st + r * SM::kXRow + ks + tq * 4;
        const uint8_t* x8 = x0 + 8 * SM::kXRow;
        a[i][0] = *reinterpret_cast<const uint32_t*>(x0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(x8);
        a[i][2] = *reinterpret_cast<const uint32_t*>(x0 + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(x8 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * (BN / TL::WN) + j * 8 + gr;
        // B is K-major per column: gather the column's four K-rows per
        // register (the codes are stored with N contiguous)
        const uint8_t* w0 = wsm + (ks + tq * 4) * SM::kWRow + n;
        const uint8_t* w16 = w0 + 16 * SM::kWRow;
        const uint32_t b0 = (uint32_t)w0[0] | (uint32_t)w0[SM::kWRow] << 8 |
                            (uint32_t)w0[2 * SM::kWRow] << 16 |
                            (uint32_t)w0[3 * SM::kWRow] << 24;
        const uint32_t b1 = (uint32_t)w16[0] | (uint32_t)w16[SM::kWRow] << 8 |
                            (uint32_t)w16[2 * SM::kWRow] << 16 |
                            (uint32_t)w16[3 * SM::kWRow] << 24;
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(iacc[i][j], a[i], b0, b1);
      }
    }
    if ((t + 1) % tiles_per_group == 0) {  // the group is complete: rescale
      const float* xsc = reinterpret_cast<const float*>(st + SM::kXBytes + SM::kWBytes);
      const float* wsc = xsc + BM;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * (BM / TL::WM) + i * 16 + gr + (e >> 1) * 8;
            const int c = wn * (BN / TL::WN) + j * 8 + tq * 2 + (e & 1);
            const float p = __fmul_rn(__fmul_rn((float)iacc[i][j][e], xsc[r]), wsc[c]);
            acc[i][j][e] = __fadd_rn(acc[i][j][e], p);
            iacc[i][j][e] = 0;
          }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = m0 + wm * (BM / TL::WM) + i * 16 + gr;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + wn * (BN / TL::WN) + j * 8 + tq * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
        if (rr < M && cc < N) out[(long long)rr * N + cc] = from_float<XT>(acc[i][j][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

// decode rows (M <= kSmallM) and everything larger
using MixedSmall = Tiling<16, 128, 128, 1, 4, 4>;
using Int8Small = Tiling<16, 32, 128, 1, 4, 8>;
using Int8Large = Tiling<64, 64, 64, 2, 2, 4>;
constexpr int kSmallM = 16;

template <typename XT, int BITS>
cudaError_t launch_mixed(const void* x, const void* codes, const void* scales, void* out,
                         float* ws, int M, int N, int K, int group, int splits,
                         cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  XT* op = static_cast<XT*>(out);
  if (M <= kSmallM) {
    using TL = MixedSmall;
    auto kernel = mixed_gemm_kernel<XT, BITS, TL>;
    const int smem = MixedSmem<XT, BITS, TL>::kBytes;
    static cudaError_t attr = allow_smem(kernel, smem);  // once per instantiation
    if (attr != cudaSuccess) return attr;
    const dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, splits);
    kernel<<<grid, TL::kThreads, smem, st>>>(xp, cp, sp, op, ws, M, N, K, group, splits);
  } else {
    using L = MmaSmem<XT, BITS>;
    auto kernel = mixed_gemm_mma_kernel<XT, BITS>;
    static cudaError_t attr = allow_smem(kernel, L::kBytes);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM, splits);
    kernel<<<grid, L::kThreads, L::kBytes, st>>>(xp, cp, sp, op, ws, M, N, K, group, splits);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 1056 ? (mn + 255) / 256 : 1056);
  splitk_reduce_kernel<XT><<<blocks, 256, 0, st>>>(ws, op, mn, splits);
  return cudaGetLastError();
}

template <typename XT, typename TL>
cudaError_t launch_int8(const void* xc, const void* xs_t, const void* wc, const void* ws,
                        void* out, int M, int N, int K, int group, cudaStream_t st) {
  if (group % TL::BK != 0 || K % group != 0) return cudaErrorInvalidValue;
  auto kernel = int8_gemm_kernel<XT, TL>;
  const int smem = Int8Smem<TL>::kBytes;
  static cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM);
  kernel<<<grid, TL::kThreads, smem, st>>>(
      static_cast<const int8_t*>(xc), static_cast<const float*>(xs_t),
      static_cast<const int8_t*>(wc), static_cast<const float*>(ws), static_cast<XT*>(out), M,
      N, K, group);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_int8(const void* xc, const void* xs_t, const void* wc, const void* ws,
                          void* out, int M, int N, int K, int group, cudaStream_t st) {
  if (M <= kSmallM)
    return launch_int8<XT, Int8Small>(xc, xs_t, wc, ws, out, M, N, K, group, st);
  return launch_int8<XT, Int8Large>(xc, xs_t, wc, ws, out, M, N, K, group, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x and out); bits: 8, 4 or 6.  codes and scales
// as in the header; K = (K / group) * group.  splits (1 <= splits <= K /
// group) shares the K-groups among blockIdx.z; with splits > 1, ws is an f32
// workspace of splits * M * N.
extern "C" int ds_mixed_gemm(int dtype, int bits, const void* x, const void* codes,
                             const void* scales, void* out, void* ws, int M, int N, int K,
                             int group, int splits, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (M == 0 || N == 0) return cudaSuccess;
  if (group <= 0 || K % group != 0 || splits < 1 || splits > K / group ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
#define DS_MIXED(T, B) \
  return (int)launch_mixed<T, B>(x, codes, scales, out, wsp, M, N, K, group, splits, st)
  if (dtype == 1) {
    if (bits == 8) DS_MIXED(__nv_bfloat16, 8);
    if (bits == 4) DS_MIXED(__nv_bfloat16, 4);
    if (bits == 6) DS_MIXED(__nv_bfloat16, 6);
  }
  if (dtype == 0) {
    if (bits == 8) DS_MIXED(float, 8);
    if (bits == 4) DS_MIXED(float, 4);
    if (bits == 6) DS_MIXED(float, 6);
  }
#undef DS_MIXED
  return cudaErrorInvalidValue;
}

// W8A8: xc int8 (M, K), xs_t f32 (K/group, M), wc int8 (K, N), ws f32
// (K/group, N); group a multiple of 128.
extern "C" int ds_int8_gemm(int dtype, const void* xc, const void* xs_t, const void* wc,
                            const void* ws, void* out, int M, int N, int K, int group,
                            void* stream) {
  cudaGetLastError();
  if (M == 0 || N == 0) return cudaSuccess;
  if (group <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_int8<__nv_bfloat16>(xc, xs_t, wc, ws, out, M, N, K, group, st);
  if (dtype == 0) return (int)dispatch_int8<float>(xc, xs_t, wc, ws, out, M, N, K, group, st);
  return cudaErrorInvalidValue;
}
