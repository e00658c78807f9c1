// Quantized-weight GEMMs for serving, written for Hopper (sm_90a).
//
//   mixed_gemm_decode_kernel, replace deepspeed_tpu/ops/pallas/mixed_gemm.py
//   mixed_gemm_wgmma_kernel,  _mixed_gemm_kernel (entry mixed_gemm):
//   mixed_gemm_mma_kernel     M <= 16 rows, bf16 or f16 x at M > 16, f32 x
//                      at M > 16 (the dispatch is on M and dtype, not a
//                      fallback);
//                      all three compute
//                      y (M, N) = x (M, K) @ dequant(W).  Per K-group g, each
//                      code becomes f32, is multiplied by the group's scale
//                      scales[g, n] and rounded to bf16; x is rounded to bf16;
//                      the (exact) bf16 products are summed in f32 and y is
//                      written in x's dtype (bf16, f16 or f32).  f16 x is
//                      not an f16 product: it is rounded to bf16, as the
//                      reference rounds any x to bf16 (the decode
//                      kernel where it loads its B fragments; above 16
//                      rows round_x_bf16_kernel, launched by the same
//                      entry before the wgmma kernel, into the caller's
//                      workspace).  Codes: int8
//                      (K, N); int4 (K/2, N), byte row r holding K-rows 2r
//                      (low nibble) and 2r+1 (high nibble), both signed; fp6
//                      e3m2 (3K/4, N), bytes (b0, b1, b2) of a column holding
//                      four K-rows c0 = b0 & 63, c1 = b0 >> 6 | (b1 & 15) << 2,
//                      c2 = b1 >> 4 | (b2 & 3) << 4, c3 = b2 >> 2.
//   int8_gemm_wgmma_kernel,  replace mixed_gemm.py _int8_gemm_kernel (entry
//   int8_gemm_mma_kernel     int8_gemm): W8A8.  x arrives quantized per (row,
//                      K-group) by the caller (codes int8 (M, K), scales
//                      transposed to (K/group, M) f32); per group the int8 x
//                      int8 product is summed exactly in int32, then
//                      acc += f32(i32) * xs[g, m] * ws[g, n] in that order,
//                      with no contraction into an FMA (__fmul_rn /
//                      __fadd_rn), group by group: the plain version's
//                      arithmetic to the bit.  The dispatch (chosen by the
//                      wrapper, checked here) is on M and the layout:
//                      M > 16 with TMA's rows (N % 16 == 0, 16-byte
//                      aligned arrays) runs the wgmma kernel, M <= 16 and
//                      any other N the mma.sync kernel.  The output is
//                      bf16, f16 or f32.
//
// They use the tensor cores: wgmma m64n64k16 bf16 -> f32 (bf16 x, M > 16),
// mma.sync m16n8k16 bf16 -> f32 (the other mixed GEMMs), wgmma m64n64k32
// and mma.sync m16n8k32 s8 -> s32 (W8A8).  bf16 x bf16 products are exact
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
//   * decode rows (M <= 16, mixed_gemm_decode_kernel): y^T = W^T x^T on
//     mma.sync m16n8k16, the dequantized weight as the A operand built in
//     registers straight from global memory (no shared-memory tile), x^T as
//     B (one n8 tile of x rows up to M = 8, two up to 16), so no mma row is
//     padding at M <= 8.  A warp owns 128 columns, a thread 16 adjacent ones
//     (its A rows gr and gr + 8 of eight m16 tiles): one 16-byte load per
//     code row feeds all eight tiles.  The codes become f32 without
//     conversion instructions (int8 and int4: the code placed in the
//     mantissa of 2^23 by byte permutes, the offset taken off exactly; fp6:
//     its bits placed as a scaled f32 pattern), then one product by the
//     scale and a packed round to bf16.  The grid is as many blocks of 8
//     warps as the card holds at once, each an equal share of the
//     128-column tiles' K-steps in tile order (stream-K: no SM holds more
//     work than another), one tile at a time, each warp a contiguous share
//     of the tile's steps with the next step's loads in flight while it
//     converts one; the warps' sums meet in shared memory in warp order,
//     and a tile that several blocks share is added up in the same kernel
//     from an f32 workspace: the last of its blocks to finish (an atomic
//     ticket per tile, reset by that block) adds the shares in block order.
//     At llama3-8b's widths int8 streams its codes at ~85% of the memory
//     rate once running, and a launch's fixed cost (its first loads after a
//     cold start, the shared tiles' sums) is most of the rest; int4 and
//     fp6 are held by the instruction issue of their conversions (~4 and ~5
//     instructions a code).  A shared-memory cp.async ring (more steps in
//     flight), wider blocks (longer runs of a code row, more splits), L2
//     prefetch ahead of the loads and a third register stage (spills) each
//     measured slower;
//   * every block of the M > 16 kernels owns a BM x BN output tile and
//     walks K in BK-deep tiles (a tile never spans two groups, so it carries
//     one scale row), with a ring of stages kept in flight so that the code
//     stream does not wait on one round trip per tile; their split-K
//     (blockIdx.z takes a contiguous share of the K-groups) writes f32
//     partial sums to a workspace that splitk_reduce_kernel adds in order
//     into the output;
//   * bf16 x at M > 16 (mixed_gemm_wgmma_kernel): y^T = W^T x^T on wgmma,
//     the dequantized weight as the A operand straight from registers.  A
//     block owns 128 output columns (two consumer warpgroups of 64, each
//     thread two adjacent columns, so one 16-bit load per code row feeds
//     both) and all 256 rows of a mixed step (B = x^T, K-major in shared
//     memory), so each code is read from memory once per GEMM and
//     dequantized once, in registers, with no bf16 weight tile and no
//     block-wide barrier between the dequantization and the tensor cores.
//     A producer warpgroup fills a 4-stage ring through TMA (one thread,
//     three copies a stage, 128-byte swizzled tiles that wgmma reads as
//     they land) where rows are 16-byte aligned and K-tiles stay inside one
//     group, else with its 128 threads' cp.async; stages pass between the
//     producer and the consumers by mbarriers, and the two consumer
//     warpgroups take turns at the tensor cores while the other one
//     dequantizes.  At a 256-row mixed step the copies alone take ~2/3 of
//     its time and the products without the dequantization ~4/5; what
//     holds it is the dequantization, which a warpgroup does not overlap
//     with its own products (int8 +20%, fp6 +75%; a second register set
//     for A broke the results or was serialized by ptxas).  Each column
//     block reads all of x, but skipping x's copies saves 3%.  A 128-row
//     variant (more blocks, codes dequantized twice) and a 5-stage ring
//     measured slower at three of llama3-8b's four shapes.  fp6 converts a
//     code with two exact f32 products (fp6_times), not fp6_value.  f16 x
//     takes the same kernel (bf16 x, f16 y) after one elementwise pass
//     rounds x to bf16 into a workspace, so each element is converted once
//     (converted per stage in shared memory, every column block would
//     convert all of x again);
//   * f32 x at M > 16 (mixed_gemm_mma_kernel): 128 x 128 tiles for 8 warps;
//     each tile's codes are dequantized once, by the whole block, into a
//     bf16 tile in shared memory, which every warp reads with ldmatrix, x
//     converted to bf16 the same way.
// What the W8A8 kernels do (the same bounds, int8 products at twice the
// bf16 rate, no dequantization): both compute y^T = W^T x^T, the codes as
// the A operand from registers.  The codes are (K, N) with N contiguous,
// but an s8 A fragment wants four K-rows of one column in a register: a
// thread owns two adjacent columns (its A rows gr and gr + 8), so one
// 16-bit load per code row feeds both, and byte permutes put four rows in
// order (AFragS8); the code tiles are 64 columns of 128 K-rows in the
// 64-byte swizzle mode, so that a warp's loads hit no bank twice.  A
// 128-deep K-tile never spans two groups (group % 128 == 0), so a group's
// s32 sums end on a tile edge, where they are rescaled into f32.
//   * M > 16 (int8_gemm_wgmma_kernel): a block owns 64 columns and up to
//     256 rows of a mixed step (two consumer warpgroups of 128 rows: an s32
//     partial and an f32 sum of 64 registers each), so each code byte is
//     read from memory once per GEMM; wgmma m64n128k32 with B = x^T K-major
//     straight from TMA's 128-byte-swizzled tile, scale-d = 0 on a group's
//     first k-step to start the group's sum; a producer thread keeps a
//     4-stage ring full by TMA (x, codes, both scale rows).  Where 256-row
//     blocks would leave SMs idle (N < 64 x the SM count), blocks of 128
//     rows, the two row blocks of a column block neighbours in the launch
//     order (the code slab read from memory once, from L2 twice).  No
//     split-K: splits that added partial sums would change the last bit.
//     The rescale, which a warpgroup does not overlap with its own products,
//     holds much of the time at a mixed step (the conversion of the s32 sums
//     is the exact magic-number add, not cvt, for groups of at most 256);
//     keeping two groups' sums in flight, so that one group's rescale ran
//     under the next group's products, made ptxas serialize every wgmma
//     (C7514, C7515).
//   * M <= 16 (int8_gemm_mma_kernel): mma.sync m16n8k32, B = x^T as one or
//     two n8 tiles of x rows, 64 columns a block (224 blocks at N =
//     14336), an 8-stage cp.async ring (~56 KB of codes in flight a block).
//
// Ragged M, N and K edges are masked here (rows >= M and columns >= N are
// loaded as zeros and never stored; a group that BK does not divide ends in
// a partial tile, zero-filled), so any M, any N and K = G * group work.
// Loads whose source is not 16-byte aligned (odd N, odd K) go through
// registers byte by byte; the rest by cp.async, TMA or (decode rows) 16-byte
// loads into registers.
//
// Every C entry point launches on the caller's stream, allocates nothing
// (the caller passes the split-K workspace, which also holds f16 x rounded
// to bf16, and the decode kernel's tickets), and returns cudaGetLastError()
// after its launches.

#include "hopper.cuh"

namespace {

constexpr int kPad = 16;  // bytes of padding after every shared-memory row

// 16 bytes from global to shared memory: by cp.async when the source is
// 16-byte aligned and all `valid` bytes are there, zeros when none is, else
// byte by byte with zeros past `valid`
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, bool aligned,
                                       int valid) {
  if (aligned && valid >= 16) {
    cp_async16(dst, src);
  } else if (valid <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b) dst[b] = b < valid ? src[b] : 0;
  }
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
    copy16(dst + r * dst_stride + c, src + r * src_stride + c, aligned,
           r < valid_rows ? valid_bytes - c : 0);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as one register of packed bf16: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// a packed f16 pair rounded to a packed bf16 pair (f16 -> f32 is exact)
__device__ __forceinline__ uint32_t half2_to_bf16x2(uint32_t w) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  return pack_bf16(f.x, f.y);
}
__device__ __forceinline__ uint4 half8_to_bf16(uint4 u) {
  return make_uint4(half2_to_bf16x2(u.x), half2_to_bf16x2(u.y), half2_to_bf16x2(u.z),
                    half2_to_bf16x2(u.w));
}

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

// f32 x, M > 16: 128 x 128 tiles, 8 warps of 64 x 32, two blocks per SM;
// each K-tile's codes are dequantized once, by the whole block, into a bf16
// tile in shared memory ([k][n], read with ldmatrix.trans), and the staged
// f32 x is rounded into a bf16 tile ([m][k], read with ldmatrix).  bf16 x
// at M > 16 runs mixed_gemm_wgmma_kernel below; the dispatch is on dtype.
template <int BITS>
struct MmaSmem {
  static constexpr int BM = 128, BN = 128, BK = 64, WM = 2, WN = 4, STAGES = 3;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int kXRow = BK * 4 + kPad;  // staged f32 x
  static constexpr int kCRows = BK * Pack<BITS>::num / Pack<BITS>::den;
  static constexpr int kCRow = BN + kPad;
  static constexpr int kStage = BM * kXRow + kCRows * kCRow + BN * 4;
  static constexpr int kWRow = (BN + 8) * 2;   // bf16 weight tile row: 272 bytes
  static constexpr int kXbRow = (BK + 8) * 2;  // bf16 x tile row: 144 bytes
  static constexpr int kBytes = STAGES * kStage + BK * kWRow + BM * kXbRow;
};

template <int BITS>
__global__ void __launch_bounds__(MmaSmem<BITS>::kThreads)
    mixed_gemm_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                          const float* __restrict__ scales, float* __restrict__ out,
                          float* __restrict__ ws, int M, int N, int K, int group, int splits) {
  using L = MmaSmem<BITS>;
  constexpr int BM = L::BM, BN = L::BN, BK = L::BK, MT = L::MT, NT = L::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wtile = smem + L::STAGES * L::kStage;
  uint8_t* xtile = wtile + BK * L::kWRow;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int g_lo, g_hi;
  split_groups(K, group, splits, g_lo, g_hi);
  const int tiles = (g_hi - g_lo) * ((group + BK - 1) / BK);
  auto load = [&](int t) {
    load_mixed_tile<float, BITS, BM, BN, BK>(smem + (t % L::STAGES) * L::kStage, L::kXRow,
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
    for (int p = threadIdx.x; p < BM * BK / 4; p += L::kThreads) {
      const int m = p / (BK / 4), k = (p % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(st + m * L::kXRow + k * 4);
      *reinterpret_cast<uint2*>(xtile + m * L::kXbRow + k * 2) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * (BM / L::WM) + i * 16 + (lane & 15);
        ldmatrix_x4(a[i], xtile + r * L::kXbRow + (ks + (lane >> 4) * 8) * 2);
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
  store_acc<float, MT, NT>(acc, out, ws, splits, M, N, m0 + wm * (BM / L::WM),
                           n0 + wn * (BN / L::WN));
}

// ---------------------------------------------------------------------------
// bf16 x, M > 16: wgmma, with the weight dequantized into registers
// ---------------------------------------------------------------------------

// The dequantized bf16 pairs (k, k+1) (k even) of columns c (p0, scale
// s.x) and c + 1 (p1, scale s.y), c even, of a staged code tile (128-byte
// rows, swizzled: sw128): one 16-bit load per code row gives both columns.
// Each value is code * scale in f32, rounded once to f32 and once to bf16,
// as _mixed_gemm_kernel computes it.
template <int BITS>
__device__ __forceinline__ void w_pairs(const uint8_t* cs, int k, int c, float2 s, uint32_t& p0,
                                        uint32_t& p1);

template <>
__device__ __forceinline__ void w_pairs<8>(const uint8_t* cs, int k, int c, float2 s,
                                           uint32_t& p0, uint32_t& p1) {
  const uint32_t u0 = *reinterpret_cast<const uint16_t*>(cs + sw128(k, c));
  const uint32_t u1 = *reinterpret_cast<const uint16_t*>(cs + sw128(k + 1, c));
  p0 = pack_bf16(__fmul_rn(sbyte(u0, 0), s.x), __fmul_rn(sbyte(u1, 0), s.x));
  p1 = pack_bf16(__fmul_rn(sbyte(u0, 1), s.y), __fmul_rn(sbyte(u1, 1), s.y));
}

template <>
__device__ __forceinline__ void w_pairs<4>(const uint8_t* cs, int k, int c, float2 s,
                                           uint32_t& p0, uint32_t& p1) {
  const uint32_t u = *reinterpret_cast<const uint16_t*>(cs + sw128(k >> 1, c));
  const int b0 = (int8_t)(u & 255), b1 = (int8_t)(u >> 8);  // K-rows k (low), k+1 (high)
  p0 = pack_bf16(__fmul_rn((float)(((b0 & 15) ^ 8) - 8), s.x), __fmul_rn((float)(b0 >> 4), s.x));
  p1 = pack_bf16(__fmul_rn((float)(((b1 & 15) ^ 8) - 8), s.y), __fmul_rn((float)(b1 >> 4), s.y));
}

// fp6 code c times s: c's five magnitude bits placed at bit 21 of an f32
// read as (1 + m/4) 2^(e - 127), or m 2^-128 when e = 0 (an f32
// subnormal), so one exact product by 2^124 gives fp6_value(c); then one
// rounded product by s, as fp6_value(c) * s
__device__ __forceinline__ float fp6_times(uint32_t c, float s) {
  const float v = __uint_as_float((c & 32) << 26 | (c & 31) << 21);
  return __fmul_rn(__fmul_rn(v, 0x1p124f), s);
}

// fp6: K-rows 4q..4q+3 of a column are bits 0-5, 6-11, 12-17, 18-23 of its
// code bytes (b0 | b1 << 8 | b2 << 16) at rows 3q..3q+2; the pair k, k+1
// (k % 4 = 0 or 2) lies in the 16 bits of code rows 3q + r, 3q + r + 1,
// r = (k % 4) / 2, from bit (k % 4) * 2
template <>
__device__ __forceinline__ void w_pairs<6>(const uint8_t* cs, int k, int c, float2 s,
                                           uint32_t& p0, uint32_t& p1) {
  const int r = (k >> 2) * 3 + ((k & 3) >> 1);
  const uint32_t ua = *reinterpret_cast<const uint16_t*>(cs + sw128(r, c));
  const uint32_t ub = *reinterpret_cast<const uint16_t*>(cs + sw128(r + 1, c));
  const int sh = (k & 3) * 2;
  const uint32_t v0 = (ua & 255) | (ub & 255) << 8, v1 = ua >> 8 | (ub & 0xff00);
  p0 = pack_bf16(fp6_times(v0 >> sh, s.x), fp6_times(v0 >> (sh + 6), s.x));
  p1 = pack_bf16(fp6_times(v1 >> sh, s.y), fp6_times(v1 >> (sh + 6), s.y));
}

// y^T = W^T x^T per block: BN = 128 output columns (two consumer
// warpgroups of 64, the wgmma M) by BM = 64 NSUB rows of x (the wgmma N,
// NSUB m64n64k16 products per 16-deep k-step), K in 64-deep tiles through
// a ring of STAGES stages filled by a producer warpgroup.  A stage holds
// the x tile (BM rows of 64 K-elements) and the code tile (kCRows rows of
// BN codes), both as 128-byte rows in the 128-byte swizzle mode (sw128),
// then the group's scale row.  Where the global layout allows it (TMA:
// 16-byte aligned rows, K-tiles inside one group) one thread fills a stage
// with three TMA copies; elsewhere the producer's 128 threads copy 16-byte
// chunks into the same layout (cp.async, or bytes for unaligned rows).
template <int BITS, int NSUB>
struct WgSmem {
  static constexpr int kConsumers = 2;  // warpgroups
  static constexpr int BN = 64 * kConsumers, BM = 64 * NSUB, BK = 64, STAGES = 4;
  static constexpr int kLag = 2;  // tiles the cp.async producer keeps in flight
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kXBytes = BM * BK * 2;
  static constexpr int kCRows = BK * Pack<BITS>::num / Pack<BITS>::den;
  static constexpr int kCBytes = kCRows * BN;
  static constexpr int kTmaBytes = kXBytes + kCBytes + BN * 4;  // a stage's copies
  static constexpr int kStage = (kTmaBytes + 1023) / 1024 * 1024;
  // + full and empty barriers, + slack to align the ring to 1024 bytes
  static constexpr int kBytes = STAGES * kStage + 2 * STAGES * 8 + 1024;
  static_assert(BK * 2 == 128 && BN == 128 && kCRows % 16 == 0 && kLag < STAGES,
                "128-byte rows");
};

// OT, y's type: __nv_bfloat16, or __half for f16 x (which launch_mixed
// has rounded to bf16 first)
template <typename OT, int BITS, int NSUB>
__global__ void __launch_bounds__(WgSmem<BITS, NSUB>::kThreads, 1)
    mixed_gemm_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                            const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                            OT* __restrict__ out, float* __restrict__ ws, int M, int N,
                            int K, int group, int splits, const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_c,
                            const __grid_constant__ CUtensorMap tm_s, int use_tma) {
  using L = WgSmem<BITS, NSUB>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::STAGES * L::kStage);
  uint64_t* empty = full + L::STAGES;
  const int n0 = blockIdx.x * L::BN, m0 = blockIdx.y * L::BM;
  const int rows = min(L::BM, M - m0);
  int g_lo, g_hi;
  split_groups(K, group, splits, g_lo, g_hi);
  const int tpg = (group + L::BK - 1) / L::BK;  // K-tiles per group
  const int tiles = (g_hi - g_lo) * tpg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // x rows past M stay zero in every stage (TMA writes its own zeros);
  // full[s] counts the TMA thread or the producer's 128 threads, empty[s]
  // the consumer warps
  if (!use_tma)
    for (int i = threadIdx.x; i < L::STAGES * (L::BM - rows) * 8; i += blockDim.x) {
      const int st = i / ((L::BM - rows) * 8), r = i % ((L::BM - rows) * 8);
      *reinterpret_cast<uint4*>(smem + st * L::kStage + (rows + r / 8) * 128 + (r % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], use_tma ? 1 : 128);
      mbar_init(&empty[s], 4 * L::kConsumers);
    }
    mbar_init_fence();
  }
  fence_proxy_async();  // the zeros, for wgmma's reads
  __syncthreads();

  if (warp >= 4 * L::kConsumers) {
    // producer: tile t into stage t % STAGES once the consumers released
    // it; a stage is announced (full) when its copies have landed
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int p = threadIdx.x - 128 * L::kConsumers;
    if (use_tma) {  // one thread: x, codes and scale row by TMA
      if (p != 0) return;
      for (int t = 0; t < tiles; ++t) {
        const int st = t % L::STAGES;
        if (t >= L::STAGES) mbar_wait(&empty[st], (t / L::STAGES - 1) & 1);
        uint8_t* sp = smem + st * L::kStage;
        const int g = g_lo + t / tpg, k0 = g * group + (t % tpg) * L::BK;
        mbar_expect_tx(&full[st], L::kTmaBytes);
        tma_load(sp, &tm_x, &full[st], k0, m0);
        tma_load(sp + L::kXBytes, &tm_c, &full[st], n0, k0 * Pack<BITS>::num / Pack<BITS>::den);
        tma_load(sp + L::kXBytes + L::kCBytes, &tm_s, &full[st], n0, g);
      }
      return;
    }
    // cp.async: thread p moves x chunks 2cc + (p & 1) of rows p / 2 + 64 j,
    // code chunk p % 8 of code rows p / 8 + 16 i, and scale chunk p (p <
    // 32): fixed for the whole walk, so no address needs a division
    const long long xstride = (long long)K * 2;
    const uint8_t* xrow = reinterpret_cast<const uint8_t*>(x + (long long)(m0 + (p >> 1)) * K);
    const bool x_al = ((reinterpret_cast<uintptr_t>(x) | (uintptr_t)xstride) & 15) == 0;
    const int ccol = (p & 7) * 16, cvalid = N - n0 - ccol;
    const uint8_t* ccodes = codes + n0 + ccol;
    const bool c_al = ((reinterpret_cast<uintptr_t>(codes) | (uintptr_t)N) & 15) == 0;
    const uint8_t* cscales = reinterpret_cast<const uint8_t*>(scales + n0) + 16 * p;
    const int svalid = (N - n0) * 4 - 16 * p;
    const bool s_al = ((reinterpret_cast<uintptr_t>(scales) | (uintptr_t)N * 4) & 15) == 0;
    for (int t = 0; t < tiles; ++t) {
      const int st = t % L::STAGES;
      if (t >= L::STAGES) mbar_wait(&empty[st], (t / L::STAGES - 1) & 1);
      uint8_t* sp = smem + st * L::kStage;
      const int g = g_lo + t / tpg, kin = (t % tpg) * L::BK;
      const int k0 = g * group + kin, vk = min(L::BK, group - kin);
      const bool xa = x_al && (k0 & 7) == 0;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        const int m = (p >> 1) + 64 * j;
        if (m >= rows) break;
#pragma unroll
        for (int cc = 0; cc < L::BK / 16; ++cc) {
          const int c = 2 * cc + (p & 1);
          copy16(sp + sw128(m, 16 * c), xrow + 64 * j * xstride + (k0 + 8 * c) * 2, xa,
                 (vk - 8 * c) * 2);
        }
      }
      const long long crow = (long long)k0 * Pack<BITS>::num / Pack<BITS>::den;
      const int vrows = vk * Pack<BITS>::num / Pack<BITS>::den;
#pragma unroll
      for (int i = 0; i < L::kCRows / 16; ++i) {
        const int r = (p >> 3) + 16 * i;
        copy16(sp + L::kXBytes + sw128(r, ccol), ccodes + (crow + r) * N, c_al,
               r < vrows ? cvalid : 0);
      }
      if (p < L::BN / 4)
        copy16(sp + L::kXBytes + L::kCBytes + 16 * p, cscales + (long long)g * N * 4, s_al,
               svalid);
      cp_async_commit();
      if (t >= L::kLag) {
        cp_async_wait<L::kLag>();
        fence_proxy_async();
        mbar_arrive(&full[(t - L::kLag) % L::STAGES]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int t = max(0, tiles - L::kLag); t < tiles; ++t) mbar_arrive(&full[t % L::STAGES]);
    return;
  }

  // consumers: warp wl of warpgroup wg owns the block's columns c0 = 64 wg +
  // 16 wl + 2 gr and c0 + 1 as the A rows gr and gr + 8 of its 16, so one
  // 16-bit load per code row gives both, and the stores write column pairs
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wl = warp & 3, gr = lane >> 2, tq = lane & 3;
  const int c0 = wg * 64 + wl * 16 + 2 * gr;
  float d[NSUB][32];
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[sb][i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int st = t % L::STAGES;
    mbar_wait(&full[st], (t / L::STAGES) & 1);
    __syncwarp();
    const uint8_t* sp = smem + st * L::kStage;
    const uint8_t* cs = sp + L::kXBytes;
    const float2 sc = *reinterpret_cast<const float2*>(cs + L::kCBytes + c0 * 4);
    // A = W^T of the tile's four k-steps, dequantized into registers
    uint32_t a[L::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk) {
      const int k = kk * 16 + 2 * tq;
      w_pairs<BITS>(cs, k, c0, sc, a[kk][0], a[kk][1]);
      w_pairs<BITS>(cs, k + 8, c0, sc, a[kk][2], a[kk][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk)
#pragma unroll
      for (int sb = 0; sb < NSUB; ++sb)
        wgmma_m64n64k16(d[sb], a[kk], sw128_desc(sp + 64 * 128 * sb + 32 * kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sb = 0; sb < NSUB; ++sb) fence_acc(d[sb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  // d[sb][4j + h] and d[sb][4j + 2 + h] are columns c0, c0 + 1 of x row
  // 64 sb + 8j + 2tq + h: to `out` when the K range is whole, else as f32
  // partial sums to split blockIdx.z of `ws`
  const int n = n0 + c0;
  const bool pair = n + 1 < N && (N & 1) == 0;
  float* part = ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * sb + 8 * j + 2 * tq + h;
        if (m >= M || n >= N) continue;
        const float v0 = d[sb][4 * j + h], v1 = d[sb][4 * j + 2 + h];
        const long long at = (long long)m * N + n;
        if (splits == 1) {
          if (pair) {
            store_pair(out + at, v0, v1);
          } else {
            out[at] = from_float<OT>(v0);
            if (n + 1 < N) out[at + 1] = from_float<OT>(v1);
          }
        } else if (pair) {
          *reinterpret_cast<float2*>(part + at) = make_float2(v0, v1);
        } else {
          part[at] = v0;
          if (n + 1 < N) part[at + 1] = v1;
        }
      }
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

// f16 x above 16 rows: x (n values) rounded to bf16 into xb, the workspace
// that mixed_gemm_wgmma_kernel then reads as bf16 x; 8 values a thread-step
// where both are 16-byte aligned
__global__ void round_x_bf16_kernel(const __half* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                                    long long n, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    done = n / 8 * 8;
    for (long long i = i0; i < n / 8; i += stride)
      reinterpret_cast<uint4*>(xb)[i] = half8_to_bf16(__ldg(reinterpret_cast<const uint4*>(x) + i));
  }
  for (long long i = done + i0; i < n; i += stride) xb[i] = __float2bfloat16(__half2float(x[i]));
}

// where ws holds the bf16 copy of f16 x, in floats: after the split-K sums,
// 16-byte aligned
inline long long round_x_offset(int M, int N, int splits) {
  return splits > 1 ? ((long long)splits * M * N + 3) / 4 * 4 : 0;
}

// ---------------------------------------------------------------------------
// decode rows (M <= 16): mixed_gemm_decode_kernel
// ---------------------------------------------------------------------------

// y^T = W^T x^T on mma.sync m16n8k16 over 128-column tiles of y and their
// K-steps, 16 K-rows each: a group of `group` rows is ceil(group / 16)
// steps, the last one partial when 16 does not divide it (its rows past the
// group read as zeros, codes and x).  Block b takes the steps [b T S / B,
// (b + 1) T S / B) of the T tiles' S steps in tile order, a tile at a time;
// its 8 warps take contiguous shares of a tile's steps; every warp owns
// all 128 columns, thread (gr, tq) of a warp the 16 adjacent columns
// c = 16 gr .. + 15, as the A rows gr (its column 2t) and gr + 8 (column
// 2t + 1) of the eight m16 tiles t.  So one 16-byte load per code row feeds
// all eight tiles, and the sums of a thread end as 16 adjacent columns of
// its x rows 2tq, 2tq + 1 (+ 8).  The codes go from global memory straight
// into registers (read once, not kept in L1), each step issued one step
// ahead of its use; x's B fragments (x rows gr, gr + 8) are read from L1.
// Where the rows are 16-byte aligned and 16 divides the group, the steps
// follow each other in memory and the loads walk running pointers; else
// every row is checked against its group and N (byte loads off the grid).
struct Dec {
  static constexpr int BN = 128;    // columns per tile (and per warp)
  static constexpr int kWarps = 8;  // per block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStep = 16;  // K-rows per step (the mma's k)
  static constexpr int kStages = 2;  // register sets: a step in flight while one is used
  static constexpr int kFinal = 8;   // partial sums the last block loads at once
  // shared memory of the warps' sums: kWarps x 32 NT x 32 floats
  static constexpr int smem(int nt) { return kWarps * 32 * nt * 32 * 4; }
};

// The code rows a thread loads for one step (kRegs rows of its 16 columns),
// as offsets from the step's first code row (K-row k0: int4 k0 even, fp6
// k0 % 4 == 0), and the first K-row of each, from k0, which decides whether
// it lies inside the step's group.
template <int BITS>
struct DecRows;
template <>
struct DecRows<8> {  // K-rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9
  static constexpr int kRegs = 4;
  static __device__ __forceinline__ int row(int i, int tq) {
    return 2 * tq + (i & 1) + 8 * (i >> 1);
  }
  static __device__ __forceinline__ int krow(int i, int tq) { return row(i, tq); }
};
template <>
struct DecRows<4> {  // byte rows tq, tq + 4: K-rows 2tq, 2tq + 1 and 8 further
  static constexpr int kRegs = 2;
  static __device__ __forceinline__ int row(int i, int tq) { return tq + 4 * i; }
  static __device__ __forceinline__ int krow(int i, int tq) { return 2 * tq + 8 * i; }
};
template <>
struct DecRows<6> {  // the two byte rows of K-rows 2tq, 2tq + 1 (and 8 further)
  static constexpr int kRegs = 4;
  static __device__ __forceinline__ int row(int i, int tq) {
    return 3 * (tq >> 1) + (tq & 1) + (i & 1) + 6 * (i >> 1);
  }
  static __device__ __forceinline__ int krow(int i, int tq) { return 2 * tq + 8 * (i >> 1); }
};


// x elements k, k + 1 of one row (nullptr: a row past M) as packed bf16, 0
// from kend on
__device__ __forceinline__ float x_value(const float* row, int k) { return row[k]; }
__device__ __forceinline__ float x_value(const __nv_bfloat16* row, int k) {
  return __bfloat162float(row[k]);
}
__device__ __forceinline__ float x_value(const __half* row, int k) {
  return __half2float(row[k]);
}
template <typename XT>
__device__ __forceinline__ uint32_t x_frag(const XT* row, int k, int kend, bool vec) {
  if (row == nullptr) return 0;
  if (vec && k + 1 < kend) {
    if constexpr (std::is_same<XT, __nv_bfloat16>::value) {
      return __ldg(reinterpret_cast<const unsigned int*>(row + k));
    } else if constexpr (std::is_same<XT, __half>::value) {
      return half2_to_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(row + k)));
    } else {
      const float2 v = __ldg(reinterpret_cast<const float2*>(row + k));
      return pack_bf16(v.x, v.y);
    }
  }
  return pack_bf16(k < kend ? x_value(row, k) : 0.f, k + 1 < kend ? x_value(row, k + 1) : 0.f);
}

// Exact f32 codes without conversion instructions.  int8: byte b of w, its
// sign bit flipped (w ^ 0x80808080), in the mantissa of 2^23: 2^23 + code +
// 128, less 2^23 + 128.
__device__ __forceinline__ float i8_value(uint32_t w, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + b)), 8388736.0f);
}
// int4 low nibble (w & 0x0F0F0F0F) ^ 0x08080808: 2^23 + code + 8, less 2^23 + 8
__device__ __forceinline__ float i4_lo(uint32_t l, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540 + b)), 8388616.0f);
}
// int4 high nibble (w & 0xF0F0F0F0) ^ 0x80808080: 2^23 + 16 (code + 8), by
// 1/16 less 2^19 + 8 in one fma whose exact result is the code
__device__ __forceinline__ float i4_hi(uint32_t h, int b) {
  return __fmaf_rn(__uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540 + b)), 0.0625f,
                   -524296.0f);
}
// fp6: t holds two columns' codes of K-rows k (bits 0-5) and k + 1 (bits
// 6-11), one column per 16-bit half.  The code of K-row k (second = false)
// or k + 1 of both columns as bf16 bit patterns: sign at bit 15, the five
// bits e m at bits 5-9, which reads as fp6 * 2^-124 (as fp6_times places
// them, a subnormal when e = 0).  Its halves as f32: x << 16, x & 0xFFFF0000.
__device__ __forceinline__ uint32_t fp6_bits(uint32_t t, bool second) {
  return second ? ((t >> 1) & 0x03E003E0u) | ((t << 4) & 0x80008000u)
                : ((t << 5) & 0x03E003E0u) | ((t << 10) & 0x80008000u);
}
// v * s for an fp6 pattern v: `fast`, the scale holds s * 2^124 (exact, s <
// 16), one rounded product of the exact fp6 * s; else two, as fp6_times
__device__ __forceinline__ float fp6_scaled(uint32_t v, float s, bool fast) {
  const float f = __uint_as_float(v);
  return fast ? __fmul_rn(f, s) : __fmul_rn(__fmul_rn(f, 0x1p124f), s);
}

// One step's products: the A fragments of the eight tiles from the codes c
// (rows as DecRows) and the scales sc of the thread's 16 columns (fp6,
// `fast`: times 2^124), each element code * scale in f32 rounded to bf16;
// then acc[t][j] += A_t B_j.
template <int BITS, int NT>
__device__ __forceinline__ void decode_step(const uint32_t (&c)[DecRows<BITS>::kRegs][4],
                                            const float (&sc)[16], bool fast, int tq,
                                            const uint32_t (&b)[NT][2], float (&acc)[8][NT][4]) {
  if constexpr (BITS == 8) {
    uint32_t w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[i][q] = c[i][q] ^ 0x80808080u;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int q = t >> 1, b0 = 2 * (t & 1);
      const float s0 = sc[2 * t], s1 = sc[2 * t + 1];
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // K-rows 2tq, 2tq + 1, then 8 further
        a[2 * h] = pack_bf16(__fmul_rn(i8_value(w[2 * h][q], b0), s0),
                             __fmul_rn(i8_value(w[2 * h + 1][q], b0), s0));
        a[2 * h + 1] = pack_bf16(__fmul_rn(i8_value(w[2 * h][q], b0 + 1), s1),
                                 __fmul_rn(i8_value(w[2 * h + 1][q], b0 + 1), s1));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[t][j], a, b[j][0], b[j][1]);
    }
  } else if constexpr (BITS == 4) {
    uint32_t lo[2][4], hi[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lo[i][q] = (c[i][q] & 0x0F0F0F0Fu) ^ 0x08080808u;
        hi[i][q] = (c[i][q] & 0xF0F0F0F0u) ^ 0x80808080u;
      }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int q = t >> 1, b0 = 2 * (t & 1);
      const float s0 = sc[2 * t], s1 = sc[2 * t + 1];
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // byte row tq (K-rows 2tq, 2tq + 1), then tq + 4
        a[2 * h] = pack_bf16(__fmul_rn(i4_lo(lo[h][q], b0), s0),
                             __fmul_rn(i4_hi(hi[h][q], b0), s0));
        a[2 * h + 1] = pack_bf16(__fmul_rn(i4_lo(lo[h][q], b0 + 1), s1),
                                 __fmul_rn(i4_hi(hi[h][q], b0 + 1), s1));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[t][j], a, b[j][0], b[j][1]);
    }
  } else {
    // the two byte rows of a K-row pair hold its codes at bit sh of each
    // column's 16 bits (b_row | b_row+1 << 8): sh = 0 for K-rows 4q, 4q + 1,
    // 4 for 4q + 2, 4q + 3
    const int sh = 4 * (tq & 1);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int q = t >> 1;
      const float s0 = sc[2 * t], s1 = sc[2 * t + 1];
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // columns 2t (low half) and 2t + 1 (high half): bytes 2(t & 1) and
        // 2(t & 1) + 1 of both rows' word q
        const uint32_t u = __byte_perm(c[2 * h][q], c[2 * h + 1][q], (t & 1) ? 0x7362 : 0x5140);
        const uint32_t x0 = fp6_bits(u >> sh, false), x1 = fp6_bits(u >> sh, true);
        a[2 * h] = pack_bf16(fp6_scaled(x0 << 16, s0, fast), fp6_scaled(x1 << 16, s0, fast));
        a[2 * h + 1] = pack_bf16(fp6_scaled(x0 & 0xFFFF0000u, s1, fast),
                                 fp6_scaled(x1 & 0xFFFF0000u, s1, fast));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[t][j], a, b[j][0], b[j][1]);
    }
  }
}

// 16 bytes that are read once: kept out of L1, where x stays
__device__ __forceinline__ void ld_stream(uint32_t (&v)[4], const uint8_t* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "l"(p));
}

// A code row's 16 bytes at p (columns col .. col + 15; `valid` of them
// inside N): one 16-byte load where the rows are 16-byte aligned (then all
// 16 or none are valid), else byte by byte; zeros for a row outside the step
__device__ __forceinline__ void load_code_row(uint32_t (&v)[4], const uint8_t* p, bool aligned,
                                              int valid, bool row_ok) {
  if (row_ok && aligned && valid >= 16) {
    ld_stream(v, p);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = 0;
  if (!row_ok || aligned) return;
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (c < valid) v[c >> 2] |= (uint32_t)p[c] << (8 * (c & 3));
}

// A warp's place in its share of the K-steps: step u, in group g, from the
// group's K-row kin; next() walks on without a division.
struct DecPos {
  int u, g, kin;
  __device__ __forceinline__ DecPos(int u0, int upg)
      : u(u0), g(u0 / upg), kin((u0 - u0 / upg * upg) * Dec::kStep) {}
  __device__ __forceinline__ void next(int group) {
    ++u;
    kin += Dec::kStep;
    if (kin >= group) {
      kin = 0;
      ++g;
    }
  }
};


// Built with -DDS_DECODE_TRACE (scripts/torch_b6_decode_trace.py, never the
// library the port loads), thread 0 of every decode block stamps
// %globaltimer at its start (0), its first step's products (1), the end of
// its warps' steps (2), its stores (3), its ticket (4), a shared tile's
// sum (5), and its SM (7), the last segment's stamps winning; the entry
// ds_decode_trace reads or clears them.
#ifdef DS_DECODE_TRACE
__device__ unsigned long long g_decode_trace[4096 * 8];
__device__ __forceinline__ void dec_mark(int i, bool once = false) {
  if (threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long* p = g_decode_trace + 8 * (blockIdx.x & 4095);
  if (!(once && p[i] != 0)) p[i] = t;
  if (i == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    p[7] = smid;
  }
}
#else
__device__ __forceinline__ void dec_mark(int, bool = false) {}
#endif

// one more on the ticket at p: an acquire-release atomic at GPU scope;
// returns the count before it
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// the registers of one step in flight: its code rows and x's B fragments
template <int BITS, int NT>
struct DecStage {
  uint32_t c[DecRows<BITS>::kRegs][4];
  uint32_t b[NT][2];
};

// y[m, n .. n + 1] (v0, v1; n + 1 only where < N) in T: a pair store where
// N is even (n is)
template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1, int n, int N) {
  if ((N & 1) == 0 && n + 1 < N) {
    store_pair(p, v0, v1);
  } else {
    p[0] = from_float<T>(v0);
    if (n + 1 < N) p[1] = from_float<T>(v1);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// y[m, n .. n + 3] (those < N) in T: two pair stores where N is even
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v, int n, int N) {
  if (n < N) store2(p, v.x, v.y, n, N);
  if (n + 2 < N) store2(p + 2, v.z, v.w, n + 2, N);
}

template <typename XT, int BITS, int NT>
__global__ void __launch_bounds__(Dec::kThreads, NT == 1 ? 2 : 1)
    mixed_gemm_decode_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                             const float* __restrict__ scales, XT* __restrict__ out,
                             float* __restrict__ ws, int* __restrict__ tickets, int M, int N,
                             int K, int group, int aligned, int xvec) {
  using R = DecRows<BITS>;
  extern __shared__ __align__(16) float red[];  // [warp][t][j][e][lane]
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int upg = (group + Dec::kStep - 1) / Dec::kStep, steps = (K / group) * upg;
  // block b's share of the tiles' steps, in tile order: [start_of(b), start_of(b + 1))
  const int tiles = (N + Dec::BN - 1) / Dec::BN, nb = gridDim.x;
  const long long all = (long long)tiles * steps;
  auto start_of = [&](int b) { return (long long)b * all / nb; };
  auto block_of = [&](long long l) {  // the block whose share holds step l
    return (int)(((l + 1) * nb + all - 1) / all - 1);
  };
  const XT* xrow[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) xrow[j] = gr + 8 * j < M ? x + (long long)(gr + 8 * j) * K : nullptr;
  dec_mark(0);

  const long long l_start = start_of(blockIdx.x);
  for (long long l = l_start, l_end = start_of(blockIdx.x + 1); l < l_end;) {
    // one tile's segment [s_lo, s_hi) of the share; a tile that several
    // blocks share has its segments' sums added by the last to finish
    const int tile = (int)(l / steps), s_lo = (int)(l - (long long)tile * steps);
    const int s_hi = (int)min((long long)steps, s_lo + (l_end - l));
    const bool first = l == l_start;  // the block's first segment
    l += s_hi - s_lo;
    const int col = tile * Dec::BN + 16 * gr;  // the thread's first column
    const int u_lo = s_lo + warp * (s_hi - s_lo) / Dec::kWarps;
    const int u_hi = s_lo + (warp + 1) * (s_hi - s_lo) / Dec::kWarps;
    const uint8_t* ccol = codes + col;

    // step p's code rows and B fragments into st (nothing past the warp's share)
    auto issue = [&](DecStage<BITS, NT>& st, const DecPos& p) {
      if (p.u >= u_hi) return;
      const int k0 = p.g * group + p.kin, vk = min(Dec::kStep, group - p.kin);
      const long long row0 = (long long)k0 * Pack<BITS>::num / Pack<BITS>::den;
#pragma unroll
      for (int i = 0; i < R::kRegs; ++i)
        load_code_row(st.c[i], ccol + (row0 + R::row(i, tq)) * N, aligned, N - col,
                      R::krow(i, tq) < vk);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        st.b[j][0] = x_frag(xrow[j], k0 + 2 * tq, k0 + vk, xvec);
        st.b[j][1] = x_frag(xrow[j], k0 + 2 * tq + 8, k0 + vk, xvec);
      }
    };

    float acc[8][NT][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
    float sc[16];
    int gcur = -1;
    bool fast = true;
    // step cp's products from the registers of st: first the group's scales
    // of the thread's columns when the group changes
    auto compute = [&](const DecStage<BITS, NT>& st, const DecPos& cp) {
      const int g = cp.g;
      if (g != gcur) {
        gcur = g;
        const float* sp = scales + (long long)g * N + col;
        if (aligned && col < N) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(sp) + q);
            sc[4 * q] = v.x;
            sc[4 * q + 1] = v.y;
            sc[4 * q + 2] = v.z;
            sc[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c) sc[c] = col + c < N ? sp[c] : 0.f;
        }
        if constexpr (BITS == 6) {  // s * 2^124 is exact for every s < 16
          bool small = true;
#pragma unroll
          for (int c = 0; c < 16; ++c) small = small && sc[c] < 16.f;
          fast = __all_sync(0xffffffffu, small);
          if (fast)
#pragma unroll
            for (int c = 0; c < 16; ++c) sc[c] = __fmul_rn(sc[c], 0x1p124f);
        }
      }
      decode_step<BITS, NT>(st.c, sc, fast, tq, st.b, acc);
      dec_mark(1, true);
    };

    DecPos ld(u_lo, upg), cp = ld;  // loaded, computed
    DecStage<BITS, NT> st[Dec::kStages];
    if (aligned && xvec && group % Dec::kStep == 0) {
      // every step whole and the next one's rows right after it: running
      // pointers, no bounds but the ragged columns and x's rows
      constexpr int kStepRows = Dec::kStep * Pack<BITS>::num / Pack<BITS>::den;
      const long long step_bytes = (long long)kStepRows * N;
      const uint8_t* cptr = ccol + (long long)u_lo * step_bytes;
      int roff[R::kRegs];
#pragma unroll
      for (int i = 0; i < R::kRegs; ++i) roff[i] = R::row(i, tq) * N;
      const XT* xp[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        xp[j] = xrow[j] == nullptr ? nullptr : xrow[j] + u_lo * Dec::kStep + 2 * tq;
      const bool cols_ok = col < N;
      auto issue_fast = [&](DecStage<BITS, NT>& st, int u) {
        if (u < u_hi) {
#pragma unroll
          for (int i = 0; i < R::kRegs; ++i) {
            if (cols_ok) {
              ld_stream(st.c[i], cptr + roff[i]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) st.c[i][q] = 0;
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            st.b[j][0] = x_frag(xp[j], 0, 2, true);
            st.b[j][1] = x_frag(xp[j], 8, 10, true);
            if (xp[j] != nullptr) xp[j] += Dec::kStep;
          }
        }
        cptr += step_bytes;
      };
#pragma unroll
      for (int s = 0; s + 1 < Dec::kStages; ++s) issue_fast(st[s], u_lo + s);
      for (int base = u_lo; base < u_hi; base += Dec::kStages) {
#pragma unroll
        for (int s = 0; s < Dec::kStages; ++s) {
          if (base + s >= u_hi) break;
          issue_fast(st[(s + Dec::kStages - 1) % Dec::kStages], base + s + Dec::kStages - 1);
          compute(st[s], cp);
          cp.next(group);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s + 1 < Dec::kStages; ++s) {
        issue(st[s], ld);
        ld.next(group);
      }
      while (cp.u < u_hi) {
#pragma unroll
        for (int s = 0; s < Dec::kStages; ++s) {
          if (cp.u >= u_hi) break;
          issue(st[(s + Dec::kStages - 1) % Dec::kStages], ld);
          ld.next(group);
          compute(st[s], cp);
          cp.next(group);
        }
      }
    }

    // the warps' sums meet in shared memory; warp w adds tile t = w of every
    // warp's in warp order: thread lane then holds y rows 8j + 2tq + h,
    // columns n = col + 2t and n + 1
    float* mine = red + warp * (8 * NT * 4 * 32) + lane;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((t * NT + j) * 4 + e) * 32] = acc[t][j][e];
    __syncthreads();
    dec_mark(2);
    const int t = warp, n = col + 2 * t;
    float v[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* p = red + ((t * NT + j) * 4 + e) * 32 + lane;
        float s = p[0];
#pragma unroll
        for (int w = 1; w < Dec::kWarps; ++w) s = __fadd_rn(s, p[w * (8 * NT * 4 * 32)]);
        v[j][e] = s;
      }
    const long long t0 = (long long)tile * steps;
    const int b_first = block_of(t0), b_last = block_of(t0 + steps - 1);
    // a segment's partial sums: slot 2b (the block's first segment) or 2b +
    // 1 (its last), M rows of the tile's 128 columns.  The tile is the first
    // segment of every block after b_first, and b_first's first too when
    // its share starts with the tile.
    const int nt = n - tile * Dec::BN;
    const int first_slot = 2 * b_first + (start_of(b_first) == t0 ? 0 : 1);
    auto slot = [&](int s) { return ws + (long long)s * M * Dec::BN; };
    float* mine_part = slot(2 * blockIdx.x + (first ? 0 : 1));
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * j + 2 * tq + h;
        if (m >= M || n >= N) continue;
        if (b_first == b_last)
          store2(out + (long long)m * N + n, v[j][h], v[j][2 + h], n, N);
        else
          store2(mine_part + m * Dec::BN + nt, v[j][h], v[j][2 + h], n, N);
      }
    dec_mark(3);
    if (b_first != b_last) {
      // The barrier orders every thread's stores before thread 0's ticket,
      // an acquire-release atomic at GPU scope, which orders them before the
      // last block's loads, and the other blocks' stores before them through
      // its acquire and the second barrier.
      __syncthreads();
      if (threadIdx.x == 0) last = ticket_add(tickets + tile) == b_last - b_first;
      __syncthreads();
      dec_mark(4);
      if (last) {
        // add the segments in block order (deterministic): thread i takes
        // row i / 32 (and every 8th after it) at columns 4 (i % 32) .. + 3
        // of the tile, one 16-byte load per segment, kFinal in flight
        const int c4 = 4 * lane, n4 = tile * Dec::BN + c4;
        for (int m = warp; m < M; m += Dec::kWarps) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int b0 = b_first; b0 <= b_last; b0 += Dec::kFinal) {
            float4 a[Dec::kFinal];
#pragma unroll
            for (int i = 0; i < Dec::kFinal; ++i) {
              const int b = b0 + i;
              a[i] = b <= b_last ? __ldcg(reinterpret_cast<const float4*>(
                                       slot(b == b_first ? first_slot : 2 * b) + m * Dec::BN + c4))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int i = 0; i < Dec::kFinal; ++i)
              if (b0 + i <= b_last) sum = b0 + i == b_first ? a[i] : add4(sum, a[i]);
          }
          store4(out + (long long)m * N + n4, sum, n4, N);
        }
        if (threadIdx.x == 0) tickets[tile] = 0;  // for the stream's next launch
        dec_mark(5);
      }
    }
    __syncthreads();  // the sums' shared memory and `last` serve the next segment
  }
}

// ---------------------------------------------------------------------------
// W8A8 int8 GEMM: y^T = W^T x^T, s8 x s8 -> s32 per group, then the rescale
// ---------------------------------------------------------------------------

// byte c (< 64) of row r of a 64-byte-row tile in the 64-byte swizzle mode
// (TMA's CU_TENSOR_MAP_SWIZZLE_64B on a 512-byte-aligned tile; the
// cp.async copies of int8_gemm_mma_kernel write the same layout): the
// 16-byte chunk j of row r stored at chunk j ^ ((r / 2) % 4)
__device__ __forceinline__ int sw64(int r, int c) {
  return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// The s8 A fragment of W^T for one 32-deep k-step at K-row k0 of a staged
// code tile (64 columns, sw64), as AFragS8::load reads it: the A rows gr
// and gr + 8 of the warp's 16 are the tile's columns c and c + 1 (c even),
// so one 16-bit load per code row gives both.  a[0] and a[1] hold K-rows k0 + 4tq .. + 3 of columns c
// and c + 1, a[2] and a[3] the same 16 rows further on (the m16n8k32 A
// layout, and wgmma's per warp), the lowest K in the lowest byte, packed by
// byte permutes.  Threads with tq >= 2 load their four rows in the order
// 2, 3, 0, 1: then the warp's four row groups of each load fall in four
// different 16-byte bank groups of the swizzled tile.  The byte offsets of
// a thread's four code rows 4 tq + (i + rot) % 4, rot = tq & 2, at column c
// are computed once: a row 16 further on is 1024 bytes further on (its
// swizzle is the same), so they serve every k-step.
struct AFragS8 {
  int off[4];
  __device__ __forceinline__ AFragS8(int c, int tq) {
#pragma unroll
    for (int i = 0; i < 4; ++i) off[i] = sw64(4 * tq + ((i + (tq & 2)) & 3), c);
  }
  // the fragment of the k-step at K-row k0 (k0 % 32 == 0)
  __device__ __forceinline__ void load(const uint8_t* cs, int k0, int tq,
                                       uint32_t (&a)[4]) const {
    const bool rot = (tq & 2) != 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* base = cs + 64 * (k0 + 16 * h);
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = *reinterpret_cast<const uint16_t*>(base + off[i]);
      const uint32_t p = __byte_perm(u[0], u[1], 0x5410), q = __byte_perm(u[2], u[3], 0x5410);
      const uint32_t r01 = rot ? q : p, r23 = rot ? p : q;  // K-rows 0, 1 and 2, 3
      a[2 * h] = __byte_perm(r01, r23, 0x6420);             // column c
      a[2 * h + 1] = __byte_perm(r01, r23, 0x7531);         // column c + 1
    }
  }
};

// f32(i) of a group's s32 sum.  SMALL (a group of at most 256 int8 x int8
// products, each at most 2^14 in size, so |i| <= 2^22): i added to the bits
// of 1.5 * 2^23 stays in its mantissa, and the exact difference with 1.5 *
// 2^23 is i, an integer add and a float add at the full rate where
// cvt.rn.f32.s32 runs at a quarter of it; else cvt.rn.f32.s32.
template <bool SMALL>
__device__ __forceinline__ float group_sum_f32(int i) {
  if (SMALL) return __fsub_rn(__int_as_float(0x4B400000 + i), 12582912.0f);
  return (float)i;
}

// acc += f32(i) * xs * ws with no contraction, the plain version's order
template <bool SMALL>
__device__ __forceinline__ float rescale(float acc, int i, float xs, float ws) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(group_sum_f32<SMALL>(i), xs), ws));
}

// The wgmma kernel's rescale of a warpgroup's NSUB x 32 sums: d[sb][4j + h]
// and d[sb][4j + 2 + h] are columns c, c + 1 (scales w) of the warpgroup's
// row 64 sb + 8j + 2tq + h (scale xs[that row]).
template <bool SMALL, int NSUB>
__device__ __forceinline__ void rescale_group(float (&acc)[NSUB][32], const int (&d)[NSUB][32],
                                              const float* xs, float2 w, int tq) {
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + 64 * sb + 8 * j + 2 * tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float xh = h ? xv.y : xv.x;
        acc[sb][4 * j + h] = rescale<SMALL>(acc[sb][4 * j + h], d[sb][4 * j + h], xh, w.x);
        acc[sb][4 * j + 2 + h] =
            rescale<SMALL>(acc[sb][4 * j + 2 + h], d[sb][4 * j + 2 + h], xh, w.y);
      }
    }
}

// Stores the s8 kernels' results: v[4j + h] and v[4j + 2 + h] are columns
// n, n + 1 of row m0 + 8j + 2tq + h, j < J.
template <typename XT, int J>
__device__ __forceinline__ void store_i8(XT* out, const float* v, int M, int N, int m0, int n,
                                         int tq) {
  if (n >= N) return;
  const bool pair = n + 1 < N && (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * tq + h;
      if (m >= M) continue;
      XT* p = out + (long long)m * N + n;
      if (pair) {
        store_pair(p, v[4 * j + h], v[4 * j + 2 + h]);
      } else {
        p[0] = from_float<XT>(v[4 * j + h]);
        if (n + 1 < N) p[1] = from_float<XT>(v[4 * j + 2 + h]);
      }
    }
}

// D[64 x 64] (+)= A[64 x 32] . B[32 x 64], s8 -> s32: A from registers
// (AFragS8 per warp), B K-major in shared memory (sw128_desc); `acc` 0
// starts a new sum (wgmma's scale-d), 1 adds to d.  d's layout is
// wgmma_m64n64k16's.
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// The same on m64n128k32: d[4j .. 4j + 3] for j < 16, the layout of two
// m64n64k32 products side by side.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// M > 16 (int8_gemm_wgmma_kernel): a block owns BN = 64 output columns and
// BM = 2 RW rows of x, RW = 64 NSUB per consumer warpgroup (one m64n64k32
// or m64n128k32 product per 32-deep k-step), K in 128-deep tiles through a
// ring of STAGES stages that one producer thread fills by TMA: the x tile
// (BM rows of 128 codes, sw128, wgmma's B), the code tile (128 K-rows of 64
// codes, sw64, read into the A registers by both warpgroups), the group's
// x-scale row (BM) and w-scale row (BN).
template <int NSUB>
struct I8Wg {
  static constexpr int kConsumers = 2;  // warpgroups, RW rows each
  static constexpr int BN = 64, RW = 64 * NSUB, BM = RW * kConsumers, BK = 128, STAGES = 4;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kXBytes = BM * BK;
  static constexpr int kCBytes = BK * BN;
  static constexpr int kTmaBytes = kXBytes + kCBytes + BM * 4 + BN * 4;  // a stage's copies
  static constexpr int kStage = (kTmaBytes + 1023) / 1024 * 1024;
  // + full and empty barriers, + slack to align the ring to 1024 bytes
  static constexpr int kBytes = STAGES * kStage + 2 * STAGES * 8 + 1024;
};

template <typename XT, int NSUB>
__global__ void __launch_bounds__(I8Wg<NSUB>::kThreads, 1)
    int8_gemm_wgmma_kernel(XT* __restrict__ out, int M, int N, int K, int group,
                           const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_c,
                           const __grid_constant__ CUtensorMap tm_xs,
                           const __grid_constant__ CUtensorMap tm_ws) {
  using L = I8Wg<NSUB>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::STAGES * L::kStage);
  uint64_t* empty = full + L::STAGES;
  // the row blocks of a column block are neighbours in the launch order, so
  // that they share its code slab in L2
  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const int tpg = group / L::BK, tiles = K / L::BK;  // K-tiles per group, in all
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * L::kConsumers) {
    // producer: tile t into stage t % STAGES once the consumers released
    // it; the stage is announced (full) when its four copies have landed
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 128 * L::kConsumers) return;
    for (int t = 0; t < tiles; ++t) {
      const int st = t % L::STAGES, g = t / tpg;
      if (t >= L::STAGES) mbar_wait(&empty[st], (t / L::STAGES - 1) & 1);
      uint8_t* sp = smem + st * L::kStage;
      mbar_expect_tx(&full[st], L::kTmaBytes);
      tma_load(sp, &tm_x, &full[st], t * L::BK, m0);
      tma_load(sp + L::kXBytes, &tm_c, &full[st], n0, t * L::BK);
      tma_load(sp + L::kXBytes + L::kCBytes, &tm_xs, &full[st], m0, g);
      tma_load(sp + L::kXBytes + L::kCBytes + L::BM * 4, &tm_ws, &full[st], n0, g);
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + wg RW .. + RW; warp wl the
  // block's columns c = 16 wl + 2 gr and c + 1 as its A rows gr and gr + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wl = warp & 3, gr = lane >> 2, tq = lane & 3;
  const int c = wl * 16 + 2 * gr;
  const AFragS8 afrag(c, tq);
  int d[NSUB][32];  // the group's exact s32 sums
  float acc[NSUB][32];
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      d[sb][i] = 0;
      acc[sb][i] = 0.f;
    }

  for (int t = 0; t < tiles; ++t) {
    const int st = t % L::STAGES;
    mbar_wait(&full[st], (t / L::STAGES) & 1);
    const uint8_t* sp = smem + st * L::kStage;
    const uint8_t* cs = sp + L::kXBytes;
    uint32_t a[L::BK / 32][4];
#pragma unroll
    for (int kk = 0; kk < L::BK / 32; ++kk) afrag.load(cs, 32 * kk, tq, a[kk]);
    const int carry = t % tpg != 0;  // 0: the tile starts a group, a new sum
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BK / 32; ++kk) {
      const uint64_t b = sw128_desc(sp + wg * L::RW * 128 + 32 * kk);
      if constexpr (NSUB == 2)  // the warpgroup's 128 rows in one product
        wgmma_s8_m64n128k32(reinterpret_cast<int(&)[64]>(d), a[kk], b, kk == 0 ? carry : 1);
      else
        wgmma_s8_m64n64k32(d[0], a[kk], b, kk == 0 ? carry : 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sb = 0; sb < NSUB; ++sb) fence_acc(d[sb]);
    if ((t + 1) % tpg == 0) {  // the group is complete: rescale into acc
      const float* xs = reinterpret_cast<const float*>(cs + L::kCBytes);
      const float2 w = *reinterpret_cast<const float2*>(xs + L::BM + c);
      if (tpg <= 2)
        rescale_group<true>(acc, d, xs + wg * L::RW, w, tq);
      else
        rescale_group<false>(acc, d, xs + wg * L::RW, w, tq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }
#pragma unroll
  for (int sb = 0; sb < NSUB; ++sb)
    store_i8<XT, 8>(out, acc[sb], M, N, m0 + wg * L::RW + 64 * sb, n0 + c, tq);
}

// M <= 16, and rows TMA cannot take (int8_gemm_mma_kernel): the same swapped
// form on mma.sync m16n8k32, 4 warps, BN = 64 columns (16 a warp, c = 16 wl
// + 2 gr and c + 1 as its A rows gr and gr + 8), BM = 16 rows of x per
// block (NT n8 tiles of B = x^T), K in 128-deep tiles through a cp.async
// ring of STAGES stages: the code tile (128 K-rows of 64 codes, sw64), the
// x tile (16 rows of 128 codes), the group's x-scale row (16) and w-scale
// row (64).
struct I8Mma {
  static constexpr int BN = 64, BM = 16, BK = 128, STAGES = 8, kThreads = 128;
  static constexpr int kXRow = BK + kPad;  // conflict-free B fragment loads
  static constexpr int kCBytes = BK * BN;
  static constexpr int kXBytes = BM * kXRow;
  static constexpr int kStage = (kCBytes + kXBytes + BM * 4 + BN * 4 + 127) / 128 * 128;
  static constexpr int kBytes = STAGES * kStage + 128;  // + slack to align to 128 bytes
};

template <typename XT, int NT>
__global__ void __launch_bounds__(I8Mma::kThreads)
    int8_gemm_mma_kernel(const int8_t* __restrict__ xc, const float* __restrict__ xs_t,
                         int xs_pitch, const int8_t* __restrict__ wc,
                         const float* __restrict__ ws, XT* __restrict__ out, int M, int N,
                         int K, int group) {
  using L = I8Mma;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const int n0 = blockIdx.x * L::BN, m0 = blockIdx.y * L::BM;
  const int tpg = group / L::BK, tiles = K / L::BK;
  const int tid = threadIdx.x;
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(wc);
  const bool c_al = ((reinterpret_cast<uintptr_t>(wc) | (uintptr_t)N) & 15) == 0;
  const bool s_al = ((reinterpret_cast<uintptr_t>(ws) | (uintptr_t)N * 4) & 15) == 0;
  const bool x_al = (reinterpret_cast<uintptr_t>(xc) & 15) == 0;  // K % 128 == 0
  const bool xs_al = (reinterpret_cast<uintptr_t>(xs_t) & 15) == 0;  // pitch % 4 == 0

  // thread tid copies code chunks tid + 128 i (row (tid + 128 i) / 4, chunk
  // tid % 4), x chunk tid (row tid / 8, chunk tid % 8), and one scale chunk
  // (tid < 4: x scales, 4 <= tid < 20: w scales)
  auto load = [&](int t) {
    uint8_t* sp = smem + (t % L::STAGES) * L::kStage;
    const int k0 = t * L::BK, g = t / tpg;
    const int ch = tid & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 2) + 32 * i;
      copy16(sp + sw64(r, 16 * ch), codes + (long long)(k0 + r) * N + n0 + 16 * ch, c_al,
             N - n0 - 16 * ch);
    }
    const int xr = tid >> 3, xch = tid & 7;
    copy16(sp + L::kCBytes + xr * L::kXRow + 16 * xch,
           reinterpret_cast<const uint8_t*>(xc) + (long long)(m0 + xr) * K + k0 + 16 * xch,
           x_al, m0 + xr < M ? 16 : 0);
    uint8_t* ss = sp + L::kCBytes + L::kXBytes;
    if (tid < 4)
      copy16(ss + 16 * tid,
             reinterpret_cast<const uint8_t*>(xs_t + (long long)g * xs_pitch + m0 + 4 * tid),
             xs_al, (M - m0 - 4 * tid) * 4);
    else if (tid < 20)
      copy16(ss + L::BM * 4 + 16 * (tid - 4),
             reinterpret_cast<const uint8_t*>(ws + (long long)g * N + n0 + 4 * (tid - 4)), s_al,
             (N - n0 - 4 * (tid - 4)) * 4);
  };

  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int c = warp * 16 + 2 * gr;
  const AFragS8 afrag(c, tq);
  int iacc[NT][4];
  float acc[NT * 4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      iacc[j][e] = 0;
      acc[4 * j + e] = 0.f;
    }

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + L::STAGES - 1 < tiles) load(t + L::STAGES - 1);
    cp_async_commit();

    const uint8_t* cs = smem + (t % L::STAGES) * L::kStage;
    const uint8_t* xsm = cs + L::kCBytes;
#pragma unroll
    for (int kk = 0; kk < L::BK / 32; ++kk) {
      uint32_t a[4];
      afrag.load(cs, 32 * kk, tq, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B = x^T: K-rows 4tq .. + 3 (and 16 more) of x row 8j + gr
        const uint8_t* xr = xsm + (8 * j + gr) * L::kXRow + 32 * kk + 4 * tq;
        mma_s8(iacc[j], a, *reinterpret_cast<const uint32_t*>(xr),
               *reinterpret_cast<const uint32_t*>(xr + 16));
      }
    }
    if ((t + 1) % tpg == 0) {  // the group is complete: rescale
      const float* xs = reinterpret_cast<const float*>(xsm + L::kXBytes);
      const float w0 = xs[L::BM + c], w1 = xs[L::BM + c + 1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xh = xs[8 * j + 2 * tq + h];
          acc[4 * j + h] = rescale<false>(acc[4 * j + h], iacc[j][h], xh, w0);
          acc[4 * j + 2 + h] = rescale<false>(acc[4 * j + 2 + h], iacc[j][2 + h], xh, w1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[j][e] = 0;
      }
    }
  }
  cp_async_wait<0>();
  store_i8<XT, NT>(out, acc, M, N, m0, n0 + c, tq);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kDecodeM = 16;  // rows that run mixed_gemm_decode_kernel

// decode rows: one n8 tile of x rows up to M = 8, two up to 16; 16-byte
// code loads where the code and scale rows are 16-byte aligned, bytes
// elsewhere; x pairs by one load where x's rows allow it
template <typename XT, int BITS, int NT>
cudaError_t launch_decode(const XT* x, const uint8_t* codes, const float* scales, XT* out,
                          float* ws, int* tickets, int M, int N, int K, int group, int blocks,
                          cudaStream_t st) {
  auto kernel = mixed_gemm_decode_kernel<XT, BITS, NT>;
  static cudaError_t attr = allow_smem(kernel, Dec::smem(NT));  // once per instantiation
  if (attr != cudaSuccess) return attr;
  const int aligned =
      ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(scales)) & 15) == 0 &&
      N % 16 == 0;
  const int xvec = reinterpret_cast<uintptr_t>(x) % (2 * sizeof(XT)) == 0 && K % 2 == 0;
  kernel<<<blocks, Dec::kThreads, Dec::smem(NT), st>>>(x, codes, scales, out, ws, tickets, M,
                                                        N, K, group, aligned, xvec);
  return cudaGetLastError();
}

// TMA takes x, the codes and the scales when their rows are 16-byte
// aligned and no K-tile spans two groups; other shapes are copied by the
// producer's threads (an explicit choice by shape, the same result)
template <typename OT, int BITS, int NSUB>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* codes, const float* scales,
                         OT* out, float* ws, int M, int N, int K, int group, int splits,
                         cudaStream_t st) {
  using L = WgSmem<BITS, NSUB>;
  auto kernel = mixed_gemm_wgmma_kernel<OT, BITS, NSUB>;
  static cudaError_t attr = allow_smem(kernel, L::kBytes);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_x{}, tm_c{}, tm_s{};
  const bool use_tma =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(codes) |
        reinterpret_cast<uintptr_t>(scales)) & 15) == 0 &&
      K % 8 == 0 && N % 16 == 0 && group % L::BK == 0;
  if (use_tma) {
    const uint64_t code_rows = (uint64_t)K * Pack<BITS>::num / Pack<BITS>::den;
    if (!tile_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, L::BK,
                  L::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tile_map(&tm_c, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, code_rows, N, L::BN,
                  L::kCRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tile_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, N, K / group,
                  (uint64_t)N * 4, L::BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  }
  const dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM, splits);
  kernel<<<grid, L::kThreads, L::kBytes, st>>>(x, codes, scales, out, ws, M, N, K, group, splits,
                                                tm_x, tm_c, tm_s, use_tma);
  return cudaSuccess;
}

template <typename XT, int BITS>
cudaError_t launch_mixed(const void* x, const void* codes, const void* scales, void* out,
                         float* ws, int* tickets, int M, int N, int K, int group, int splits,
                         cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* sp = static_cast<const float*>(scales);
  XT* op = static_cast<XT*>(out);
  if (M <= kDecodeM)  // the split-K sums are added inside the kernel
    return M <= 8 ? launch_decode<XT, BITS, 1>(xp, cp, sp, op, ws, tickets, M, N, K, group,
                                               splits, st)
                  : launch_decode<XT, BITS, 2>(xp, cp, sp, op, ws, tickets, M, N, K, group,
                                               splits, st);
  if constexpr (sizeof(XT) == 2) {  // bf16, f16: wgmma, 128 or 256 rows per block
    const __nv_bfloat16* xb;
    if constexpr (std::is_same<XT, __half>::value) {  // f16 x, rounded to bf16 first
      __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(ws + round_x_offset(M, N, splits));
      const long long n = (long long)M * K;
      const int vec = ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(xw)) &
                       15) == 0;
      const long long chunks = (vec ? n / 8 : n) + 255;
      round_x_bf16_kernel<<<(int)(chunks / 256 < 1056 ? chunks / 256 : 1056), 256, 0, st>>>(
          xp, xw, n, vec);
      xb = xw;
    } else {
      xb = xp;
    }
    const cudaError_t attr =
        M <= 128 ? launch_wgmma<XT, BITS, 2>(xb, cp, sp, op, ws, M, N, K, group, splits, st)
                 : launch_wgmma<XT, BITS, 4>(xb, cp, sp, op, ws, M, N, K, group, splits, st);
    if (attr != cudaSuccess) return attr;
  } else {  // f32: mma.sync
    using L = MmaSmem<BITS>;
    auto kernel = mixed_gemm_mma_kernel<BITS>;
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

// W8A8 on wgmma: every operand by TMA (x codes, the codes, both scale rows)
template <typename XT, int NSUB>
cudaError_t launch_int8_wgmma(const int8_t* xc, const float* xs_t, int xs_pitch,
                              const int8_t* wc, const float* ws, XT* out, int M, int N, int K,
                              int group, cudaStream_t st) {
  using L = I8Wg<NSUB>;
  auto kernel = int8_gemm_wgmma_kernel<XT, NSUB>;
  static cudaError_t attr = allow_smem(kernel, L::kBytes);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_x{}, tm_c{}, tm_xs{}, tm_ws{};
  if (!tile_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, xc, K, M, K, L::BK, L::BM,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&tm_c, CU_TENSOR_MAP_DATA_TYPE_UINT8, wc, N, K, N, L::BN, L::BK,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tile_map(&tm_xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xs_t, M, K / group,
                (uint64_t)xs_pitch * 4, L::BM, 1, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tile_map(&tm_ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, N, K / group, (uint64_t)N * 4,
                L::BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid((M + L::BM - 1) / L::BM, (N + L::BN - 1) / L::BN);
  kernel<<<grid, L::kThreads, L::kBytes, st>>>(out, M, N, K, group, tm_x, tm_c, tm_xs, tm_ws);
  return cudaGetLastError();
}

template <typename XT, int NT>
cudaError_t launch_int8_mma(const int8_t* xc, const float* xs_t, int xs_pitch, const int8_t* wc,
                            const float* ws, XT* out, int M, int N, int K, int group,
                            cudaStream_t st) {
  auto kernel = int8_gemm_mma_kernel<XT, NT>;
  static cudaError_t attr = allow_smem(kernel, I8Mma::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + I8Mma::BN - 1) / I8Mma::BN, (M + I8Mma::BM - 1) / I8Mma::BM);
  kernel<<<grid, I8Mma::kThreads, I8Mma::kBytes, st>>>(xc, xs_t, xs_pitch, wc, ws, out, M, N, K,
                                                       group);
  return cudaGetLastError();
}

// wgmma: 256 rows a block where its blocks fill the card's SMs (a mixed
// step's 256 rows at N >= 64 SMs columns: each code byte read once), else
// 128 (M <= 128, or too few column blocks: twice the blocks, the code slab
// read by two neighbours); mma.sync: one n8 tile of x rows up to M = 8,
// else two
template <typename XT>
cudaError_t dispatch_int8(int wgmma, const void* xc, const void* xs_t, int xs_pitch,
                          const void* wc, const void* ws, void* out, int M, int N, int K,
                          int group, cudaStream_t st) {
  const int8_t* x = static_cast<const int8_t*>(xc);
  const float* xs = static_cast<const float*>(xs_t);
  const int8_t* w = static_cast<const int8_t*>(wc);
  const float* s = static_cast<const float*>(ws);
  XT* o = static_cast<XT*>(out);
  if (wgmma) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long blocks256 =
        (long long)((M + 255) / 256) * ((N + I8Wg<2>::BN - 1) / I8Wg<2>::BN);
    return M > 128 && blocks256 >= sms
               ? launch_int8_wgmma<XT, 2>(x, xs, xs_pitch, w, s, o, M, N, K, group, st)
               : launch_int8_wgmma<XT, 1>(x, xs, xs_pitch, w, s, o, M, N, K, group, st);
  }
  return M <= 8 ? launch_int8_mma<XT, 1>(x, xs, xs_pitch, w, s, o, M, N, K, group, st)
                : launch_int8_mma<XT, 2>(x, xs, xs_pitch, w, s, o, M, N, K, group, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16 (x and out); bits: 8, 4 or 6.  codes and scales
// as in the header; K = (K / group) * group.  Above 16 rows, splits (1 <=
// splits <= K / group) shares the K-groups among blockIdx.z, and with
// splits > 1 ws is an f32 workspace of splits * M * N; f16 x there also
// takes M * K bf16 in ws, after those sums rounded up to 16 bytes (from
// offset 0 when splits = 1), where x is rounded to bf16 before the wgmma
// kernel runs.  At M <= 16, splits
// is the decode kernel's block count B (1 <= B <= tiles * steps, tiles =
// ceil(N / 128), steps = K / group * ceil(group / 16)): block b takes
// steps [b * tiles * steps / B, (b + 1) * tiles * steps / B) of the
// tiles' steps in tile order; with B > 1, ws is an f32 workspace of 2 B *
// M * 128 and tickets a zero int per tile, which the launch leaves zero
// (one buffer per stream serves its launches in turn).  There a group
// starts on a code byte: int4 groups are even and fp6 groups a multiple
// of 4, unless there is one group.
extern "C" int ds_mixed_gemm(int dtype, int bits, const void* x, const void* codes,
                             const void* scales, void* out, void* ws, void* tickets, int M, int N,
                             int K, int group, int splits, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (M == 0 || N == 0) return cudaSuccess;
  if (group <= 0 || K % group != 0 || splits < 1) return cudaErrorInvalidValue;
  if (M <= kDecodeM) {
    const long long steps = (long long)(K / group) * ((group + Dec::kStep - 1) / Dec::kStep);
    if (splits > (N + Dec::BN - 1) / Dec::BN * steps ||
        (splits > 1 && (ws == nullptr || tickets == nullptr)) ||
        (K > group && ((bits == 4 && group % 2 != 0) || (bits == 6 && group % 4 != 0))))
      return cudaErrorInvalidValue;
  } else if (splits > K / group || ((splits > 1 || dtype == 2) && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  int* tp = static_cast<int*>(tickets);
#define DS_MIXED(T, B) \
  return (int)launch_mixed<T, B>(x, codes, scales, out, wsp, tp, M, N, K, group, splits, st)
  if (dtype == 1) {
    if (bits == 8) DS_MIXED(__nv_bfloat16, 8);
    if (bits == 4) DS_MIXED(__nv_bfloat16, 4);
    if (bits == 6) DS_MIXED(__nv_bfloat16, 6);
  }
  if (dtype == 2) {
    if (bits == 8) DS_MIXED(__half, 8);
    if (bits == 4) DS_MIXED(__half, 4);
    if (bits == 6) DS_MIXED(__half, 6);
  }
  if (dtype == 0) {
    if (bits == 8) DS_MIXED(float, 8);
    if (bits == 4) DS_MIXED(float, 4);
    if (bits == 6) DS_MIXED(float, 6);
  }
#undef DS_MIXED
  return cudaErrorInvalidValue;
}

#ifdef DS_DECODE_TRACE
// the decode blocks' stamps (4096 x 8 u64) into dst, or cleared (clear)
extern "C" int ds_decode_trace(void* dst, int clear) {
  static unsigned long long zeros[4096 * 8];
  if (clear) return (int)cudaMemcpyToSymbol(g_decode_trace, zeros, sizeof(zeros));
  return (int)cudaMemcpyFromSymbol(dst, g_decode_trace, sizeof(zeros));
}
#endif

// W8A8: xc int8 (M, K), xs_t f32 (K/group, M) in rows xs_pitch >= M
// elements apart (xs_pitch % 4 == 0), wc int8 (K, N), ws f32 (K/group, N);
// group a multiple of 128; out in dtype (0 = f32, 1 = bf16, 2 = f16).
// wgmma = 1 runs int8_gemm_wgmma_kernel, which takes TMA's rows only (N %
// 16 == 0, all four arrays 16-byte aligned); wgmma = 0 runs
// int8_gemm_mma_kernel, which takes any N.
extern "C" int ds_int8_gemm(int dtype, int wgmma, const void* xc, const void* xs_t,
                            int xs_pitch, const void* wc, const void* ws, void* out, int M,
                            int N, int K, int group, void* stream) {
  cudaGetLastError();
  if (M == 0 || N == 0) return cudaSuccess;
  if (group <= 0 || group % 128 != 0 || K % group != 0 || xs_pitch < M || xs_pitch % 4 != 0)
    return cudaErrorInvalidValue;
  if (wgmma && (N % 16 != 0 || ((reinterpret_cast<uintptr_t>(xc) |
                                  reinterpret_cast<uintptr_t>(xs_t) |
                                  reinterpret_cast<uintptr_t>(wc) |
                                  reinterpret_cast<uintptr_t>(ws)) & 15) != 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_int8<__nv_bfloat16>(wgmma, xc, xs_t, xs_pitch, wc, ws, out, M, N, K,
                                             group, st);
  if (dtype == 2)
    return (int)dispatch_int8<__half>(wgmma, xc, xs_t, xs_pitch, wc, ws, out, M, N, K, group,
                                      st);
  if (dtype == 0)
    return (int)dispatch_int8<float>(wgmma, xc, xs_t, xs_pitch, wc, ws, out, M, N, K, group,
                                     st);
  return cudaErrorInvalidValue;
}
