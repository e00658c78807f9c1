// Grouped (per-expert) matmul for dropless MoE, written for Hopper (sm_90a).
//
//   grouped_matmul_wgmma_kernel,  replace
//   grouped_matmul_bf16_kernel,   deepspeed_tpu/ops/pallas/grouped_matmul.py
//   grouped_matmul_f32_kernel     _gmm_kernel (entry grouped_matmul):
//                          out[r] = lhs[r] @ W_e, e = tile_group[r / tile_m],
//                          W_e = rhs[e] read as (K, N), or with transposed = 1
//                          rhs[e] read as (N, K) and used transposed (the
//                          backward's dlhs = g @ rhs[e]^T, without a copy).
//                          f32 accumulation, the output in lhs's dtype.
//                          The dispatch (chosen by the wrapper, checked
//                          here) is on dtype, transposition and tile_m:
//                          bf16 or f16 on (K, N) weights with tile_m a
//                          multiple of 64 (dropless MoE's mixed steps) runs
//                          the wgmma kernel; bf16 or f16 at tile_m 16
//                          (decode bodies) or on transposed weights (the
//                          backward's dlhs) the mma.sync kernel; f32 the
//                          CUDA-core kernel.  f16 runs the bf16 kernels at
//                          E = __half (mma.sync and wgmma f16 -> f32): the
//                          products of f16 inputs are exact in f32 as
//                          bf16's are, so only the element type differs.
//
// lhs (M, K) holds rows in the tile-aligned layout: M is a multiple of
// tile_m and every tile_m-row tile belongs to one expert; tile_group is
// sorted, so an expert's tiles are contiguous.  Tiles at or past *used (the
// count of tiles that hold a group; null: all) hold only padding rows,
// which are zero: their output is written as zeros and no weights are read
// for them.  The layout always appends such tiles, clipped to expert E-1,
// and a kernel that computed them would stream that expert's weights again
// for nothing.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at Mixtral's width
// (E = 8, K x N = 4096 x 14336 or 14336 x 4096, bf16) a decode body routes
// 16 assignments, ~2 rows per touched expert, so each touched expert's 117
// MB of weights is read for ~4 flops per 2-byte element: bound by those
// bytes.  A 256-token mixed step gives ~64 rows per expert, still below the
// ~295 flops/byte ridge: bound by the bytes of all 8 experts (0.94 GB,
// 0.28 ms).  What the kernels do about that:
//   * wgmma kernel: a block owns (expert e, 128 output columns) and finds
//     e's first tile and tile count in tile_group itself (no host read, so
//     a decode body stays free of host syncs), so each weight byte is read
//     from memory once per GEMM when the expert has at most 256 rows (the
//     rows go in chunks of at most 256, usually one).  The swapped form
//     out_e^T = W_e^T lhs_e^T: W_e's columns are wgmma's M (two consumer
//     warpgroups of 64), the expert's rows its N in 64-row sub-tiles, only
//     as many as the chunk has (the tensor cores do no work on rows the
//     expert does not have).  A producer thread keeps a 4-stage ring full
//     by TMA; lhs feeds wgmma's B straight from its 128-byte-swizzled tile,
//     W_e's (K, N) tile the A registers through ldmatrix.trans (A from
//     registers needs no MN-major shared-memory descriptor).  One extra
//     row of blocks writes the all-padding tail's zeros.
//   * mma.sync kernel: bf16 through the tensor cores (m16n8k16, f32
//     accumulation), tiles staged with cp.async in a 4-stage ring; lhs read
//     with ldmatrix, the weight tile with ldmatrix.trans ((K, N): [k][n] in
//     shared memory) or ldmatrix ((N, K): [n][k]); BM = 16 row blocks for
//     the layout's 16-row tiles (decode: one mma row tile, 4 warps across
//     64 columns, ~450 blocks at decode for 132 SMs) and BM = 64 for the
//     transposed weights at 64-row tiles.
//   * f32 (the small models' path) on the CUDA cores: 4 x 4 outputs per
//     thread from shared-memory tiles, fmaf.
// Split-K and a persistent schedule are later work.
//
// The bf16 and f16 paths load 16-byte chunks: K and N multiples of 8 and 16-byte
// aligned tensors (the wrapper checks).  K and N edges are zero-filled and
// masked.  The C entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 64;       // K per pipeline stage (bf16)
constexpr int kStages = 4;
constexpr int kRow = (kBK + 8) * 2;  // bytes per shared row: 144 (conflict-free ldmatrix)
constexpr int kF32BK = 16;    // K per step (f32)

// The expert of this block's rows, or -1 when the tile is past the used
// ones (or names no expert): then the block only writes zeros.
__device__ __forceinline__ int block_expert(const int* tile_group, const int* used, int row0,
                                            int tile_m, int E) {
  const int tile = row0 / tile_m;
  if (used != nullptr && tile >= *used) return -1;
  const int e = tile_group[tile];
  return (e < 0 || e >= E) ? -1 : e;
}

template <typename T>
__device__ void write_zeros(T* out, int row0, int rows, int n0, int N) {
  for (int i = threadIdx.x; i < rows * kBN; i += blockDim.x) {
    const int r = row0 + i / kBN, c = n0 + i % kBN;
    if (c < N) out[(long long)r * N + c] = T(0.0f);
  }
}

// 16-byte chunk copy, or zeros where the chunk lies outside the matrix.
__device__ __forceinline__ void chunk(uint8_t* dst, const void* src, bool valid) {
  if (valid)
    cp_async16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// bf16 (or f16: E = __half) tensor-core kernel.  4 warps: BM = 16 -> 1 x
// 4 warps of 16 x 16; BM = 64 -> 2 x 2 warps of 32 x 32.
template <int BM, bool TRANS>
struct Bf16Tile {
  static constexpr int WM = BM == 16 ? 1 : 2, WN = 4 / WM;
  static constexpr int kThreads = 128;
  static constexpr int MT = BM / WM / 16, NT = kBN / WN / 8;
  static constexpr int kABytes = BM * kRow;
  static constexpr int kBBytes = (TRANS ? kBN : kBK) * kRow;
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kSmem = kStage * kStages;
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
};

template <typename ET, int BM, bool TRANS>
__global__ void __launch_bounds__(128)
    grouped_matmul_bf16_kernel(const ET* __restrict__ lhs, const ET* __restrict__ rhs,
                               const int* __restrict__ tile_group, const int* __restrict__ used,
                               ET* __restrict__ out, int N, int K, int E, int tile_m) {
  using L = Bf16Tile<BM, TRANS>;
  constexpr int MT = L::MT, NT = L::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * BM;
  const int e = block_expert(tile_group, used, row0, tile_m, E);
  if (e < 0) {
    write_zeros(out, row0, BM, n0, N);
    return;
  }
  const ET* a_src = lhs + (long long)row0 * K;
  const ET* w = rhs + (long long)e * K * N;
  const int nk = (K + kBK - 1) / kBK;

  auto load = [&](int t) {
    uint8_t* st = smem + (t % kStages) * L::kStage;
    const int k0 = t * kBK;
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += L::kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      chunk(st + r * kRow + c * 2, a_src + (long long)r * K + k0 + c, k0 + c < K);
    }
    uint8_t* bs = st + L::kABytes;
    for (int i = threadIdx.x; i < 64 * 8; i += L::kThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      if (TRANS)  // row r = column n0 + r of W, K contiguous
        chunk(bs + r * kRow + c * 2, w + (long long)(n0 + r) * K + k0 + c,
              n0 + r < N && k0 + c < K);
      else  // row r = K-row k0 + r, N contiguous
        chunk(bs + r * kRow + c * 2, w + (long long)(k0 + r) * N + n0 + c,
              k0 + r < K && n0 + c < N);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / L::WN, wn = warp % L::WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    cp_async_commit();
    const uint8_t* as = smem + (t % kStages) * L::kStage;
    const uint8_t* bs = as + L::kABytes;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * (BM / L::WM) + i * 16 + (lane & 15);
        ldmatrix_x4(a[i], as + r * kRow + (ks + (lane >> 4) * 8) * 2);
      }
      uint32_t b[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        if (TRANS) {  // [n][k]: plain ldmatrix gives the col-major B fragment
          const int n = wn * (kBN / L::WN) + jj * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int k = ks + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(r, bs + n * kRow + k * 2);
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        } else {  // [k][n]: transposed ldmatrix
          const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = wn * (kBN / L::WN) + jj * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(r, bs + k * kRow + n * 2);
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tc<ET>(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows gr and gr + 8 of the mma tile
        const int r = row0 + wm * (BM / L::WM) + i * 16 + gr + h * 8;
        const int c = n0 + wn * (kBN / L::WN) + j * 8 + tq * 2;
        if (c < N)  // N is even: the pair is whole
          store_pair(out + (long long)r * N + c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// f32 on the CUDA cores: (BM / 4) x 16 threads, 4 x 4 outputs each.
template <int BM, bool TRANS>
__global__ void __launch_bounds__(BM * 4)
    grouped_matmul_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                              const int* __restrict__ tile_group, const int* __restrict__ used,
                              float* __restrict__ out, int N, int K, int E, int tile_m) {
  constexpr int kThreads = BM * 4;
  __shared__ float as[kF32BK][BM];
  __shared__ float bs[kF32BK][kBN];
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * BM;
  const int e = block_expert(tile_group, used, row0, tile_m, E);
  if (e < 0) {
    write_zeros(out, row0, BM, n0, N);
    return;
  }
  const float* w = rhs + (long long)e * K * N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    for (int i = threadIdx.x; i < BM * kF32BK; i += kThreads) {
      const int r = i / kF32BK, c = i % kF32BK;
      as[c][r] = k0 + c < K ? lhs[(long long)(row0 + r) * K + k0 + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < kF32BK * kBN; i += kThreads) {
      if (TRANS) {  // n-major reads: K is contiguous
        const int r = i / kF32BK, c = i % kF32BK;
        bs[c][r] = (n0 + r < N && k0 + c < K) ? w[(long long)(n0 + r) * K + k0 + c] : 0.0f;
      } else {
        const int r = i / kBN, c = i % kBN;
        bs[r][c] = (k0 + r < K && n0 + c < N) ? w[(long long)(k0 + r) * N + n0 + c] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = as[kk][ty * 4 + q];
        b[q] = bs[kk][tx * 4 + q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (c < N) out[(long long)r * N + c] = acc[i][j];
    }
}

// bf16 or f16 (ET), rhs (E, K, N), tile_m a multiple of 64 (grouped_matmul_wgmma_kernel):
// out_e^T = W_e^T lhs_e^T per block of (expert e, BN = 128 output columns),
// two consumer warpgroups of 64 columns (the wgmma M) and the expert's rows
// in chunks of at most 256 (NSUB <= 4 m64n64k16 products per 16-deep
// k-step, as many as the chunk has 64-row sub-tiles: no products on rows
// the expert does not have), K in 64-deep tiles through a ring of STAGES
// stages that one producer thread fills by TMA: the chunk's lhs rows (NSUB
// boxes of 64 rows x 64 K, 128-byte swizzle, wgmma's B, K-major) and the
// expert's weight tile (two boxes of 64 K-rows x 64 columns, 128-byte
// swizzle), which each warp reads into its A registers with ldmatrix.trans.
struct GmmWg {
  static constexpr int kConsumers = 2;  // warpgroups, 64 columns each
  static constexpr int BN = 64 * kConsumers, BK = 64, MAXSUB = 4, STAGES = 4;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBox = 64 * BK * 2;  // one 64 x 64 bf16 box
  static constexpr int kXBytes = MAXSUB * kBox, kWBytes = kConsumers * kBox;
  static constexpr int kStage = kXBytes + kWBytes;
  // + full and empty barriers, + slack to align the ring to 1024 bytes
  static constexpr int kBytes = STAGES * kStage + 2 * STAGES * 8 + 1024;
  static_assert(kStage % 1024 == 0, "swizzle atoms stay 1024-byte aligned");
};

template <typename ET>
__global__ void __launch_bounds__(GmmWg::kThreads, 1)
    grouped_matmul_wgmma_kernel(ET* __restrict__ out,
                                const int* __restrict__ tile_group,
                                const int* __restrict__ used, int N, int K, int E, int ntiles,
                                int tile_m, const __grid_constant__ CUtensorMap tm_lhs,
                                const __grid_constant__ CUtensorMap tm_rhs) {
  using L = GmmWg;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::STAGES * L::kStage);
  uint64_t* empty = full + L::STAGES;
  __shared__ int s_before, s_mine;
  const int e = blockIdx.y, n0 = blockIdx.x * L::BN;
  // the tiles that hold a group: the first *used, or all
  const int lim = used != nullptr ? min(max(*used, 0), ntiles) : ntiles;
  if (e == E) {  // the all-padding tail [lim, ntiles): zeros, no weights read
    const long long r0 = (long long)lim * tile_m, rows = (long long)(ntiles - lim) * tile_m;
    for (long long i = threadIdx.x; i < rows * (L::BN / 8); i += blockDim.x) {
      const int n = n0 + (int)(i % (L::BN / 8)) * 8;
      if (n < N)
        *reinterpret_cast<uint4*>(out + (r0 + i / (L::BN / 8)) * N + n) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  // expert e's tiles among the first lim (tile_group is sorted): they
  // start after the tiles of experts < e
  if (threadIdx.x == 0) s_before = s_mine = 0;
  __syncthreads();
  int before = 0, mine = 0;
  for (int i = threadIdx.x; i < lim; i += blockDim.x) {
    const int g = tile_group[i];
    before += g < e;
    mine += g == e;
  }
  if (before) atomicAdd(&s_before, before);
  if (mine) atomicAdd(&s_mine, mine);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int row0 = s_before * tile_m, rows = s_mine * tile_m;  // rows % 64 == 0
  if (rows == 0) return;  // an expert with no rows
  const int ktiles = (K + L::BK - 1) / L::BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= 4 * L::kConsumers) {
    // producer: (chunk, K-tile) t into stage t % STAGES once the consumers
    // released it; announced (full) when its copies have landed
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 128 * L::kConsumers) return;
    int t = 0;
    for (int r = row0; r < row0 + rows; r += 64 * L::MAXSUB) {
      const int nsub = min(L::MAXSUB, (row0 + rows - r) / 64);
      for (int kt = 0; kt < ktiles; ++kt, ++t) {
        const int st = t % L::STAGES;
        if (t >= L::STAGES) mbar_wait(&empty[st], (t / L::STAGES - 1) & 1);
        uint8_t* sp = smem + st * L::kStage;
        mbar_expect_tx(&full[st], nsub * L::kBox + L::kWBytes);
        for (int s = 0; s < nsub; ++s)
          tma_load(sp + s * L::kBox, &tm_lhs, &full[st], kt * L::BK, r + 64 * s);
        for (int w = 0; w < L::kConsumers; ++w)
          tma_load_3d(sp + L::kXBytes + w * L::kBox, &tm_rhs, &full[st], n0 + 64 * w,
                      kt * L::BK, e);
      }
    }
    return;
  }

  // consumers: warp wl of warpgroup wg owns the columns c = n0 + 64 wg +
  // 16 wl + gr and c + 8 (its A rows gr, gr + 8; the m16n8k16 A layout)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wl = warp & 3, gr = lane >> 2, tq = lane & 3;
  // ldmatrix.trans lane addresses: matrix q = lane / 8 holds K-rows
  // 8 (q / 2) .. + 7 and columns 8 (q % 2) .. + 7 of the warp's 16
  const int a_k = (lane & 7) + ((lane >> 4) << 3), a_c = (16 * wl + ((lane >> 3) & 1) * 8) * 2;
  const int c = n0 + 64 * wg + 16 * wl + gr;
  int t = 0;
  for (int r = row0; r < row0 + rows; r += 64 * L::MAXSUB) {
    const int nsub = min(L::MAXSUB, (row0 + rows - r) / 64);
    float d[L::MAXSUB][32];
#pragma unroll
    for (int sb = 0; sb < L::MAXSUB; ++sb)
#pragma unroll
      for (int i = 0; i < 32; ++i) d[sb][i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++t) {
      const int st = t % L::STAGES;
      mbar_wait(&full[st], (t / L::STAGES) & 1);
      const uint8_t* sp = smem + st * L::kStage;
      const uint8_t* wt = sp + L::kXBytes + wg * L::kBox;  // [k][n], 128-byte rows
      uint32_t a[L::BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk)
        ldmatrix_x4_trans(a[kk], wt + sw128(16 * kk + a_k, a_c));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::BK / 16; ++kk)
#pragma unroll
        for (int sb = 0; sb < L::MAXSUB; ++sb)
          if (sb < nsub)
            wgmma_m64n64k16<ET>(d[sb], a[kk], sw128_desc(sp + sb * L::kBox + 32 * kk));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int sb = 0; sb < L::MAXSUB; ++sb) fence_acc(d[sb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    }
    // d[sb][4j + h] and d[sb][4j + 2 + h] are columns c and c + 8 of row
    // r + 64 sb + 8j + 2tq + h
#pragma unroll
    for (int sb = 0; sb < L::MAXSUB; ++sb) {
      if (sb >= nsub) break;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ET* p = out + (long long)(r + 64 * sb + 8 * j + 2 * tq + h) * N + c;
          if (c < N) p[0] = from_float<ET>(d[sb][4 * j + h]);
          if (c + 8 < N) p[8] = from_float<ET>(d[sb][4 * j + 2 + h]);
        }
    }
  }
}

template <typename ET, int BM, bool TRANS>
cudaError_t launch_bf16(const void* lhs, const void* rhs, const int* tg, const int* used,
                        void* out, int M, int N, int K, int E, int tile_m, cudaStream_t st) {
  using L = Bf16Tile<BM, TRANS>;
  auto kernel = grouped_matmul_bf16_kernel<ET, BM, TRANS>;
  static cudaError_t attr = allow_smem(kernel, L::kSmem);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kBN - 1) / kBN, M / BM);
  kernel<<<grid, L::kThreads, L::kSmem, st>>>(static_cast<const ET*>(lhs),
                                              static_cast<const ET*>(rhs), tg, used,
                                              static_cast<ET*>(out), N, K, E, tile_m);
  return cudaGetLastError();
}

template <typename ET>
cudaError_t launch_bf16_wgmma(const void* lhs, const void* rhs, const int* tg, const int* used,
                              void* out, int M, int N, int K, int E, int tile_m,
                              cudaStream_t st) {
  using L = GmmWg;
  auto kernel = grouped_matmul_wgmma_kernel<ET>;
  static cudaError_t attr = allow_smem(kernel, L::kBytes);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  const CUtensorMapDataType type = std::is_same<ET, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_lhs{}, tm_rhs{};
  const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t pitch[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t box[3] = {64, L::BK, 1};
  if (!tile_map(&tm_lhs, type, lhs, K, M, (uint64_t)K * 2, L::BK, 64,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map_nd(&tm_rhs, type, rhs, 3, dims, pitch, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const dim3 grid((N + L::BN - 1) / L::BN, E + 1);  // + 1: the padding tail's zeros
  kernel<<<grid, L::kThreads, L::kBytes, st>>>(static_cast<ET*>(out), tg, used, N, K, E,
                                               M / tile_m, tile_m, tm_lhs, tm_rhs);
  return cudaGetLastError();
}

// the mma.sync kernel at ET (bf16 or f16): row blocks of bm rows, rhs (K,
// N) at bm = 16 or transposed; (K, N) at 64-row tiles is the wgmma kernel's
template <typename ET>
cudaError_t dispatch_tc(const void* lhs, const void* rhs, const int* tg, const int* used,
                        void* out, int M, int N, int K, int E, int tile_m, int bm,
                        int transposed, cudaStream_t st) {
  if (bm == 16)
    return transposed ? launch_bf16<ET, 16, true>(lhs, rhs, tg, used, out, M, N, K, E, tile_m, st)
                      : launch_bf16<ET, 16, false>(lhs, rhs, tg, used, out, M, N, K, E, tile_m, st);
  if (transposed) return launch_bf16<ET, 64, true>(lhs, rhs, tg, used, out, M, N, K, E, tile_m, st);
  return cudaErrorInvalidValue;
}

template <int BM, bool TRANS>
cudaError_t launch_f32(const void* lhs, const void* rhs, const int* tg, const int* used,
                       void* out, int M, int N, int K, int E, int tile_m, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, M / BM);
  grouped_matmul_f32_kernel<BM, TRANS><<<grid, BM * 4, 0, st>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs), tg, used,
      static_cast<float*>(out), N, K, E, tile_m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16 (lhs, rhs and out).  lhs (M, K); rhs (E, K, N),
// or (E, N, K) with transposed = 1; tile_group (M / tile_m,) int32; used: a
// device int32 count of the tiles that hold a group, or null; out (M, N).
// wgmma = 1 runs grouped_matmul_wgmma_kernel, which takes bf16 or f16 with rhs
// (E, K, N) and tile_m a multiple of 64 (TMA: 16-byte aligned lhs and rhs);
// wgmma = 0 runs the mma.sync or CUDA-core kernels with row blocks of bm
// (16 or 64) rows, bm dividing tile_m, for everything else.
extern "C" int ds_grouped_matmul(int dtype, const void* lhs, const void* rhs,
                                 const void* tile_group, const void* used, void* out, int M,
                                 int N, int K, int E, int tile_m, int bm, int transposed,
                                 int wgmma, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (M == 0 || N == 0) return cudaSuccess;
  if (tile_m <= 0 || M % tile_m != 0 || E <= 0 || K <= 0) return cudaErrorInvalidValue;
  if ((dtype == 1 || dtype == 2) && (K % 8 != 0 || N % 8 != 0)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);
  const int* u = static_cast<const int*>(used);
  if (wgmma) {
    if ((dtype != 1 && dtype != 2) || transposed || tile_m % 64 != 0 ||
        ((reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs)) & 15) != 0)
      return cudaErrorInvalidValue;
    if (dtype == 2)
      return (int)launch_bf16_wgmma<__half>(lhs, rhs, tg, u, out, M, N, K, E, tile_m, st);
    return (int)launch_bf16_wgmma<__nv_bfloat16>(lhs, rhs, tg, u, out, M, N, K, E, tile_m, st);
  }
  if ((bm != 16 && bm != 64) || tile_m % bm != 0) return cudaErrorInvalidValue;
#define DS_GMM(LAUNCH, BM, TR) return (int)LAUNCH<BM, TR>(lhs, rhs, tg, u, out, M, N, K, E, tile_m, st)
  if (dtype == 1) return (int)dispatch_tc<__nv_bfloat16>(lhs, rhs, tg, u, out, M, N, K, E,
                                                        tile_m, bm, transposed, st);
  if (dtype == 2)
    return (int)dispatch_tc<__half>(lhs, rhs, tg, u, out, M, N, K, E, tile_m, bm, transposed, st);
  if (dtype == 0) {
    if (bm == 16) {
      if (transposed) DS_GMM(launch_f32, 16, true);
      DS_GMM(launch_f32, 16, false);
    }
    if (transposed) DS_GMM(launch_f32, 64, true);
    DS_GMM(launch_f32, 64, false);
  }
#undef DS_GMM
  return cudaErrorInvalidValue;
}
