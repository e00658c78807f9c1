// Grouped (per-expert) matmul for dropless MoE, written for Hopper (sm_90a).
//
//   grouped_matmul_kernel  replaces deepspeed_tpu/ops/pallas/grouped_matmul.py
//                          _gmm_kernel (entry grouped_matmul):
//                          out[r] = lhs[r] @ W_e, e = tile_group[r / tile_m],
//                          W_e = rhs[e] read as (K, N), or with transposed = 1
//                          rhs[e] read as (N, K) and used transposed (the
//                          backward's dlhs = g @ rhs[e]^T, without a copy).
//                          f32 accumulation, the output in lhs's dtype.
//
// lhs (M, K) holds rows in the tile-aligned layout: M is a multiple of
// tile_m and every tile_m-row tile belongs to one expert.  A block owns BM
// rows (BM divides tile_m, so its rows share one expert) and BN columns; it
// reads tile_group for its tile and points at that expert's weights.  Tiles
// at or past *used (the count of tiles that hold a group; null: all) hold
// only padding rows, which are zero: the block writes zeros there and reads
// no weights.  The layout always appends such tiles, clipped to expert E-1,
// and a kernel that computed them would stream that expert's weights again
// for nothing.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at Mixtral's width
// (E = 8, K x N = 4096 x 14336 or 14336 x 4096, bf16) a decode body routes
// 16 assignments, ~2 rows per touched expert, so each touched expert's 117
// MB of weights is read for ~4 flops per 2-byte element: bound by those
// bytes.  A 256-token mixed step gives ~64 rows per expert, still below the
// ~295 flops/byte ridge: bound by the bytes of all 8 experts.  What this
// kernel does about that:
//   * bf16 through the tensor cores (mma.sync m16n8k16, f32 accumulation),
//     tiles staged with cp.async in a 4-stage ring so that each SM keeps
//     tens of KB of weight loads in flight; lhs read with ldmatrix, the
//     weight tile with ldmatrix.trans ((K, N): [k][n] in shared memory) or
//     ldmatrix ((N, K): [n][k]);
//   * BM = 16 row blocks for the layout's 16-row tiles (decode: one mma row
//     tile, 4 warps across 64 columns) and BM = 64 for 64-row tiles (mixed
//     steps: fewer re-reads of each expert's weights);
//   * 64-wide column blocks, so that even a 4096-wide projection gives 64
//     column blocks per touched tile, ~450 blocks at decode for 132 SMs.
//   * f32 (the small models' path) on the CUDA cores: 4 x 4 outputs per
//     thread from shared-memory tiles, fmaf.
// wgmma, TMA, split-K and a persistent schedule are later work.
//
// The bf16 path loads 16-byte chunks: K and N multiples of 8 and 16-byte
// aligned tensors (the wrapper checks).  K and N edges are zero-filled and
// masked.  The C entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 64;       // K per pipeline stage (bf16)
constexpr int kStages = 4;
constexpr int kRow = (kBK + 8) * 2;  // bytes per shared row: 144 (conflict-free ldmatrix)
constexpr int kF32BK = 16;    // K per step (f32)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
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
__device__ __forceinline__ void chunk(uint8_t* dst, const __nv_bfloat16* src, bool valid) {
  if (valid)
    cp_async16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// bf16 tensor-core kernel.  4 warps: BM = 16 -> 1 x 4 warps of 16 x 16;
// BM = 64 -> 2 x 2 warps of 32 x 32.
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

template <int BM, bool TRANS>
__global__ void __launch_bounds__(128)
    grouped_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                               const __nv_bfloat16* __restrict__ rhs,
                               const int* __restrict__ tile_group, const int* __restrict__ used,
                               __nv_bfloat16* __restrict__ out, int N, int K, int E,
                               int tile_m) {
  using L = Bf16Tile<BM, TRANS>;
  constexpr int MT = L::MT, NT = L::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * BM;
  const int e = block_expert(tile_group, used, row0, tile_m, E);
  if (e < 0) {
    write_zeros(out, row0, BM, n0, N);
    return;
  }
  const __nv_bfloat16* a_src = lhs + (long long)row0 * K;
  const __nv_bfloat16* w = rhs + (long long)e * K * N;
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
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
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
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * N + c) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

template <int BM, bool TRANS>
cudaError_t launch_bf16(const void* lhs, const void* rhs, const int* tg, const int* used,
                        void* out, int M, int N, int K, int E, int tile_m, cudaStream_t st) {
  using L = Bf16Tile<BM, TRANS>;
  auto kernel = grouped_matmul_bf16_kernel<BM, TRANS>;
  static cudaError_t attr = allow_smem(kernel, L::kSmem);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kBN - 1) / kBN, M / BM);
  kernel<<<grid, L::kThreads, L::kSmem, st>>>(static_cast<const __nv_bfloat16*>(lhs),
                                              static_cast<const __nv_bfloat16*>(rhs), tg, used,
                                              static_cast<__nv_bfloat16*>(out), N, K, E, tile_m);
  return cudaGetLastError();
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

// dtype: 0 = f32, 1 = bf16 (lhs, rhs and out).  lhs (M, K); rhs (E, K, N),
// or (E, N, K) with transposed = 1; tile_group (M / tile_m,) int32; used: a
// device int32 count of the tiles that hold a group, or null; out (M, N).
// bm (16 or 64) divides tile_m, which divides M.
extern "C" int ds_grouped_matmul(int dtype, const void* lhs, const void* rhs,
                                 const void* tile_group, const void* used, void* out, int M,
                                 int N, int K, int E, int tile_m, int bm, int transposed,
                                 void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (M == 0 || N == 0) return cudaSuccess;
  if ((bm != 16 && bm != 64) || tile_m <= 0 || tile_m % bm != 0 || M % tile_m != 0 || E <= 0 ||
      K <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 1 && (K % 8 != 0 || N % 8 != 0)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(tile_group);
  const int* u = static_cast<const int*>(used);
#define DS_GMM(LAUNCH, BM, TR) return (int)LAUNCH<BM, TR>(lhs, rhs, tg, u, out, M, N, K, E, tile_m, st)
  if (dtype == 1) {
    if (bm == 16) {
      if (transposed) DS_GMM(launch_bf16, 16, true);
      DS_GMM(launch_bf16, 16, false);
    }
    if (transposed) DS_GMM(launch_bf16, 64, true);
    DS_GMM(launch_bf16, 64, false);
  }
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
