// Flash attention for training, written for Hopper (sm_90a): forward, dK/dV
// and dQ.  Layouts are the public ones, so no transposes happen around the
// kernels: q, o, dq, do (B, S, H, D); k, v, dk, dv (B, Skv, KV, D) with
// H % KV == 0; lse and delta (B, H, S) f32.
//
// Which kernel serves which call (the dispatch is on dtype, in the C entry
// points below; it is not a fallback: each dtype has exactly one kernel).
// All replace kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//
//   flash_fwd_tc_kernel   bf16 forward, on the tensor cores: replaces
//                         _fwd_kernel (online-softmax o and f32 lse).
//   flash_dkdv_tc_kernel  bf16 dK/dV, on the tensor cores: replaces
//                         _bwd_dkdv_kernel (dK and dV per kv tile, summed
//                         over every query row of every head of the tile's
//                         GQA group).
//   flash_dq_tc_kernel    bf16 dQ, on the tensor cores: replaces
//                         _bwd_dq_kernel (dQ per query block, summed over
//                         every key tile of its band).
//   flash_fwd_kernel,     f32 forward, dK/dV and dQ: CUDA-core f32 FMAs
//   flash_dkdv_kernel,    from f32 shared-memory tiles.
//   flash_dq_kernel
//
// f16 runs the three tensor-core kernels at E = __half (m16n8k16 f16 ->
// f32, the same schedule; built in flash_attention_f16.cu); its forward
// with biases (f16 or f32) is built in flash_attention_bias_f16.cu, beside
// the bf16 one's in flash_attention_bias.cu.
//
// The forwards also take _fwd_kernel's additive biases (has_b1/has_b2, fed
// by _flash_fwd's bias_kv and bias_qk; the evoformer attention op is their
// caller): b1 (B, Skv), one value per key broadcast over rows and heads, and
// b2 (B / rep, H, S, Skv), whose batch b reads b2[b / rep]; each f32 or
// the half type of the call (bf16; f16 for an f16 forward), read in its own
// type and added in f32.  The scores become
// s scale + b1 + b2, then the masks drop elements as before, then the
// online softmax runs; lse (natural units) includes the biases.  A bias is
// not a mask: a row whose keys all sit at -1e9 (a padded MSA sequence) is
// kept, every score rounds to the same value and o is the mean of V, as
// in the reference.  The backwards never see a bias (the reference's
// evoformer recomputes its gradients outside any kernel).
//
// A row with no kept key writes o = 0 and lse = -inf.  The backward
// recomputes p = exp(s - lse) and ds = p (dp - delta) scale, with delta =
// rowsum(dO * O) computed by the caller, as _flash_bwd does.  Masks, all
// composable, as the Pallas kernels apply them: causal (key <= row); a
// window > 0 keeps keys in (row - window, row] whether or not causal is set;
// segment ids (B, S) int32 keep equal ids; a block table (nqb, nkb) int32
// keeps (row, key) iff table[row / bq][key / bk] != 0.  Keys >= Skv and rows
// >= S (the ragged edge) are masked here, so any S works.  A masked element
// gets p = 0 without ever computing exp(s - lse), so a fully masked row
// (lse = -inf) contributes nothing instead of inf * 0.
//
// Work split.  A block owns a contiguous range of "query vectors": the
// flattened (row, head-in-group) index of one (batch, kv head), so the H/KV
// query heads of a kv head share every K/V tile the block loads (the decode
// kernel's trick in paged_attention.cu).  The forward and dQ kernels walk
// the 64-key tiles of their band; the dK/dV kernels own 64 keys of one kv
// head and walk the query vectors of their band, accumulating dk and dv in
// registers, so no atomics are needed (the reference's own schedule).
//
// Bounds on an H100 SXM at the training shape (B=4, S=2048, H=32, KV=8,
// D=128, causal): the forward does 4 D flops per kept (row, key) pair of
// each head, dK/dV 8 D and dQ 6 D, ~0.14, 0.28 and 0.21 TFLOP against ~67 MB
// of q/k/v/o moved: far above the card's ~295 flops/byte ridge, so all
// three are bound by operations (0.14 ms, 0.28 ms and 0.21 ms at the 989
// TFLOP/s bf16 tensor-core rate).
//
// The bf16 kernels' design, against that bound:
//   * Every product is mma.sync.m16n8k16 bf16 -> f32.  Forward: a block
//     owns 128 query vectors, 8 warps of 16, one block per SM (~226
//     registers a thread; two 4-warp blocks per SM ran slower, each
//     loading its own K/V; at D = 32, two blocks of at most 128
//     registers); Q is read once into registers (ldmatrix),
//     S = Q K^T takes K by plain ldmatrix from a [key][d] tile, and
//     O += P V takes P straight from S's accumulators, repacked in
//     registers as A fragments, and V by ldmatrix.trans.  dK/dV: a block
//     owns 64 keys, 4 warps of 16, two blocks per SM, with the keys as the
//     M dimension: S^T = K Q^T and dP^T = V dO^T over a 64-vector stage
//     leave P^T and dS^T in accumulators, which feed dV += P^T dO and
//     dK += dS^T Q as A fragments; K and V stay in shared memory, Q and dO
//     are read by ldmatrix (.trans for dV/dK).  dK, dV, P^T and dS^T fill
//     the 255 registers, with a few spilled words.  dQ: the forward's
//     block (128 query vectors, 8 warps of 16, one block per SM) with Q
//     and dO both held as A fragments; per 64-key tile, in two 32-key
//     halves, S = Q K^T and dP = dO V^T, then dS = P (dP - delta) in
//     place of S feeds dQ += dS K as A fragments, K by ldmatrix.trans.
//     The halves keep S and dP at 16 registers each beside Q, dO (32
//     each) and dQ (64).  The scale multiplies dQ once, at the store.
//   * Precision as in the reference, which keeps p and ds in f32: q, k, v
//     and dO are bf16 already, so their products are exact in f32; p and ds
//     are computed in f32 and split into hi = bf16(x), lo = bf16(x - hi),
//     two mma each into the same f32 accumulator, which keeps x to ~2^-17
//     of its size.  Rounding p or ds to bf16 alone breaks the per-element
//     limits of chip_smoke.py (tests/test_torch_flash_precision.py emulates
//     both).  So the kernels do 6 D flops per kept pair in the forward,
//     12 D in dK/dV and 8 D in dQ, not 4 D, 8 D and 6 D; the bound above
//     counts the function's
//     work, not the kernel's.  The online-softmax state, o = acc / l and
//     lse stay f32; exp runs as ex2.approx on log2e-scaled logits.
//   * K/V (forward, dQ) and Q/dO with their rows' lse and delta (dK/dV)
//     come through a 2-stage cp.async ring (16-byte copies, each thread's
//     pointers computed once): the next tile's loads are in flight while
//     the current one computes, one barrier per tile.  Tiles stay bf16 in
//     shared memory with rows padded by 16 bytes (D + 8 elements), so the
//     8 rows an ldmatrix reads hit 8 different bank groups.
//   * Masks by tile: each (vectors x keys) tile is classified once per
//     block as empty (skipped, never loaded), full (no element mask) or
//     partial (keep() per element); only the band's edge, ragged ends,
//     segment ids and mixed block-table tiles are partial.  The full and
//     partial softmax are separate instantiations (softmax_step<MASK>,
//     probs_t<MASK>, ds_tile<MASK>): a per-element branch inside the unrolled loop split
//     it into basic blocks that the compiler could not interleave, which
//     cost most of the forward's time.
//   * Causal blocks differ in work by up to S/64x, so the heaviest launch
//     first: forward and dQ blocks in descending query order, dK/dV
//     blocks in ascending key order.
//   * Biases (bf16 forward): each stage of the ring also holds the 64-key
//     slice of b1 and the (128 vectors x 64 keys) tile of b2, copied in
//     their own type by cp.async beside K and V.  A vector's b2 row is
//     gathered through a per-block table of row offsets (the vectors of a
//     block may span heads, as Q's are); rows are padded by 16 (bf16) or 32
//     (f32) bytes, so a warp's pair reads hit distinct banks.  A row whose
//     16-byte chunk is not 16-byte aligned (Skv not a multiple of 8 in
//     bf16, 4 in f32) or runs past Skv is copied with 4-byte cp.async and,
//     for a bf16 element off the 4-byte grid, a 2-byte load; the tail past
//     Skv is zero.  softmax_step adds (b1 + b2) log2e to s scale log2e
//     before the max.  Each (b1 type, b2 type) pair is its own
//     instantiation, so the unbiased forward's code is unchanged.
//   * f16 (fp16 training under a dynamic loss scale): the products of f16
//     q, k, v and dO are exact in f32 as bf16's are; p <= 1 is split into
//     f16 hi/lo after a multiply by 2^14 (kHalfP), so that no p >= 2^-28
//     falls under f16's normal range; dS, which the reference keeps in f32
//     and which a loss scale of 2^16 pushes past 65504, is split after a
//     power-of-two scale per accumulator row (scale_rows), taken out at the
//     store.  Outputs round once to f16 and overflow to inf, never clamp.
// The f32 kernels compute on the CUDA cores: each thread keeps a
// 4 x 4 score tile and a 4 x (D/16) output tile in registers and reads f32
// operands from shared memory whose rows are padded to D + 1 floats.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() after its launch.  The bf16 kernels read
// 16-byte chunks: the wrapper checks that q, k, v and dO are 16-byte
// aligned (D is a multiple of 8).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// This file is compiled four times (ops/hopper/build.py), so that nvcc
// builds its instantiations side by side: flash_attention_bias.cu includes
// it with DS_FLASH_BIAS_UNIT 1 and keeps only the bf16 forward's biased
// instantiations (ds_flash::run_fwd_tc_bias), flash_attention_bias_f16.cu
// with DS_FLASH_BIAS_UNIT 2 and keeps only the f16 forward's
// (ds_flash::run_fwd_tc_bias_f16); flash_attention_f16.cu includes it with
// DS_FLASH_F16_UNIT set and keeps only the f16 tensor-core kernels
// (ds_flash::run_*_f16); this unit keeps everything else, the C entry
// points among it.
#ifndef DS_FLASH_BIAS_UNIT
#define DS_FLASH_BIAS_UNIT 0
#endif
#ifndef DS_FLASH_F16_UNIT
#define DS_FLASH_F16_UNIT 0
#endif
#define DS_FLASH_MAIN_UNIT (!DS_FLASH_BIAS_UNIT && !DS_FLASH_F16_UNIT)

namespace ds_flash {

struct Problem {
  int B, S, Skv, H, KV, group;
  int causal, window;
  const int* seg;  // (B, S) or null; requires S == Skv
  const int* bm;   // (nqb, nkb) or null
  int bq, bk, nkb;
  float scale;
  const void* b1;      // bias (B, Skv) or null (forward only)
  const void* b2;      // bias (B / b2_rep, H, S, Skv) or null (forward only)
  int b2_rep;
  int b1_f32, b2_f32;  // a bias's element type: 1 float, 0 the call's half type
};

// the bf16 and f16 forwards with b1 and / or b2 (defined by the bias units)
cudaError_t run_fwd_tc_bias(int D, const Problem& p, const void* q, const void* k,
                            const void* v, void* o, float* lse, cudaStream_t st);
cudaError_t run_fwd_tc_bias_f16(int D, const Problem& p, const void* q, const void* k,
                                const void* v, void* o, float* lse, cudaStream_t st);

// the f16 tensor-core kernels (defined by the f16 unit; a biased forward
// goes on to run_fwd_tc_bias_f16)
cudaError_t run_fwd_f16(int D, const Problem& p, const void* q, const void* k,
                        const void* v, void* o, float* lse, cudaStream_t st);
cudaError_t run_dkdv_f16(int D, const Problem& p, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, cudaStream_t st);
cudaError_t run_dq_f16(int D, const Problem& p, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, void* dq, cudaStream_t st);

}  // namespace ds_flash

namespace {

using ds_flash::Problem;

constexpr int kThreads = 256;  // 16 x 16: tx = tid & 15, ty = tid >> 4
constexpr int kTile = 64;      // query vectors per block, keys per kv tile
constexpr int kPLd = kTile + 1;
constexpr int kMaxSmem = 227 * 1024;

// the CUDA-core kernels below run f32 only (bf16 has the tensor-core ones)
template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// element i of a bias of element type f32 (1) or bf16 (0), as f32
__device__ __forceinline__ float bias_value(const void* b, size_t i, int f32) {
  return f32 ? static_cast<const float*>(b)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
}

// the element keep-mask of one (row, key) pair; r < 0 marks a padding vector
__device__ __forceinline__ bool keep(const Problem& p, int r, int c, int qseg,
                                     int kseg) {
  if (r < 0 || r >= p.S || c >= p.Skv) return false;
  if (p.window > 0) {
    if (c <= r - p.window || c > r) return false;
  } else if (p.causal && c > r) {
    return false;
  }
  if (p.seg != nullptr && qseg != kseg) return false;
  if (p.bm != nullptr && p.bm[(r / p.bq) * p.nkb + c / p.bk] == 0) return false;
  return true;
}

// true (on every thread) unless the block table masks every (row, key) of
// rows [r_lo, r_hi] x keys [c_lo, c_hi]; call from all threads of the block
__device__ bool tile_live(const Problem& p, int r_lo, int r_hi, int c_lo,
                          int c_hi) {
  if (p.bm == nullptr) return true;
  const int i0 = r_lo / p.bq, i1 = r_hi / p.bq;
  const int j0 = c_lo / p.bk, j1 = c_hi / p.bk;
  const int nj = j1 - j0 + 1, n = (i1 - i0 + 1) * nj;
  int found = 0;
  for (int t = threadIdx.x; t < n && !found; t += blockDim.x)
    found = p.bm[(i0 + t / nj) * p.nkb + j0 + t % nj] != 0;
  return __syncthreads_or(found) != 0;
}

// rows [lo, lo + 64) of a (rows, D) slab into f32 shared memory with row
// stride D + 1; `src(i)` gives row i's global pointer or null (zeros)
template <typename T, int D, typename Src>
__device__ __forceinline__ void stage(float* dst, Src src) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    const T* row = src(i);
    dst[i * (D + 1) + d] = row != nullptr ? to_float<T>(row[d]) : 0.f;
  }
}

// out[u][w] = sum_d X[ty + 16u][d] * Y[tx + 16w][d]
template <int D>
__device__ __forceinline__ void dot_tile(const float* X, const float* Y, int ty,
                                         int tx, float (&out)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) out[u][w] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = X[(ty + 16 * u) * LD + d];
#pragma unroll
    for (int w = 0; w < 4; ++w) y[w] = Y[(tx + 16 * w) * LD + d];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) out[u][w] = fmaf(x[u], y[w], out[u][w]);
  }
}

// acc[u][w] += sum_k A(k, ty + 16u) * Z[k][tx + 16w] for k < 64, where
// A(k, a) is A[a][k] (row-major, stride kPLd) or, with TRANS, A[k][a]
template <int D, bool TRANS>
__device__ __forceinline__ void acc_tile(const float* A, const float* Z, int ty,
                                         int tx, float (&acc)[4][D / 16]) {
  constexpr int LD = D + 1;
  constexpr int W = D / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], z[W];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[u] = TRANS ? A[k * kPLd + ty + 16 * u] : A[(ty + 16 * u) * kPLd + k];
#pragma unroll
    for (int w = 0; w < W; ++w) z[w] = Z[k * LD + tx + 16 * w];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = fmaf(a[u], z[w], acc[u][w]);
  }
}

// reductions over the 16 lanes (one ty) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the block's 64 query vectors: flattened index base + i of (row, g) within
// one (batch, kv head); row -1 for padding past S
struct Vectors {
  int row[kTile];
  int head[kTile];
  int seg[kTile];
};

__device__ void set_vectors(Vectors& vs, const Problem& p, int b, int kvh,
                            int base) {
  if (threadIdx.x < kTile) {
    const int gi = base + threadIdx.x;
    const int r = gi / p.group;
    const bool ok = r < p.S;
    vs.row[threadIdx.x] = ok ? r : -1;
    vs.head[threadIdx.x] = kvh * p.group + (gi - r * p.group);
    vs.seg[threadIdx.x] = (ok && p.seg != nullptr) ? p.seg[(size_t)b * p.S + r] : 0;
  }
}

__device__ void set_key_segs(int* kseg, const Problem& p, int b, int c0) {
  if (threadIdx.x < kTile) {
    const int c = c0 + threadIdx.x;
    kseg[threadIdx.x] = (p.seg != nullptr && c < p.Skv) ? p.seg[(size_t)b * p.S + c] : 0;
  }
}

// the kv-tile range [kt_lo, kt_hi] that rows [r_lo, r_hi] can see
__device__ __forceinline__ void kv_range(const Problem& p, int r_lo, int r_hi,
                                         int& kt_lo, int& kt_hi) {
  int c_max = (p.causal || p.window > 0) ? r_hi : p.Skv - 1;
  c_max = min(c_max, p.Skv - 1);
  const int c_min = p.window > 0 ? max(0, r_lo - p.window + 1) : 0;
  kt_lo = c_min / kTile;
  kt_hi = c_max < c_min ? kt_lo - 1 : c_max / kTile;
}

template <typename T>
__device__ __forceinline__ const T* q_row(const T* q, const Problem& p, int b,
                                          const Vectors& vs, int i, int D) {
  return vs.row[i] < 0 ? nullptr
                       : q + (((size_t)b * p.S + vs.row[i]) * p.H + vs.head[i]) * D;
}

template <typename T>
__device__ __forceinline__ const T* kv_row(const T* k, const Problem& p, int b,
                                           int kvh, int c, int D) {
  return c >= p.Skv ? nullptr : k + (((size_t)b * p.Skv + c) * p.KV + kvh) * D;
}

// the biases of keys [c0, c0 + 64) for the block's 64 vectors, as f32:
// b1_s[j] and b2_s[i][j] (stride kPLd); zeros past Skv, for padding vectors
// and for an absent bias
__device__ void stage_bias(float* b1_s, float* b2_s, const Problem& p, int b,
                           const Vectors& vs, int c0) {
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int i = idx / kTile, j = idx - i * kTile;
    const int r = vs.row[i], c = c0 + j;
    float x = 0.f;
    if (p.b2 != nullptr && r >= 0 && c < p.Skv)
      x = bias_value(
          p.b2, (((size_t)(b / p.b2_rep) * p.H + vs.head[i]) * p.S + r) * p.Skv + c,
          p.b2_f32);
    b2_s[i * kPLd + j] = x;
  }
  if (threadIdx.x < kTile) {
    const int c = c0 + threadIdx.x;
    b1_s[threadIdx.x] = (p.b1 != nullptr && c < p.Skv)
                            ? bias_value(p.b1, (size_t)b * p.Skv + c, p.b1_f32)
                            : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(S * group / 64), KV, B); BIAS: b1 and b2 (either may
// be null) are added to the scaled scores
// ---------------------------------------------------------------------------
template <typename T, int D, bool BIAS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Problem p, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse) {
  constexpr int LD = D + 1;
  constexpr int W = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][D+1]
  float* k_s = q_s + kTile * LD;     // [64][D+1]
  float* v_s = k_s + kTile * LD;     // [64][D+1]
  float* p_s = v_s + kTile * LD;     // [64][65]
  float* b2_s = p_s + kTile * kPLd;  // [64][65] (BIAS)
  float* b1_s = b2_s + kTile * kPLd; // [64] (BIAS)
  __shared__ Vectors vs;
  __shared__ int kseg[kTile];

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  set_vectors(vs, p, b, kvh, base);
  __syncthreads();
  stage<T, D>(q_s, [&](int i) { return q_row(q, p, b, vs, i, D); });

  const int r_lo = base / p.group;
  const int r_hi = min(p.S - 1, (base + kTile - 1) / p.group);
  int kt_lo, kt_hi;
  kv_range(p, r_lo, r_hi, kt_lo, kt_hi);

  float acc[4][W], m[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = -INFINITY;
    l[u] = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) acc[u][w] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int c0 = kt * kTile;
    if (!tile_live(p, r_lo, r_hi, c0, min(c0 + kTile, p.Skv) - 1)) continue;
    __syncthreads();  // everyone is done with the previous tile
    set_key_segs(kseg, p, b, c0);
    stage<T, D>(k_s, [&](int i) { return kv_row(k, p, b, kvh, c0 + i, D); });
    stage<T, D>(v_s, [&](int i) { return kv_row(v, p, b, kvh, c0 + i, D); });
    if constexpr (BIAS) stage_bias(b1_s, b2_s, p, b, vs, c0);
    __syncthreads();

    float s[4][4];
    dot_tile<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = ty + 16 * u;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = tx + 16 * w;
        float x = s[u][w] * p.scale;
        if constexpr (BIAS) x = x + b1_s[j] + b2_s[i * kPLd + j];
        s[u][w] = keep(p, vs.row[i], c0 + j, vs.seg[i], kseg[j]) ? x : -INFINITY;
        mx = fmaxf(mx, s[u][w]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[u], mx);
      // nothing kept yet: keep the state as it is (alpha 1, p 0)
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[u] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float pv = s[u][w] == -INFINITY ? 0.f : expf(s[u][w] - m_new);
        sum += pv;
        p_s[i * kPLd + tx + 16 * w] = pv;
      }
      sum = row_sum(sum);
      l[u] = l[u] * alpha + sum;
      m[u] = m_new;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] *= alpha;
    }
    __syncthreads();
    acc_tile<D, false>(p_s, v_s, ty, tx, acc);
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = ty + 16 * u;
    const int r = vs.row[i];
    if (r < 0) continue;
    const int h = vs.head[i];
    const float inv = l[u] > 0.f ? 1.f / l[u] : 0.f;
    T* orow = o + (((size_t)b * p.S + r) * p.H + h) * D;
#pragma unroll
    for (int w = 0; w < W; ++w) orow[tx + 16 * w] = from_float<T>(acc[u][w] * inv);
    if (tx == 0)
      lse[((size_t)b * p.H + h) * p.S + r] = l[u] > 0.f ? m[u] + logf(l[u]) : -INFINITY;
  }
}

// p and ds of one (64 vectors) x (64 keys) tile into shared memory; q_s/k_s
// hold q and k, do_s/v_s hold dO and V, lse_s/dl_s the vectors' lse and delta
template <int D>
__device__ __forceinline__ void grad_tile(const Problem& p, const Vectors& vs,
                                          const int* kseg, int c0,
                                          const float* q_s, const float* k_s,
                                          const float* do_s, const float* v_s,
                                          const float* lse_s, const float* dl_s,
                                          float* p_s, float* ds_s, int ty, int tx) {
  float s[4][4], dp[4][4];
  dot_tile<D>(q_s, k_s, ty, tx, s);
  dot_tile<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = ty + 16 * u;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = tx + 16 * w;
      float pv = 0.f;
      // a kept element has a finite lse; a masked one is never exponentiated
      if (keep(p, vs.row[i], c0 + j, vs.seg[i], kseg[j]))
        pv = expf(s[u][w] * p.scale - lse_s[i]);
      if (p_s != nullptr) p_s[i * kPLd + j] = pv;
      ds_s[i * kPLd + j] = pv * (dp[u][w] - dl_s[i]) * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV: grid (ceil(Skv / 64), KV, B)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(Problem p, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int LD = D + 1;
  constexpr int W = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [64][D+1]
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;    // [64][65]
  float* ds_s = p_s + kTile * kPLd;  // [64][65]
  __shared__ Vectors vs;
  __shared__ int kseg[kTile];
  __shared__ float lse_s[kTile], dl_s[kTile];

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int c0 = blockIdx.x * kTile;
  const int c1 = min(c0 + kTile, p.Skv) - 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  set_key_segs(kseg, p, b, c0);
  stage<T, D>(k_s, [&](int i) { return kv_row(k, p, b, kvh, c0 + i, D); });
  stage<T, D>(v_s, [&](int i) { return kv_row(v, p, b, kvh, c0 + i, D); });

  // the rows that can see keys [c0, c1]
  const int r_min = (p.causal || p.window > 0) ? c0 : 0;
  const int r_max = p.window > 0 ? min(p.S - 1, c1 + p.window - 1) : p.S - 1;
  float dk_acc[4][W], dv_acc[4][W];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < W; ++w) { dk_acc[u][w] = 0.f; dv_acc[u][w] = 0.f; }

  if (r_min <= r_max) {
    const int ch_lo = r_min * p.group / kTile;
    const int ch_hi = ((r_max + 1) * p.group - 1) / kTile;
    for (int ch = ch_lo; ch <= ch_hi; ++ch) {
      const int base = ch * kTile;
      const int r_lo = base / p.group;
      const int r_hi = min(p.S - 1, (base + kTile - 1) / p.group);
      if (!tile_live(p, r_lo, r_hi, c0, c1)) continue;
      __syncthreads();  // everyone is done with the previous chunk
      set_vectors(vs, p, b, kvh, base);
      __syncthreads();
      if (threadIdx.x < kTile) {
        const int i = threadIdx.x, r = vs.row[i];
        const size_t at = ((size_t)b * p.H + vs.head[i]) * p.S + r;
        lse_s[i] = r < 0 ? -INFINITY : lse[at];
        dl_s[i] = r < 0 ? 0.f : delta[at];
      }
      stage<T, D>(q_s, [&](int i) { return q_row(q, p, b, vs, i, D); });
      stage<T, D>(do_s, [&](int i) { return q_row(dout, p, b, vs, i, D); });
      __syncthreads();
      grad_tile<D>(p, vs, kseg, c0, q_s, k_s, do_s, v_s, lse_s, dl_s, p_s, ds_s, ty, tx);
      __syncthreads();
      acc_tile<D, true>(p_s, do_s, ty, tx, dv_acc);   // dv[j] += sum_i p[i][j] dO[i]
      acc_tile<D, true>(ds_s, q_s, ty, tx, dk_acc);   // dk[j] += sum_i ds[i][j] q[i]
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = c0 + ty + 16 * u;
    if (c >= p.Skv) continue;
    const size_t row = (((size_t)b * p.Skv + c) * p.KV + kvh) * D;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dk[row + tx + 16 * w] = from_float<T>(dk_acc[u][w]);
      dv[row + tx + 16 * w] = from_float<T>(dv_acc[u][w]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (ceil(S * group / 64), KV, B)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(Problem p, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq) {
  constexpr int LD = D + 1;
  constexpr int W = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][D+1]
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;    // [64][65]
  __shared__ Vectors vs;
  __shared__ int kseg[kTile];
  __shared__ float lse_s[kTile], dl_s[kTile];

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int base = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  set_vectors(vs, p, b, kvh, base);
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int i = threadIdx.x, r = vs.row[i];
    const size_t at = ((size_t)b * p.H + vs.head[i]) * p.S + r;
    lse_s[i] = r < 0 ? -INFINITY : lse[at];
    dl_s[i] = r < 0 ? 0.f : delta[at];
  }
  stage<T, D>(q_s, [&](int i) { return q_row(q, p, b, vs, i, D); });
  stage<T, D>(do_s, [&](int i) { return q_row(dout, p, b, vs, i, D); });

  const int r_lo = base / p.group;
  const int r_hi = min(p.S - 1, (base + kTile - 1) / p.group);
  int kt_lo, kt_hi;
  kv_range(p, r_lo, r_hi, kt_lo, kt_hi);
  float acc[4][W];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[u][w] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int c0 = kt * kTile;
    if (!tile_live(p, r_lo, r_hi, c0, min(c0 + kTile, p.Skv) - 1)) continue;
    __syncthreads();
    set_key_segs(kseg, p, b, c0);
    stage<T, D>(k_s, [&](int i) { return kv_row(k, p, b, kvh, c0 + i, D); });
    stage<T, D>(v_s, [&](int i) { return kv_row(v, p, b, kvh, c0 + i, D); });
    __syncthreads();
    grad_tile<D>(p, vs, kseg, c0, q_s, k_s, do_s, v_s, lse_s, dl_s, nullptr, ds_s, ty, tx);
    __syncthreads();
    acc_tile<D, false>(ds_s, k_s, ty, tx, acc);  // dq[i] += sum_j ds[i][j] k[j]
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = ty + 16 * u;
    const int r = vs.row[i];
    if (r < 0) continue;
    T* row = dq + (((size_t)b * p.S + r) * p.H + vs.head[i]) * D;
#pragma unroll
    for (int w = 0; w < W; ++w) row[tx + 16 * w] = from_float<T>(acc[u][w]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 8;                // forward: 16 query vectors per warp,
constexpr int kFwdVecs = 16 * kFwdWarps;    // 128 per block, one block per SM
constexpr int kBwdWarps = 4;                // dK/dV: 16 keys per warp,
constexpr int kBwdKeys = 16 * kBwdWarps;    // 64 per block
constexpr int kBwdVecs = 64;                // query vectors per dK/dV stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// f16 (the same kernels at E = __half; see "f16" in the file's notes):
// p <= 1 is split into hi/lo as bf16's is, after a multiply by kHalfP =
// 2^14, which keeps every p >= 2^-28 in f16's normal range and p 2^14 <=
// 16384 under its 65504.  The sums and accumulators fed by p carry the
// same factor, taken out at the store (exact: a power of two).
constexpr float kHalfP = 16384.f;
constexpr float kHalfPInv = 1.f / 16384.f;
constexpr float kHalfPLn = 9.704060527839234f;  // ln(2^14)

// bytes per bf16 shared-memory row of D elements: D + 8, so that the 8 rows
// an ldmatrix reads (16 bytes each) start 16 bytes apart modulo 128
template <int D>
constexpr int tc_row() { return (D + 8) * 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// E, the tensor-core kernels' element type: __nv_bfloat16 or __half (the
// same m16n8k16 shape and fragments, f32 accumulators)
template <typename E>
constexpr bool kIsHalf = std::is_same<E, __half>::value;

// not volatile: a pure function of its operands, so the compiler may
// interleave independent products with the fragment loads around them
template <typename E>
__device__ __forceinline__ void mma_tc(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (kIsHalf<E>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

// (x0, x1) rounded to nearest into one packed pair of E (x0 in the low
// half); an f16 conversion past 65504 gives inf, never a clamped value
template <typename E>
__device__ __forceinline__ uint32_t pack_pair(float x0, float x1) {
  if constexpr (kIsHalf<E>) {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <typename E>
__device__ __forceinline__ float2 unpack_pair(uint32_t x) {
  if constexpr (kIsHalf<E>)
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// (x0, x1) -> hi = E(x), lo = E(x - hi) as packed pairs (x0 in the low
// half, the lower column of an A fragment)
template <typename E>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_pair<E>(x0, x1);
  const float2 hf = unpack_pair<E>(hi);
  lo = pack_pair<E>(x0 - hf.x, x1 - hf.y);
}

// the A fragments (hi and lo) of k-step kk of a 16 x 64 accumulator tile
// acc[8][4] (rows gr, gr + 8; columns 8j + 2tq, +1 of n-tile j)
template <typename E, int NT>
__device__ __forceinline__ void a_split(const float (&acc)[NT][4], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_pair<E>(acc[2 * kk][0], acc[2 * kk][1], hi[0], lo[0]);
  split_pair<E>(acc[2 * kk][2], acc[2 * kk][3], hi[1], lo[1]);
  split_pair<E>(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[2], lo[2]);
  split_pair<E>(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[3], lo[3]);
}

// C[16 x 8 NT] += A[16 x 16] . B^T, B a [n][k] bf16 shared tile (rows
// n0.., stride ROW bytes): plain ldmatrix gives the col-major B fragments.
// All fragments are loaded before the products, so no mma waits on a load.
template <typename E, int NT, int ROW>
__device__ __forceinline__ void mma_bt(float (&c)[NT][4], const uint32_t (&a)[4],
                                       const uint8_t* b, int n0, int k0, int lane) {
  uint32_t r[NT / 2][4];
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    const int n = n0 + jj * 16 + (lane & 7) + ((lane >> 4) << 3);
    const int k = k0 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(r[jj], b + n * ROW + k * 2);
  }
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    mma_tc<E>(c[2 * jj], a, r[jj][0], r[jj][1]);
    mma_tc<E>(c[2 * jj + 1], a, r[jj][2], r[jj][3]);
  }
}

// C[16 x D] += (hi + lo)[16 x 16] . B, B a [k][n] bf16 shared tile whose
// rows k0..k0+15 are read with ldmatrix.trans.  In groups of 8 n-tiles (4
// at D = 32): the group's fragments first, then its hi products, then its
// lo products, so the two products into one accumulator are 8 (4) apart.
template <typename E, int D, int ROW>
__device__ __forceinline__ void mma_split_b(float (&c)[D / 8][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const uint8_t* b, int k0,
                                            int lane) {
  constexpr int G = D / 16 < 4 ? D / 16 : 4;  // ldmatrix.x4 per group: 2G n-tiles
  static_assert((D / 16) % G == 0, "D is 32, 64 or 128");
#pragma unroll
  for (int g = 0; g < D / 16; g += G) {
    uint32_t r[G][4];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int n = (g + jj) * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(r[jj], b + k * ROW + n * 2);
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      mma_tc<E>(c[2 * (g + jj)], hi, r[jj][0], r[jj][1]);
      mma_tc<E>(c[2 * (g + jj) + 1], hi, r[jj][2], r[jj][3]);
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      mma_tc<E>(c[2 * (g + jj)], lo, r[jj][0], r[jj][1]);
      mma_tc<E>(c[2 * (g + jj) + 1], lo, r[jj][2], r[jj][3]);
    }
  }
}

// 2^x by the special-function unit (ex2.approx: within 2 ulp of the
// rounded result; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes of a bf16 or f16 row into shared memory, or zeros where the row
// is absent (past S or Skv)
__device__ __forceinline__ void chunk16(uint8_t* dst, const void* src) {
  if (src != nullptr)
    cp_async16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// Copies of bf16 rows into padded shared tiles: thread t moves the 16-byte
// chunk t % (D/8) of rows t / (D/8), + R, + 2R, ..., so its column and
// pointers are computed once.
template <int D, int THREADS>
struct RowCopy {
  static constexpr int CH = D / 8, R = THREADS / CH;
  static_assert(THREADS % CH == 0, "whole rows per pass");
  int row0, col;
  __device__ RowCopy() : row0(threadIdx.x / CH), col((threadIdx.x % CH) * 8) {}

  // keys [c0, c0 + N) of one (batch, kv head) of k and v (B, Skv, KV, D)
  // into [N][ROW] tiles; zeros past Skv
  template <int ROW, int N, typename E>
  __device__ __forceinline__ void keys(uint8_t* ks, uint8_t* vs, const E* k, const E* v,
                                       const Problem& p, int b, int kvh, int c0) const {
    static_assert(N % R == 0, "whole passes");
    const size_t step = (size_t)p.KV * D;
    const size_t at = ((size_t)b * p.Skv * p.KV + kvh) * D + col;
#pragma unroll
    for (int i = 0; i < N / R; ++i) {
      const int c = c0 + row0 + i * R;
      const int o = (row0 + i * R) * ROW + col * 2;
      const size_t off = at + (size_t)c * step;
      chunk16(ks + o, c < p.Skv ? k + off : nullptr);
      chunk16(vs + o, c < p.Skv ? v + off : nullptr);
    }
  }

  // N query vectors from flattened index base of one (batch, kv head) of a
  // (and b2 when given), (B, S, H, D), into [N][ROW] tiles; zeros past S
  template <int ROW, int N, typename E>
  __device__ __forceinline__ void vectors(uint8_t* da, const E* a, uint8_t* db, const void* b2v,
                                          const Problem& p, int b, int kvh, int base) const {
    const E* b2 = static_cast<const E*>(b2v);
    static_assert(N % R == 0, "whole passes");
#pragma unroll
    for (int i = 0; i < N / R; ++i) {
      const int vi = row0 + i * R, gi = base + vi;
      const int r = gi / p.group;
      const size_t at =
          (((size_t)b * p.S + r) * p.H + kvh * p.group + (gi - r * p.group)) * D + col;
      const int o = vi * ROW + col * 2;
      chunk16(da + o, r < p.S ? a + at : nullptr);
      if (b2 != nullptr) chunk16(db + o, r < p.S ? b2 + at : nullptr);
    }
  }
};

enum TileState { kEmpty = 0, kFull = 1, kPartial = 2 };

// How rows [r_lo, r_hi] meet keys [c_lo, c_lo + nkeys): kEmpty when no
// (row, key) pair is kept, kFull when every pair is kept (no element mask
// needed), else kPartial.  `rows_whole`: every query vector of the tile is a
// real row (none past S).  Call from every thread of the block with the same
// arguments: the block table is read cooperatively.
__device__ int tile_state(const Problem& p, int r_lo, int r_hi, int c_lo, int nkeys,
                          bool rows_whole) {
  const int c_hi = min(c_lo + nkeys, p.Skv) - 1;
  bool any, all;
  if (p.window > 0) {
    any = c_lo <= r_hi && c_hi > r_lo - p.window;
    all = c_hi <= r_lo && c_lo > r_hi - p.window;
  } else if (p.causal) {
    any = c_lo <= r_hi;
    all = c_hi <= r_lo;
  } else {
    any = all = true;
  }
  all = all && rows_whole && c_lo + nkeys <= p.Skv && p.seg == nullptr;
  if (p.bm != nullptr && any) {
    const int i0 = r_lo / p.bq, i1 = r_hi / p.bq;
    const int j0 = c_lo / p.bk, j1 = c_hi / p.bk;
    const int nj = j1 - j0 + 1, n = (i1 - i0 + 1) * nj;
    int found = 0, missing = 0;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int live = p.bm[(i0 + t / nj) * p.nkb + j0 + t % nj] != 0;
      found |= live;
      missing |= !live;
    }
    any = __syncthreads_or(found) != 0;
    all = all && __syncthreads_or(missing) == 0;
  }
  return !any ? kEmpty : all ? kFull : kPartial;
}

// the rows [r_lo, r_hi] of n query vectors from flattened index base
__device__ __forceinline__ void vector_rows(const Problem& p, int base, int n, int& r_lo,
                                            int& r_hi) {
  r_lo = base / p.group;
  r_hi = min(p.S - 1, (base + n - 1) / p.group);
}

// The bf16 forward's and dQ's block: kFwdVecs query vectors of one (batch,
// kv head) from flattened index `base`, the blocks of a 1-D grid in
// descending query order (the causal band's heaviest first), walking the
// live 64-key tiles [kt_lo, kt_hi] of its band through a 2-stage ring.
template <int D>
struct QueryBlock {
  static constexpr int kRow = tc_row<D>();
  static constexpr int kKvBytes = kTile * kRow;  // one K or V tile
  int b, kvh, base, r_lo, r_hi, kt_lo, kt_hi;
  bool rows_whole;  // no vector of the block lies past S
  RowCopy<D, 32 * kFwdWarps> copy;

  __device__ explicit QueryBlock(const Problem& p) {
    const int nqb = gridDim.x / (p.B * p.KV);
    const int bh = blockIdx.x % (p.B * p.KV);
    b = bh / p.KV;
    kvh = bh % p.KV;
    base = (nqb - 1 - (int)(blockIdx.x / (p.B * p.KV))) * kFwdVecs;
    vector_rows(p, base, kFwdVecs, r_lo, r_hi);
    rows_whole = base + kFwdVecs <= p.S * p.group;
    kv_range(p, r_lo, r_hi, kt_lo, kt_hi);
  }

  // row (-1 past S), head and segment of this thread's two vectors: gr and
  // gr + 8 of its warp's 16
  __device__ void thread_rows(const Problem& p, int warp, int gr, int (&row)[2],
                              int (&head)[2], int (&qseg)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = base + warp * 16 + gr + 8 * h;
      const int r = gi / p.group;
      row[h] = r < p.S ? r : -1;
      head[h] = kvh * p.group + (gi - r * p.group);
      qseg[h] = (r < p.S && p.seg != nullptr) ? p.seg[(size_t)b * p.S + r] : 0;
    }
  }

  // the first live tile at or after kt, and its state; call from every
  // thread (tile_state votes)
  __device__ int next_live(const Problem& p, int kt, int& state) const {
    for (; kt <= kt_hi; ++kt) {
      state = tile_state(p, r_lo, r_hi, kt * kTile, kTile, rows_whole);
      if (state != kEmpty) break;
    }
    return kt;
  }

  // K and V of tile kt into a ring stage ([K | V]) and its key segments
  // into kseg
  template <typename E>
  __device__ void load_kv(const Problem& p, const E* k, const E* v,
                          uint8_t* stage, int* kseg, int kt) const {
    copy.template keys<kRow, kTile>(stage, stage + kKvBytes, k, v, p, b, kvh, kt * kTile);
    if (p.seg != nullptr && threadIdx.x < kTile) {
      const int c = kt * kTile + threadIdx.x;
      kseg[threadIdx.x] = c < p.Skv ? p.seg[(size_t)b * p.S + c] : 0;
    }
  }
};

// ---------------------------------------------------------------------------
// bf16 forward: 1-D grid of ceil(S * group / 128) * KV * B blocks
// ---------------------------------------------------------------------------
// bytes of one bias element; 0 for an absent bias (void)
template <typename B>
constexpr int elem_bytes() {
  if constexpr (std::is_void<B>::value) return 0; else return (int)sizeof(B);
}

// B1 and B2: the element types of b1 and b2 (float, or the forward's
// element type E: __nv_bfloat16 or __half), void when absent.  A ring
// stage holds [K | V | b1 slice | b2 tile]; after the kseg rings,
// b2_off[kFwdVecs] holds each vector's b2 row offset.
template <int D, typename B1 = void, typename B2 = void>
struct FwdTc {
  static constexpr int kRow = tc_row<D>();
  static constexpr int kThreads = 32 * kFwdWarps;
  static constexpr int kQBytes = kFwdVecs * kRow;
  static constexpr int kKvBytes = kTile * kRow;      // one K or V tile
  static constexpr int kB1Bytes = kTile * elem_bytes<B1>();       // 64 keys of b1
  static constexpr int kB2Row = (kTile + 8) * elem_bytes<B2>();   // a padded b2 row
  static constexpr int kB2Bytes = kFwdVecs * kB2Row;               // the vectors' b2 rows
  static constexpr int kStageBytes = 2 * kKvBytes + kB1Bytes + kB2Bytes;
  static constexpr int kSmem = kQBytes + 2 * kStageBytes + 2 * kTile * (int)sizeof(int) +
                               (kB2Bytes > 0 ? kFwdVecs * (int)sizeof(long long) : 0);
};

// 16 bytes of bias elements into shared memory: the m elements at src (m
// may exceed the chunk: only the chunk's share is copied), zeros after
// them.  A whole, 16-byte aligned chunk is one 16-byte cp.async; otherwise
// (a row stride off the 16-byte grid, or the ragged edge) 4-byte cp.async
// and, for bf16 elements off the 4-byte grid, 2-byte loads.
template <typename B>
__device__ __forceinline__ void bias_chunk(uint8_t* dst, const B* src, int m) {
  constexpr int E = 16 / (int)sizeof(B);
  if (m <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if (m >= E && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else if constexpr (sizeof(B) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < m)
        cp_async4(dst + 4 * e, src + e);
      else
        reinterpret_cast<uint32_t*>(dst)[e] = 0u;
    }
  } else {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
    const bool pairs = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      if (pairs && e + 1 < m) {
        cp_async4(d16 + e, s16 + e);
      } else {
        d16[e] = e < m ? s16[e] : (uint16_t)0;
        d16[e + 1] = e + 1 < m ? s16[e + 1] : (uint16_t)0;
      }
    }
  }
}

// (b1 + b2) of one thread's rows in one ring stage, read in each bias's own
// type and summed in f32.  v0: the thread's first vector in the block (its
// second is v0 + 8).
template <int D, typename B1, typename B2>
struct BiasView {
  static constexpr bool kAny = !std::is_void<B1>::value || !std::is_void<B2>::value;
  const uint8_t* b1;  // the stage's 64 keys of b1
  const uint8_t* b2;  // the stage's b2 tile
  int v0;

  template <typename B>
  static __device__ __forceinline__ float2 load_pair(const uint8_t* at) {
    if constexpr (std::is_same<B, float>::value)
      return *reinterpret_cast<const float2*>(at);
    else if constexpr (std::is_same<B, __half>::value)
      return __half22float2(*reinterpret_cast<const __half2*>(at));
    else
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
  }

  // b1 + b2 at keys jc, jc + 1 (jc even) of the thread's row h
  __device__ __forceinline__ float2 pair(int h, int jc) const {
    float2 x = make_float2(0.f, 0.f);
    if constexpr (!std::is_void<B1>::value) {
      const float2 y = load_pair<B1>(b1 + jc * (int)sizeof(B1));
      x.x += y.x;
      x.y += y.y;
    }
    if constexpr (!std::is_void<B2>::value) {
      const float2 y = load_pair<B2>(b2 + (v0 + 8 * h) * FwdTc<D, B1, B2>::kB2Row +
                                     jc * (int)sizeof(B2));
      x.x += y.x;
      x.y += y.y;
    }
    return x;
  }
};

// One online-softmax step of a warp's 16 x 64 tile, in the log2 domain: s
// holds Q K^T and becomes p; m (the rows' running max), l (this thread's
// share of the row sums) and acc are rescaled.  With biases, x = s scale
// log2e + (b1 + b2) log2e before the max.  MASK (a partial tile): keep()
// per element, and a masked element is -inf and gets p = 0 without an exp.
// A row with nothing kept yet keeps m = -inf and p = 0.  In f16, p leaves
// multiplied by kHalfP (p_scale below), as do the sums it adds to l.
template <typename E, bool MASK, int D, typename Bias>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 8][4], float sl2,
                                             const Problem& p, const int (&row)[2],
                                             const int (&qseg)[2], const int* kseg, int c0,
                                             int tq, const Bias& bias) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 bl = make_float2(0.f, 0.f);
      if constexpr (Bias::kAny) bl = bias.pair(h, j * 8 + 2 * tq);
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        float x = s[j][e] * sl2;
        if constexpr (Bias::kAny) x += ((e & 1) ? bl.y : bl.x) * kLog2e;
        if constexpr (MASK) {
          const int jc = j * 8 + 2 * tq + (e & 1);
          if (!keep(p, row[h], c0 + jc, qseg[h], kseg[jc])) x = -INFINITY;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
  float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    m_use[h] = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2_approx(m[h] - m_use[h]);  // 0 while m = -inf
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      float pv = (MASK && x == -INFINITY) ? 0.f : exp2_approx(x - m_use[e >> 1]);
      if constexpr (kIsHalf<E>) pv *= kHalfP;
      s[j][e] = pv;
      sum[e >> 1] += pv;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
}

// B1, B2: the biases' element types, void when absent (FwdTc).  D = 32
// (the evoformer's heads) is held to 128 registers, so two blocks share an
// SM: its blocks walk few key tiles and wait on their copies, and a second
// block hides that (timings in PERF.md; the variants with an f32 b2
// spill 16-24 bytes).
template <typename E, int D, typename B1, typename B2>
__global__ void __launch_bounds__(32 * kFwdWarps, D <= 32 ? 2 : 1)
flash_fwd_tc_kernel(Problem p, const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, E* __restrict__ o, float* __restrict__ lse) {
  using L = FwdTc<D, B1, B2>;
  extern __shared__ __align__(16) uint8_t tc_smem[];  // bytes, not the f32 kernels' smem
  uint8_t* q_s = tc_smem;
  uint8_t* kv_s = tc_smem + L::kQBytes;  // 2 stages of [K | V | b1 | b2]
  int* kseg_s = reinterpret_cast<int*>(kv_s + 2 * L::kStageBytes);  // [2][64]
  long long* b2_off = reinterpret_cast<long long*>(kseg_s + 2 * kTile);  // [kFwdVecs]

  const QueryBlock<D> blk(p);
  const int b = blk.b, kvh = blk.kvh, kt_hi = blk.kt_hi;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  int row[2], head[2], qseg[2];
  blk.thread_rows(p, warp, gr, row, head, qseg);
  if constexpr (!std::is_void<B2>::value) {
    // each vector's b2 row: (b / rep, head, row, 0), or -1 past S
    for (int i = threadIdx.x; i < kFwdVecs; i += L::kThreads) {
      const int gi = blk.base + i;
      const int r = gi / p.group;
      b2_off[i] = r < p.S ? (((long long)(b / p.b2_rep) * p.H + kvh * p.group +
                              (gi - r * p.group)) * p.S + r) * p.Skv
                          : -1;
    }
    __syncthreads();
  }
  auto load_kv = [&](int kt, int st) {
    uint8_t* stage = kv_s + st * L::kStageBytes;
    blk.load_kv(p, k, v, stage, kseg_s + st * kTile, kt);
    const int c0 = kt * kTile;
    if constexpr (!std::is_void<B1>::value) {
      constexpr int EB = 16 / (int)sizeof(B1), CPR = kTile / EB;
      if (threadIdx.x < CPR) {
        const int e0 = c0 + threadIdx.x * EB;
        bias_chunk<B1>(stage + 2 * L::kKvBytes + threadIdx.x * 16,
                       static_cast<const B1*>(p.b1) + (size_t)b * p.Skv + e0, p.Skv - e0);
      }
    }
    if constexpr (!std::is_void<B2>::value) {
      constexpr int EB = 16 / (int)sizeof(B2), CPR = kTile / EB;
      static_assert(kFwdVecs * CPR % L::kThreads == 0, "whole passes");
      uint8_t* tile = stage + 2 * L::kKvBytes + L::kB1Bytes;
#pragma unroll
      for (int it = 0; it < kFwdVecs * CPR / L::kThreads; ++it) {
        const int ci = threadIdx.x + it * L::kThreads;
        const int i = ci / CPR, e0 = c0 + (ci % CPR) * EB;
        const long long off = b2_off[i];
        bias_chunk<B2>(tile + i * L::kB2Row + (ci % CPR) * 16,
                       static_cast<const B2*>(p.b2) + (off < 0 ? 0 : off + e0),
                       off < 0 ? 0 : p.Skv - e0);
      }
    }
  };
  auto next_live = [&](int kt, int& state) { return blk.next_live(p, kt, state); };

  // Q of the block's vectors and the first K/V tile; Q then lives in
  // registers as A fragments for the whole walk
  blk.copy.template vectors<L::kRow, kFwdVecs>(q_s, q, nullptr, nullptr, p, b, kvh, blk.base);
  int cur_state = kEmpty, nxt_state = kEmpty;
  int cur = next_live(blk.kt_lo, cur_state);
  if (cur <= kt_hi) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * L::kRow + (kk * 16 + (lane >> 4) * 8) * 2);

  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

  int nxt = cur <= kt_hi ? next_live(cur + 1, nxt_state) : kt_hi + 1;
  int st = 0;
  while (cur <= kt_hi) {
    if (nxt <= kt_hi) load_kv(nxt, st ^ 1);  // in flight while this tile computes
    cp_async_commit();
    const uint8_t* ks = kv_s + st * L::kStageBytes;
    const uint8_t* vs = ks + L::kKvBytes;
    const BiasView<D, B1, B2> bias{ks + 2 * L::kKvBytes, ks + 2 * L::kKvBytes + L::kB1Bytes,
                                   warp * 16 + gr};

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_bt<E, 8, L::kRow>(s, qf[kk], ks, 0, kk * 16, lane);

    if (cur_state == kPartial)
      softmax_step<E, true, D>(s, m, l, acc, sl2, p, row, qseg, kseg_s + st * kTile, cur * kTile,
                               tq, bias);
    else
      softmax_step<E, false, D>(s, m, l, acc, sl2, p, row, qseg, nullptr, 0, tq, bias);

    // O += (P_hi + P_lo) V
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      a_split<E>(s, kk, hi, lo);
      mma_split_b<E, D, L::kRow>(acc, hi, lo, vs, kk * 16, lane);
    }

    cp_async_wait_all();
    __syncthreads();  // the next tile is in; every warp is done with this one
    cur = nxt;
    cur_state = nxt_state;
    st ^= 1;
    if (cur <= kt_hi) nxt = next_live(cur + 1, nxt_state);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    if (row[h] < 0) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    E* orow = o + (((size_t)b * p.S + row[h]) * p.H + head[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
          pack_pair<E>(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    if (tq == 0) {
      float lrow = -INFINITY;
      if (lt > 0.f) {
        lrow = m[h] * kLn2 + logf(lt);
        if constexpr (kIsHalf<E>) lrow -= kHalfPLn;  // l carries kHalfP
      }
      lse[((size_t)b * p.H + head[h]) * p.S + row[h]] = lrow;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK / dV: 1-D grid of ceil(Skv / 64) * KV * B blocks, the key blocks
// in ascending order (the causal band's heaviest first)
// ---------------------------------------------------------------------------
template <int D>
struct DkdvTc {
  static constexpr int kRow = tc_row<D>();
  static constexpr int kThreads = 32 * kBwdWarps;
  static constexpr int kKeyBytes = kBwdKeys * kRow;  // K or V
  static constexpr int kVecBytes = kBwdVecs * kRow;  // a stage's Q or dO
  // a stage: Q, dO, then lse, delta, row and segment per vector
  static constexpr int kStageBytes = 2 * kVecBytes + 4 * kBwdVecs * 4;
  static constexpr int kSmem = 2 * kKeyBytes + 2 * kStageBytes;
  static_assert(kBwdVecs <= kThreads, "one thread per vector's lse and delta");
};

// f16's dS (dK/dV and dQ).  The reference keeps ds = p (dp - delta) in
// f32; under a loss scale of 2^16 it passes 65504, and it may fall under
// f16's normal range (2^-14), so an f16 hi/lo split as bf16's would turn a
// finite gradient into inf or lose it.  Each accumulator row (a thread's
// rows h = 0, 1: gr and gr + 8 of its warp's 16) therefore has its own
// power-of-two scale 2^sig: sig is the least 14 - floor(log2 max |ds|)
// over the row's tiles so far, so every tile's row max lands at or under
// [2^14, 2^15) before the split; the accumulator holds its sum times 2^sig
// and is rescaled when sig falls, and the store multiplies by 2^-sig.
// Every factor is a power of two, so no scaling rounds.  A row whose ds is
// all zero or not finite sets no scale (kNoScale): inf and NaN reach the
// accumulator as they are and the output reads inf or NaN, as the
// reference's does.
constexpr int kNoScale = 1000;

// 2^n for n <= 127 (0 under 2^-126)
__device__ __forceinline__ float pow2i(int n) {
  return n < -126 ? 0.f : __int_as_float((n + 127) << 23);
}

// x: a warp's 16 rows x 8 NT columns of ds in accumulator layout; acc: the
// same rows' accumulator (NA n-tiles); sig: the rows' scales
template <int NT, int NA>
__device__ __forceinline__ void scale_rows(float (&x)[NT][4], float (&acc)[NA][4],
                                           int (&sig)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(x[j][e]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(mx[h]);
    // 14 - floor(log2 m) from m's exponent bits; at most 100 (m under
    // 2^-86, or f32-subnormal)
    const int want = (m > 0.f && m <= 3.402823466e38f)
                         ? min(141 - (int)(__float_as_uint(m) >> 23), 100)
                         : kNoScale;
    if (want < sig[h]) {
      const float f = sig[h] == kNoScale ? 1.f : pow2i(want - sig[h]);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        acc[j][2 * h] *= f;
        acc[j][2 * h + 1] *= f;
      }
      sig[h] = want;
    }
    const float f = sig[h] == kNoScale ? 1.f : pow2i(sig[h]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      x[j][2 * h] *= f;
      x[j][2 * h + 1] *= f;
    }
  }
}

// 2^-sig, the factor that takes a row's scale out at the store
__device__ __forceinline__ float unscale(int sig) {
  return sig == kNoScale ? 1.f : pow2i(-sig);
}

// P^T of a warp's 16 keys x 8 NT vectors: exp2(s^T scale log2e - lse
// log2e) in f32 (times kHalfP in f16).  MASK (a partial tile): keep() per
// element; a masked element gets p = 0 without an exp (its lse may be
// -inf).
template <typename E, bool MASK, int NT>
__device__ __forceinline__ void probs_t(float (&pt)[NT][4], float sl2, const Problem& p,
                                        const int (&key)[2], const int (&kseg)[2],
                                        const float* lse_t, const int* row_t,
                                        const int* seg_t, int tq) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vi = j * 8 + 2 * tq + (e & 1);
      float pv = 0.f;
      if (!MASK || keep(p, row_t[vi], key[e >> 1], seg_t[vi], kseg[e >> 1]))
        pv = exp2_approx(pt[j][e] * sl2 - lse_t[vi] * kLog2e);
      if constexpr (kIsHalf<E>) pv *= kHalfP;
      pt[j][e] = pv;
    }
}

template <typename E, int D>
__global__ void __launch_bounds__(32 * kBwdWarps, 8 / kBwdWarps)
flash_dkdv_tc_kernel(Problem p, const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const E* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     E* __restrict__ dk, E* __restrict__ dv) {
  using L = DkdvTc<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* k_s = tc_smem;
  uint8_t* v_s = tc_smem + L::kKeyBytes;
  uint8_t* stages = tc_smem + 2 * L::kKeyBytes;

  const int bh = blockIdx.x % (p.B * p.KV);
  const int b = bh / p.KV, kvh = bh % p.KV;
  const int c0 = (blockIdx.x / (p.B * p.KV)) * kBwdKeys;
  const int c1 = min(c0 + kBwdKeys, p.Skv) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;

  // this thread's two keys (gr and gr + 8 of its warp's 16) and segments
  int key[2], kseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = c0 + warp * 16 + gr + 8 * h;
    kseg[h] = (p.seg != nullptr && key[h] < p.Skv) ? p.seg[(size_t)b * p.S + key[h]] : 0;
  }

  const RowCopy<D, L::kThreads> copy;
  copy.template keys<L::kRow, kBwdKeys>(k_s, v_s, k, v, p, b, kvh, c0);

  auto load_stage = [&](int ch, int st) {
    uint8_t* q_t = stages + st * L::kStageBytes;
    uint8_t* do_t = q_t + L::kVecBytes;
    float* lse_t = reinterpret_cast<float*>(do_t + L::kVecBytes);
    float* dl_t = lse_t + kBwdVecs;
    int* row_t = reinterpret_cast<int*>(dl_t + kBwdVecs);
    int* seg_t = row_t + kBwdVecs;
    const int base = ch * kBwdVecs;
    copy.template vectors<L::kRow, kBwdVecs>(q_t, q, do_t, dout, p, b, kvh, base);
    if (threadIdx.x < kBwdVecs) {
      const int vi = threadIdx.x, gi = base + vi;
      const int r = gi / p.group;
      if (r < p.S) {
        const size_t at = ((size_t)b * p.H + kvh * p.group + (gi - r * p.group)) * p.S + r;
        cp_async4(lse_t + vi, lse + at);
        cp_async4(dl_t + vi, delta + at);
        row_t[vi] = r;
        seg_t[vi] = p.seg != nullptr ? p.seg[(size_t)b * p.S + r] : 0;
      } else {  // padding: masked everywhere, zeros keep ds finite
        lse_t[vi] = 0.f;
        dl_t[vi] = 0.f;
        row_t[vi] = -1;
        seg_t[vi] = 0;
      }
    }
  };

  // the query vectors whose rows can see keys [c0, c1], in 64-vector stages
  const int r_min = (p.causal || p.window > 0) ? c0 : 0;
  const int r_max = p.window > 0 ? min(p.S - 1, c1 + p.window - 1) : p.S - 1;
  const int ch_lo = r_min * p.group / kBwdVecs;
  const int ch_hi = r_min <= r_max ? ((r_max + 1) * p.group - 1) / kBwdVecs : ch_lo - 1;
  auto next_live = [&](int ch, int& state) {
    for (; ch <= ch_hi; ++ch) {
      int r_lo, r_hi;
      vector_rows(p, ch * kBwdVecs, kBwdVecs, r_lo, r_hi);
      state = tile_state(p, r_lo, r_hi, c0, kBwdKeys, (ch + 1) * kBwdVecs <= p.S * p.group);
      if (state != kEmpty) break;
    }
    return ch;
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  int sig[2] = {kNoScale, kNoScale};  // f16: dk_acc's row scales

  int cur_state = kEmpty, nxt_state = kEmpty;
  int cur = next_live(ch_lo, cur_state);
  if (cur <= ch_hi) load_stage(cur, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  int nxt = cur <= ch_hi ? next_live(cur + 1, nxt_state) : ch_hi + 1;
  int st = 0;
  const float sl2 = p.scale * kLog2e;
  // this warp's 16 keys of K and V, as ldmatrix A-fragment rows
  const uint8_t* k_w = k_s + (warp * 16 + (lane & 15)) * L::kRow + (lane >> 4) * 16;
  const uint8_t* v_w = v_s + (warp * 16 + (lane & 15)) * L::kRow + (lane >> 4) * 16;

  while (cur <= ch_hi) {
    if (nxt <= ch_hi) load_stage(nxt, st ^ 1);  // in flight while this stage computes
    cp_async_commit();
    const uint8_t* q_t = stages + st * L::kStageBytes;
    const uint8_t* do_t = q_t + L::kVecBytes;
    const float* lse_t = reinterpret_cast<const float*>(do_t + L::kVecBytes);
    const float* dl_t = lse_t + kBwdVecs;
    const int* row_t = reinterpret_cast<const int*>(dl_t + kBwdVecs);
    const int* seg_t = row_t + kBwdVecs;

    constexpr int NT = kBwdVecs / 8;
    // P^T = exp(S^T scale - lse), S^T = K Q^T (keys x vectors)
    float pt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, k_w + kk * 32);
      mma_bt<E, NT, L::kRow>(pt, a, q_t, 0, kk * 16, lane);
    }
    if (cur_state == kPartial)
      probs_t<E, true, NT>(pt, sl2, p, key, kseg, lse_t, row_t, seg_t, tq);
    else
      probs_t<E, false, NT>(pt, sl2, p, key, kseg, lse_t, row_t, seg_t, tq);
    // dV += (P^T_hi + P^T_lo) dO
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      a_split<E>(pt, kk, hi, lo);
      mma_split_b<E, D, L::kRow>(dv_acc, hi, lo, do_t, kk * 16, lane);
    }
    // dS^T = P^T (dP^T - delta) scale, dP^T = V dO^T
    float dst[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, v_w + kk * 32);
      mma_bt<E, NT, L::kRow>(dst, a, do_t, 0, kk * 16, lane);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int vi = j * 8 + 2 * tq + (e & 1);
        if constexpr (kIsHalf<E>)  // scale and kHalfP come out at the store
          dst[j][e] = pt[j][e] * (dst[j][e] - dl_t[vi]);
        else
          dst[j][e] = pt[j][e] * (dst[j][e] - dl_t[vi]) * p.scale;
      }
    if constexpr (kIsHalf<E>) scale_rows(dst, dk_acc, sig);
    // dK += (dS^T_hi + dS^T_lo) Q
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      a_split<E>(dst, kk, hi, lo);
      mma_split_b<E, D, L::kRow>(dk_acc, hi, lo, q_t, kk * 16, lane);
    }

    cp_async_wait_all();
    __syncthreads();  // the next stage is in; every warp is done with this one
    cur = nxt;
    cur_state = nxt_state;
    st ^= 1;
    if (cur <= ch_hi) nxt = next_live(cur + 1, nxt_state);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= p.Skv) continue;
    const size_t at = (((size_t)b * p.Skv + key[h]) * p.KV + kvh) * D;
    if constexpr (kIsHalf<E>) {
      // dk: 2^-sig kHalfP^-1 (exact) then the softmax scale; dv: kHalfP^-1
      const float fk = unscale(sig[h]) * kHalfPInv;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = j * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(dk + at + d) = pack_pair<E>(
            dk_acc[j][2 * h] * fk * p.scale, dk_acc[j][2 * h + 1] * fk * p.scale);
        *reinterpret_cast<uint32_t*>(dv + at + d) =
            pack_pair<E>(dv_acc[j][2 * h] * kHalfPInv, dv_acc[j][2 * h + 1] * kHalfPInv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = j * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(dk + at + d) =
            pack_pair<E>(dk_acc[j][2 * h], dk_acc[j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + d) =
            pack_pair<E>(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ: the forward's grid and blocks (QueryBlock).  Each block owns its
// dQ rows: written once, no atomics.
// ---------------------------------------------------------------------------
template <int D>
struct DqTc {
  static constexpr int kRow = tc_row<D>();
  static constexpr int kThreads = 32 * kFwdWarps;
  static constexpr int kVecBytes = kFwdVecs * kRow;  // Q or dO
  static constexpr int kKvBytes = kTile * kRow;      // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;   // K then V
  static constexpr int kSmem = 2 * kVecBytes + 2 * kStageBytes + 2 * kTile * (int)sizeof(int);
};

// keys per S and dP product: each 64-key tile runs as two 32-key halves, so
// S and dP take 16 registers each beside Q, dO (32 each) and dQ (64)
constexpr int kDqKeys = 32;

// dS of a warp's 16 vectors x 8 NT keys, in place of S: p = exp2(s scale
// log2e - lse log2e) in f32 and ds = p (dp - delta); the scale is applied
// once, at the store.  MASK (a partial tile): keep() per element, and a
// masked element gets ds = 0 without an exp (its row's lse may be -inf).
template <bool MASK, int NT>
__device__ __forceinline__ void ds_tile(float (&s)[NT][4], const float (&dp)[NT][4], float sl2,
                                        const float (&lse2)[2], const float (&dl)[2],
                                        const Problem& p, const int (&row)[2],
                                        const int (&qseg)[2], const int* kseg, int c0, int tq) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float pv = 0.f;
      if constexpr (MASK) {
        const int jc = j * 8 + 2 * tq + (e & 1);
        if (keep(p, row[h], c0 + jc, qseg[h], kseg[jc]))
          pv = exp2_approx(s[j][e] * sl2 - lse2[h]);
      } else {
        pv = exp2_approx(s[j][e] * sl2 - lse2[h]);
      }
      s[j][e] = pv * (dp[j][e] - dl[h]);
    }
}

template <typename E, int D>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
flash_dq_tc_kernel(Problem p, const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, const E* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   E* __restrict__ dq) {
  using L = DqTc<D>;
  constexpr int NT = kDqKeys / 8;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* q_s = tc_smem;
  uint8_t* do_s = q_s + L::kVecBytes;
  uint8_t* kv_s = do_s + L::kVecBytes;  // 2 stages of [K | V]
  int* kseg_s = reinterpret_cast<int*>(kv_s + 2 * L::kStageBytes);  // [2][64]

  const QueryBlock<D> blk(p);
  const int b = blk.b, kvh = blk.kvh, kt_hi = blk.kt_hi;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;

  // this thread's two rows with their lse (log2 domain) and delta; padding
  // rows get 0 (always masked)
  int row[2], head[2], qseg[2];
  blk.thread_rows(p, warp, gr, row, head, qseg);
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = ((size_t)b * p.H + head[h]) * p.S + max(row[h], 0);
    lse2[h] = row[h] >= 0 ? lse[at] * kLog2e : 0.f;
    dl[h] = row[h] >= 0 ? delta[at] : 0.f;
  }
  auto load_kv = [&](int kt, int st) {
    blk.load_kv(p, k, v, kv_s + st * L::kStageBytes, kseg_s + st * kTile, kt);
  };
  auto next_live = [&](int kt, int& state) { return blk.next_live(p, kt, state); };

  // Q and dO of the block's vectors and the first K/V tile; Q and dO then
  // live in registers as A fragments for the whole walk
  blk.copy.template vectors<L::kRow, kFwdVecs>(q_s, q, do_s, dout, p, b, kvh, blk.base);
  int cur_state = kEmpty, nxt_state = kEmpty;
  int cur = next_live(blk.kt_lo, cur_state);
  if (cur <= kt_hi) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (warp * 16 + (lane & 15)) * L::kRow + (kk * 16 + (lane >> 4) * 8) * 2;
    ldmatrix_x4(qf[kk], q_s + off);
    ldmatrix_x4(df[kk], do_s + off);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  int sig[2] = {kNoScale, kNoScale};  // f16: acc's row scales
  const float sl2 = p.scale * kLog2e;

  int nxt = cur <= kt_hi ? next_live(cur + 1, nxt_state) : kt_hi + 1;
  int st = 0;
  while (cur <= kt_hi) {
    if (nxt <= kt_hi) load_kv(nxt, st ^ 1);  // in flight while this tile computes
    cp_async_commit();
    const uint8_t* ks = kv_s + st * L::kStageBytes;
    const uint8_t* vs = ks + L::kKvBytes;
    const int* kseg = kseg_s + st * kTile;

#pragma unroll
    for (int n0 = 0; n0 < kTile; n0 += kDqKeys) {
      // S = Q K^T and dP = dO V^T over keys n0 .. n0 + 31
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bt<E, NT, L::kRow>(s, qf[kk], ks, n0, kk * 16, lane);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bt<E, NT, L::kRow>(dp, df[kk], vs, n0, kk * 16, lane);
      if (cur_state == kPartial)
        ds_tile<true, NT>(s, dp, sl2, lse2, dl, p, row, qseg, kseg + n0, cur * kTile + n0, tq);
      else
        ds_tile<false, NT>(s, dp, sl2, lse2, dl, p, row, qseg, kseg + n0, cur * kTile + n0, tq);
      if constexpr (kIsHalf<E>) scale_rows(s, acc, sig);
      // dQ += (dS_hi + dS_lo) K, K's rows n0 .. n0 + 31 by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk) {
        uint32_t hi[4], lo[4];
        a_split<E>(s, kk, hi, lo);
        mma_split_b<E, D, L::kRow>(acc, hi, lo, ks, n0 + kk * 16, lane);
      }
    }

    cp_async_wait_all();
    __syncthreads();  // the next tile is in; every warp is done with this one
    cur = nxt;
    cur_state = nxt_state;
    st ^= 1;
    if (cur <= kt_hi) nxt = next_live(cur + 1, nxt_state);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < 0) continue;
    E* out = dq + (((size_t)b * p.S + row[h]) * p.H + head[h]) * D;
    float f = p.scale;
    if constexpr (kIsHalf<E>) {
      const float u = unscale(sig[h]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) acc[j][e] *= u;  // exact
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + 2 * tq) =
          pack_pair<E>(acc[j][2 * h] * f, acc[j][2 * h + 1] * f);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

constexpr size_t slab_floats(int D) { return (size_t)kTile * (D + 1); }
constexpr size_t tile_floats() { return (size_t)kTile * kPLd; }

template <typename E, int D, typename B1, typename B2>
cudaError_t run_fwd_tc(const Problem& p, const void* q, const void* k, const void* v, void* o,
                       float* lse, cudaStream_t st) {
  using L = FwdTc<D, B1, B2>;
  auto kernel = flash_fwd_tc_kernel<E, D, B1, B2>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (((long long)p.S * p.group + kFwdVecs - 1) / kFwdVecs) * p.KV * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, L::kThreads, L::kSmem, st>>>(
      p, static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(o), lse);
  return cudaGetLastError();
}

#if DS_FLASH_BIAS_UNIT
// the E forward's instantiation for the biases' element types (void:
// absent; a half-type bias is E's own type); b1_f32 / b2_f32 in p say which
// type each present bias has
template <typename E, int D, typename B1>
cudaError_t run_fwd_tc_b2(const Problem& p, const void* q, const void* k, const void* v,
                          void* o, float* lse, cudaStream_t st) {
  if (p.b2 == nullptr) return run_fwd_tc<E, D, B1, void>(p, q, k, v, o, lse, st);
  if (p.b2_f32) return run_fwd_tc<E, D, B1, float>(p, q, k, v, o, lse, st);
  return run_fwd_tc<E, D, B1, E>(p, q, k, v, o, lse, st);
}

template <typename E, int D>
cudaError_t run_fwd_tc_b1(const Problem& p, const void* q, const void* k, const void* v,
                          void* o, float* lse, cudaStream_t st) {
  if (p.b1 == nullptr) return run_fwd_tc_b2<E, D, void>(p, q, k, v, o, lse, st);
  if (p.b1_f32) return run_fwd_tc_b2<E, D, float>(p, q, k, v, o, lse, st);
  return run_fwd_tc_b2<E, D, E>(p, q, k, v, o, lse, st);
}

template <typename E>
cudaError_t run_fwd_tc_bias_d(int D, const Problem& p, const void* q, const void* k,
                              const void* v, void* o, float* lse, cudaStream_t st) {
  if (D == 32) return run_fwd_tc_b1<E, 32>(p, q, k, v, o, lse, st);
  if (D == 64) return run_fwd_tc_b1<E, 64>(p, q, k, v, o, lse, st);
  if (D == 128) return run_fwd_tc_b1<E, 128>(p, q, k, v, o, lse, st);
  return cudaErrorInvalidValue;
}
#endif

template <typename T, int D>
cudaError_t run_fwd(const Problem& p, const void* q, const void* k, const void* v,
                    void* o, float* lse, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.b1 != nullptr || p.b2 != nullptr)
      return ds_flash::run_fwd_tc_bias(D, p, q, k, v, o, lse, st);
    return run_fwd_tc<__nv_bfloat16, D, void, void>(p, q, k, v, o, lse, st);
  } else {
    const bool bias = p.b1 != nullptr || p.b2 != nullptr;
    const size_t smem =
        (3 * slab_floats(D) + (bias ? 2 * tile_floats() + kTile : tile_floats())) * sizeof(float);
    auto kernel = bias ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S * p.group + kTile - 1) / kTile, p.KV, p.B);
    kernel<<<grid, kThreads, smem, st>>>(p, static_cast<const T*>(q),
                                         static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), lse);
    return cudaGetLastError();
  }
}

template <typename E, int D>
cudaError_t run_dkdv_tc(const Problem& p, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, void* dk,
                        void* dv, cudaStream_t st) {
  using L = DkdvTc<D>;
  auto kernel = flash_dkdv_tc_kernel<E, D>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (((long long)p.Skv + kBwdKeys - 1) / kBwdKeys) * p.KV * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, L::kThreads, L::kSmem, st>>>(
      p, static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dk), static_cast<E*>(dv));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkdv(const Problem& p, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return run_dkdv_tc<__nv_bfloat16, D>(p, q, k, v, dout, lse, delta, dk, dv, st);
  } else {
    const size_t smem = (4 * slab_floats(D) + 2 * tile_floats()) * sizeof(float);
    auto kernel = flash_dkdv_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Skv + kTile - 1) / kTile, p.KV, p.B);
    kernel<<<grid, kThreads, smem, st>>>(
        p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv));
    return cudaGetLastError();
  }
}

template <typename E, int D>
cudaError_t run_dq_tc(const Problem& p, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta, void* dq,
                      cudaStream_t st) {
  using L = DqTc<D>;
  auto kernel = flash_dq_tc_kernel<E, D>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (((long long)p.S * p.group + kFwdVecs - 1) / kFwdVecs) * p.KV * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, L::kThreads, L::kSmem, st>>>(
      p, static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const Problem& p, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta, void* dq,
                   cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return run_dq_tc<__nv_bfloat16, D>(p, q, k, v, dout, lse, delta, dq, st);
  } else {
    const size_t smem = (4 * slab_floats(D) + tile_floats()) * sizeof(float);
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S * p.group + kTile - 1) / kTile, p.KV, p.B);
    kernel<<<grid, kThreads, smem, st>>>(
        p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq));
    return cudaGetLastError();
  }
}

#if DS_FLASH_MAIN_UNIT
Problem make_problem(int B, int S, int Skv, int H, int KV, int causal, int window,
                     const void* seg, const void* bm, int bq, int bk, int nkb,
                     float scale) {
  Problem p;
  p.B = B; p.S = S; p.Skv = Skv; p.H = H; p.KV = KV; p.group = H / KV;
  p.causal = causal; p.window = window;
  p.seg = static_cast<const int*>(seg);
  p.bm = static_cast<const int*>(bm);
  p.bq = bq > 0 ? bq : 1; p.bk = bk > 0 ? bk : 1; p.nkb = nkb;
  p.scale = scale;
  p.b1 = nullptr;
  p.b2 = nullptr;
  p.b2_rep = 1;
  p.b1_f32 = p.b2_f32 = 0;
  return p;
}
#endif

}  // namespace

#if DS_FLASH_BIAS_UNIT == 1
cudaError_t ds_flash::run_fwd_tc_bias(int D, const Problem& p, const void* q, const void* k,
                                      const void* v, void* o, float* lse, cudaStream_t st) {
  return run_fwd_tc_bias_d<__nv_bfloat16>(D, p, q, k, v, o, lse, st);
}
#endif

#if DS_FLASH_BIAS_UNIT == 2
cudaError_t ds_flash::run_fwd_tc_bias_f16(int D, const Problem& p, const void* q,
                                          const void* k, const void* v, void* o, float* lse,
                                          cudaStream_t st) {
  return run_fwd_tc_bias_d<__half>(D, p, q, k, v, o, lse, st);
}
#endif

#if DS_FLASH_F16_UNIT
// f16 runs the bf16 kernels' schedule at E = __half; a biased forward (the
// evoformer op's) runs the bias unit's f16 instantiations
cudaError_t ds_flash::run_fwd_f16(int D, const Problem& p, const void* q, const void* k,
                                  const void* v, void* o, float* lse, cudaStream_t st) {
  if (p.b1 != nullptr || p.b2 != nullptr)
    return ds_flash::run_fwd_tc_bias_f16(D, p, q, k, v, o, lse, st);
  if (D == 32) return run_fwd_tc<__half, 32, void, void>(p, q, k, v, o, lse, st);
  if (D == 64) return run_fwd_tc<__half, 64, void, void>(p, q, k, v, o, lse, st);
  if (D == 128) return run_fwd_tc<__half, 128, void, void>(p, q, k, v, o, lse, st);
  return cudaErrorInvalidValue;
}

cudaError_t ds_flash::run_dkdv_f16(int D, const Problem& p, const void* q, const void* k,
                                   const void* v, const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv, cudaStream_t st) {
  if (D == 32) return run_dkdv_tc<__half, 32>(p, q, k, v, dout, lse, delta, dk, dv, st);
  if (D == 64) return run_dkdv_tc<__half, 64>(p, q, k, v, dout, lse, delta, dk, dv, st);
  if (D == 128) return run_dkdv_tc<__half, 128>(p, q, k, v, dout, lse, delta, dk, dv, st);
  return cudaErrorInvalidValue;
}

cudaError_t ds_flash::run_dq_f16(int D, const Problem& p, const void* q, const void* k,
                                 const void* v, const void* dout, const float* lse,
                                 const float* delta, void* dq, cudaStream_t st) {
  if (D == 32) return run_dq_tc<__half, 32>(p, q, k, v, dout, lse, delta, dq, st);
  if (D == 64) return run_dq_tc<__half, 64>(p, q, k, v, dout, lse, delta, dq, st);
  if (D == 128) return run_dq_tc<__half, 128>(p, q, k, v, dout, lse, delta, dq, st);
  return cudaErrorInvalidValue;
}
#endif

#if DS_FLASH_MAIN_UNIT

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the f16 unit's kernels);
// D: 32, 64 or 128; H % KV == 0.  The Python wrapper checks
// shapes before it calls; a dtype or D outside these gives
// cudaErrorInvalidValue.  seg and bm may be null.  Returns a cudaError_t.
#define DS_FLASH_DISPATCH(CALL)                          \
  if (dtype == 1) {                                      \
    if (D == 32) return (int)CALL(__nv_bfloat16, 32);    \
    if (D == 64) return (int)CALL(__nv_bfloat16, 64);    \
    if (D == 128) return (int)CALL(__nv_bfloat16, 128);  \
  }                                                      \
  if (dtype == 0) {                                      \
    if (D == 32) return (int)CALL(float, 32);            \
    if (D == 64) return (int)CALL(float, 64);            \
    if (D == 128) return (int)CALL(float, 128);          \
  }                                                      \
  return (int)cudaErrorInvalidValue;

// b1 (B, Skv) and b2 (B / b2_rep, H, S, Skv) may be null; b1_dtype and
// b2_dtype use dtype's codes: 0 (f32) or the call's half type (1 for an f32
// or bf16 call, 2 for an f16 call).
extern "C" int ds_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* seg, const void* bm, const void* b1,
                            const void* b2, int b1_dtype, int b2_dtype, int b2_rep,
                            void* o, void* lse, int B, int S, int Skv, int H, int KV,
                            int D, int causal, int window, int bq, int bk, int nkb,
                            float scale, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (B == 0 || S == 0) return cudaSuccess;
  const int half_code = dtype == 2 ? 2 : 1;
  if ((b1 != nullptr && b1_dtype != 0 && b1_dtype != half_code) ||
      (b2 != nullptr && ((b2_dtype != 0 && b2_dtype != half_code) || b2_rep <= 0)))
    return (int)cudaErrorInvalidValue;
  Problem p = make_problem(B, S, Skv, H, KV, causal, window, seg, bm, bq, bk, nkb, scale);
  p.b1 = b1;
  p.b2 = b2;
  p.b2_rep = b2_rep;
  p.b1_f32 = b1_dtype == 0;
  p.b2_f32 = b2_dtype == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 2) return (int)ds_flash::run_fwd_f16(D, p, q, k, v, o, lse_f, st);
#define DS_FWD(T, DD) run_fwd<T, DD>(p, q, k, v, o, lse_f, st)
  DS_FLASH_DISPATCH(DS_FWD)
#undef DS_FWD
}

extern "C" int ds_flash_bwd_dkdv(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout, const void* lse,
                                 const void* delta, const void* seg, const void* bm,
                                 void* dk, void* dv, int B, int S, int Skv, int H,
                                 int KV, int D, int causal, int window, int bq, int bk,
                                 int nkb, float scale, void* stream) {
  cudaGetLastError();
  if (B == 0 || Skv == 0) return cudaSuccess;
  const Problem p = make_problem(B, S, Skv, H, KV, causal, window, seg, bm, bq, bk, nkb, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* dl_f = static_cast<const float*>(delta);
  if (dtype == 2)
    return (int)ds_flash::run_dkdv_f16(D, p, q, k, v, dout, lse_f, dl_f, dk, dv, st);
#define DS_DKDV(T, DD) run_dkdv<T, DD>(p, q, k, v, dout, lse_f, dl_f, dk, dv, st)
  DS_FLASH_DISPATCH(DS_DKDV)
#undef DS_DKDV
}

extern "C" int ds_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               const void* seg, const void* bm, void* dq, int B, int S,
                               int Skv, int H, int KV, int D, int causal, int window,
                               int bq, int bk, int nkb, float scale, void* stream) {
  cudaGetLastError();
  if (B == 0 || S == 0) return cudaSuccess;
  const Problem p = make_problem(B, S, Skv, H, KV, causal, window, seg, bm, bq, bk, nkb, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* dl_f = static_cast<const float*>(delta);
  if (dtype == 2) return (int)ds_flash::run_dq_f16(D, p, q, k, v, dout, lse_f, dl_f, dq, st);
#define DS_DQ(T, DD) run_dq<T, DD>(p, q, k, v, dout, lse_f, dl_f, dq, st)
  DS_FLASH_DISPATCH(DS_DQ)
#undef DS_DQ
}
#undef DS_FLASH_DISPATCH
#endif  // DS_FLASH_MAIN_UNIT
