// Flash attention for training, written for Hopper (sm_90a): forward, dK/dV
// and dQ.  Layouts are the public ones, so no transposes happen around the
// kernels: q, o, dq, do (B, S, H, D); k, v, dk, dv (B, Skv, KV, D) with
// H % KV == 0; lse and delta (B, H, S) f32.
//
//   flash_fwd_kernel   replaces deepspeed_tpu/ops/pallas/flash_attention.py
//                      _fwd_kernel: online-softmax o and f32 lse.  A row with
//                      no kept key writes o = 0 and lse = -inf.
//   flash_dkdv_kernel  replaces flash_attention.py _bwd_dkdv_kernel: dK and
//                      dV per kv tile, summed over every query row of every
//                      head of the tile's GQA group.
//   flash_dq_kernel    replaces flash_attention.py _bwd_dq_kernel: dQ.
//
// The backward recomputes p = exp(s - lse) and ds = p (dp - delta) scale,
// with delta = rowsum(dO * O) computed by the caller, as _flash_bwd does.
// Masks, all composable, as the Pallas kernels apply them: causal (key <=
// row); a window > 0 keeps keys in (row - window, row] whether or not causal
// is set; segment ids (B, S) int32 keep equal ids; a block table (nqb, nkb)
// int32 keeps (row, key) iff table[row / bq][key / bk] != 0.  Keys >= Skv and
// rows >= S (the ragged edge) are masked here, so any S works.  A masked
// element gets p = 0 without ever computing exp(s - lse), so a fully masked
// row (lse = -inf) contributes nothing instead of inf * 0.
//
// Work split.  A block owns 64 "query vectors": a contiguous range of the
// flattened (row, head-in-group) index of one (batch, kv head), so the H/KV
// query heads of a kv head share every K/V tile the block loads (the
// decode kernel's trick in paged_attention.cu).  The forward and dQ kernels
// walk the kv tiles of their band; the dK/dV kernel owns 64 keys of one kv
// head and walks the query vectors of its band, accumulating dk and dv in
// registers, so no atomics are needed (the reference's own schedule).  The
// causal/window band bounds both loops, and a tile whose block-table entries
// are all 0 is skipped whole.
//
// Bounds on an H100 SXM at the training shape (B=4, S=2048, H=32, KV=8,
// D=128, causal): the forward does 4 D flops per kept (row, key) pair of
// each head, dK/dV 8 D and dQ 6 D, ~0.14, 0.28 and 0.21 TFLOP against
// ~67 MB of q/k/v/o moved: far above the card's ~295 flops/byte ridge, so
// all three are bound by operations (0.14 ms, 0.28 ms and 0.21 ms at the
// 989 TFLOP/s bf16 tensor-core rate).  These first kernels compute on the
// CUDA cores in f32 (67 TFLOP/s peak), so they stay well above that bound:
// each thread keeps a 4 x 4 score tile and a 4 x (D/16) output tile in
// registers and reads f32 operands from shared memory whose rows are padded
// to D + 1 floats (conflict-free column reads).  wgmma/TMA tiles are later
// work.
//
// Every C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = tid & 15, ty = tid >> 4
constexpr int kTile = 64;      // query vectors per block, keys per kv tile
constexpr int kPLd = kTile + 1;
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Problem {
  int B, S, Skv, H, KV, group;
  int causal, window;
  const int* seg;  // (B, S) or null; requires S == Skv
  const int* bm;   // (nqb, nkb) or null
  int bq, bk, nkb;
  float scale;
};

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

// ---------------------------------------------------------------------------
// forward: grid (ceil(S * group / 64), KV, B)
// ---------------------------------------------------------------------------
template <typename T, int D>
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
        s[u][w] = keep(p, vs.row[i], c0 + j, vs.seg[i], kseg[j]) ? s[u][w] * p.scale
                                                                  : -INFINITY;
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

template <typename T, int D>
cudaError_t run_fwd(const Problem& p, const void* q, const void* k, const void* v,
                    void* o, float* lse, cudaStream_t st) {
  const size_t smem = (3 * slab_floats(D) + tile_floats()) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S * p.group + kTile - 1) / kTile, p.KV, p.B);
  kernel<<<grid, kThreads, smem, st>>>(p, static_cast<const T*>(q),
                                       static_cast<const T*>(k),
                                       static_cast<const T*>(v), static_cast<T*>(o), lse);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkdv(const Problem& p, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, cudaStream_t st) {
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

template <typename T, int D>
cudaError_t run_dq(const Problem& p, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta, void* dq,
                   cudaStream_t st) {
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
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128; H % KV == 0.  The Python
// wrapper checks shapes before it calls; a dtype or D outside these gives
// cudaErrorInvalidValue.  seg and bm may be null.  Returns a cudaError_t.
#define DS_FLASH_DISPATCH(CALL)                          \
  if (dtype == 1) {                                      \
    if (D == 64) return (int)CALL(__nv_bfloat16, 64);    \
    if (D == 128) return (int)CALL(__nv_bfloat16, 128);  \
  }                                                      \
  if (dtype == 0) {                                      \
    if (D == 64) return (int)CALL(float, 64);            \
    if (D == 128) return (int)CALL(float, 128);          \
  }                                                      \
  return (int)cudaErrorInvalidValue;

extern "C" int ds_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                            const void* seg, const void* bm, void* o, void* lse,
                            int B, int S, int Skv, int H, int KV, int D, int causal,
                            int window, int bq, int bk, int nkb, float scale,
                            void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (B == 0 || S == 0) return cudaSuccess;
  const Problem p = make_problem(B, S, Skv, H, KV, causal, window, seg, bm, bq, bk, nkb, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
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
#define DS_DQ(T, DD) run_dq<T, DD>(p, q, k, v, dout, lse_f, dl_f, dq, st)
  DS_FLASH_DISPATCH(DS_DQ)
#undef DS_DQ
}
#undef DS_FLASH_DISPATCH
