// Paged attention for the v2 serving engine, written for Hopper (sm_90a).
//
// Two kernels over a paged KV cache k/v: (num_blocks, block_size, KV, D),
// indexed through per-sequence block tables (S, max_blocks) int32:
//
//   paged_decode_kernel   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//   (+ decode_merge_kernel) _decode_kernel (entry paged_decode_attention).
//                         One query token per sequence; context_lens include
//                         the current token; ctx = 0 rows write zeros.
//   paged_prefill_kernel  replaces paged_attention.py _prefill_kernel (entry
//                         paged_prefill_attention).  Chunked prefill: row i
//                         of sequence s sits at absolute position
//                         chunk_start[s] + i and sees cache positions <= its
//                         own and < chunk_start[s] + chunk_len[s]; rows
//                         >= chunk_len[s] write zeros.
//
// Both accumulate in f32 with an online softmax scaled by 1/sqrt(D), take
// bf16 or f32 in and write the query's dtype.  Plain C entry points (bound
// from Python with ctypes) launch on the caller's stream, allocate nothing,
// and return cudaGetLastError() after the launch.
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   decode  reads each sequence's K and V once per kv head, 2*ctx*KV*D*2
//           bytes, against 4*ctx*H*D flops: memory-bound by far, and at a
//           serving batch (8 sequences x 8 kv heads) one block per (sequence,
//           kv head) would fill half the card's 132 SMs and wait on its
//           longest chain.  So the chain is split (flash-decoding): one
//           block per (sequence, kv head, split of `split` positions, 128 or
//           more, fixed by the shapes MB * BS, never by context_lens), each
//           streaming its positions once with whole 16-byte slot-row copies
//           (cp.async, two tiles in flight) and serving all H/KV query
//           heads of its kv head from them.  Splits past a row's context
//           exit at once; a chain of one split writes its output directly,
//           longer ones write f32 partials (m, l, acc) to a workspace the
//           wrapper sizes from the shapes, and a second kernel merges them
//           in split order (deterministic, no atomics).  Scores are a dot
//           per (head, key) on the CUDA cores and one softmax update per
//           tile: at the smoke's contexts the whole call is ~73 MFLOP.
//   prefill at 256-row chunks does ~ctx flops per byte of K/V, above the
//           card's ridge of ~295 flops/byte, so its bound is the tensor
//           cores; this first kernel computes on the CUDA cores with shuffle
//           reductions and is far from that bound.  One block per (sequence,
//           q tile, kv head) stages each K/V block of its kv head in shared
//           memory (64 x 128 bf16 = 16 KB each) and reuses it for every
//           query row and query head of the tile.  wgmma, TMA and
//           double-buffered loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDecodeThreads = 128;   // 4 warps
constexpr int kMaxGroup = 8;          // query heads per kv head (decode)
constexpr int kMaxSplits = 32;        // split-KV blocks per chain (decode)
constexpr int kPrefillThreads = 256;  // 32 query vectors x 8 lanes
constexpr int kPrefillVecs = kPrefillThreads / 8;
constexpr int kPrefillChunk = 16;     // kv positions per softmax update

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous elements at p (aligned to N * sizeof(T)) into f32 registers
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      float4 u = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = u.x; out[4 * i + 1] = u.y;
      out[4 * i + 2] = u.z; out[4 * i + 3] = u.w;
    }
  } else {
    static_assert(N == 2, "f32 vector width must be 2 or a multiple of 4");
    float2 u = *reinterpret_cast<const float2*>(p);
    out[0] = u.x; out[1] = u.y;
  }
}

__device__ __forceinline__ void unpack2(uint32_t w, float* out) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  float2 f = __bfloat1622float2(h);
  out[0] = f.x; out[1] = f.y;
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack2(u.x, out + 8 * i); unpack2(u.y, out + 8 * i + 2);
      unpack2(u.z, out + 8 * i + 4); unpack2(u.w, out + 8 * i + 6);
    }
  } else {
    static_assert(N == 2, "bf16 vector width must be 2 or 8k");
    unpack2(*reinterpret_cast<const uint32_t*>(p), out);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// sum over the aligned group of 8 lanes that owns one query vector
__device__ __forceinline__ float octet_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

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

// wait until at most N of this thread's most recent copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// decode, split-KV (flash-decoding): a 1-D grid of S * KV * NS blocks, one
// per (sequence, kv head, split of `split` positions), kDecodeThreads
// threads.  A split walks its positions in tiles of kKeys through a 2-stage
// cp.async ring of whole K and V slot rows (16-byte copies; both stages are
// in flight from the start, and each refills as soon as it is used); per
// tile:
//   scores  each thread owns (head, key) pairs: a dot over D from the K
//           row in shared memory and the pre-scaled q (log2 domain);
//   softmax warp w owns heads w, w + 4: one max and one rescale per tile;
//   P V     each thread owns a column pair of up to 4 heads' outputs.
// A chain that fits one split writes its output here; longer chains write
// each split's (m, l, acc) in f32 to the workspace, and decode_merge_kernel
// combines them in split order.
// ---------------------------------------------------------------------------
template <typename T, int D>
struct Decode {
  static constexpr int kKeys = 128 / (int)sizeof(T);       // per tile: 64 bf16, 32 f32
  static constexpr int kElems = 16 / (int)sizeof(T);       // per 16-byte chunk
  static constexpr int kChunks = D / kElems;               // per K or V row
  static constexpr int kRow = D * (int)sizeof(T) + 16;     // padded shared row, bytes
  static constexpr int kTileBytes = kKeys * kRow;          // K or V of one tile
  static constexpr int kStageBytes = 2 * kTileBytes;       // K then V
  static constexpr int kPairs = D / 2;                     // output column pairs
  static constexpr int kHeadStep = kDecodeThreads / kPairs;
  static constexpr int kHeads = kMaxGroup / kHeadStep;     // heads per thread in P V
  static constexpr int kWarps = kDecodeThreads / 32;
  // stages, then q [8][D], p [8][kKeys], alpha [8], m [8], l [8] as f32
  static constexpr int kSmem = 2 * kStageBytes + kMaxGroup * (D + kKeys + 3) * 4;
  static_assert(kDecodeThreads % kChunks == 0 && kKeys % (kDecodeThreads / kChunks) == 0,
                "whole rows per copy pass");
  static_assert(kDecodeThreads % kPairs == 0 && kMaxGroup % kHeadStep == 0, "P V split");
};

// q[0..D) . row[0..D), row a T row in shared memory; kElems independent
// sums, so the FMAs do not form one dependent chain
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* q, const uint8_t* row) {
  constexpr int E = 16 / (int)sizeof(T);
  float part[E];
#pragma unroll
  for (int e = 0; e < E; ++e) part[e] = 0.f;
#pragma unroll
  for (int c = 0; c < D / E; ++c) {
    float kf[E], qf[E];
    load_vec<E>(reinterpret_cast<const T*>(row) + c * E, kf);
    load_vec<E>(q + c * E, qf);
#pragma unroll
    for (int e = 0; e < E; ++e) part[e] = fmaf(qf[e], kf[e], part[e]);
  }
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) d += part[e];
  return d;
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, T* __restrict__ out,
                    float* __restrict__ ws, int S, int H, int KV, int BS, int MB,
                    int split, float scale) {
  using L = Decode<T, D>;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  float* q_s = reinterpret_cast<float*>(dec_smem + 2 * L::kStageBytes);  // [8][D]
  float* p_s = q_s + kMaxGroup * D;                                      // [8][kKeys]
  float* alpha_s = p_s + kMaxGroup * L::kKeys;                           // [8]
  float* m_s = alpha_s + kMaxGroup;
  float* l_s = m_s + kMaxGroup;

  const int ns = (MB * BS + split - 1) / split;
  const int sp = blockIdx.x % ns;
  const int kvh = (blockIdx.x / ns) % KV;
  const int s = blockIdx.x / (ns * KV);
  const int group = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ctx = min(context_lens[s], MB * BS);
  const int lo = sp * split;
  T* o = out + ((size_t)s * H + (size_t)kvh * group) * D;
  if (ctx <= 0) {  // an inactive row: zeros, never NaN, from the first split
    if (sp == 0)
      for (int i = tid; i < group * D; i += kDecodeThreads) o[i] = from_float<T>(0.f);
    return;
  }
  if (lo >= ctx) return;  // past the context: nothing to add
  const int hi = min(ctx, lo + split);
  const int nsplit = (ctx + split - 1) / split;  // splits this row uses

  // tile copies: thread t moves 16-byte chunk t % kChunks of rows t /
  // kChunks, + R, + 2R, ...; rows past the split's end become zeros
  constexpr int R = kDecodeThreads / L::kChunks;
  const int row0 = tid / L::kChunks, col = (tid % L::kChunks) * L::kElems;
  const int* bt = block_tables + (size_t)s * MB;
  const size_t slot_stride = (size_t)KV * D;
  auto load_tile = [&](int c0, int st) {
    uint8_t* ks = dec_smem + st * L::kStageBytes;
    uint8_t* vs = ks + L::kTileBytes;
#pragma unroll
    for (int i = 0; i < L::kKeys / R; ++i) {
      const int r = row0 + i * R, pos = c0 + r;
      const int off = r * L::kRow + col * (int)sizeof(T);
      if (pos < hi) {
        const int j = pos / BS;
        const size_t at =
            ((size_t)bt[j] * BS + (pos - j * BS)) * slot_stride + (size_t)kvh * D + col;
        cp_async16(ks + off, k_cache + at);
        cp_async16(vs + off, v_cache + at);
      } else {
        *reinterpret_cast<uint4*>(ks + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + off) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  // softmax state of this warp's heads (warp, warp + kWarps), m replicated
  // over the lanes, l a per-lane share; P V accumulators of this thread's
  // column pair for heads hg, hg + kHeadStep, ...
  constexpr int WH = kMaxGroup / L::kWarps;
  float m[WH], l[WH];
#pragma unroll
  for (int i = 0; i < WH; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  const int hg = tid / L::kPairs, cp = tid % L::kPairs;
  float acc[L::kHeads][2];
#pragma unroll
  for (int i = 0; i < L::kHeads; ++i) acc[i][0] = acc[i][1] = 0.f;

  // one copy group per tile, the first two at once; q of the group's heads,
  // scaled into the log2 domain, while they fly
  load_tile(lo, 0);
  cp_async_commit();
  if (lo + L::kKeys < hi) load_tile(lo + L::kKeys, 1);
  cp_async_commit();
  const float qscale = scale * 1.4426950408889634f;
  for (int i = tid; i < group * D; i += kDecodeThreads)
    q_s[i] = to_float(q[((size_t)s * H + (size_t)kvh * group) * D + i]) * qscale;
  int st = 0;
  for (int c0 = lo; c0 < hi; c0 += L::kKeys, st ^= 1) {
    cp_async_wait<1>();  // this tile's group is in (the next may be pending)
    __syncthreads();
    const uint8_t* ks = dec_smem + st * L::kStageBytes;
    const uint8_t* vs = ks + L::kTileBytes;
    const int nk = min(L::kKeys, hi - c0);  // >= 1

    // scores, log2 domain; keys past the split's end are -inf
    for (int e = tid; e < group * L::kKeys; e += kDecodeThreads) {
      const int g = e / L::kKeys, j = e - g * L::kKeys;
      p_s[e] = j < nk ? dot_row<T, D>(q_s + g * D, ks + j * L::kRow) : -INFINITY;
    }
    __syncthreads();

    // one online-softmax update per head and tile; the tile holds a kept
    // key, so its max and m_new are finite and alpha = 0 on the first tile
#pragma unroll
    for (int i = 0; i < WH; ++i) {
      const int g = warp + i * L::kWarps;
      if (g >= group) break;  // warp-uniform
      float x[L::kKeys / 32], mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < L::kKeys / 32; ++u) {
        x[u] = p_s[g * L::kKeys + lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float a = exp2f(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < L::kKeys / 32; ++u) {
        const float pv = exp2f(x[u] - m_new);  // -inf -> 0
        p_s[g * L::kKeys + lane + 32 * u] = pv;
        ps += pv;
      }
      l[i] = l[i] * a + ps;
      m[i] = m_new;
      if (lane == 0) alpha_s[g] = a;
    }
    __syncthreads();

    // acc = acc alpha + P V over the tile's rows (zeros past nk, p = 0)
#pragma unroll
    for (int i = 0; i < L::kHeads; ++i) {
      const int g = hg + i * L::kHeadStep;
      const float alpha = g < group ? alpha_s[g] : 0.f;
      acc[i][0] *= alpha;
      acc[i][1] *= alpha;
    }
    const int nk4 = (nk + 3) & ~3;
    for (int j = 0; j < nk4; j += 4) {
      float v2[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load_vec<2>(reinterpret_cast<const T*>(vs + (j + u) * L::kRow) + 2 * cp, v2[u]);
#pragma unroll
      for (int i = 0; i < L::kHeads; ++i) {
        const int g = hg + i * L::kHeadStep;
        if (g >= group) break;  // warp-uniform
        const float4 p4 = *reinterpret_cast<const float4*>(p_s + g * L::kKeys + j);
        const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(pp[u], v2[u][0], acc[i][0]);
          acc[i][1] = fmaf(pp[u], v2[u][1], acc[i][1]);
        }
      }
    }
    __syncthreads();  // everyone is done with this stage: refill it
    if (c0 + 2 * L::kKeys < hi) load_tile(c0 + 2 * L::kKeys, st);
    cp_async_commit();
  }

  // each head's m and l: the warp's lanes sum their shares of l
#pragma unroll
  for (int i = 0; i < WH; ++i) {
    const int g = warp + i * L::kWarps;
    if (g >= group) break;
    const float lt = warp_sum(l[i]);
    if (lane == 0) { m_s[g] = m[i]; l_s[g] = lt; }
  }
  __syncthreads();
  const size_t part = ((size_t)s * KV + kvh) * ns + sp;  // this split's workspace slot
#pragma unroll
  for (int i = 0; i < L::kHeads; ++i) {
    const int g = hg + i * L::kHeadStep;
    if (g >= group) break;
    if (nsplit == 1) {  // the whole chain: the output itself
      const float inv = 1.f / l_s[g];
      o[(size_t)g * D + 2 * cp] = from_float<T>(acc[i][0] * inv);
      o[(size_t)g * D + 2 * cp + 1] = from_float<T>(acc[i][1] * inv);
    } else {
      *reinterpret_cast<float2*>(ws + (part * group + g) * D + 2 * cp) =
          make_float2(acc[i][0], acc[i][1]);
    }
  }
  if (nsplit > 1 && tid < group) {
    float* ml = ws + (size_t)S * KV * ns * group * D + (part * group + tid) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// the splits of every chain longer than one split, merged in split order:
// one block per (sequence, query head), D threads, one output element each;
// out = sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const int* __restrict__ context_lens, const float* __restrict__ ws,
                    T* __restrict__ out, int S, int H, int KV, int BS, int MB, int split) {
  __shared__ float m_s[kMaxSplits], l_s[kMaxSplits];
  const int ns = (MB * BS + split - 1) / split;
  const int group = H / KV;
  const int g = blockIdx.x % group, kvh = (blockIdx.x / group) % KV;
  const int s = blockIdx.x / (group * KV);
  const int ctx = min(context_lens[s], MB * BS);
  const int nsplit = (ctx + split - 1) / split;
  if (nsplit <= 1) return;  // written by its only split (or zeros)
  const size_t part0 = ((size_t)s * KV + kvh) * ns;
  if (threadIdx.x < nsplit) {
    const float* ml = ws + (size_t)S * KV * ns * group * D + ((part0 + threadIdx.x) * group + g) * 2;
    m_s[threadIdx.x] = ml[0];
    l_s[threadIdx.x] = ml[1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, m_s[i]);
  const float* acc = ws + (part0 * group + g) * D + threadIdx.x;  // split i: + i group D
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i) {
    const float c = exp2f(m_s[i] - mx);
    den = fmaf(c, l_s[i], den);
    num = fmaf(c, acc[(size_t)i * group * D], num);
  }
  out[((size_t)s * H + (size_t)kvh * group + g) * D + threadIdx.x] = from_float<T>(num / den);
}

// ---------------------------------------------------------------------------
// prefill: grid (S, ceil(Qp / tq), KV), kPrefillThreads threads, tq =
// kPrefillVecs / group query rows per tile.  Each aligned group of 8 lanes
// owns one (row, head) query vector; lane `sub` of it holds head dims
// c*64 + sub*8 + [0, 8) for c < D/64, so the 8 lanes read 128 contiguous
// bytes of a staged bf16 K/V row per 16-byte load (no bank conflicts).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                     const T* __restrict__ v_cache,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ chunk_start,
                     const int* __restrict__ chunk_len, T* __restrict__ out,
                     int Qp, int H, int KV, int BS, int MB, float scale) {
  constexpr int NCH = D / 64;
  constexpr int PER = 8 * NCH;  // head dims per lane
  constexpr int CH = kPrefillChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [BS][D]
  T* v_s = k_s + (size_t)BS * D;            // [BS][D]

  const int s = blockIdx.x;
  const int kvh = blockIdx.z;
  const int group = H / KV;
  const int tq = kPrefillVecs / group;
  const int vec = threadIdx.x >> 3;
  const int sub = threadIdx.x & 7;
  const int r = vec / group;
  const int h = kvh * group + (vec - r * group);
  const int tile_lo = blockIdx.y * tq;
  const int row = tile_lo + r;
  const bool in_q = row < Qp;
  const int start = chunk_start[s];
  const int qlen = chunk_len[s];
  T* o = out + (((size_t)s * Qp + row) * H + h) * D;

  if (tile_lo >= qlen) {  // inactive tile (block-uniform): zeros
    if (in_q) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[c * 64 + sub * 8 + e] = from_float<T>(0.f);
    }
    return;
  }
  const bool q_valid = in_q && row < qlen;
  const int ctx_end = start + qlen;
  const int q_abs = start + row;
  const int kv_hi = min(ctx_end, start + tile_lo + tq);  // causal bound of the tile
  const int nblocks = min((kv_hi + BS - 1) / BS, MB);

  float qr[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) { qr[i] = 0.f; acc[i] = 0.f; }
  if (in_q) {
    const T* qp = q + (((size_t)s * Qp + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float t8[8];
      load_vec<8>(qp + c * 64 + sub * 8, t8);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[c * 8 + e] = t8[e] * scale;
    }
  }
  float m = -INFINITY, l = 0.f;

  const int* bt = block_tables + (size_t)s * MB;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  const int row_vecs = D / VEC;
  for (int j = 0; j < nblocks; ++j) {
    const size_t blk = (size_t)bt[j];
    __syncthreads();  // every thread is done with the previous block
    for (int i = threadIdx.x; i < BS * row_vecs; i += blockDim.x) {
      const int t = i / row_vecs, c = i - t * row_vecs;
      const size_t src = ((blk * BS + t) * KV + kvh) * D + (size_t)c * VEC;
      reinterpret_cast<uint4*>(k_s + (size_t)t * D)[c] =
          reinterpret_cast<const uint4*>(k_cache + src)[0];
      reinterpret_cast<uint4*>(v_s + (size_t)t * D)[c] =
          reinterpret_cast<const uint4*>(v_cache + src)[0];
    }
    __syncthreads();
    for (int t0 = 0; t0 < BS; t0 += CH) {
      float sc[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int t = t0 + u;
        float d = 0.f;
        if (t < BS) {  // block-uniform
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float k8[8];
            load_vec<8>(k_s + (size_t)t * D + c * 64 + sub * 8, k8);
#pragma unroll
            for (int e = 0; e < 8; ++e) d = fmaf(qr[c * 8 + e], k8[e], d);
          }
        }
        d = octet_sum(d);
        const int pos = j * BS + t;
        const bool keep = q_valid && t < BS && pos <= q_abs && pos < ctx_end;
        sc[u] = keep ? d : -INFINITY;
        cmax = fmaxf(cmax, sc[u]);
      }
      const float m_new = fmaxf(m, cmax);
      // still nothing visible: keep the state as it is (alpha 1, p 0)
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const float p = sc[u] == -INFINITY ? 0.f : expf(sc[u] - m_new);
        if (p != 0.f) {
          psum += p;
          const int t = t0 + u;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float v8[8];
            load_vec<8>(v_s + (size_t)t * D + c * 64 + sub * 8, v8);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[c * 8 + e] = fmaf(p, v8[e], acc[c * 8 + e]);
          }
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (in_q) {
    const float inv = (q_valid && l > 0.f) ? 1.f / l : 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[c * 64 + sub * 8 + e] = from_float<T>(acc[c * 8 + e] * inv);
  }
}

constexpr int kMaxSmem = 227 * 1024;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* bt,
                          const int* ctx, void* out, float* ws, int S, int H, int KV, int BS,
                          int MB, int split, cudaStream_t stream) {
  using L = Decode<T, D>;
  const int ns = (MB * BS + split - 1) / split;
  if (split <= 0 || split % L::kKeys != 0 || ns > kMaxSplits || (ns > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<S * KV * ns, kDecodeThreads, L::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bt, ctx,
      static_cast<T*>(out), ws, S, H, KV, BS, MB, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || ns == 1) return err;
  decode_merge_kernel<T, D><<<S * H, D, 0, stream>>>(
      ctx, ws, static_cast<T*>(out), S, H, KV, BS, MB, split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const int* bt, const int* cs, const int* cl, void* out,
                           int S, int Qp, int H, int KV, int BS, int MB,
                           cudaStream_t stream) {
  const int tq = kPrefillVecs / (H / KV);
  const size_t smem = 2 * (size_t)BS * D * sizeof(T);
  auto kernel = paged_prefill_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, (Qp + tq - 1) / tq, KV), kPrefillThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bt, cs, cl, static_cast<T*>(out), Qp, H, KV, BS, MB, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128; H / KV: 1, 2, 4 or 8.  The
// Python wrapper checks shapes before it calls; a dtype or D outside these
// gives cudaErrorInvalidValue.  Returns a cudaError_t.
extern "C" int ds_paged_decode(int dtype, const void* q, const void* k_cache,
                               const void* v_cache, const void* block_tables,
                               const void* context_lens, void* out, void* workspace, int S,
                               int H, int KV, int D, int BS, int MB, int split, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (S == 0) return cudaSuccess;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(context_lens);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DECODE(T, DD) \
  return (int)launch_decode<T, DD>(q, k_cache, v_cache, bt, ctx, out, ws, S, H, KV, BS, MB, split, st)
  if (dtype == 1) {
    if (D == 64) DS_DECODE(__nv_bfloat16, 64);
    if (D == 128) DS_DECODE(__nv_bfloat16, 128);
  }
  if (dtype == 0) {
    if (D == 64) DS_DECODE(float, 64);
    if (D == 128) DS_DECODE(float, 128);
  }
#undef DS_DECODE
  return cudaErrorInvalidValue;
}

extern "C" int ds_paged_prefill(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const void* block_tables,
                                const void* chunk_start, const void* chunk_len,
                                void* out, int S, int Qp, int H, int KV, int D,
                                int BS, int MB, void* stream) {
  cudaGetLastError();
  if (S == 0 || Qp == 0) return cudaSuccess;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cs = static_cast<const int*>(chunk_start);
  const int* cl = static_cast<const int*>(chunk_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_PREFILL(T, DD) \
  return (int)launch_prefill<T, DD>(q, k_cache, v_cache, bt, cs, cl, out, S, Qp, H, KV, BS, MB, st)
  if (dtype == 1) {
    if (D == 64) DS_PREFILL(__nv_bfloat16, 64);
    if (D == 128) DS_PREFILL(__nv_bfloat16, 128);
  }
  if (dtype == 0) {
    if (D == 64) DS_PREFILL(float, 64);
    if (D == 128) DS_PREFILL(float, 128);
  }
#undef DS_PREFILL
  return cudaErrorInvalidValue;
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
