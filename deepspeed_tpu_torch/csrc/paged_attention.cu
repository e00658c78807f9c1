// Paged attention for the v2 serving engine, written for Hopper (sm_90a).
//
// Two kernels over a paged KV cache k/v: (num_blocks, block_size, KV, D),
// indexed through per-sequence block tables (S, max_blocks) int32:
//
//   paged_decode_kernel   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//   (+ decode_merge_kernel) _decode_kernel (entry paged_decode_attention).
//                         One query token per sequence; context_lens include
//                         the current token; ctx = 0 rows write zeros.
//   paged_prefill_tc_kernel  replace paged_attention.py _prefill_kernel
//   (bf16, f16), paged_      (entry paged_prefill_attention).  Chunked
//   prefill_kernel (f32)     prefill: row i of sequence s sits at absolute
//                            position chunk_start[s] + i and sees cache
//                            positions <= its own and < chunk_start[s] +
//                            chunk_len[s]; rows >= chunk_len[s] write
//                            zeros.  The dispatch is on dtype (each dtype
//                            has exactly one kernel; not a fallback).
//
// All accumulate in f32 with an online softmax scaled by 1/sqrt(D), take
// bf16, f16 or f32 in and write the query's dtype (the output rounds
// once).  Plain C entry points (bound from Python with ctypes) launch on
// the caller's stream, allocate nothing, and return cudaGetLastError()
// after the launch.
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
//   prefill at the smoke's chunks (8 sequences of up to 256 rows,
//           contexts up to 1200) moves ~39 MB, q and o most of it, for ~7.1
//           GFLOP: its least time is set by the bytes, 0.012 ms.  The
//           kernel does ~13 GFLOP of mma.sync work (the split below) and is
//           held back by the issue rate and latency of its products and by
//           the partial tiles on the causal edge.
//           paged_prefill_tc_kernel (bf16) is the flash forward of
//           flash_attention.cu with paged K/V: a block owns 128 query
//           vectors (row, head of the kv head's group) of one (sequence,
//           kv head), 8 warps of 16, Q held in registers as mma.sync
//           m16n8k16 A fragments, so a 256-row chunk reads its chain once
//           per 128 vectors (Qp * group / 128 times).  It walks its
//           band in 64-key tiles through a two-stage cp.async ring; each
//           key row looks up its page in the block table, so a tile may
//           span several pages or part of one, and neither the grid nor the
//           shared memory depends on the block size.  S = Q K^T, an
//           online softmax in the log2 domain (ex2.approx), then O += (P_hi
//           + P_lo) V with P split into two bf16 halves (P rounded to bf16
//           alone misses the smoke's bf16 limit at its prefill shape;
//           tests/test_torch_paged_attention.py emulates both), V by
//           ldmatrix.trans.  Tiles are classified once per block (full: no
//           element mask; partial: the causal edge and the chunk end), and
//           only partial tiles run the masked softmax.  f16 runs the same
//           kernel at E = __half (mma.sync m16n8k16 f16 -> f32): q, k and v
//           products are exact in f32 as bf16's are, and p <= 1 is split
//           into f16 hi/lo after a multiply by 2^14 (kHalfP), so that no p
//           >= 2^-28 falls under f16's normal range (2^-14); l carries the
//           same factor, so it cancels in o = acc / l.  f32 keeps
//           paged_prefill_kernel: CUDA-core dot products over one staged
//           K/V block per step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kDecodeThreads = 128;   // 4 warps
constexpr int kMaxGroup = 8;          // query heads per kv head (decode)
constexpr int kMaxSplits = 32;        // split-KV blocks per chain (decode)
constexpr int kPrefillThreads = 256;  // 32 query vectors x 8 lanes
constexpr int kPrefillVecs = kPrefillThreads / 8;
constexpr int kPrefillChunk = 16;     // kv positions per softmax update

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
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

// a packed pair of T (bf16 or f16) into two f32
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t w, float* out) {
  float2 f;
  if constexpr (std::is_same<T, __half>::value)
    f = __half22float2(*reinterpret_cast<__half2*>(&w));
  else
    f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  out[0] = f.x; out[1] = f.y;
}

// the 2-byte types: bf16 or f16
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  static_assert(sizeof(T) == 2, "bf16 or f16");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack2<T>(u.x, out + 8 * i); unpack2<T>(u.y, out + 8 * i + 2);
      unpack2<T>(u.z, out + 8 * i + 4); unpack2<T>(u.w, out + 8 * i + 6);
    }
  } else {
    static_assert(N == 2, "bf16 / f16 vector width must be 2 or 8k");
    unpack2<T>(*reinterpret_cast<const uint32_t*>(p), out);
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
// f32 prefill: grid (S, ceil(Qp / tq), KV), kPrefillThreads threads, tq =
// kPrefillVecs / group query rows per tile.  Each aligned group of 8 lanes
// owns one (row, head) query vector; lane `sub` of it holds head dims
// c*64 + sub*8 + [0, 8) for c < D/64, so the 8 lanes read 256 contiguous
// bytes of a staged K/V row per pair of 16-byte loads.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k_cache,
                     const float* __restrict__ v_cache,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ chunk_start,
                     const int* __restrict__ chunk_len, float* __restrict__ out,
                     int Qp, int H, int KV, int BS, int MB, float scale) {
  constexpr int NCH = D / 64;
  constexpr int PER = 8 * NCH;  // head dims per lane
  constexpr int CH = kPrefillChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [BS][D]
  float* v_s = k_s + (size_t)BS * D;                // [BS][D]

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
  float* o = out + (((size_t)s * Qp + row) * H + h) * D;

  if (tile_lo >= qlen) {  // inactive tile (block-uniform): zeros
    if (in_q) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[c * 64 + sub * 8 + e] = 0.f;
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
    const float* qp = q + (((size_t)s * Qp + row) * H + h) * D;
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
  constexpr int VEC = 4;  // elements per 16-byte copy
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
        o[c * 64 + sub * 8 + e] = acc[c * 8 + e] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 prefill on the tensor cores.  The helpers below are those of
// the flash forward (csrc/flash_attention.cu), kept here so that each
// source builds alone.  E, the element type: __nv_bfloat16 or __half (the
// same m16n8k16 shape and fragments, f32 accumulators).
// ---------------------------------------------------------------------------
constexpr int kTcWarps = 8;               // 16 query vectors per warp
constexpr int kTcVecs = 16 * kTcWarps;    // 128 per block, one block per SM
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcKeys = 64;               // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
// f16: p <= 1 leaves the softmax multiplied by 2^14, which keeps every p >=
// 2^-28 in f16's normal range and p 2^14 <= 16384 under its 65504; l
// carries the same factor, so o = acc / l is unchanged
constexpr float kHalfP = 16384.f;

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

// (x0, x1) rounded to nearest into one packed pair of E (x0 in the low half)
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

// (x0, x1) -> hi = E(x), lo = E(x - hi) as packed pairs (x0 in the low
// half, the lower column of an A fragment)
template <typename E>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_pair<E>(x0, x1);
  float hf[2];
  unpack2<E>(hi, hf);
  lo = pack_pair<E>(x0 - hf[0], x1 - hf[1]);
}

// the A fragments (hi and lo) of k-step kk of a 16 x 64 accumulator tile
// acc[8][4] (rows gr, gr + 8; columns 8j + 2tq, +1 of n-tile j)
template <typename E>
__device__ __forceinline__ void a_split(const float (&acc)[8][4], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_pair<E>(acc[2 * kk][0], acc[2 * kk][1], hi[0], lo[0]);
  split_pair<E>(acc[2 * kk][2], acc[2 * kk][3], hi[1], lo[1]);
  split_pair<E>(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[2], lo[2]);
  split_pair<E>(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[3], lo[3]);
}

// C[16 x 64] += A[16 x 16] . B^T, B a [n][k] E shared tile (rows 0..63,
// stride ROW bytes): plain ldmatrix gives the col-major B fragments.  All
// fragments are loaded before the products, so no mma waits on a load.
template <typename E, int ROW>
__device__ __forceinline__ void mma_bt(float (&c)[8][4], const uint32_t (&a)[4],
                                       const uint8_t* b, int k0, int lane) {
  uint32_t r[4][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int n = jj * 16 + (lane & 7) + ((lane >> 4) << 3);
    const int k = k0 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(r[jj], b + n * ROW + k * 2);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    mma_tc<E>(c[2 * jj], a, r[jj][0], r[jj][1]);
    mma_tc<E>(c[2 * jj + 1], a, r[jj][2], r[jj][3]);
  }
}

// C[16 x D] += (hi + lo)[16 x 16] . B, B a [k][n] E shared tile whose
// rows k0..k0+15 are read with ldmatrix.trans.  In groups of 8 n-tiles:
// the group's fragments first, then its hi products, then its lo products,
// so the two products into one accumulator are 8 apart.
template <typename E, int D, int ROW>
__device__ __forceinline__ void mma_split_b(float (&c)[D / 8][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const uint8_t* b, int k0,
                                            int lane) {
  constexpr int G = 4;  // ldmatrix.x4 per group: 8 n-tiles
  static_assert((D / 16) % G == 0, "D is 64 or 128");
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

template <int D>
struct PrefillTc {
  static constexpr int kRow = (D + 8) * 2;  // 2-byte row padded by 16 bytes: ldmatrix's 8
                                            // rows hit 8 bank groups
  static constexpr int kChunks = D / 8;     // 16-byte chunks per row
  static constexpr int kPass = kTcThreads / kChunks;  // rows per copy pass
  static constexpr int kQBytes = kTcVecs * kRow;
  static constexpr int kKvBytes = kTcKeys * kRow;     // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;    // K then V
  static constexpr int kSmem = kQBytes + 2 * kStageBytes;
  static_assert(kTcKeys % kPass == 0 && kTcVecs % kPass == 0, "whole copy passes");
};

// One online-softmax step of a warp's 16 x 64 tile, in the log2 domain: s
// holds Q K^T and becomes p; m (the rows' running max), l (this thread's
// share of the row sums) and acc are rescaled.  MASK (a partial tile): key
// c0 + j is kept for vector h iff it is <= lim[h] (-1: a vector with no
// key), and a masked element is -inf and gets p = 0 without an exp.  A row
// with nothing kept yet keeps m = -inf and p = 0.  In f16, p leaves
// multiplied by kHalfP, as do the sums it adds to l.
template <typename E, bool MASK, int D>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 8][4], float sl2,
                                             const int (&lim)[2], int c0, int tq) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sl2;
      if constexpr (MASK) {
        if (c0 + j * 8 + 2 * tq + (e & 1) > lim[e >> 1]) x = -INFINITY;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
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

// 1-D grid of S * KV * ceil(Qp * group / 128) blocks: block b owns the 128
// query vectors (flattened (row, head-in-group), 16 per warp) of (sequence,
// kv head) b % (S * KV), from vector base ((nvb - 1 - b / (S * KV)) * 128),
// so the heaviest vector blocks of every sequence launch first.
template <typename E, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
paged_prefill_tc_kernel(const E* __restrict__ q,
                        const E* __restrict__ k_cache,
                        const E* __restrict__ v_cache,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ chunk_start,
                        const int* __restrict__ chunk_len, E* __restrict__ out,
                        int S, int Qp, int H, int KV, int BS, int MB, float scale) {
  using L = PrefillTc<D>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* q_s = tc_smem;
  uint8_t* kv_s = tc_smem + L::kQBytes;  // 2 stages of [K | V]

  const int group = H / KV;
  const int nvb = (Qp * group + kTcVecs - 1) / kTcVecs;
  const int s = (blockIdx.x % (S * KV)) / KV, kvh = blockIdx.x % KV;
  const int base = (nvb - 1 - (int)(blockIdx.x / (S * KV))) * kTcVecs;
  const int start = chunk_start[s], qlen = min(chunk_len[s], Qp);
  const int r_lo = base / group, r_hi = min(Qp - 1, (base + kTcVecs - 1) / group);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  // keys past the chunk's end, or past the chain, do not exist
  const int kv_end = min(start + qlen, MB * BS);

  // this thread's two vectors, gr and gr + 8 of its warp's 16: row (>= Qp
  // past the end), head, and lim, the last key each sees (-1: none)
  int row[2], head[2], lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gi = base + warp * 16 + gr + 8 * h;
    row[h] = gi / group;
    head[h] = kvh * group + (gi - row[h] * group);
    lim[h] = row[h] < qlen ? min(start + row[h], kv_end - 1) : -1;
  }
  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // the block's band: tiles [0, kt_hi]; tiles below kt_full keep every
  // (vector, key) pair (every vector a live row, every key at or before the
  // first row's position and before the chunk's end).  A block whose first
  // row is past the chunk (block-uniform) only writes zeros.
  int kt_hi = -1, kt_full = 0;
  if (r_lo < qlen) {
    kt_hi = min(start + min(r_hi, qlen - 1), kv_end - 1) / kTcKeys;
    if (r_hi < qlen && base + kTcVecs <= Qp * group)
      kt_full = (min(start + r_lo, kv_end - 1) + 1) / kTcKeys;
  }

  if (kt_hi >= 0) {
    // copies: thread t moves 16-byte chunk t % kChunks of rows t / kChunks,
    // + kPass, ...; each K/V row through the block table, zeros past kv_end
    const int row0 = tid / L::kChunks, col = (tid % L::kChunks) * 8;
    const int* bt = block_tables + (size_t)s * MB;
    const size_t slot = (size_t)KV * D;
    auto load_kv = [&](int kt, int st) {
      uint8_t* ks = kv_s + st * L::kStageBytes;
      uint8_t* vs = ks + L::kKvBytes;
#pragma unroll
      for (int i = 0; i < kTcKeys / L::kPass; ++i) {
        const int r = row0 + i * L::kPass, c = kt * kTcKeys + r;
        const int o = r * L::kRow + col * 2;
        if (c < kv_end) {
          const int j = c / BS;
          const size_t at = ((size_t)bt[j] * BS + (c - j * BS)) * slot + (size_t)kvh * D + col;
          cp_async16(ks + o, k_cache + at);
          cp_async16(vs + o, v_cache + at);
        } else {
          *reinterpret_cast<uint4*>(ks + o) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(vs + o) = make_uint4(0, 0, 0, 0);
        }
      }
    };

    // Q of the block's vectors (zeros past Qp) and the first K/V tile; Q
    // then lives in registers as A fragments for the whole walk
#pragma unroll
    for (int i = 0; i < kTcVecs / L::kPass; ++i) {
      const int vi = row0 + i * L::kPass, gi = base + vi, r = gi / group;
      uint8_t* dst = q_s + vi * L::kRow + col * 2;
      const size_t at = (((size_t)s * Qp + r) * H + kvh * group + (gi - r * group)) * D + col;
      if (r < Qp)
        cp_async16(dst, q + at);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    load_kv(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * L::kRow + (kk * 16 + (lane >> 4) * 8) * 2);

    const float sl2 = scale * kLog2e;
    int st = 0;
    for (int kt = 0; kt <= kt_hi; ++kt, st ^= 1) {
      if (kt < kt_hi) load_kv(kt + 1, st ^ 1);  // in flight while this tile computes
      cp_async_commit();
      const uint8_t* ks = kv_s + st * L::kStageBytes;
      const uint8_t* vs = ks + L::kKvBytes;

      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma_bt<E, L::kRow>(sc, qf[kk], ks, kk * 16, lane);

      if (kt < kt_full)
        softmax_tile<E, false, D>(sc, m, l, acc, sl2, lim, 0, tq);
      else
        softmax_tile<E, true, D>(sc, m, l, acc, sl2, lim, kt * kTcKeys, tq);

      // O += (P_hi + P_lo) V
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        uint32_t hi[4], lo[4];
        a_split<E>(sc, kk, hi, lo);
        mma_split_b<E, D, L::kRow>(acc, hi, lo, vs, kk * 16, lane);
      }

      cp_async_wait<0>();
      __syncthreads();  // the next tile is in; every warp is done with this one
    }
  }

  // o = acc / l; vectors with no key (rows at or past chunk_len) write zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    if (row[h] >= Qp) continue;
    const float inv = (lim[h] >= 0 && lt > 0.f) ? 1.f / lt : 0.f;
    E* orow = out + (((size_t)s * Qp + row[h]) * H + head[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq) =
          pack_pair<E>(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
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

template <int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const int* bt, const int* cs, const int* cl, void* out,
                           int S, int Qp, int H, int KV, int BS, int MB,
                           cudaStream_t stream) {
  const int tq = kPrefillVecs / (H / KV);
  const size_t smem = 2 * (size_t)BS * D * sizeof(float);
  auto kernel = paged_prefill_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, (Qp + tq - 1) / tq, KV), kPrefillThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bt, cs, cl, static_cast<float*>(out), Qp, H, KV, BS, MB,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_prefill_tc(const void* q, const void* k, const void* v, const int* bt,
                              const int* cs, const int* cl, void* out, int S, int Qp, int H,
                              int KV, int BS, int MB, cudaStream_t stream) {
  using L = PrefillTc<D>;
  auto kernel = paged_prefill_tc_kernel<E, D>;
  cudaError_t err = allow_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  const int nvb = (Qp * (H / KV) + kTcVecs - 1) / kTcVecs;
  kernel<<<S * KV * nvb, kTcThreads, L::kSmem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), bt, cs, cl,
      static_cast<E*>(out), S, Qp, H, KV, BS, MB, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D: 64 or 128; H / KV: 1, 2,
// 4 or 8.  The
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
  if (dtype == 2) {
    if (D == 64) DS_DECODE(__half, 64);
    if (D == 128) DS_DECODE(__half, 128);
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
#define DS_PREFILL(DD) \
  return (int)launch_prefill<DD>(q, k_cache, v_cache, bt, cs, cl, out, S, Qp, H, KV, BS, MB, st)
#define DS_PREFILL_TC(E, DD) \
  return (int)launch_prefill_tc<E, DD>(q, k_cache, v_cache, bt, cs, cl, out, S, Qp, H, KV, BS, MB, st)
  if (dtype == 1) {  // bf16: the tensor-core kernel
    if (D == 64) DS_PREFILL_TC(__nv_bfloat16, 64);
    if (D == 128) DS_PREFILL_TC(__nv_bfloat16, 128);
  }
  if (dtype == 2) {  // f16: the same kernel at __half
    if (D == 64) DS_PREFILL_TC(__half, 64);
    if (D == 128) DS_PREFILL_TC(__half, 128);
  }
  if (dtype == 0) {  // f32: the CUDA-core kernel
    if (D == 64) DS_PREFILL(64);
    if (D == 128) DS_PREFILL(128);
  }
#undef DS_PREFILL
#undef DS_PREFILL_TC
  return cudaErrorInvalidValue;
}

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
