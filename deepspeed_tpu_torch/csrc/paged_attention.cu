// Paged attention for the v2 serving engine, written for Hopper (sm_90a).
//
// Two kernels over a paged KV cache k/v: (num_blocks, block_size, KV, D),
// indexed through per-sequence block tables (S, max_blocks) int32:
//
//   paged_decode_kernel   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//                         _decode_kernel (entry paged_decode_attention).
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
//           bytes, against 4*ctx*H*D flops: memory-bound by far.  One block
//           per (sequence, kv head) streams the chain once and serves all
//           H/KV query heads of that kv head from it, so K/V bytes are read
//           once, not once per query head; each warp keeps U tokens' loads
//           in flight.  Split-KV (more blocks per long sequence) is later
//           work.
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

constexpr int kDecodeThreads = 256;   // 8 warps
constexpr int kDecodeUnroll = 4;      // tokens in flight per warp
constexpr int kMaxGroup = 8;          // query heads per kv head (decode)
constexpr int kPrefillThreads = 256;  // 32 query vectors x 8 lanes
constexpr int kPrefillVecs = kPrefillThreads / 8;
constexpr int kPrefillChunk = 16;     // kv positions per softmax update

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
  } else if constexpr (N == 4) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, out); unpack2(u.y, out + 2);
  } else {
    static_assert(N == 2, "bf16 vector width must be 2, 4 or 8k");
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

// ---------------------------------------------------------------------------
// decode: grid (S, KV), kDecodeThreads threads.  Lane l of every warp owns
// head dims [l*E, (l+1)*E) of each of the block's `group` query heads; warp w
// takes positions [w*U, w*U+U), [w*U + NW*U, ...), ... of the chain with its
// own online-softmax state, and the warps' states are merged at the end.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, T* __restrict__ out,
                    int H, int KV, int BS, int MB, float scale) {
  constexpr int E = D / 32;
  constexpr int NW = kDecodeThreads / 32;
  constexpr int U = kDecodeUnroll;
  extern __shared__ float smem[];  // [NW][group] m, [NW][group] l, [NW][group][D] acc

  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = H / KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ctx = min(context_lens[s], MB * BS);
  T* o = out + ((size_t)s * H + (size_t)kvh * group) * D;
  if (ctx <= 0) {  // an inactive row: zeros, never NaN
    for (int i = threadIdx.x; i < group * D; i += blockDim.x) o[i] = from_float<T>(0.f);
    return;
  }

  float qr[kMaxGroup][E], acc[kMaxGroup][E], m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) { qr[g][e] = 0.f; acc[g][e] = 0.f; }
    if (g < group) {
      load_vec<E>(q + ((size_t)s * H + (size_t)kvh * group + g) * D + lane * E, qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= scale;
    }
  }

  const int* bt = block_tables + (size_t)s * MB;
  const size_t slot_stride = (size_t)KV * D;  // between neighbouring slots of a block
  for (int base = warp * U; base < ctx; base += NW * U) {
    float kf[U][E], vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      if (p < ctx) {
        const int j = p / BS;
        const size_t row = ((size_t)bt[j] * BS + (p - j * BS)) * slot_stride +
                           (size_t)kvh * D + lane * E;
        load_vec<E>(k_cache + row, kf[u]);
        load_vec<E>(v_cache + row, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u >= ctx) break;  // warp-uniform
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;  // block-uniform
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kf[u][e], d);
        d = warp_sum(d);
        const float m_new = fmaxf(m[g], d);
        const float alpha = expf(m[g] - m_new);  // m = -inf on the first token -> 0
        const float p = expf(d - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  float* sm_m = smem;
  float* sm_l = sm_m + NW * group;
  float* sm_acc = sm_l + NW * group;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    if (lane == 0) { sm_m[warp * group + g] = m[g]; sm_l[warp * group + g] = l[g]; }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[((size_t)warp * group + g) * D + lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * group + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float mw = sm_m[w * group + g];
      if (mw == -INFINITY) continue;  // a warp that saw no position
      const float c = expf(mw - mx);
      den += c * sm_l[w * group + g];
      num += c * sm_acc[((size_t)w * group + g) * D + d];
    }
    o[(size_t)g * D + d] = from_float<T>(den > 0.f ? num / den : 0.f);
  }
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
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* bt, const int* ctx, void* out, int S, int H,
                          int KV, int BS, int MB, cudaStream_t stream) {
  const int group = H / KV;
  const size_t smem = (size_t)(kDecodeThreads / 32) * group * (D + 2) * sizeof(float);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, KV), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bt, ctx, static_cast<T*>(out), H, KV, BS, MB, 1.0f / sqrtf((float)D));
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
                               const void* context_lens, void* out, int S, int H,
                               int KV, int D, int BS, int MB, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (S == 0) return cudaSuccess;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ctx = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DECODE(T, DD) \
  return (int)launch_decode<T, DD>(q, k_cache, v_cache, bt, ctx, out, S, H, KV, BS, MB, st)
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
