// Fused AdamW over one flat vector, written for Hopper (sm_90a).
//
//   fused_adamw_kernel  replaces deepspeed_tpu/ops/fused_optimizers.py
//                       _adam_kernel (entries fused_adamw_flat and
//                       fused_adamw_tree).  For every element, in f32:
//                         m' = b1 m + (1 - b1) g
//                         v' = b2 v + (1 - b2) g g
//                         p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)
//                       with bc = 1 - b^step in f32, step read from device
//                       memory (no host sync per call); p' in p's dtype.
//
// Each operation rounds once, in the plain version's order (__fmul_rn and
// friends keep nvcc from contracting pairs into FMAs; division and square
// root are IEEE).  (1 - b1) and (1 - b2) arrive from the host, computed
// there as the plain version computes them.
//
// Bound on an H100 SXM: one pass that reads p, g, m, v and writes p, m, v,
// 28 bytes per element with f32 parameters and gradients, a few flops each:
// bound by those bytes at 3.35 TB/s.  What the kernel does about it: a
// grid-stride loop over groups of four elements, each thread loading
// 16 bytes at a time from every f32 stream (8 from a bf16 or f16 one) when the
// pointers allow it; the ragged tail, and misaligned pointers, go element
// by element.  Nothing is read twice and nothing is padded.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void adam1(float p, float g, float m, float v, const Hyper& h,
                                      float& po, float& mo, float& vo) {
  mo = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  vo = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = __fdiv_rn(mo, h.bc1);
  const float vh = __fdiv_rn(vo, h.bc2);
  const float upd = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)), __fmul_rn(h.wd, p));
  po = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// four consecutive elements as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, const float4& v) {
  const __half2 a = __floats2half2_rn(v.x, v.y);
  const __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename PT, typename GT>
__global__ void __launch_bounds__(256)
    fused_adamw_kernel(const PT* __restrict__ p, const GT* __restrict__ g,
                       const float* __restrict__ m, const float* __restrict__ v,
                       const int* __restrict__ step, PT* __restrict__ po, float* __restrict__ mo,
                       float* __restrict__ vo, long long n, int vec, Hyper h) {
  const float s = (float)(*step);
  h.bc1 = __fsub_rn(1.0f, powf(h.b1, s));
  h.bc2 = __fsub_rn(1.0f, powf(h.b2, s));
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const long long j = 4 * i;
    const float4 pv = load4(p + j), gv = load4(g + j), mv = load4(m + j), vv = load4(v + j);
    float4 pn, mn, vn;
    adam1(pv.x, gv.x, mv.x, vv.x, h, pn.x, mn.x, vn.x);
    adam1(pv.y, gv.y, mv.y, vv.y, h, pn.y, mn.y, vn.y);
    adam1(pv.z, gv.z, mv.z, vv.z, h, pn.z, mn.z, vn.z);
    adam1(pv.w, gv.w, mv.w, vv.w, h, pn.w, mn.w, vn.w);
    store4(po + j, pn);
    store4(mo + j, mn);
    store4(vo + j, vn);
  }
  for (long long j = 4 * n4 + tid; j < n; j += stride) {
    float pn, mn, vn;
    adam1(to_f(p[j]), to_f(g[j]), m[j], v[j], h, pn, mn, vn);
    po[j] = from_f<PT>(pn);
    mo[j] = mn;
    vo[j] = vn;
  }
}

template <typename PT, typename GT>
cudaError_t launch(const void* p, const void* g, const void* m, const void* v, const int* step,
                   void* po, void* mo, void* vo, long long n, int vec, const Hyper& h,
                   cudaStream_t st) {
  const long long units = vec ? (n + 3) / 4 : n;
  const long long want = (units + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  fused_adamw_kernel<PT, GT><<<blocks, 256, 0, st>>>(
      static_cast<const PT*>(p), static_cast<const GT*>(g), static_cast<const float*>(m),
      static_cast<const float*>(v), step, static_cast<PT*>(po), static_cast<float*>(mo),
      static_cast<float*>(vo), n, vec, h);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

}  // namespace

// p_dtype, g_dtype: 0 = f32, 1 = bf16, 2 = f16.  p, g, m, v and the outputs po, mo,
// vo: n elements each (m, v, mo, vo f32); step: one device int32.
// omb1 = 1 - b1 and omb2 = 1 - b2, as the host computes them.
extern "C" int ds_fused_adamw(int p_dtype, int g_dtype, const void* p, const void* g,
                              const void* m, const void* v, const void* step, void* po, void* mo,
                              void* vo, long long n, float lr, float b1, float b2, float omb1,
                              float omb2, float eps, float wd, void* stream) {
  cudaGetLastError();  // a stale error must not be blamed on this launch
  if (n == 0) return cudaSuccess;
  if (n < 0) return cudaErrorInvalidValue;
  const Hyper h{lr, b1, b2, omb1, omb2, eps, wd, 0.0f, 0.0f};
  const int pb = p_dtype != 0 ? 8 : 16, gb = g_dtype != 0 ? 8 : 16;
  const int vec = aligned(p, pb) && aligned(po, pb) && aligned(g, gb) && aligned(m, 16) &&
                  aligned(v, 16) && aligned(mo, 16) && aligned(vo, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(step);
#define DS_ADAM(PT, GT) return (int)launch<PT, GT>(p, g, m, v, sp, po, mo, vo, n, vec, h, st)
#define DS_ADAM_G(PT)                               \
  do {                                              \
    if (g_dtype == 0) DS_ADAM(PT, float);           \
    if (g_dtype == 1) DS_ADAM(PT, __nv_bfloat16);   \
    if (g_dtype == 2) DS_ADAM(PT, __half);          \
  } while (0)
  if (p_dtype == 0) DS_ADAM_G(float);
  if (p_dtype == 1) DS_ADAM_G(__nv_bfloat16);
  if (p_dtype == 2) DS_ADAM_G(__half);
#undef DS_ADAM_G
#undef DS_ADAM
  return cudaErrorInvalidValue;
}
