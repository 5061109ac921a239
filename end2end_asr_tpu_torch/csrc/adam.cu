// The train step's Noam Adam update in one pass over a flat f32 buffer
// (or a slice of it), out of place, with the skip of a non-finite step:
//
//   g  = (g_raw * inv) * clip             (the second product only with clip)
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*(g*g)
//   p' = p - (lr * (m'/bc1)) / (sqrt(v'/bc2) + eps)
//   where `finite` is false: p' = p, m' = m, v' = v, bit for bit
//
// Every operation is one explicitly rounded f32 operation, in the order of
// the plain chain of training/optimizer.py's adam_update (PyTorch's
// elementwise kernels, one rounding each), with no contraction into a fused
// multiply-add, so the result is that chain's bit for bit. The moments are
// f32 or bf16: a bf16 load widens exactly, a store rounds to nearest even
// (as `.to(torch.bfloat16)`); the update itself is f32.
//
// Every value that changes between steps (lr, bc1 = 1-b1^t, bc2 = 1-b2^t,
// inv, clip, finite) is read from device memory, so a launch captured in a
// CUDA graph reads each replay's own. Only the fixed constants (b1, b2,
// 1-b1, 1-b2, eps) are arguments.
//
// Layout: every array starts 16-byte aligned (the step's flat buffers and
// their slices are allocations of their own); any length. Elements go as
// vectors of 4, one a thread, a block a contiguous tile (the order that
// served csrc/stream.cu's copy best); the last `tail` < 4 one a thread in
// block 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Scalars {
  const float* lr;
  const float* bc1;
  const float* bc2;
  const float* inv;
  const float* clip;             // nullptr: no clip
  const unsigned char* finite;   // a bool
  float b1, b2, omb1, omb2, eps;
};

struct Coef {
  float lr, bc1, bc2, inv, clip, b1, b2, omb1, omb2, eps;
};

template <bool CLIP>
__device__ __forceinline__ Coef load_coef(const Scalars& s) {
  Coef c;
  c.lr = *s.lr;
  c.bc1 = *s.bc1;
  c.bc2 = *s.bc2;
  c.inv = *s.inv;
  c.clip = CLIP ? *s.clip : 1.f;
  c.b1 = s.b1; c.b2 = s.b2; c.omb1 = s.omb1; c.omb2 = s.omb2; c.eps = s.eps;
  return c;
}

template <bool CLIP>
__device__ __forceinline__ void adam1(float& p, float& m, float& v,
                                      float graw, const Coef& c) {
  float g = __fmul_rn(graw, c.inv);
  if (CLIP) g = __fmul_rn(g, c.clip);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, c.bc1);
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.bc2)), c.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.lr, mhat), denom));
}

// one moment element: widen on load, round on store; raw bits to copy
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename M> __device__ __forceinline__ M narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 moment elements: a float4 of f32, 8 bytes of bf16
template <typename M> struct alignas(4 * sizeof(M)) Vec4 { M x[4]; };

template <typename M, bool CLIP>
__device__ __forceinline__ void update_one(
    const float* __restrict__ p, const float* __restrict__ g,
    const M* __restrict__ m, const M* __restrict__ v, float* __restrict__ po,
    M* __restrict__ mo, M* __restrict__ vo, long i, bool fin,
    const Coef& c) {
  if (!fin) {
    po[i] = p[i]; mo[i] = m[i]; vo[i] = v[i];
    return;
  }
  float pp = p[i], mm = widen(m[i]), vv = widen(v[i]);
  adam1<CLIP>(pp, mm, vv, g[i], c);
  po[i] = pp; mo[i] = narrow<M>(mm); vo[i] = narrow<M>(vv);
}

// elements [0, 4*n4) as vectors, thread i the i-th; block 0 also takes the
// `tail` after them
template <typename M, bool CLIP>
__global__ void __launch_bounds__(THREADS)
adam_vec_kernel(const float* __restrict__ p, const float* __restrict__ g,
                const M* __restrict__ m, const M* __restrict__ v,
                float* __restrict__ po, M* __restrict__ mo,
                M* __restrict__ vo, long n4, int tail, Scalars s) {
  const bool fin = *s.finite != 0;
  const Coef c = load_coef<CLIP>(s);
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n4) {
    const long e = 4 * i;
    const float4 p4 = *reinterpret_cast<const float4*>(p + e);
    const Vec4<M> m4 = *reinterpret_cast<const Vec4<M>*>(m + e);
    const Vec4<M> v4 = *reinterpret_cast<const Vec4<M>*>(v + e);
    if (!fin) {
      *reinterpret_cast<float4*>(po + e) = p4;
      *reinterpret_cast<Vec4<M>*>(mo + e) = m4;
      *reinterpret_cast<Vec4<M>*>(vo + e) = v4;
    } else {
      const float4 g4 = *reinterpret_cast<const float4*>(g + e);
      float pp[4] = {p4.x, p4.y, p4.z, p4.w};
      const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
      Vec4<M> mn, vn;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float mm = widen(m4.x[k]), vv = widen(v4.x[k]);
        adam1<CLIP>(pp[k], mm, vv, gg[k], c);
        mn.x[k] = narrow<M>(mm);
        vn.x[k] = narrow<M>(vv);
      }
      *reinterpret_cast<float4*>(po + e) = make_float4(pp[0], pp[1], pp[2],
                                                        pp[3]);
      *reinterpret_cast<Vec4<M>*>(mo + e) = mn;
      *reinterpret_cast<Vec4<M>*>(vo + e) = vn;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail)
    update_one<M, CLIP>(p, g, m, v, po, mo, vo, 4 * n4 + threadIdx.x, fin, c);
}

unsigned blocks(long n) {
  const long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : b);
}

template <typename M, bool CLIP>
void launch(const void* p, const void* g, const void* m, const void* v,
            void* po, void* mo, void* vo, long n, const Scalars& s,
            cudaStream_t stream) {
  const long n4 = n / 4;
  adam_vec_kernel<M, CLIP><<<blocks(n4), THREADS, 0, stream>>>(
      (const float*)p, (const float*)g, (const M*)m, (const M*)v, (float*)po,
      (M*)mo, (M*)vo, n4, (int)(n - 4 * n4), s);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p, g, p_out: n f32; m, v, m_out, v_out: n f32 (moments_bf16 0) or bf16
// (1), each 16-byte aligned (cudaErrorInvalidValue otherwise); lr, bc1,
// bc2, inv, clip: f32 scalars on the device (clip may be null: no clip);
// finite: a bool on the device. Outputs must not overlap the inputs.
extern "C" int adam_noam(const void* p, const void* g, const void* m,
                         const void* v, void* p_out, void* m_out, void* v_out,
                         long n, int moments_bf16, const void* lr,
                         const void* bc1, const void* bc2, const void* inv,
                         const void* clip, const void* finite, float b1,
                         float b2, float omb1, float omb2, float eps,
                         void* stream) {
  cudaGetLastError();  // report only this launch's error
  if (n == 0) return cudaSuccess;
  const uintptr_t any = (uintptr_t)p | (uintptr_t)g | (uintptr_t)m |
                        (uintptr_t)v | (uintptr_t)p_out | (uintptr_t)m_out |
                        (uintptr_t)v_out;
  if (any % 16) return cudaErrorInvalidValue;
  const Scalars s{(const float*)lr, (const float*)bc1, (const float*)bc2,
                  (const float*)inv, (const float*)clip,
                  (const unsigned char*)finite, b1, b2, omb1, omb2, eps};
  const cudaStream_t st = (cudaStream_t)stream;
  if (moments_bf16) {
    if (clip) launch<__nv_bfloat16, true>(p, g, m, v, p_out, m_out, v_out, n,
                                           s, st);
    else launch<__nv_bfloat16, false>(p, g, m, v, p_out, m_out, v_out, n, s,
                                       st);
  } else {
    if (clip) launch<float, true>(p, g, m, v, p_out, m_out, v_out, n, s, st);
    else launch<float, false>(p, g, m, v, p_out, m_out, v_out, n, s, st);
  }
  return cudaGetLastError();
}
