// pool_bwd: the backward of the 2x2 stride-2 VALID max pool of vgg block 2
// (kernel 6 of the port).
//
// Replaces end2end_asr_tpu/ops/pool_vjp.py::_bwd_kernel (reached from
// _pool_bwd_impl's pl.pallas_call). Each pooled gradient goes to the FIRST
// maximum of its window in (f, t) order (0,0), (0,1), (1,0), (1,1) (strict
// '>' scanning in that order: torch MaxPool2d / XLA select_and_scatter),
// every other element of the window gets zero, and an odd last row or
// column (outside every window) gets zero. Any F and T work.
//
// Two layouts of (B, C, F, T):
//   * channels-last, (B, F, T, C) in memory: the layout of the JAX kernel
//     (channels on the lanes) and of the train step, where cuDNN's conv4
//     returns its output channels-last; g (B, F/2, T/2, C). One thread
//     per pool window and VEC = 8 channels (C % 8 == 0, 16-byte aligned;
//     else VEC = 1): four 16-byte loads of y, one of g, four 16-byte
//     stores of dy; neighbouring threads on neighbouring channels, so a
//     warp reads and writes whole 256-byte runs of both window rows;
//   * NCHW, (B*C, F, T) planes: one thread per window, neighbouring
//     threads on neighbouring windows of a row; the pair of a row is one
//     4-byte (bf16) or 8-byte (f32) access where T is even.
// The grid is (window columns x batches or planes, window rows), so a
// thread finds its window with 32-bit index math and no 64-bit division;
// offsets into the tensors are 64-bit products.
//
// What bounds it on the H100: bytes. At the flagship (12 x 128 x 80 x 400
// bf16) it reads y (98 MB) and g (24.6 MB) and writes dy (98 MB): 0.066 ms
// at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC elements of type T as one aligned access
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Vec {
  T x[VEC];
};

// the window's four values of one channel -> the index of the first max
__device__ __forceinline__ int first_max(float a, float b, float c,
                                         float d) {
  int best = 0;
  float v = a;
  if (b > v) { best = 1; v = b; }
  if (c > v) { best = 2; v = c; }
  if (d > v) best = 3;
  return best;
}

// channels-last: grid (B * ceil(Tc * C / VEC / THREADS), Fc)
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
pool_bwd_nhwc_kernel(const T* __restrict__ y, const T* __restrict__ g,
                     T* __restrict__ dy, int F, int T_, int C, int nxb) {
  using V = Vec<T, VEC>;
  const int b = blockIdx.x / nxb;
  const int e = (blockIdx.x - b * nxb) * THREADS + threadIdx.x;
  const int cv = C / VEC, Tc = (T_ + 1) / 2;
  if (e >= Tc * cv) return;
  const int tc = e / cv, c = (e - tc * cv) * VEC, fc = blockIdx.y;
  const int f0 = 2 * fc, t0 = 2 * tc;
  const bool full_f = f0 + 1 < F, full_t = t0 + 1 < T_;
  // element (f, t, c) of batch b
  auto at = [&](int f, int t) {
    return ((size_t)(b * F + f) * T_ + t) * C + c;
  };
  const T zero = T(0.f);
  V d[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[m].x[j] = zero;
  if (full_f && full_t) {
    const V v0 = *reinterpret_cast<const V*>(y + at(f0, t0));
    const V v1 = *reinterpret_cast<const V*>(y + at(f0, t0 + 1));
    const V v2 = *reinterpret_cast<const V*>(y + at(f0 + 1, t0));
    const V v3 = *reinterpret_cast<const V*>(y + at(f0 + 1, t0 + 1));
    const V gv = *reinterpret_cast<const V*>(
        g + ((size_t)(b * (F / 2) + fc) * (T_ / 2) + tc) * C + c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int best = first_max(to_f(v0.x[j]), to_f(v1.x[j]),
                                 to_f(v2.x[j]), to_f(v3.x[j]));
#pragma unroll
      for (int m = 0; m < 4; ++m) d[m].x[j] = best == m ? gv.x[j] : zero;
    }
  }
  *reinterpret_cast<V*>(dy + at(f0, t0)) = d[0];
  if (full_t) *reinterpret_cast<V*>(dy + at(f0, t0 + 1)) = d[1];
  if (full_f) *reinterpret_cast<V*>(dy + at(f0 + 1, t0)) = d[2];
  if (full_f && full_t) *reinterpret_cast<V*>(dy + at(f0 + 1, t0 + 1)) = d[3];
}

// NCHW: grid (B * C * ceil(Tc / THREADS), Fc); PAIR: T even, the two
// columns of a window row are one aligned access
template <typename T, bool PAIR>
__global__ void __launch_bounds__(THREADS)
pool_bwd_nchw_kernel(const T* __restrict__ y, const T* __restrict__ g,
                     T* __restrict__ dy, int F, int T_, int nxb) {
  using V = Vec<T, 2>;
  const int p = blockIdx.x / nxb;  // the (b, c) plane
  const int tc = (blockIdx.x - p * nxb) * THREADS + threadIdx.x;
  const int Tc = (T_ + 1) / 2, fc = blockIdx.y;
  if (tc >= Tc) return;
  const int f0 = 2 * fc, t0 = 2 * tc;
  const bool full_f = f0 + 1 < F, full_t = t0 + 1 < T_;
  const T* y0 = y + ((size_t)p * F + f0) * T_ + t0;
  T* d0 = dy + ((size_t)p * F + f0) * T_ + t0;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if (full_f && full_t) {
    float v[4];
    if (PAIR) {
      const V a = *reinterpret_cast<const V*>(y0);
      const V c = *reinterpret_cast<const V*>(y0 + T_);
      v[0] = to_f(a.x[0]);
      v[1] = to_f(a.x[1]);
      v[2] = to_f(c.x[0]);
      v[3] = to_f(c.x[1]);
    } else {
      v[0] = to_f(y0[0]);
      v[1] = to_f(y0[1]);
      v[2] = to_f(y0[T_]);
      v[3] = to_f(y0[T_ + 1]);
    }
    const int best = first_max(v[0], v[1], v[2], v[3]);
    const float gv = to_f(g[((size_t)p * (F / 2) + fc) * (T_ / 2) + tc]);
#pragma unroll
    for (int m = 0; m < 4; ++m) d[m] = best == m ? gv : 0.f;
  }
  // a bf16 or f32 gradient value is exact through f32
  if (PAIR) {
    V a, c;
    a.x[0] = T(d[0]);
    a.x[1] = T(d[1]);
    c.x[0] = T(d[2]);
    c.x[1] = T(d[3]);
    *reinterpret_cast<V*>(d0) = a;
    if (full_f) *reinterpret_cast<V*>(d0 + T_) = c;
  } else {
    d0[0] = T(d[0]);
    if (full_t) d0[1] = T(d[1]);
    if (full_f) d0[T_] = T(d[2]);
    if (full_f && full_t) d0[T_ + 1] = T(d[3]);
  }
}

template <typename T>
int launch(const void* y, const void* g, void* dy, int B, int C, int F,
           int T_, int channels_last, void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int Fc = (F + 1) / 2, Tc = (T_ + 1) / 2;
  if ((long long)B * C * F * T_ == 0) return cudaSuccess;
  if (Fc > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (channels_last) {
    const bool vec = C % 8 == 0 && ((uintptr_t)y & 15) == 0 &&
                     ((uintptr_t)g & 15) == 0 && ((uintptr_t)dy & 15) == 0;
    const long long per_b = (long long)Tc * (vec ? C / 8 : C);
    const long long nxb = (per_b + THREADS - 1) / THREADS;
    if (per_b >= (1ll << 31) || nxb * B >= (1ll << 31))
      return cudaErrorInvalidValue;
    const dim3 grid((unsigned)(nxb * B), Fc);
    if (vec)
      pool_bwd_nhwc_kernel<T, 8><<<grid, THREADS, 0, st>>>(
          (const T*)y, (const T*)g, (T*)dy, F, T_, C, (int)nxb);
    else
      pool_bwd_nhwc_kernel<T, 1><<<grid, THREADS, 0, st>>>(
          (const T*)y, (const T*)g, (T*)dy, F, T_, C, (int)nxb);
  } else {
    const long long nxb = (Tc + THREADS - 1) / THREADS;
    if (nxb * B * C >= (1ll << 31)) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)(nxb * B * C), Fc);
    if (T_ % 2 == 0 && ((uintptr_t)y & (2 * sizeof(T) - 1)) == 0 &&
        ((uintptr_t)dy & (2 * sizeof(T) - 1)) == 0)
      pool_bwd_nchw_kernel<T, true><<<grid, THREADS, 0, st>>>(
          (const T*)y, (const T*)g, (T*)dy, F, T_, (int)nxb);
    else
      pool_bwd_nchw_kernel<T, false><<<grid, THREADS, 0, st>>>(
          (const T*)y, (const T*)g, (T*)dy, F, T_, (int)nxb);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y, dy (B, C, F, T) and g (B, C, F/2, T/2), dense, all in one layout:
// channels_last 1 = (B, F, T, C) in memory, 0 = NCHW; same type
extern "C" int pool_bwd_f32(const void* y, const void* g, void* dy, int B,
                            int C, int F, int T, int channels_last,
                            void* stream) {
  return launch<float>(y, g, dy, B, C, F, T, channels_last, stream);
}

extern "C" int pool_bwd_bf16(const void* y, const void* g, void* dy, int B,
                             int C, int F, int T, int channels_last,
                             void* stream) {
  return launch<__nv_bfloat16>(y, g, dy, B, C, F, T, channels_last, stream);
}
