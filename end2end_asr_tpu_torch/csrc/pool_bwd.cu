// pool_bwd: the backward of the 2x2 stride-2 VALID max pool of vgg block 2
// (kernel 6 of the port).
//
// Replaces end2end_asr_tpu/ops/pool_vjp.py::_bwd_kernel (reached from
// _pool_bwd_impl's pl.pallas_call). Each pooled gradient goes to the FIRST
// maximum of its window in (f, t) order (0,0), (0,1), (1,0), (1,1) (strict
// '>' scanning in that order: torch MaxPool2d / XLA select_and_scatter),
// every other element of the window gets zero, and an odd last row or
// column (outside every window) gets zero. The TPU kernel pairs time phases
// into lane halves (its (8, 128) layout); here any F and T work.
//
// Layouts: y and dy (BC, F, T) for the B*C planes of NCHW; g (BC, F/2, T/2).
// What bounds it on the H100: bytes. At the flagship (12 x 128 x 80 x 400
// bf16) it reads y (98 MB) and g (24.6 MB) and writes dy (98 MB): 0.066 ms
// at 3.35 TB/s. One thread per cell of 2 x 2 outputs, neighbouring threads
// on neighbouring cells of a row, so each warp reads and writes contiguous
// runs of both rows of its cells.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T_>
__device__ __forceinline__ T_ from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T_>
__global__ void pool_bwd_kernel(const T_* __restrict__ y,
                                const T_* __restrict__ g, T_* __restrict__ dy,
                                long BC, int F, int T) {
  const int Fp = F / 2, Tp = T / 2;
  const int Fc = (F + 1) / 2, Tc = (T + 1) / 2;  // cells cover odd tails
  const long n = BC * Fc * Tc;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    const int tc = e % Tc;
    const int fc = (e / Tc) % Fc;
    const long p = e / ((long)Tc * Fc);
    const T_* yp = y + (size_t)p * F * T;
    T_* dp = dy + (size_t)p * F * T;
    const int f0 = 2 * fc, t0 = 2 * tc;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (fc < Fp && tc < Tp) {
      const float v[4] = {to_f(yp[(size_t)f0 * T + t0]),
                          to_f(yp[(size_t)f0 * T + t0 + 1]),
                          to_f(yp[(size_t)(f0 + 1) * T + t0]),
                          to_f(yp[(size_t)(f0 + 1) * T + t0 + 1])};
      int best = 0;
#pragma unroll
      for (int m = 1; m < 4; ++m)
        if (v[m] > v[best]) best = m;
      d[best] = to_f(g[((size_t)p * Fp + fc) * Tp + tc]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int f = f0 + (m >> 1), t = t0 + (m & 1);
      if (f < F && t < T) dp[(size_t)f * T + t] = from_f<T_>(d[m]);
    }
  }
}

template <typename T_>
int launch(const void* y, const void* g, void* dy, int BC, int F, int T,
           void* stream) {
  cudaGetLastError();  // report only this launch's error
  const long n = (long)BC * ((F + 1) / 2) * ((T + 1) / 2);
  if (n == 0) return cudaSuccess;
  const long want = (n + 255) / 256;
  const int blocks = (int)(want < 65535 * 4 ? want : 65535 * 4);
  pool_bwd_kernel<T_><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T_*)y, (const T_*)g, (T_*)dy, BC, F, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y, dy (BC, F, T); g (BC, F/2, T/2); same type
extern "C" int pool_bwd_f32(const void* y, const void* g, void* dy, int BC,
                            int F, int T, void* stream) {
  return launch<float>(y, g, dy, BC, F, T, stream);
}

extern "C" int pool_bwd_bf16(const void* y, const void* g, void* dy, int BC,
                             int F, int T, void* stream) {
  return launch<__nv_bfloat16>(y, g, dy, BC, F, T, stream);
}
