// Two streaming kernels on flat f32 arrays, the device-memory probes of
// tools/probe_stream.py:
//
//   stream_copy: out = x + 1                         (8 bytes per element)
//   stream_adam: one Adam step in place on p, m, v   (28 bytes per element)
//
// Replace end2end_asr_tpu's tools/probe_stream.py::_copy_kernel and
// ::_adam_kernel. Both are bound by bytes: every element is read once and
// written once.
//
// stream_copy: a block takes one contiguous tile of COPY_THREADS *
// COPY_VEC float4s (each warp reads and writes 512 contiguous bytes an
// access; a thread loads its COPY_VEC float4s before it stores any), and
// there are as many blocks as tiles (19200 of 512 threads at (38400,
// 1024)), so the accesses in flight lie in a window that moves through the
// array in order; the last n % 4 floats are a scalar tail. On the H100
// that beat, in one call, a grid-stride loop over 2112 blocks (the first
// design), one wave of blocks with four float4s in flight a thread and
// streaming hints, and a ring of bulk copies through shared memory (PERF.md
// row 10): the depth and the hints did not help, the order did.
//
// stream_adam: a grid-stride loop over float4s with a scalar tail; the Adam
// step is _adam_math of the probe:
//   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
//   p = p - lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
// with the two bias corrections 1-b1^t and 1-b2^t computed on the host
// from the step t and passed as arguments (no device scalar is read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

constexpr int COPY_THREADS = 512;
constexpr int COPY_VEC = 1;  // float4 loads in flight a thread

__device__ __forceinline__ float4 copy_load(const float4* p) { return *p; }
__device__ __forceinline__ void copy_store(float4* p, float4 v) { *p = v; }

__global__ void __launch_bounds__(COPY_THREADS)
stream_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long n) {
  const long n4 = n / 4;
  const long base = (long)blockIdx.x * (COPY_THREADS * COPY_VEC) +
                    threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  float4 v[COPY_VEC];
#pragma unroll
  for (int u = 0; u < COPY_VEC; ++u)
    if (base + u * COPY_THREADS < n4)
      v[u] = copy_load(x4 + base + u * COPY_THREADS);
#pragma unroll
  for (int u = 0; u < COPY_VEC; ++u) {
    if (base + u * COPY_THREADS < n4) {
      v[u].x += 1.f; v[u].y += 1.f; v[u].z += 1.f; v[u].w += 1.f;
      copy_store(o4 + base + u * COPY_THREADS, v[u]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)
    out[4 * n4 + threadIdx.x] = x[4 * n4 + threadIdx.x] + 1.f;
}

struct AdamArgs {
  float lr, b1, b2, eps;
  float omb1, omb2;  // 1 - b1, 1 - b2 (rounded from double by the host)
  float c1, c2;      // 1 - b1^t, 1 - b2^t
};

__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g,
                                      const AdamArgs& a) {
  // the probe's order of operations, with no fused multiply-add, so the
  // result equals the eager chain's within its last bit
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  const float mhat = __fdiv_rn(m, a.c1);
  const float vhat = __fdiv_rn(v, a.c2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(a.lr, mhat),
                             __fadd_rn(__fsqrt_rn(vhat), a.eps)));
}

__global__ void __launch_bounds__(THREADS)
stream_adam_kernel(float* __restrict__ p, float* __restrict__ m,
                   float* __restrict__ v, const float* __restrict__ g,
                   long n, AdamArgs a) {
  const long n4 = n / 4;
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long i = tid; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adam1(pp.x, mm.x, vv.x, gg.x, a);
    adam1(pp.y, mm.y, vv.y, gg.y, a);
    adam1(pp.z, mm.z, vv.z, gg.z, a);
    adam1(pp.w, mm.w, vv.w, gg.w, a);
    p4[i] = pp; m4[i] = mm; v4[i] = vv;
  }
  for (long i = 4 * n4 + tid; i < n; i += stride)
    adam1(p[i], m[i], v[i], g[i], a);
}

int grid_for(long n) {
  const long want = (n / 4 + THREADS - 1) / THREADS;
  const long cap = 132 * 16;  // a few waves of blocks on the H100's 132 SMs
  return (int)(want < 1 ? 1 : (want > cap ? cap : want));
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: n f32, 16-byte aligned.
extern "C" int stream_copy(const void* x, void* out, long n, void* stream) {
  cudaGetLastError();  // report only this launch's error
  if (n == 0) return cudaSuccess;
  constexpr long tile = COPY_THREADS * COPY_VEC;
  const long tiles = (n / 4 + tile - 1) / tile;
  stream_copy_kernel<<<(unsigned)(tiles < 1 ? 1 : tiles), COPY_THREADS, 0,
                       (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                               n);
  return cudaGetLastError();
}

// p, m, v (updated in place), g: n f32, 16-byte aligned.
extern "C" int stream_adam(void* p, void* m, void* v, const void* g, long n,
                           float lr, float b1, float b2, float eps,
                           float omb1, float omb2, float c1, float c2,
                           void* stream) {
  cudaGetLastError();
  if (n == 0) return cudaSuccess;
  AdamArgs a{lr, b1, b2, eps, omb1, omb2, c1, c2};
  stream_adam_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (float*)p, (float*)m, (float*)v, (const float*)g, n, a);
  return cudaGetLastError();
}
