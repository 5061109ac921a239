// stft_logmag: log1p(|DFT|) of overlapping frames of reflect-padded PCM.
//
// Replaces end2end_asr_tpu/ops/stft_pallas.py::_stft_kernel (reached from
// _batched_features_impl's pl.pallas_call). That kernel splits each frame
// into two hop-wide chunks because Mosaic cannot DMA 160-wide rows; here a
// block stages its frames' samples in shared memory once, so any n_fft and
// hop work and overlapping frames are not re-read from device memory.
//
//   out[b, t, f] = log1p(sqrt(re^2 + im^2)),
//   re = sum_k pcm[b, t*hop + k] * cosb[k, f],  im likewise with sinb,
//
// with the window folded into the (n_fft, F) bases. Accumulation is f32
// FMA in k order.
//
// What bounds it on the H100: the product, 4*B*T*n_fft*F FLOP (about
// 2 GFLOP at B=12, T=800, n_fft=320, F=161) against the 67 TFLOP/s of f32
// FMA outside the tensor cores (~30 us); the bytes (PCM in, spectrogram
// out, ~12.7 MB) take ~4 us at 3.35 TB/s. The design: one block per
// (utterance, 64 frames, 64 frequencies); the tile's (64-1)*hop + n_fft
// samples go to shared memory once; the bases stream through shared memory
// in 32-row slabs; each thread keeps 8 frames x 2 frequencies of re and im
// in registers (32 accumulators) so every shared load feeds several FMAs.
// A warp's 32 threads share their frames (sample loads broadcast) and take
// 32 consecutive frequencies (basis loads and output stores are
// contiguous).

#include <cuda_runtime.h>

namespace {

constexpr int TT = 64;       // frames per block
constexpr int FT = 64;       // frequencies per block
constexpr int KC = 32;       // basis rows per shared-memory slab
constexpr int THREADS = 256; // 32 frequency lanes x 8 frame groups
constexpr int FPT = TT / (THREADS / 32);  // frames per thread (8)
constexpr int QPT = FT / 32;              // frequencies per thread (2)

__global__ void __launch_bounds__(THREADS)
stft_logmag_kernel(const float* __restrict__ pcm, int N,
                   const float* __restrict__ cosb,
                   const float* __restrict__ sinb,
                   float* __restrict__ out, int T, int F, int n_fft,
                   int hop, int span) {
  extern __shared__ float smem[];
  float* xs = smem;              // span samples
  float* cs = xs + span;         // KC x FT cos slab
  float* ss = cs + KC * FT;      // KC x FT sin slab

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * TT;
  const int f0 = blockIdx.y * FT;
  const float* x = pcm + (size_t)b * N;
  const long long base = (long long)t0 * hop;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const long long g = base + i;
    xs[i] = g < N ? x[g] : 0.f;
  }

  const int lane = threadIdx.x & 31;   // frequency lane
  const int grp = threadIdx.x >> 5;    // frame group
  float re[FPT][QPT], im[FPT][QPT];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int j = 0; j < QPT; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < n_fft; k0 += KC) {
    __syncthreads();  // samples staged / previous slab consumed
    for (int i = threadIdx.x; i < KC * FT; i += THREADS) {
      const int k = k0 + i / FT, f = f0 + i % FT;
      const bool ok = k < n_fft && f < F;
      cs[i] = ok ? cosb[(size_t)k * F + f] : 0.f;
      ss[i] = ok ? sinb[(size_t)k * F + f] : 0.f;
    }
    __syncthreads();
    const int kmax = min(KC, n_fft - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float c[QPT], s[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        c[j] = cs[kk * FT + lane + 32 * j];
        s[j] = ss[kk * FT + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        const float a = xs[(grp + 8 * i) * hop + k0 + kk];
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          re[i][j] = fmaf(a, c[j], re[i][j]);
          im[i][j] = fmaf(a, s[j], im[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const int t = t0 + grp + 8 * i;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int f = f0 + lane + 32 * j;
      if (t < T && f < F)
        out[((size_t)b * T + t) * F + f] =
            log1pf(sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]));
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pcm (B, N) f32, cosb/sinb (n_fft, F) f32, out (B, T, F) f32; frame t
// reads pcm[b, t*hop : t*hop + n_fft] (zeros past N).
extern "C" int stft_logmag_f32(const void* pcm, const void* cosb,
                               const void* sinb, void* out, int B, int N,
                               int T, int F, int n_fft, int hop,
                               void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int span = (TT - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (size_t)(span + 2 * KC * FT);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stft_logmag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + TT - 1) / TT, (F + FT - 1) / FT, B);
  stft_logmag_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pcm, N, (const float*)cosb, (const float*)sinb,
      (float*)out, T, F, n_fft, hop, span);
  return cudaGetLastError();
}
