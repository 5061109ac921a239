// vgg_block1_fwd: the first block of the vgg_cnn front end, fused:
//
//   out = relu(maxpool2x2(conv2_SAME(relu(conv1_SAME(x) + b1))) + b2)
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_fwd_kernel (reached from
// _fwd_pallas's pl.pallas_call). As there, the conv1 activations never go
// to device memory: each block computes the ones it needs into shared
// memory, and conv2, the pool, the bias and the relu run on them.
//
// Layouts: x (B, F, T) f32; w1 (3,3,1,64) HWIO f32; b1, b2 (64,) f32;
// conv2's weight is f32 HWIO (3,3,64,64) for the f32 kernel and bf16
// (3,3,64 out,64 in) for the bf16 kernel (the wrapper packs it, as the JAX
// package packs its weights outside its kernel, vgg_fused.py:315-325);
// out (B, F/2, T/2, 64) NHWC in the compute type cdt (f32 or bf16); idx,
// when given, (B, F/2, T/2, 64) uint8 = the pool's argmax in window order
// (0,0),(0,1),(1,0),(1,1) over (f, t).
//
// Numerics (those of vgg_fused.py:30-33,163-209 and of the composite XLA
// path, frontend.py:313-316):
//   * the input and the weights are rounded to cdt once;
//   * conv1: f32 sum, rounded to cdt, then + b1 in cdt, then relu. This is
//     the COMPOSITE order (frontend._conv: cdt(conv) + cdt(b1)); the JAX
//     Pallas kernel instead adds b1 in f32 before rounding (the 1-ulp note
//     at vgg_fused.py:163-170). In f32 the two orders are the same.
//   * conv2: f32 sum over the 576 taps, rounded to cdt before the pool;
//   * pool: 2x2 stride 2 VALID (an odd last row or column is dropped),
//     strict '>' so ties go to the earlier window element;
//   * + b2 in cdt, then relu.
// Products of cdt values are exact in f32, so only the summation order
// differs from cuDNN's or XLA's convolution.
//
// What bounds it on the H100: conv2, 2*B*F*T*64*576 FLOP (~114 GFLOP at
// B=12, F=161, T=800): ~0.12 ms at the 989 TFLOP/s of the bf16 tensor
// cores (the serving path's compute type), ~1.7 ms at the 67 TFLOP/s of
// f32 FMA. Bytes are small beside it (~30 MB in and out).
//
// bf16 (vgg_block1_fwd_bf16_kernel): one block per (utterance, pooled row,
// 4 chunks of 64 conv columns), 8 warps. The whole packed conv2 weight
// (72 KB bf16) is loaded into shared memory once per block. Per chunk, conv1
// (f32 FMA) writes the 4 x 66 positions x 64 channels it needs into shared
// memory as bf16, and conv2 runs as an implicit GEMM on the tensor cores:
// each warp owns 2 conv rows x 8 conv columns (M = 16) x 64 output channels
// (N = 64) and walks K = 9 taps x 64 input channels in steps of 16 with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), its A and B fragments read
// by ldmatrix from shared memory whose 16-byte chunks are XOR-swizzled by
// row, so the 8 rows of each 8x8 matrix hit distinct banks. The mma's row m
// and row m+8 are the two conv rows of one column, so a thread holds both
// rows of its column; one shuffle with the neighbouring column's lane
// completes each 2x2 pool window in registers.
//
// f32 (vgg_block1_fwd_f32_kernel): f32 FMA on the CUDA cores, one block per
// (utterance, pooled row, 16 pooled columns); conv2's weights stream through
// shared memory one filter row at a time; each thread owns 2 conv rows x 4
// conv columns x 4 channels (two pool windows) in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;  // channels of conv1 out / conv2 in and out

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int TP = 16;         // pooled columns per block
constexpr int CC = 2 * TP;     // conv columns per block (32)
constexpr int XR = 4;          // conv1 rows held (2 conv rows + halo)
constexpr int XC = CC + 2;     // conv1 columns held (34)
constexpr int XCP = 36;        // padded row pitch of the conv1 tile
constexpr int SR = XR + 2;     // input rows staged (6)
constexpr int SC = XC + 2;     // input columns staged (36)
constexpr int THREADS = 128;   // 8 column groups x 16 channel groups

__global__ void __launch_bounds__(THREADS)
vgg_block1_fwd_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          float* __restrict__ out,
                          uint8_t* __restrict__ idx, int F, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w2s = smem;                   // 3 x C x C (one filter row df)
  float* x1s = w2s + 3 * C * C;        // XR x C x XCP
  float* xs = x1s + XR * C * XCP;      // SR x SC
  float* w1s = xs + SR * SC;           // 9 x C
  float* b1s = w1s + 9 * C;            // C
  float* b2s = b1s + C;                // C

  const int Fp = F / 2, Tp = T / 2;
  const int b = blockIdx.z;
  const int fp = blockIdx.y;
  const int c0 = blockIdx.x * CC;      // first conv column of the block
  const int tid = threadIdx.x;

  // input tile: rows 2fp-2 .. 2fp+3, columns c0-2 .. c0+33, zero outside
  const float* xb = x + (size_t)b * F * T;
  for (int e = tid; e < SR * SC; e += THREADS) {
    const int r = e / SC, j = e % SC;
    const int g = 2 * fp - 2 + r, t = c0 - 2 + j;
    xs[e] = (g >= 0 && g < F && t >= 0 && t < T) ? xb[(size_t)g * T + t]
                                                 : 0.f;
  }
  for (int e = tid; e < 9 * C; e += THREADS) w1s[e] = w1[e];
  for (int e = tid; e < C; e += THREADS) {
    b1s[e] = b1[e];
    b2s[e] = b2[e];
  }
  __syncthreads();

  // conv1 + b1 + relu for rows 2fp-1 .. 2fp+2 and columns c0-1 .. c0+32;
  // zero outside the image (conv2's SAME padding pads the activations)
  for (int e = tid; e < XR * C * XC; e += THREADS) {
    const int r = e / (C * XC);
    const int ci = (e / XC) % C;
    const int j = e % XC;
    const int g = 2 * fp - 1 + r, t = c0 - 1 + j;
    float v = 0.f;
    if (g >= 0 && g < F && t >= 0 && t < T) {
      float acc = 0.f;
#pragma unroll
      for (int df = 0; df < 3; ++df)
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
          acc = fmaf(xs[(r + df) * SC + j + dt], w1s[(df * 3 + dt) * C + ci],
                     acc);
      v = fmaxf(acc + b1s[ci], 0.f);
    }
    x1s[(r * C + ci) * XCP + j] = v;
  }

  const int chg = tid % 16;   // output channels 4*chg .. 4*chg+3
  const int cg = tid / 16;    // conv columns 4*cg .. 4*cg+3 of the block
  float acc[2][4][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[q][i][k] = 0.f;

  for (int df = 0; df < 3; ++df) {
    __syncthreads();  // conv1 tile written / previous filter row consumed
    const float4* src = reinterpret_cast<const float4*>(w2 + df * 3 * C * C);
    float4* dst = reinterpret_cast<float4*>(w2s);
    for (int e = tid; e < 3 * C * C / 4; e += THREADS) dst[e] = src[e];
    __syncthreads();
    for (int ci = 0; ci < C; ++ci) {
      float a[2][6];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* row = x1s + ((q + df) * C + ci) * XCP + 4 * cg;
        const float4 v = *reinterpret_cast<const float4*>(row);
        const float2 u = *reinterpret_cast<const float2*>(row + 4);
        a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
        a[q][4] = u.x; a[q][5] = u.y;
      }
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const float4 w =
            *reinterpret_cast<const float4*>(w2s + (dt * C + ci) * C + 4 * chg);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = a[q][i + dt];
            acc[q][i][0] = fmaf(av, w.x, acc[q][i][0]);
            acc[q][i][1] = fmaf(av, w.y, acc[q][i][1]);
            acc[q][i][2] = fmaf(av, w.z, acc[q][i][2]);
            acc[q][i][3] = fmaf(av, w.w, acc[q][i][3]);
          }
      }
    }
  }

  // pool windows: columns (4cg, 4cg+1) and (4cg+2, 4cg+3) of rows 2fp, 2fp+1
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int tp = blockIdx.x * TP + 2 * cg + w;
    if (tp >= Tp) continue;
    float o[4];
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v[4] = {acc[0][2 * w][k], acc[0][2 * w + 1][k],
                          acc[1][2 * w][k], acc[1][2 * w + 1][k]};
      float best = v[0];
      uint32_t id = 0;
#pragma unroll
      for (int m = 1; m < 4; ++m)
        if (v[m] > best) { best = v[m]; id = m; }
      o[k] = fmaxf(best + b2s[4 * chg + k], 0.f);
      packed |= id << (8 * k);
    }
    const size_t off = (((size_t)b * Fp + fp) * Tp + tp) * C + 4 * chg;
    *reinterpret_cast<float4*>(out + off) = make_float4(o[0], o[1], o[2], o[3]);
    if (idx != nullptr) *reinterpret_cast<uint32_t*>(idx + off) = packed;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int MWARPS = 8;              // warps per block
constexpr int MTHREADS = 32 * MWARPS;
constexpr int WCOLS = 8;               // conv columns per warp
constexpr int CHUNK = MWARPS * WCOLS;  // conv columns per chunk (64)
constexpr int CHUNKS = 4;              // chunks per block
constexpr int MXC = CHUNK + 2;         // conv1 columns held (66)
constexpr int MSC = CHUNK + 4;         // input columns staged (68)

// Offset (in bf16 elements) of 16-byte chunk `ch` (8 channels) of row
// `row` in a [rows][64] bf16 tile whose chunks are XOR-swizzled by row.
__device__ __forceinline__ int swz(int row, int ch) {
  return row * C + ((ch ^ (row & 7)) << 3);
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(MTHREADS, 2)
vgg_block1_fwd_bf16_kernel(const float* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const __nv_bfloat16* __restrict__ w2p,
                           const float* __restrict__ b2,
                           __nv_bfloat16* __restrict__ out,
                           uint8_t* __restrict__ idx, int F, int T) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);  // 576 x 64
  __nv_bfloat16* x1s = w2s + 9 * C * C;                 // 4*MXC x 64
  float* xs = reinterpret_cast<float*>(x1s + 4 * MXC * C);  // 6 x MSC
  float* w1s = xs + 6 * MSC;                            // 9 x C
  float* b1s = w1s + 9 * C;                             // C
  float* b2s = b1s + C;                                 // C

  const int Fp = F / 2, Tp = T / 2;
  const int b = blockIdx.z;
  const int fp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // packed conv2 weight: row = tap*64 + out channel, 64 input channels
  for (int e = tid; e < 9 * C * 8; e += MTHREADS)
    *reinterpret_cast<uint4*>(w2s + swz(e >> 3, e & 7)) =
        reinterpret_cast<const uint4*>(w2p)[e];
  for (int e = tid; e < 9 * C; e += MTHREADS) w1s[e] = bf16r(w1[e]);
  for (int e = tid; e < C; e += MTHREADS) {
    b1s[e] = bf16r(b1[e]);
    b2s[e] = bf16r(b2[e]);
  }

  const float* xb = x + (size_t)b * F * T;
  // per-lane ldmatrix rows: A = (conv row q, column c) x 8 channels of
  // chunk akc; B = output channel bn of an n-tile pair x chunk bkc
  const int aq = (lane >> 3) & 1, ac = lane & 7, akc = lane >> 4;
  const int bn = ((lane >> 4) << 3) + (lane & 7), bkc = (lane >> 3) & 1;

  for (int chunk = 0; chunk < CHUNKS; ++chunk) {
    const int c0 = (blockIdx.x * CHUNKS + chunk) * CHUNK;
    if (c0 >= 2 * Tp) break;  // uniform across the block
    __syncthreads();  // weights staged / previous chunk's tiles consumed

    // input tile: rows 2fp-2 .. 2fp+3, columns c0-2 .. c0+65, bf16-rounded
    for (int e = tid; e < 6 * MSC; e += MTHREADS) {
      const int r = e / MSC, j = e % MSC;
      const int g = 2 * fp - 2 + r, t = c0 - 2 + j;
      xs[e] = (g >= 0 && g < F && t >= 0 && t < T)
                  ? bf16r(xb[(size_t)g * T + t]) : 0.f;
    }
    __syncthreads();

    // conv1 + b1 + relu at rows 2fp-1 .. 2fp+2, columns c0-1 .. c0+64, as
    // bf16; zero outside the image. Each item: one position x 8 channels
    // (the thread's channel group is fixed: MTHREADS % 8 == 0).
    {
      const int cg = tid & 7;
      float wr[9][8], br[8];
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i) wr[k][i] = w1s[k * C + cg * 8 + i];
#pragma unroll
      for (int i = 0; i < 8; ++i) br[i] = b1s[cg * 8 + i];
      for (int pos = tid >> 3; pos < 4 * MXC; pos += MTHREADS >> 3) {
        const int r = pos / MXC, j = pos % MXC;
        const int g = 2 * fp - 1 + r, t = c0 - 1 + j;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (g >= 0 && g < F && t >= 0 && t < T) {
          float xv[9];
#pragma unroll
          for (int df = 0; df < 3; ++df)
#pragma unroll
            for (int dt = 0; dt < 3; ++dt)
              xv[df * 3 + dt] = xs[(r + df) * MSC + j + dt];
          float o[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k) acc = fmaf(xv[k], wr[k][i], acc);
            o[i] = fmaxf(bf16r(bf16r(acc) + br[i]), 0.f);
          }
          v = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                         pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
        }
        *reinterpret_cast<uint4*>(x1s + swz(pos, cg)) = v;
      }
    }
    __syncthreads();

    // conv2: per warp M = 16 (2 rows x 8 columns), N = 64, K = 9 x 64
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int df = tap / 3, dt = tap % 3;
      const int apos = (aq + df) * MXC + warp * WCOLS + ac + dt;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4];
        ldsm_x4(x1s + swz(apos, 2 * kc + akc), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t q0, q1, q2, q3;
          ldsm_x4(w2s + swz(tap * C + np * 16 + bn, 2 * kc + bkc), q0, q1,
                  q2, q3);
          mma_bf16(acc[2 * np], a, q0, q1);
          mma_bf16(acc[2 * np + 1], a, q2, q3);
        }
      }
    }

    // epilogue: this lane holds rows (2fp, 2fp+1) of conv column cq for
    // channels 8n + 2(lane%4) + {0,1}; lane^4 holds the neighbouring
    // column. The even column's lane writes channel +0, the odd's +1.
    const int cq = lane >> 2;
    const bool odd = cq & 1;
    const int tp = (c0 + warp * WCOLS + cq) >> 1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float nb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        nb[i] = __shfl_xor_sync(0xffffffffu, acc[n][i], 4);
      const float own0 = bf16r(odd ? acc[n][1] : acc[n][0]);  // row 2fp
      const float own1 = bf16r(odd ? acc[n][3] : acc[n][2]);  // row 2fp+1
      const float nb0 = bf16r(odd ? nb[1] : nb[0]);
      const float nb1 = bf16r(odd ? nb[3] : nb[2]);
      const float v[4] = {odd ? nb0 : own0, odd ? own0 : nb0,
                          odd ? nb1 : own1, odd ? own1 : nb1};
      float best = v[0];
      uint8_t id = 0;
#pragma unroll
      for (int m = 1; m < 4; ++m)
        if (v[m] > best) { best = v[m]; id = m; }
      const int co = 8 * n + 2 * (lane & 3) + (odd ? 1 : 0);
      if (tp < Tp) {
        const size_t off = (((size_t)b * Fp + fp) * Tp + tp) * C + co;
        out[off] = __float2bfloat16(fmaxf(bf16r(best + b2s[co]), 0.f));
        if (idx != nullptr) idx[off] = id;
      }
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, F, T) f32; w1 (3,3,1,64), b1 (64), w2 (3,3,64,64) HWIO, b2 (64)
// f32; out (B, F/2, T/2, 64) f32; idx uint8 of out's shape or null.
extern "C" int vgg_block1_fwd_f32(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* idx,
                                  int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int Fp = F / 2, Tp = T / 2;
  if (Fp == 0 || Tp == 0 || B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)(3 * C * C + XR * C * XCP +
                                               SR * SC + 9 * C + 2 * C);
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block1_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tp + TP - 1) / TP, Fp, B);
  vgg_block1_fwd_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)out, (uint8_t*)idx, F, T);
  return cudaGetLastError();
}

// As above with w2p the bf16 conv2 weight packed as (3,3,64 out,64 in) and
// out bf16.
extern "C" int vgg_block1_fwd_bf16(const void* x, const void* w1,
                                   const void* b1, const void* w2p,
                                   const void* b2, void* out, void* idx,
                                   int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int Fp = F / 2, Tp = T / 2;
  if (Fp == 0 || Tp == 0 || B == 0) return cudaSuccess;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(9 * C * C +
                                                       4 * MXC * C) +
                      sizeof(float) * (size_t)(6 * MSC + 9 * C + 2 * C);
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block1_fwd_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int chunks = (2 * Tp + CHUNK - 1) / CHUNK;
  dim3 grid((chunks + CHUNKS - 1) / CHUNKS, Fp, B);
  vgg_block1_fwd_bf16_kernel<<<grid, MTHREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1,
      (const __nv_bfloat16*)w2p, (const float*)b2, (__nv_bfloat16*)out,
      (uint8_t*)idx, F, T);
  return cudaGetLastError();
}
