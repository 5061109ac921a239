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

// ---------------------------------------------------------------------------
// backward (vgg_block1_bwd): dW1, db1, dW2, db2, no input gradient
// ---------------------------------------------------------------------------
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_bwd_kernel (reached from
// _bwd_pallas). Inputs: the forward's input x, weights, output `out`, the
// uint8 pool argmax `idx` and g = dL/d(out), all (B, F/2, T/2, 64) NHWC.
//   dy2 = g * [out > 0] routed to the argmax of its 2x2 window (zero in an
//         odd last row / column), rounded to cdt;
//   dW2 = sum dy2 (x) im2col(x1), db2 = sum g * [out > 0];
//   dx1 = conv2^T(dy2) * [x1 > 0], db1 = sum dx1,
//   dW1 = sum cdt(dx1) (x) im2col(cdt(x))      (vgg_fused.py:279-284),
// with x1 recomputed exactly as the forward computes it (so the relu mask
// is the forward's). The TPU kernel carries the sums across its sequential
// grid (:222-227); blocks here run in no order, so each of a FIXED number
// of blocks (BWD_BLOCKS) walks a fixed range of work items, keeps its
// partial sums in registers and writes them out, and a last kernel adds
// the partials in block order: two runs give identical bits.
//
// Work item = (utterance, pair of conv rows 2r, 2r+1, 64 conv columns).
//   dW2 kernel (grid BWD_BLOCKS x 3): block (i, df) owns dW2[df] (3 taps x
//     64 x 64); per item it rebuilds x1 at rows 2r-1 .. 2r+2 and the item's
//     own dy2, and runs dW2[df] += x1_shift^T . dy2 (K = the item's 128
//     positions). bf16: mma.sync, each warp owning 3 of the 24 (16 ci x 32
//     co) tiles; f32: FMA, each thread 3 taps x 4 ci x 4 co.
//   dx kernel (grid BWD_BLOCKS): per item it gathers dy2 at rows 2r-1 ..
//     2r+2 (the halo comes from the neighbouring items' pool windows, so
//     every x1 position's dx is complete inside one item: no partial dx
//     crosses blocks) and runs dx1 = sum_taps dy2_shift . W2_tap^T, the
//     forward's implicit GEMM with W2 in its natural (tap, ci, co) layout;
//     then the relu mask, db1, and dW1 from cdt(dx1) and the input tile.
// Bound on the H100 (B=12, F=161, T=800): dW2 and dx1 are 2 x 114 GFLOP,
// conv1's recompute and dW1 2 x 1.8: 231.5 GFLOP, 0.234 ms on the bf16
// tensor cores (3.5 ms at the f32 FMA rate); bytes (~60 MB in) are small
// beside it.

constexpr int BWD_BLOCKS = 256;    // fixed: the reduction order is fixed
constexpr int BT = 256;            // threads of the backward blocks
constexpr int CW = 64;             // conv columns per work item
constexpr int XW = CW + 2;         // x1 / dy2 columns held (halo)
constexpr int XS = CW + 4;         // input columns staged
constexpr int DW2_SIZE = 9 * C * C;
constexpr int PART = 9 * C + C + DW2_SIZE + C;  // floats per block

struct Item {
  int b, r, c0;
};

__device__ __forceinline__ Item item_of(long it, int rows, int chunks) {
  Item w;
  w.c0 = (int)(it % chunks) * CW;
  it /= chunks;
  w.r = (int)(it % rows);
  w.b = (int)(it / rows);
  return w;
}

// input rows 2r-2 .. 2r+3, columns c0-2 .. c0+65 (rounded to bf16 when
// `round`), zero outside the image
__device__ __forceinline__ void stage_x(const float* x, int F, int T,
                                        const Item& w, float* xs,
                                        bool round, int tid) {
  const float* xb = x + (size_t)w.b * F * T;
  for (int e = tid; e < 6 * XS; e += BT) {
    const int i = e / XS, j = e % XS;
    const int g = 2 * w.r - 2 + i, t = w.c0 - 2 + j;
    float v = 0.f;
    if (g >= 0 && g < F && t >= 0 && t < T) {
      v = xb[(size_t)g * T + t];
      if (round) v = bf16r(v);
    }
    xs[e] = v;
  }
}

// x1 at (row 2r + q, column c0 + j) for conv1 output channel ci, from the
// staged tile, as the forward computes it (bf16: cdt(conv) + cdt(b1)).
__device__ __forceinline__ float x1_at(const float* xs, const float* w1s,
                                       const float* b1s, int q, int j, int ci,
                                       bool bf16) {
  float acc = 0.f;
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
      acc = fmaf(xs[(q + 1 + df) * XS + j + 1 + dt], w1s[(df * 3 + dt) * C + ci],
                 acc);
  return bf16 ? fmaxf(bf16r(bf16r(acc) + b1s[ci]), 0.f)
              : fmaxf(acc + b1s[ci], 0.f);
}

// g, out and idx of 8 channels at one pooled position (zeros and an idx
// that matches no window element when the position is outside the pool)
__device__ __forceinline__ void load_pooled8(const void* g, const void* out,
                                             const uint8_t* idx, size_t off,
                                             bool valid, bool bf16,
                                             float* gv, float* ov,
                                             uint8_t* iv) {
  if (!valid) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gv[i] = 0.f;
      ov[i] = 0.f;
      iv[i] = 255;
    }
    return;
  }
  if (bf16) {
    const uint4 a = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(g) + off);
    const uint4 c = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(out) + off);
    const __nv_bfloat16* ap = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* cp = reinterpret_cast<const __nv_bfloat16*>(&c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gv[i] = __bfloat162float(ap[i]);
      ov[i] = __bfloat162float(cp[i]);
    }
  } else {
    const float4* gp = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(g) + off);
    const float4* op = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(out) + off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = gp[h], c = op[h];
      gv[4 * h] = a.x; gv[4 * h + 1] = a.y; gv[4 * h + 2] = a.z;
      gv[4 * h + 3] = a.w;
      ov[4 * h] = c.x; ov[4 * h + 1] = c.y; ov[4 * h + 2] = c.z;
      ov[4 * h + 3] = c.w;
    }
  }
  const uint2 u = *reinterpret_cast<const uint2*>(idx + off);
  const uint8_t* up = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) iv[i] = up[i];
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void stage_w1b1(const float* w1, const float* b1,
                                           float* w1s, float* b1s, bool bf16,
                                           int tid) {
  for (int e = tid; e < 9 * C; e += BT) w1s[e] = bf16 ? bf16r(w1[e]) : w1[e];
  for (int e = tid; e < C; e += BT) b1s[e] = bf16 ? bf16r(b1[e]) : b1[e];
}

// ---- dW2 (+ db2), bf16 ----------------------------------------------------

__global__ void __launch_bounds__(BT)
vgg_block1_dw2_bf16_kernel(const float* __restrict__ x,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ out,
                           const uint8_t* __restrict__ idx,
                           float* __restrict__ part, int B, int F, int T) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* x1s = reinterpret_cast<__nv_bfloat16*>(smem4);  // 4XW x 64
  __nv_bfloat16* dys = x1s + 4 * XW * C;                         // 2CW x 64
  float* xs = reinterpret_cast<float*>(dys + 2 * CW * C);        // 6 x XS
  float* w1s = xs + 6 * XS;
  float* b1s = w1s + 9 * C;
  float* red = b1s + C;                                          // 32 x 64

  const int Fp = F / 2, Tp = T / 2;
  const int chunks = (2 * Tp + CW - 1) / CW;
  const long n = (long)B * Fp * chunks;
  const int blk = blockIdx.x, df = blockIdx.y;
  const long lo = n * blk / BWD_BLOCKS, hi = n * (blk + 1) / BWD_BLOCKS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_w1b1(w1, b1, w1s, b1s, true, tid);

  float acc[3][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][nn][i] = 0.f;
  float db2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) db2[i] = 0.f;
  const int tpl = tid >> 3, ch = tid & 7;  // dy fill: pooled column, chunk

  for (long it = lo; it < hi; ++it) {
    const Item w = item_of(it, Fp, chunks);
    __syncthreads();  // previous item's tiles consumed
    stage_x(x, F, T, w, xs, true, tid);
    {  // this item's dy2: 2 rows x 64 columns
      const int tp = w.c0 / 2 + tpl;
      float gv[8], ov[8];
      uint8_t iv[8];
      load_pooled8(g, out, idx, (((size_t)w.b * Fp + w.r) * Tp + tp) * C +
                                    ch * 8,
                   tp < Tp, true, gv, ov, iv);
#pragma unroll
      for (int wp = 0; wp < 4; ++wp) {
        float d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = (iv[i] == wp && ov[i] > 0.f)
                                               ? gv[i] : 0.f;
        const int pos = (wp >> 1) * CW + 2 * tpl + (wp & 1);
        *reinterpret_cast<uint4*>(dys + swz(pos, ch)) =
            make_uint4(pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]),
                       pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7]));
      }
      if (df == 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) db2[i] += ov[i] > 0.f ? gv[i] : 0.f;
    }
    __syncthreads();  // xs staged
    // x1 at rows 2r-1 .. 2r+2, columns c0-1 .. c0+64, bf16 (the forward's)
    {
      const int cg = tid & 7;
      for (int pos = tid >> 3; pos < 4 * XW; pos += BT >> 3) {
        const int i = pos / XW, j = pos % XW;
        const int gr = 2 * w.r - 1 + i, t = w.c0 - 1 + j;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gr >= 0 && gr < F && t >= 0 && t < T) {
          float o[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            o[k] = x1_at(xs, w1s, b1s, i - 1, j - 1, cg * 8 + k, true);
          v = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                         pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
        }
        *reinterpret_cast<uint4*>(x1s + swz(pos, cg)) = v;
      }
    }
    __syncthreads();
    // dW2[df] += x1_shift^T . dy2 over the item's 128 positions
#pragma unroll 1
    for (int q = 0; q < 2; ++q)
#pragma unroll 1
      for (int kb = 0; kb < CW / 16; ++kb) {
        uint32_t bf[2][2][4];
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
#pragma unroll
          for (int np = 0; np < 2; ++np)
            ldsm_x4_t(dys + swz(q * CW + 16 * kb + (lane & 15),
                                nh * 4 + 2 * np + (lane >> 4)),
                      bf[nh][np][0], bf[nh][np][1], bf[nh][np][2],
                      bf[nh][np][3]);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int u = warp * 3 + s, mt = u >> 1, nh = u & 1;
          const int dt = mt >> 2, c16 = mt & 3;
          const int pos = (q + df) * XW + 16 * kb + dt + (lane & 7) +
                          ((lane >> 4) << 3);
          uint32_t a[4];
          ldsm_x4_t(x1s + swz(pos, 2 * c16 + ((lane >> 3) & 1)), a[0], a[1],
                    a[2], a[3]);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(acc[s][2 * np], a, bf[nh][np][0], bf[nh][np][1]);
            mma_bf16(acc[s][2 * np + 1], a, bf[nh][np][2], bf[nh][np][3]);
          }
        }
      }
  }

  // partial dW2[df] -> part[blk]: layout (dt, ci, co) after 9C + C floats
  float* pd = part + (size_t)blk * PART + 9 * C + C + df * 3 * C * C;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int u = warp * 3 + s, mt = u >> 1, nh = u & 1;
    const int dt = mt >> 2, c16 = mt & 3;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = c16 * 16 + (lane >> 2) + 8 * (i >> 1);
        const int co = nh * 32 + nn * 8 + 2 * (lane & 3) + (i & 1);
        pd[(dt * C + ci) * C + co] = acc[s][nn][i];
      }
  }
  if (df == 0) {  // db2: 32 pooled columns x 8 chunks -> 64 channels
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) red[tpl * C + ch * 8 + i] = db2[i];
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int k = 0; k < 32; ++k) s += red[k * C + tid];
      part[(size_t)blk * PART + 9 * C + C + DW2_SIZE + tid] = s;
    }
  }
}

// dy2 at rows 2r-1 .. 2r+2 and columns c0-1 .. c0+64 of an item (the
// positions whose dy2 reaches the item's x1 through conv2), one thread per
// (position, 8 channels); `put` stores the 8 values of a position.
template <typename Put>
__device__ __forceinline__ void gather_dy(const void* g, const void* out,
                                          const uint8_t* idx, const Item& w,
                                          int Fp, int Tp, bool bf16, int tid,
                                          Put put) {
  for (int e = tid; e < 4 * XW * 8; e += BT) {
    const int pos = e >> 3, ch = e & 7;
    const int i = pos / XW, j = pos % XW;
    const int R = 2 * w.r - 1 + i, Cc = w.c0 - 1 + j;
    const bool in = R >= 0 && R < 2 * Fp && Cc >= 0 && Cc < 2 * Tp;
    float gv[8], ov[8];
    uint8_t iv[8];
    load_pooled8(g, out, idx,
                 in ? (((size_t)w.b * Fp + R / 2) * Tp + Cc / 2) * C + ch * 8
                    : 0,
                 in, bf16, gv, ov, iv);
    const int wp = 2 * (R & 1) + (Cc & 1);
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[k] = (in && iv[k] == wp && ov[k] > 0.f) ? gv[k] : 0.f;
    put(pos, ch, d);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dW1 partial over an item: thread e (< 576 = 9 taps x 64) accumulates
// sum_pos dx1[pos][ci] * x[pos + tap]; dxs is the masked dx1 (rounded to
// cdt) at the item's 2 x 64 positions, [pos][64].
template <typename Dx>
__device__ __forceinline__ void accumulate_dw1(const Dx* dxs, const float* xs,
                                               float* dw1, int tid) {
  const int ci = tid & 63, t0 = tid >> 6;
#pragma unroll 1
  for (int q = 0; q < 2; ++q)
#pragma unroll 4
    for (int j = 0; j < CW; ++j) {
      const float d = to_f(dxs[(q * CW + j) * C + ci]);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int tap = t0 + 4 * s;
        if (tap < 9)
          dw1[s] = fmaf(d, xs[(q + 1 + tap / 3) * XS + j + 1 + tap % 3],
                        dw1[s]);
      }
    }
}

// write the block's dW1 partial (thread e holds taps e/64, e/64+4, e/64+8)
__device__ __forceinline__ void store_dw1(float* part, int blk,
                                          const float* dw1, int tid) {
  float* p = part + (size_t)blk * PART;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int e = tid + 256 * s;
    if (e < 9 * C) p[e] = dw1[s];
  }
}

// ---- dx1 -> dW1, db1, bf16 ------------------------------------------------

__global__ void __launch_bounds__(BT, 1)
vgg_block1_dx_bf16_kernel(const float* __restrict__ x,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ w2n,
                          const __nv_bfloat16* __restrict__ g,
                          const __nv_bfloat16* __restrict__ out,
                          const uint8_t* __restrict__ idx,
                          float* __restrict__ part, int B, int F, int T) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);  // 576 x 64
  __nv_bfloat16* dys = w2s + 9 * C * C;                          // 4XW x 64
  __nv_bfloat16* dxs = dys + 4 * XW * C;                         // 2CW x 64
  float* xs = reinterpret_cast<float*>(dxs + 2 * CW * C);        // 6 x XS
  float* w1s = xs + 6 * XS;
  float* b1s = w1s + 9 * C;
  float* red = b1s + C;                                          // 8 x 64

  const int Fp = F / 2, Tp = T / 2;
  const int rows = (F + 1) / 2, chunks = (T + CW - 1) / CW;
  const long n = (long)B * rows * chunks;
  const int blk = blockIdx.x;
  const long lo = n * blk / BWD_BLOCKS, hi = n * (blk + 1) / BWD_BLOCKS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // conv2's weight in its natural layout: row = tap*64 + ci, 64 co
  for (int e = tid; e < 9 * C * 8; e += BT)
    *reinterpret_cast<uint4*>(w2s + swz(e >> 3, e & 7)) =
        reinterpret_cast<const uint4*>(w2n)[e];
  stage_w1b1(w1, b1, w1s, b1s, true, tid);

  float dw1[3] = {0.f, 0.f, 0.f};
  float db1[8][2];
#pragma unroll
  for (int k = 0; k < 8; ++k) db1[k][0] = db1[k][1] = 0.f;
  const int aq = (lane >> 3) & 1, ac = lane & 7, akc = lane >> 4;
  const int bn = ((lane >> 4) << 3) + (lane & 7), bkc = (lane >> 3) & 1;
  const int cq = lane >> 2;

  for (long it = lo; it < hi; ++it) {
    const Item w = item_of(it, rows, chunks);
    __syncthreads();  // previous item's tiles consumed
    stage_x(x, F, T, w, xs, true, tid);
    gather_dy(g, out, idx, w, Fp, Tp, true, tid,
              [&](int pos, int ch, const float* d) {
                *reinterpret_cast<uint4*>(dys + swz(pos, ch)) = make_uint4(
                    pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]),
                    pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7]));
              });
    __syncthreads();

    // dx1 at rows 2r, 2r+1, columns warp*8 .. +7: M = 16, N = 64 ci,
    // K = 9 taps x 64 co; A = dy2 shifted by the tap, B = W2[tap] (ci x co)
    float acc[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nn][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int df = tap / 3, dt = tap % 3;
      const int apos = (aq + 2 - df) * XW + warp * 8 + ac + 2 - dt;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4];
        ldsm_x4(dys + swz(apos, 2 * kc + akc), a[0], a[1], a[2], a[3]);
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

    // relu mask with x1 recomputed; db1 from dx1, dxs = cdt(dx1)
    const int j = warp * 8 + cq;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = i >> 1, ci = 8 * nn + 2 * (lane & 3) + (i & 1);
        const bool in = 2 * w.r + q < F && w.c0 + j < T;
        float d = 0.f;
        if (in && x1_at(xs, w1s, b1s, q, j, ci, true) > 0.f) d = acc[nn][i];
        db1[nn][i & 1] += d;
        dxs[(q * CW + j) * C + ci] = __float2bfloat16(d);
      }
    __syncthreads();
    accumulate_dw1(dxs, xs, dw1, tid);
  }

  store_dw1(part, blk, dw1, tid);
  // db1: lanes sharing lane & 3 hold the same channels
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v = db1[nn][k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      db1[nn][k] = v;
    }
  __syncthreads();
  if (lane < 4)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int k = 0; k < 2; ++k) red[warp * C + 8 * nn + 2 * lane + k] =
          db1[nn][k];
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
    for (int k = 0; k < BT / 32; ++k) s += red[k * C + tid];
    part[(size_t)blk * PART + 9 * C + tid] = s;
  }
}

// ---- dW2 (+ db2), f32 FMA ------------------------------------------------

__global__ void __launch_bounds__(BT)
vgg_block1_dw2_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ g,
                          const float* __restrict__ out,
                          const uint8_t* __restrict__ idx,
                          float* __restrict__ part, int B, int F, int T) {
  extern __shared__ float4 smem4[];
  float* x1s = reinterpret_cast<float*>(smem4);  // 4XW x 64
  float* dys = x1s + 4 * XW * C;                 // 2CW x 64
  float* xs = dys + 2 * CW * C;                  // 6 x XS
  float* w1s = xs + 6 * XS;
  float* b1s = w1s + 9 * C;
  float* red = b1s + C;                          // 32 x 64

  const int Fp = F / 2, Tp = T / 2;
  const int chunks = (2 * Tp + CW - 1) / CW;
  const long n = (long)B * Fp * chunks;
  const int blk = blockIdx.x, df = blockIdx.y;
  const long lo = n * blk / BWD_BLOCKS, hi = n * (blk + 1) / BWD_BLOCKS;
  const int tid = threadIdx.x;
  stage_w1b1(w1, b1, w1s, b1s, false, tid);

  const int cg = tid >> 4, og = tid & 15;  // ci 4cg.., co 4og..
  float acc[3][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[s][i][k] = 0.f;
  float db2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) db2[i] = 0.f;
  const int tpl = tid >> 3, ch = tid & 7;

  for (long it = lo; it < hi; ++it) {
    const Item w = item_of(it, Fp, chunks);
    __syncthreads();
    stage_x(x, F, T, w, xs, false, tid);
    {
      const int tp = w.c0 / 2 + tpl;
      float gv[8], ov[8];
      uint8_t iv[8];
      load_pooled8(g, out, idx, (((size_t)w.b * Fp + w.r) * Tp + tp) * C +
                                    ch * 8,
                   tp < Tp, false, gv, ov, iv);
#pragma unroll
      for (int wp = 0; wp < 4; ++wp) {
        const int pos = (wp >> 1) * CW + 2 * tpl + (wp & 1);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dys[pos * C + ch * 8 + i] =
              (iv[i] == wp && ov[i] > 0.f) ? gv[i] : 0.f;
      }
      if (df == 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) db2[i] += ov[i] > 0.f ? gv[i] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < 4 * XW * C; e += BT) {
      const int ci = e & 63, pos = e >> 6;
      const int i = pos / XW, j = pos % XW;
      const int gr = 2 * w.r - 1 + i, t = w.c0 - 1 + j;
      x1s[e] = (gr >= 0 && gr < F && t >= 0 && t < T)
                   ? x1_at(xs, w1s, b1s, i - 1, j - 1, ci, false) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < 2; ++q)
#pragma unroll 2
      for (int j = 0; j < CW; ++j) {
        const float4 d = *reinterpret_cast<const float4*>(
            dys + (q * CW + j) * C + 4 * og);
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float4 a = *reinterpret_cast<const float4*>(
              x1s + ((q + df) * XW + j + dt) * C + 4 * cg);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[dt][ii][jj] = fmaf(av[ii], dv[jj], acc[dt][ii][jj]);
        }
      }
  }

  float* pd = part + (size_t)blk * PART + 9 * C + C + df * 3 * C * C;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        pd[(dt * C + 4 * cg + ii) * C + 4 * og + jj] = acc[dt][ii][jj];
  if (df == 0) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) red[tpl * C + ch * 8 + i] = db2[i];
    __syncthreads();
    if (tid < C) {
      float s = 0.f;
      for (int k = 0; k < 32; ++k) s += red[k * C + tid];
      part[(size_t)blk * PART + 9 * C + C + DW2_SIZE + tid] = s;
    }
  }
}

// ---- dx1 -> dW1, db1, f32 FMA --------------------------------------------

constexpr int XP = 68;  // column pitch of the f32 dy2 tile

__global__ void __launch_bounds__(BT, 1)
vgg_block1_dx_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ g,
                         const float* __restrict__ out,
                         const uint8_t* __restrict__ idx,
                         float* __restrict__ part, int B, int F, int T) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // 3 dt x 64 co x 64 ci
  float* dys = w2s + 3 * C * C;                  // 4 rows x 64 co x XP
  float* dxs = dys + 4 * C * XP;                 // 2CW x 64
  float* xs = dxs + 2 * CW * C;                  // 6 x XS
  float* w1s = xs + 6 * XS;
  float* b1s = w1s + 9 * C;
  float* red = b1s + C;                          // BT x 4

  const int Fp = F / 2, Tp = T / 2;
  const int rows = (F + 1) / 2, chunks = (T + CW - 1) / CW;
  const long n = (long)B * rows * chunks;
  const int blk = blockIdx.x;
  const long lo = n * blk / BWD_BLOCKS, hi = n * (blk + 1) / BWD_BLOCKS;
  const int tid = threadIdx.x;
  stage_w1b1(w1, b1, w1s, b1s, false, tid);

  const int cgi = tid & 15, colg = tid >> 4;  // ci 4cgi.., cols 4colg..
  float dw1[3] = {0.f, 0.f, 0.f};
  float db1[4] = {0.f, 0.f, 0.f, 0.f};

  for (long it = lo; it < hi; ++it) {
    const Item w = item_of(it, rows, chunks);
    __syncthreads();
    stage_x(x, F, T, w, xs, false, tid);
    gather_dy(g, out, idx, w, Fp, Tp, false, tid,
              [&](int pos, int ch, const float* d) {
                const int i = pos / XW, j = pos % XW;
#pragma unroll
                for (int k = 0; k < 8; ++k)
                  dys[(i * C + ch * 8 + k) * XP + j] = d[k];
              });
    float acc[2][4][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[q][i][k] = 0.f;
    for (int df = 0; df < 3; ++df) {
      __syncthreads();  // dy2 gathered / previous filter row consumed
      for (int e = tid; e < 3 * C * C; e += BT) {
        const int dt = e / (C * C), ci = (e / C) % C, co = e % C;
        w2s[(dt * C + co) * C + ci] = w2[((df * 3 + dt) * C + ci) * C + co];
      }
      __syncthreads();
      for (int co = 0; co < C; ++co) {
        float a[2][6];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* row = dys + ((q + 2 - df) * C + co) * XP + 4 * colg;
          const float4 v = *reinterpret_cast<const float4*>(row);
          const float2 u = *reinterpret_cast<const float2*>(row + 4);
          a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
          a[q][4] = u.x; a[q][5] = u.y;
        }
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const float4 wv = *reinterpret_cast<const float4*>(
              w2s + (dt * C + co) * C + 4 * cgi);
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
                acc[q][jj][cc] =
                    fmaf(a[q][jj + 2 - dt], wr[cc], acc[q][jj][cc]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = 4 * colg + jj, ci = 4 * cgi + cc;
          const bool in = 2 * w.r + q < F && w.c0 + j < T;
          float d = 0.f;
          if (in && x1_at(xs, w1s, b1s, q, j, ci, false) > 0.f)
            d = acc[q][jj][cc];
          db1[cc] += d;
          dxs[(q * CW + j) * C + ci] = d;
        }
    __syncthreads();
    accumulate_dw1(dxs, xs, dw1, tid);
  }

  store_dw1(part, blk, dw1, tid);
  __syncthreads();
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) red[tid * 4 + cc] = db1[cc];
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
    for (int k = 0; k < BT / 16; ++k) s += red[(k * 16 + (tid >> 2)) * 4 +
                                               (tid & 3)];
    part[(size_t)blk * PART + 9 * C + tid] = s;
  }
}

// grads[e] = sum over blocks, in block order, of part[blk][e]
__global__ void vgg_block1_bwd_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PART) return;
  float s = 0.f;
  for (int k = 0; k < BWD_BLOCKS; ++k) s += part[(size_t)k * PART + e];
  grads[e] = s;
}

template <typename Dw2, typename Dx, typename W2, typename G>
int launch_bwd(Dw2 dw2_kernel, Dx dx_kernel, size_t smem_dw2, size_t smem_dx,
               const float* x, const float* w1, const float* b1, const W2* w2,
               const G* g, const G* out, const uint8_t* idx, float* part,
               float* grads, int B, int F, int T, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      dw2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dw2);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dx_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dx);
  if (e != cudaSuccess) return e;
  dw2_kernel<<<dim3(BWD_BLOCKS, 3), BT, smem_dw2, s>>>(x, w1, b1, g, out, idx,
                                                       part, B, F, T);
  dx_kernel<<<BWD_BLOCKS, BT, smem_dx, s>>>(x, w1, b1, w2, g, out, idx, part,
                                            B, F, T);
  vgg_block1_bwd_reduce_kernel<<<(PART + 255) / 256, 256, 0, s>>>(part,
                                                                  grads);
  return cudaGetLastError();
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

// Backward. x (B, F, T) f32; w1 (3,3,1,64), b1 (64) f32; w2: bf16 HWIO
// (3,3,64 ci,64 co) for the bf16 entry, f32 HWIO for the f32 entry; g and
// out (B, F/2, T/2, 64) NHWC in cdt; idx uint8 of the same shape; part:
// BWD_BLOCKS x PART f32 scratch; grads: PART f32 = dW1 (3,3,1,64) | db1
// (64) | dW2 (3,3,64,64) | db2 (64).
extern "C" int vgg_block1_bwd_bf16(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* g, const void* out,
                                   const void* idx, void* part, void* grads,
                                   int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this call's error
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F / 2 == 0 || T / 2 == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART, s);
  const size_t smem_dw2 =
      sizeof(__nv_bfloat16) * (size_t)(4 * XW * C + 2 * CW * C) +
      sizeof(float) * (size_t)(6 * XS + 9 * C + C + 32 * C);
  const size_t smem_dx =
      sizeof(__nv_bfloat16) * (size_t)(9 * C * C + 4 * XW * C + 2 * CW * C) +
      sizeof(float) * (size_t)(6 * XS + 9 * C + C + 8 * C);
  return launch_bwd(vgg_block1_dw2_bf16_kernel, vgg_block1_dx_bf16_kernel,
                    smem_dw2, smem_dx, (const float*)x, (const float*)w1,
                    (const float*)b1, (const __nv_bfloat16*)w2,
                    (const __nv_bfloat16*)g, (const __nv_bfloat16*)out,
                    (const uint8_t*)idx, (float*)part, (float*)grads, B, F, T,
                    s);
}

extern "C" int vgg_block1_bwd_f32(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* g, const void* out,
                                  const void* idx, void* part, void* grads,
                                  int B, int F, int T, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F / 2 == 0 || T / 2 == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART, s);
  const size_t smem_dw2 =
      sizeof(float) * (size_t)(4 * XW * C + 2 * CW * C + 6 * XS + 9 * C + C +
                               32 * C);
  const size_t smem_dx =
      sizeof(float) * (size_t)(3 * C * C + 4 * C * XP + 2 * CW * C + 6 * XS +
                               9 * C + C + BT * 4);
  return launch_bwd(vgg_block1_dw2_f32_kernel, vgg_block1_dx_f32_kernel,
                    smem_dw2, smem_dx, (const float*)x, (const float*)w1,
                    (const float*)b1, (const float*)w2, (const float*)g,
                    (const float*)out, (const uint8_t*)idx, (float*)part,
                    (float*)grads, B, F, T, s);
}

