// vgg_block2_f32: the f32 entries of the fused vgg block 2 and of its
// backward (csrc/vgg_block2.cu holds the bf16 entries):
//
//   out = relu(maxpool2x2(conv4_SAME(relu(conv3_SAME(x) + b3))) + b4)
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_fwd2_kernel and
// ::_bwd2_kernel (reached from _fwd2_pallas / _bwd2_pallas) at compute type
// f32. Layouts as in csrc/vgg_block2.cu: x (B, F, T, 64) channels-last; out
// (B, F/2, T/2, 128); idx uint8 of out's shape, the pool's argmax in window
// order (0,0),(0,1),(1,0),(1,1) over (f, t); g = dL/d(out); dx of x's
// shape; F and T even. Weights: w3 "n" (tap, ci, c3) for conv3, w4 "n"
// (tap, c3, c4) for conv4, w4 "t" (tap, c4, c3) for dx2, w3 "t" (tap, c3,
// ci) for dx.
//
// Numerics (vgg_fused.py's f32 path): every product is one f32 FFMA on f32
// values (no TF32); conv3 + b3, relu, and positions outside the image are
// ZERO for conv4 (relu(0 + b3) never enters conv4's SAME border); conv4,
// the pool with strict '>' (the first maximum in (f, t) order wins), + b4,
// relu; dy4 = g * [out > 0] routed by idx; dx2 = W4^T . dy4 masked by the
// recomputed x2 > 0 (dy3); dW4 = sum x2 (x) dy4, db4 = sum dy4; dW3 = sum
// x (x) dy3, db3 = sum dy3; dx = W3^T . dy3. Only the order of the f32
// sums differs from a library convolution.
//
// Design: every product runs in one of two register-blocked FFMA tiles; a
// thread reads its A and B fragments from shared memory as float4s that
// the lanes of a warp share (broadcast).
//   * conv_tile, the four convolutions: out[p][n] = sum_tap sum_k
//     A[p + s(tap)][k] * W[tap][k][n] over a tile of 8 conv rows x 16
//     columns x 128 channels (16 x 16 x 64 for dx), 256 threads, a thread
//     8 positions x 8 channels (16 FFMA a load). K runs over chunks of 16
//     input channels; a chunk stages the tile's positions with their one-
//     position halo (zero outside the image) and the 9 taps' weights by
//     cp.async, double-buffered, and a tap is an address offset into the
//     staged halo tile (no im2col copy; the transposed convolutions read it
//     at -s(tap)). A thread's 8 positions are its warp's two rows at
//     columns 2g, 2g+1, 2g+8, 2g+9 (g = lane % 4): its two pool windows
//     lie in its registers, and the four positions a load instruction
//     reads lie in distinct banks. A float4 of A is 4 channels of one
//     position (a tap's shift keeps it aligned), a float4 of B 4 output
//     channels of one k.
//   * wgrad_tile, the weight gradients: acc[a][n] += sum_pos A[pos][a] *
//     B[pos][n] over K segments (16 columns of one conv row), two a stage,
//     A the shifted activation (x2 for dW4, one tap a tile; x for dW3, two
//     taps a tile, the fifth tile's second half idle), B the gradient at
//     the segment's own positions (dy4, dy3); 128 threads, two blocks an
//     SM, a thread 8 x 16 sums (21 FFMA a load). K is split into SPLITS
//     ranges, a fixed number; the reduce kernel adds the ranges' partial
//     sums in range order, so two runs give the same bits.
// Kernels, each named for its entry: forward x2 (conv3 + b3 + relu into
// device memory), conv4 (+ the pool, b4, relu, out, idx); backward x2 (the
// recompute), dy4 (g routed in one pass), dy3 (dx2 and the mask), wgrad
// (14 tiles x SPLITS: dW4, dW3, db4 and db3 in the tiles of tap 4), reduce,
// dx.
//
// Bound at x (12, 80, 400, 64): 169.9 GFLOP forward (2.54 ms at the H100's
// 67 TFLOP/s of f32 FMA), 339.7 GFLOP backward (5.07 ms); executed 402.5
// with the x2 recompute and dW3's idle half (6.01 ms). The intermediates
// x2, dy4 and dy3 (196.6 MB each at that shape) go through device memory:
// writing one takes ~0.06 ms at 3.35 TB/s, against 1.3-4.2 ms of products
// for each GEMM. 16-column and 8-row tiles divide T = 400 and F = 80: no
// product is computed for a position outside the image there. What bounds
// the tiles (PERF.md): the FFMA pipe fed from shared memory, at
// 42-43 TFLOP/s executed, as cuDNN's own f32 implicit GEMM runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CI = 64;     // conv3 input channels
constexpr int C2 = 128;    // conv3 / conv4 output channels
// column slots a conv thread owns in each of its two rows: columns 2g +
// (c % 2) + 8 (c / 2) for slot c, g = lane % 4; a conv tile is TC columns
// (tools/probe_vgg2_bwd.py --variants times 6 slots, 12 positions a thread)
constexpr int CSLOT = 4;
constexpr int TC = 4 * CSLOT;
constexpr int HC = TC + 2; // with the halo
constexpr int SEG = 16;    // positions a wgrad K segment (one row's columns)
constexpr int KP = 2 * SEG;  // positions a wgrad stage
constexpr int WG_TILES = 9 + 5;  // dW4 one tap a tile, dW3 two
// wgrad K ranges: fixed (the reduction order is fixed); 14 x 132 blocks
// are 7 waves of two blocks an SM on 132 SMs
constexpr int SPLITS = 132;
constexpr int DW3_SIZE = 9 * CI * C2;
constexpr int DW4_SIZE = 9 * C2 * C2;
constexpr int PART2 = DW3_SIZE + C2 + DW4_SIZE + C2;  // floats a range
constexpr int NT = 256;    // threads of the element-wise kernels

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void stg4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// conv_tile: a tile of TR = 2 WM conv rows x TC columns x NOUT = 64 WN
// output channels, 256 threads. Warp w owns rows 2 (w % WM), +1 and
// channels 64 (w / WM) .. +63; lane (g = lane % 4, c = lane / 4) owns the
// CSLOT columns 2g, 2g+1, 2g+8, 2g+9, ... of both rows (position i =
// CSLOT row + slot) and channels 4c .. 4c+3, 4c+32 .. 4c+35 (channel j).
// ---------------------------------------------------------------------------

template <int CIN_, int WM, int WN> struct Conv {
  static constexpr int CIN = CIN_;
  static constexpr int NTH = 32 * WM * WN;   // threads a block
  static constexpr int NP = 2 * CSLOT;       // positions a thread
  static constexpr int NOUT = 64 * WN;
  static constexpr int TR = 2 * WM;
  static constexpr int HR = TR + 2;
  // input channels a K chunk (tools/probe_vgg2_bwd.py --variants times 8)
  static constexpr int KC = 16;
  static constexpr int PA = KC + 4;          // floats a staged position
  static constexpr int AS = HR * HC * PA;    // floats: a chunk's halo tile
  static constexpr int WS = 9 * KC * NOUT;   // floats: a chunk's weights
  static constexpr int STAGE = AS + WS;
  static constexpr int NCHUNK = CIN / KC;
  static constexpr size_t SMEM = 2 * sizeof(float) * STAGE;
  static_assert(NTH == 256, "8 warps");
  static_assert(CIN % KC == 0, "whole chunks");
  static_assert(SMEM <= 232448, "the block's shared memory");
};
typedef Conv<CI, 4, 2> Conv3;   // x2: 8 rows x TC columns x 128
typedef Conv<C2, 4, 2> Conv4;   // conv4, dx2
typedef Conv<C2, 8, 1> ConvDx;  // dx: 16 rows x TC columns x 64

// the thread's place in the tile: position i at row r0 + prow(i), column
// c0 + pcol(i); channel j at n0 + pch(j)
struct Place {
  int r0, c0, n0;
};
__device__ __forceinline__ int prow(int i) { return i / CSLOT; }
__device__ __forceinline__ int pcol(int i) {
  return (i % CSLOT & 1) + 8 * (i % CSLOT >> 1);
}
__device__ __forceinline__ int pch(int j) { return (j & 3) + 32 * (j >> 2); }

template <typename C>
__device__ __forceinline__ Place conv_place() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % (C::TR / 2);
  return Place{(int)blockIdx.y * C::TR + 2 * wm,
               (int)blockIdx.x * TC + 2 * (lane & 3),
               64 * (warp / (C::TR / 2)) + 4 * (lane >> 2)};
}

// chunk c (input channels KC c .. KC c + KC-1) of A at rows f0-1 .. f0+TR
// and columns t0-1 .. t0+TC of one utterance (zero outside the image), and
// of the weights w (tap, CIN, NOUT), into stage st
template <typename C>
__device__ __forceinline__ void conv_stage(float* st, const float* a,
                                           const float* w, int F, int Tn,
                                           int f0, int t0, int c) {
  constexpr int KC = C::KC, PA = C::PA;
  for (int e = threadIdx.x; e < C::HR * HC * (KC / 4); e += C::NTH) {
    const int v = e % (KC / 4), pos = e / (KC / 4);
    const int f = f0 - 1 + pos / HC, t = t0 - 1 + pos % HC;
    const bool ok = f >= 0 && f < F && t >= 0 && t < Tn;
    cp_async16(st + pos * PA + 4 * v,
               ok ? a + ((size_t)f * Tn + t) * C::CIN + KC * c + 4 * v : a,
               ok);
  }
  float* ws = st + C::AS;
  constexpr int NV = C::NOUT / 4;
  for (int e = threadIdx.x; e < 9 * KC * NV; e += C::NTH) {
    const int v = e % NV, row = e / NV, tap = row / KC, k = row % KC;
    cp_async16(ws + row * C::NOUT + 4 * v,
               w + ((size_t)tap * C::CIN + KC * c + k) * C::NOUT + 4 * v,
               true);
  }
}

// acc[i][j] += the chunk's 9 x KC products. FLIP: the transposed
// convolution, which reads A at -s(tap)
template <typename C, bool FLIP>
__device__ __forceinline__ void conv_products(float (&acc)[C::NP][8],
                                              const float* st) {
  constexpr int KC = C::KC, PA = C::PA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % (C::TR / 2);
  const float* abase = st + (2 * wm * HC + 2 * (lane & 3)) * PA;
  const float* wbase = st + C::AS + 64 * (warp / (C::TR / 2)) + 4 * (lane >> 2);
#pragma unroll 1
  for (int df = 0; df < 3; ++df) {
    const int sf = FLIP ? 2 - df : df;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const float* ap = abase + (sf * HC + (FLIP ? 2 - dt : dt)) * PA;
      const float* wp = wbase + (3 * df + dt) * KC * C::NOUT;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        float4 a[C::NP];
#pragma unroll
        for (int i = 0; i < C::NP; ++i)
          a[i] = lds4(ap + (prow(i) * HC + pcol(i)) * PA + kk);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 b0 = lds4(wp + (kk + k) * C::NOUT);
          const float4 b1 = lds4(wp + (kk + k) * C::NOUT + 32);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < C::NP; ++i) {
            const float av = comp(a[i], k);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }
  }
}

// the block's tile (grid: column tiles, row tiles, utterances): acc = the
// tile's sums of the thread's outputs, A (B, F, Tn, CIN)
template <typename C, bool FLIP>
__device__ __forceinline__ void conv_tile(float (&acc)[C::NP][8],
                                          const float* a, const float* w,
                                          int F, int Tn) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int t0 = blockIdx.x * TC, f0 = blockIdx.y * C::TR;
  const float* ab = a + (size_t)blockIdx.z * F * Tn * C::CIN;
#pragma unroll
  for (int i = 0; i < C::NP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  conv_stage<C>(sm, ab, w, F, Tn, f0, t0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < C::NCHUNK; ++c) {
    if (c + 1 < C::NCHUNK)
      conv_stage<C>(sm + ((c + 1) & 1) * C::STAGE, ab, w, F, Tn, f0, t0,
                    c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    conv_products<C, FLIP>(acc, sm + (c & 1) * C::STAGE);
    __syncthreads();
  }
}

// x2 = relu(acc + b3) at the tile's positions inside the image
__device__ __forceinline__ void store_x2(const float (&acc)[Conv3::NP][8],
                                         const float* __restrict__ b3,
                                         float* __restrict__ x2, int F,
                                         int Tn) {
  const Place q = conv_place<Conv3>();
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = __ldg(b3 + q.n0 + pch(j));
#pragma unroll
  for (int i = 0; i < Conv3::NP; ++i) {
    const int f = q.r0 + prow(i), t = q.c0 + pcol(i);
    if (f >= F || t >= Tn) continue;
    float* p = x2 + (((size_t)blockIdx.z * F + f) * Tn + t) * C2 + q.n0;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[i][j] + bias[j], 0.f);
    stg4(p, v[0], v[1], v[2], v[3]);
    stg4(p + 32, v[4], v[5], v[6], v[7]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(Conv3::NTH, 1)
vgg_block2_fwd_x2_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w3,
                             const float* __restrict__ b3,
                             float* __restrict__ x2, int F, int Tn) {
  float acc[Conv3::NP][8];
  conv_tile<Conv3, false>(acc, x, w3, F, Tn);
  store_x2(acc, b3, x2, F, Tn);
}

// conv4 over x2, then the thread's CSLOT / 2 pool windows (columns 2g,
// 2g+1; 2g+8, 2g+9; ... of its row pair): first maximum wins, + b4, relu
__global__ void __launch_bounds__(Conv4::NTH, 1)
vgg_block2_fwd_conv4_f32_kernel(const float* __restrict__ x2,
                                const float* __restrict__ w4,
                                const float* __restrict__ b4,
                                float* __restrict__ out,
                                uint8_t* __restrict__ idx, int F, int Tn) {
  float acc[Conv4::NP][8];
  conv_tile<Conv4, false>(acc, x2, w4, F, Tn);
  const Place q = conv_place<Conv4>();
  const int Fp = F / 2, Tp = Tn / 2, pr = q.r0 / 2;
  if (pr >= Fp) return;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = __ldg(b4 + q.n0 + pch(j));
#pragma unroll
  for (int wdw = 0; wdw < CSLOT / 2; ++wdw) {
    const int pc = q.c0 / 2 + 4 * wdw;
    if (pc >= Tp) continue;
    // window order (0,0), (0,1), (1,0), (1,1): positions e, e+1,
    // e+CSLOT, e+CSLOT+1 of the thread, e = 2 w
    const int e = 2 * wdw;
    float v[8];
    uint32_t ids[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float best = acc[e][j];
      uint32_t id = 0;
      if (acc[e + 1][j] > best) { best = acc[e + 1][j]; id = 1; }
      if (acc[e + CSLOT][j] > best) { best = acc[e + CSLOT][j]; id = 2; }
      if (acc[e + CSLOT + 1][j] > best) {
        best = acc[e + CSLOT + 1][j];
        id = 3;
      }
      v[j] = fmaxf(best + bias[j], 0.f);
      ids[j >> 2] |= id << (8 * (j & 3));
    }
    const size_t off =
        (((size_t)blockIdx.z * Fp + pr) * Tp + pc) * C2 + q.n0;
    stg4(out + off, v[0], v[1], v[2], v[3]);
    stg4(out + off + 32, v[4], v[5], v[6], v[7]);
    if (idx != nullptr) {
      *reinterpret_cast<uint32_t*>(idx + off) = ids[0];
      *reinterpret_cast<uint32_t*>(idx + off + 32) = ids[1];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(Conv3::NTH, 1)
vgg_block2_bwd_x2_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w3,
                             const float* __restrict__ b3,
                             float* __restrict__ x2, int F, int Tn) {
  float acc[Conv3::NP][8];
  conv_tile<Conv3, false>(acc, x, w3, F, Tn);
  store_x2(acc, b3, x2, F, Tn);
}

// dy4 = g * [out > 0] at the window element idx names, 0 at the other
// three: a thread a pooled position and 4 channels (n of them)
__global__ void __launch_bounds__(NT)
vgg_block2_bwd_dy4_f32_kernel(const float* __restrict__ g,
                              const float* __restrict__ out,
                              const uint8_t* __restrict__ idx,
                              float* __restrict__ dy4, int F, int Tn,
                              long n) {
  const long e = (long)blockIdx.x * NT + threadIdx.x;
  if (e >= n) return;
  const int Fp = F / 2, Tp = Tn / 2, v = (int)(e % (C2 / 4));
  const long pp = e / (C2 / 4);
  const int pc = (int)(pp % Tp), pr = (int)(pp / Tp % Fp);
  const long b = pp / Tp / Fp;
  const float4 gv = reinterpret_cast<const float4*>(g)[e];
  const float4 ov = reinterpret_cast<const float4*>(out)[e];
  const uint32_t iv = reinterpret_cast<const uint32_t*>(idx)[e];
  const float gm[4] = {ov.x > 0.f ? gv.x : 0.f, ov.y > 0.f ? gv.y : 0.f,
                       ov.z > 0.f ? gv.z : 0.f, ov.w > 0.f ? gv.w : 0.f};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = ((iv >> (8 * k)) & 255u) == (uint32_t)w ? gm[k] : 0.f;
    const int f = 2 * pr + (w >> 1), t = 2 * pc + (w & 1);
    stg4(dy4 + ((b * F + f) * Tn + t) * C2 + 4 * v, d[0], d[1], d[2], d[3]);
  }
}

// dx2 = W4^T . dy4 (the transposed convolution), masked by x2 > 0: dy3
__global__ void __launch_bounds__(Conv4::NTH, 1)
vgg_block2_bwd_dy3_f32_kernel(const float* __restrict__ dy4,
                              const float* __restrict__ w4t,
                              const float* __restrict__ x2,
                              float* __restrict__ dy3, int F, int Tn) {
  float acc[Conv4::NP][8];
  conv_tile<Conv4, true>(acc, dy4, w4t, F, Tn);
  const Place q = conv_place<Conv4>();
#pragma unroll
  for (int i = 0; i < Conv4::NP; ++i) {
    const int f = q.r0 + prow(i), t = q.c0 + pcol(i);
    if (f >= F || t >= Tn) continue;
    const size_t off = (((size_t)blockIdx.z * F + f) * Tn + t) * C2 + q.n0;
    const float4 m0 = *reinterpret_cast<const float4*>(x2 + off);
    const float4 m1 = *reinterpret_cast<const float4*>(x2 + off + 32);
    stg4(dy3 + off, m0.x > 0.f ? acc[i][0] : 0.f, m0.y > 0.f ? acc[i][1] : 0.f,
         m0.z > 0.f ? acc[i][2] : 0.f, m0.w > 0.f ? acc[i][3] : 0.f);
    stg4(dy3 + off + 32, m1.x > 0.f ? acc[i][4] : 0.f,
         m1.y > 0.f ? acc[i][5] : 0.f, m1.z > 0.f ? acc[i][6] : 0.f,
         m1.w > 0.f ? acc[i][7] : 0.f);
  }
}

// dx = W3^T . dy3 (transposed): tiles of 16 rows x 16 columns x 64 channels
__global__ void __launch_bounds__(ConvDx::NTH, 1)
vgg_block2_bwd_dx_f32_kernel(const float* __restrict__ dy3,
                             const float* __restrict__ w3t,
                             float* __restrict__ dx, int F, int Tn) {
  float acc[ConvDx::NP][8];
  conv_tile<ConvDx, true>(acc, dy3, w3t, F, Tn);
  const Place q = conv_place<ConvDx>();
#pragma unroll
  for (int i = 0; i < ConvDx::NP; ++i) {
    const int f = q.r0 + prow(i), t = q.c0 + pcol(i);
    if (f >= F || t >= Tn) continue;
    float* p = dx + (((size_t)blockIdx.z * F + f) * Tn + t) * CI + q.n0;
    stg4(p, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    stg4(p + 32, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---------------------------------------------------------------------------
// wgrad_tile: block (u, range), 128 threads, two blocks an SM. Tile u < 9:
// dW4[u][a][n], A = x2 at the tap's shift (128 channels); tile u >= 9: dW3
// of taps 2(u-9) (a < 64) and 2(u-9)+1 (a >= 64; none for u = 13), A = x
// at each tap's shift. B = dy4 (dW4) or dy3 (dW3) at the segment's
// positions. Warp w owns a = 64 (w % 2) .. +63 and n = 64 (w / 2) .. +63;
// lane (h = lane % 8, m = lane / 8) owns a = 4h .. 4h+3, 4h+32 .. 4h+35
// and n = 4m + (0 .. 3, 16 .. 19, 32 .. 35, 48 .. 51): 8 x 16 sums, 24
// bytes of fragments a product against the conv tiles' 32.
// ---------------------------------------------------------------------------

constexpr int WG_NT = 128;
constexpr int WG_NST = 3;              // stages in flight
constexpr int WG_STAGE = 2 * KP * C2;  // floats: A then B, 128 a position
constexpr size_t WG_SMEM = WG_NST * sizeof(float) * WG_STAGE;

// segments e0, e0+1 (< hi) into stage st; segment e = (b, f, column tile),
// the column tile fastest; zero past the image, the range and T. Thread
// (row w, quad v) copies channels 4v .. 4v+3 of positions w + 4 h
__device__ __forceinline__ void wg_stage(float* st, int u,
                                         const float* __restrict__ x,
                                         const float* __restrict__ x2,
                                         const float* __restrict__ dyb,
                                         int F, int Tn, int tch, int e0,
                                         int hi) {
  constexpr int ROWS = WG_NT / 32;
  const int v = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tap = u < 9 ? u : 2 * (u - 9) + (v >> 4);
  const int df = tap / 3 - 1, dt = tap % 3 - 1;
  const float* asrc = u < 9 ? x2 + 4 * v : x + 4 * (v & 15);
  const int acin = u < 9 ? C2 : CI;
#pragma unroll
  for (int sg = 0; sg < 2; ++sg) {
    const int e = e0 + sg;
    const int tc = e % tch, f = e / tch % F, b = e / tch / F;
#pragma unroll
    for (int h = 0; h < SEG / ROWS; ++h) {
      const int j = w + ROWS * h, p = SEG * sg + j, t = tc * SEG + j;
      const bool ok = e < hi && t < Tn;
      cp_async16(st + KP * C2 + p * C2 + 4 * v,
                 ok ? dyb + (((size_t)b * F + f) * Tn + t) * C2 + 4 * v : dyb,
                 ok);
      const int fs = f + df, ts = t + dt;
      const bool oka = ok && tap < 9 && fs >= 0 && fs < F && ts >= 0 &&
                       ts < Tn;
      cp_async16(st + p * C2 + 4 * v,
                 oka ? asrc + (((size_t)b * F + fs) * Tn + ts) * acin : dyb,
                 oka);
    }
  }
}

// acc += the stage's products. One copy of the loop, unrolled by 8: the
// kernel's code then stays within the instruction cache (two fully
// unrolled copies, one summing the bias beside the products, ran far
// slower on the H100; tools/probe_vgg2_bwd.py --variants times depths 1,
// 2 and 4)
__device__ __forceinline__ void wg_products(float (&acc)[8][16],
                                            const float* st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ap = st + 64 * (warp & 1) + 4 * (lane & 7);
  const float* bp = st + KP * C2 + 64 * (warp >> 1) + 4 * (lane >> 3);
#pragma unroll 8
  for (int p = 0; p < KP; ++p) {
    const float4 a0 = lds4(ap + p * C2), a1 = lds4(ap + p * C2 + 32);
    float bv[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = lds4(bp + p * C2 + 16 * q);
      bv[4 * q] = b.x; bv[4 * q + 1] = b.y;
      bv[4 * q + 2] = b.z; bv[4 * q + 3] = b.w;
    }
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// bsum[j] += the stage's B column of the thread's n j (the bias tiles)
__device__ __forceinline__ void wg_bias(float (&bsum)[16], const float* st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bp = st + KP * C2 + 64 * (warp >> 1) + 4 * (lane >> 3);
#pragma unroll 4
  for (int p = 0; p < KP; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 b = lds4(bp + p * C2 + 16 * q);
      bsum[4 * q] += b.x; bsum[4 * q + 1] += b.y;
      bsum[4 * q + 2] += b.z; bsum[4 * q + 3] += b.w;
    }
}

// grid (WG_TILES, SPLITS); part[range] gets the range's sums of every
// weight and bias gradient (each element from one tile)
__global__ void __launch_bounds__(WG_NT, 2)
vgg_block2_bwd_wgrad_f32_kernel(const float* __restrict__ x,
                                const float* __restrict__ x2,
                                const float* __restrict__ dy4,
                                const float* __restrict__ dy3,
                                float* __restrict__ part, int B, int F,
                                int Tn) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int u = blockIdx.x, sp = blockIdx.y;
  const int tch = (Tn + SEG - 1) / SEG;
  const long nseg = (long)B * F * tch;
  const int lo = (int)(nseg * sp / SPLITS), hi = (int)(nseg * (sp + 1) / SPLITS);
  const int nst = (hi - lo + 1) / 2;
  const bool bias = u == 4 || u == 11;  // the tiles of tap 4
  const float* dyb = u < 9 ? dy4 : dy3;
  float acc[8][16], bsum[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = 0.f;
  }
  for (int s = 0; s < WG_NST - 1; ++s) {
    if (s < nst)
      wg_stage(sm + s * WG_STAGE, u, x, x2, dyb, F, Tn, tch, lo + 2 * s, hi);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int s2 = s + WG_NST - 1;  // the stage issued now
    if (s2 < nst)
      wg_stage(sm + (s2 % WG_NST) * WG_STAGE, u, x, x2, dyb, F, Tn, tch,
               lo + 2 * s2, hi);
    cp_async_commit();
    cp_async_wait<WG_NST - 1>();
    __syncthreads();
    wg_products(acc, sm + (s % WG_NST) * WG_STAGE);
    if (bias) wg_bias(bsum, sm + (s % WG_NST) * WG_STAGE);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wa = warp & 1, a0 = 4 * (lane & 7);
  const int n0 = 64 * (warp >> 1) + 4 * (lane >> 3);
  float* pb = part + (size_t)sp * PART2;
  const int tap = u < 9 ? u : 2 * (u - 9) + wa;
  if (tap < 9) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = a0 + (i & 3) + 32 * (i >> 2);  // within the warp's 64
      float* p = u < 9 ? pb + DW3_SIZE + C2 + ((size_t)u * C2 + 64 * wa + a) * C2
                       : pb + ((size_t)tap * CI + a) * C2;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        stg4(p + n0 + 16 * q, acc[i][4 * q], acc[i][4 * q + 1],
             acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  }
  if (bias && wa == 0 && (lane & 7) == 0) {
    float* p = pb + (u == 4 ? DW3_SIZE + C2 + DW4_SIZE : DW3_SIZE) + n0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      stg4(p + 16 * q, bsum[4 * q], bsum[4 * q + 1], bsum[4 * q + 2],
           bsum[4 * q + 3]);
  }
}

// grads[e] = sum over the ranges, in range order, of part[range][e]
__global__ void __launch_bounds__(NT)
vgg_block2_bwd_reduce_f32_kernel(const float* __restrict__ part,
                                 float* __restrict__ grads) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PART2) return;
  float s = 0.f;
  for (int k = 0; k < SPLITS; ++k) s += part[(size_t)k * PART2 + e];
  grads[e] = s;
}

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward. x (B, F, T, 64); w3n, w4n layout "n"; b3, b4 (128); out (B, F/2,
// T/2, 128); idx uint8 of out's shape or null; x2 (B, F, T, 128) scratch.
extern "C" int vgg_block2_fwd_f32(const void* x, const void* w3n,
                                  const void* b3, const void* w4n,
                                  const void* b4, void* out, void* idx,
                                  void* x2, int B, int F, int T,
                                  void* stream) {
  cudaGetLastError();  // report only this call's error
  if (B == 0 || F == 0 || T == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = smem_attr(vgg_block2_fwd_x2_f32_kernel, Conv3::SMEM);
  if (e != cudaSuccess) return e;
  e = smem_attr(vgg_block2_fwd_conv4_f32_kernel, Conv4::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + TC - 1) / TC, (F + Conv4::TR - 1) / Conv4::TR, B);
  vgg_block2_fwd_x2_f32_kernel<<<grid, Conv3::NTH, Conv3::SMEM, s>>>(
      (const float*)x, (const float*)w3n, (const float*)b3, (float*)x2, F, T);
  vgg_block2_fwd_conv4_f32_kernel<<<grid, Conv4::NTH, Conv4::SMEM, s>>>(
      (const float*)x2, (const float*)w4n, (const float*)b4, (float*)out,
      (uint8_t*)idx, F, T);
  return cudaGetLastError();
}

// Backward. g, out, idx as the forward's output; scratch 3 x (B, F, T, 128)
// f32 (x2, dy4, dy3); dx (B, F, T, 64); part SPLITS x PART2 f32 scratch;
// grads PART2 f32 = dW3 (3,3,64,128) | db3 (128) | dW4 (3,3,128,128) | db4
// (128). w3n = w3 "n", w4t = w4 "t", w3t = w3 "t".
extern "C" int vgg_block2_bwd_f32(const void* x, const void* w3n,
                                  const void* b3, const void* w4t,
                                  const void* w3t, const void* g,
                                  const void* out, const void* idx,
                                  void* scratch, void* dx, void* part,
                                  void* grads, int B, int F, int T,
                                  void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F == 0 || T == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART2, s);
  cudaError_t e = smem_attr(vgg_block2_bwd_x2_f32_kernel, Conv3::SMEM);
  if (e != cudaSuccess) return e;
  e = smem_attr(vgg_block2_bwd_dy3_f32_kernel, Conv4::SMEM);
  if (e != cudaSuccess) return e;
  e = smem_attr(vgg_block2_bwd_dx_f32_kernel, ConvDx::SMEM);
  if (e != cudaSuccess) return e;
  e = smem_attr(vgg_block2_bwd_wgrad_f32_kernel, WG_SMEM);
  if (e != cudaSuccess) return e;
  const size_t act = (size_t)B * F * T * C2;
  float* x2 = (float*)scratch;
  float* dy4 = x2 + act;
  float* dy3 = dy4 + act;
  const dim3 grid((T + TC - 1) / TC, (F + Conv4::TR - 1) / Conv4::TR, B);
  vgg_block2_bwd_x2_f32_kernel<<<grid, Conv3::NTH, Conv3::SMEM, s>>>(
      (const float*)x, (const float*)w3n, (const float*)b3, x2, F, T);
  const long n4 = (long)B * (F / 2) * (T / 2) * (C2 / 4);
  vgg_block2_bwd_dy4_f32_kernel<<<(unsigned)((n4 + NT - 1) / NT), NT, 0,
                                  s>>>((const float*)g, (const float*)out,
                                       (const uint8_t*)idx, dy4, F, T, n4);
  vgg_block2_bwd_dy3_f32_kernel<<<grid, Conv4::NTH, Conv4::SMEM, s>>>(
      dy4, (const float*)w4t, x2, dy3, F, T);
  vgg_block2_bwd_wgrad_f32_kernel<<<dim3(WG_TILES, SPLITS), WG_NT, WG_SMEM,
                                    s>>>((const float*)x, x2, dy4, dy3,
                                         (float*)part, B, F, T);
  vgg_block2_bwd_reduce_f32_kernel<<<(PART2 + NT - 1) / NT, NT, 0, s>>>(
      (const float*)part, (float*)grads);
  const dim3 grid_dx((T + TC - 1) / TC, (F + ConvDx::TR - 1) / ConvDx::TR,
                     B);
  vgg_block2_bwd_dx_f32_kernel<<<grid_dx, ConvDx::NTH, ConvDx::SMEM, s>>>(
      dy3, (const float*)w3t, (float*)dx, F, T);
  return cudaGetLastError();
}
