// vgg_block1_f32: the f32 entries of the fused vgg block 1 and of its
// backward (csrc/vgg_block1.cu holds the bf16 entries):
//
//   out = relu(maxpool2x2(conv2_SAME(relu(conv1_SAME(x) + b1))) + b2)
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_fwd_kernel and ::_bwd_kernel
// (reached from _fwd_pallas / _bwd_pallas) at compute type f32. Layouts as in
// csrc/vgg_block1.cu: x (B, F, T) f32; w1 (3,3,1,64) HWIO, b1, b2 (64,), w2
// (3,3,64,64) HWIO, all f32; out (B, F/2, T/2, 64) NHWC f32; idx uint8 of
// out's shape, the pool's argmax in window order (0,0),(0,1),(1,0),(1,1)
// over (f, t); g = dL/d(out).
//
// Numerics (vgg_fused.py's f32 path): every product is one f32 FFMA on f32
// values (no TF32). x1 = relu(conv1_SAME(x) + b1): the 9 taps summed from 0
// in (df, dt) order, then + b1, then relu; x1 is ZERO outside the image
// (conv2's SAME border pads the activations: relu(b1) never enters it).
// Then conv2, the 2x2 VALID pool (an odd last row or column is dropped)
// with strict '>' (the first maximum in (f, t) order wins), + b2, relu.
// Backward: dy2 = g * [out > 0] routed by idx (rows and columns the pool
// drops get none); dx1 = W2^T . dy2 masked by the recomputed x1 > 0 (row
// F-1 of an odd F gets a gradient through conv2's taps though dy2 has none
// there); dW2 = sum x1 (x) dy2, db2 = sum dy2; dW1 = sum x (x) dx1 over the
// 9 taps, db1 = sum dx1; no input gradient. Only the order of the f32 sums
// differs from a library convolution.
//
// Design: the products run in two register-blocked FFMA tiles, those of
// csrc/vgg_block2_f32.cu cut to 64 channels; a thread reads its A and B
// fragments from shared memory as float4s that the lanes of a warp share.
//   * conv tiles (the forward's conv2, the backward's dx1): 8 conv rows x
//     32 columns x 64 channels, 256 threads, a thread 8 positions x 8
//     channels (16 FFMA a load). Warp w owns rows 2 (w % 4), +1 and columns
//     16 (w / 4) .. +15; lane (g = lane % 4, c = lane / 4) the columns 2g,
//     2g+1, 2g+8, 2g+9 of both rows, so its two pool windows lie in its
//     registers and the four positions a load instruction reads lie in
//     distinct banks, and the channels 4c .. 4c+3, 4c+32 .. 4c+35. K runs
//     over chunks of 16 input channels x 9 taps; a tap is an address offset
//     into a halo tile (the transposed convolution reads it at -s(tap)).
//     The weights' chunks (36.9 KB) stream through two stages by cp.async.
//   * forward (one kernel, a tile a block): the block builds x1 for its
//     10 x 34 halo positions once into shared memory, channels contiguous,
//     from a staged input tile (1.33 x conv1's work, ~2% of the forward);
//     the pool, argmax, b2 and relu run in the epilogue from registers.
//   * backward, three kernels, with nothing but the partial sums and W2
//     transposed in device memory: dy2 is formed where a tile is staged,
//     from g, out and idx at the pooled positions under it (g where out >
//     0 at the window element idx names, zero at the other three and where
//     the pool drops a row or column), and x1 is recomputed from the
//     staged input where it is needed. Each kernel builds the next step's
//     dy2 (and x1) between two parts of this step's products, into a
//     second buffer, with one barrier a step. wgrad (dW2 and db2; first
//     its blocks transpose W2 for dx1, a slice each): SPLITS blocks of 8
//     warps, a warp 32 ci x 16 co of all 9 taps, 9 x 4 x 4 sums a thread,
//     over a fixed range of K segments of 2 conv rows x 16 columns, each
//     segment's x1 (4 x 18 positions) built once from 6 x 20 inputs, a
//     thread a row and a channel, and its dy2 (2 x 16) from 8 pooled
//     positions. dx1 (SPLITS persistent blocks, each walking a fixed range
//     of conv tiles over all F rows, 16 channels of g, out and idx staged
//     two steps ahead under the tile's halo; the epilogue recomputes x1 at
//     the tile's positions from its staged input, masks dx1 and adds the
//     tile's dW1 and db1 to the range's sums). reduce (the ranges' sums
//     added in range order: two runs give the same bits).
//
// Bound at x (12, 161, 800) (chip_smoke.py: vgg1_work): forward conv2 at
// the 2 Fp x 2 Tp positions the pool keeps, 2 B 2Fp 2Tp 64 576 = 113.2
// GFLOP, and conv1 at the B F T of the image, 1.8: 115.0 GFLOP, 1.72 ms at
// the H100's 67 TFLOP/s of f32 FMA; backward dW2 at the pool's positions
// (113.2), dx1 at the image's (114.0), conv1 and dW1 1.8 each: 230.8
// GFLOP, 3.44 ms. Executed: forward 113.2 + 1.8 x 1.33 (8-row and
// 32-column tiles divide the 160 rows the pool keeps and T = 800; conv1 at
// each tile's halo); backward dx1 over 21 tiles of 8 rows for F = 161
// (118.9) with conv1 and dW1 at its positions (1.9 each), wgrad 113.2 with
// conv1 at its segments' 4 x 18 positions (4.0). What bounds the tiles
// (PERF.md): feeding the FFMA pipe from shared memory, as for block 2's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;       // channels of x1, conv2's input and output
constexpr int CSLOT = 4;    // column slots a conv thread owns in each row
constexpr int WM = 4;       // warps down a conv tile (row pairs)
constexpr int WC = 2;       // warps across a conv tile (16 columns each)
constexpr int TR = 2 * WM;  // conv rows a tile
constexpr int TC = 4 * CSLOT * WC;  // conv columns a tile
constexpr int HR = TR + 2;  // with the halo
constexpr int HC = TC + 2;
constexpr int NTH = 32 * WM * WC;   // threads a conv tile
constexpr int NP = 2 * CSLOT;       // positions a thread
constexpr int KC = 16;      // input channels a K chunk
constexpr int NCHUNK = C / KC;
constexpr int WS = 9 * KC * C;      // floats: a chunk's weights
constexpr int XP = C + 4;   // floats a position of the forward's x1 tile
constexpr int PA = KC + 4;  // floats a position of dx1's staged dy2 chunk
constexpr int AS = HR * HC * PA;    // floats: dx1's staged dy2 chunk
constexpr int XR = TR + 4;  // rows of the forward's staged input
constexpr int XCOL = TC + 4;        // its columns
// fixed K ranges of the backward's sums (the reduction order is fixed):
// one persistent block of dx1 and one of wgrad each, a wave on 132 SMs
constexpr int SPLITS = 132;
constexpr int DW1_SIZE = 9 * C;
constexpr int DW2_SIZE = 9 * C * C;
constexpr int RED = DW1_SIZE + C;   // dx1's sums a range: dW1, db1
constexpr int PART = RED + DW2_SIZE + C;  // floats a range
constexpr int NT = 256;     // threads of the element-wise kernels
static_assert(NTH == 256, "8 warps");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
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
// the conv tile: a thread's position i at tile row r + prow(i), column c +
// pcol(i); its channel j at n + pch(j)
// ---------------------------------------------------------------------------

struct Place {
  int r, c, n;
};
__device__ __forceinline__ int prow(int i) { return i / CSLOT; }
__device__ __forceinline__ int pcol(int i) {
  return (i % CSLOT & 1) + 8 * (i % CSLOT >> 1);
}
__device__ __forceinline__ int pch(int j) { return (j & 3) + 32 * (j >> 2); }

__device__ __forceinline__ Place place() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return Place{2 * (warp % WM), 16 * (warp / WM) + 2 * (lane & 3),
               4 * (lane >> 2)};
}

// chunk c of w (tap, 64 k, 64 n): its 9 x KC rows into ws
__device__ __forceinline__ void stage_w(float* ws, const float* w, int c) {
  for (int e = threadIdx.x; e < 9 * KC * (C / 4); e += NTH) {
    const int v = e % (C / 4), row = e / (C / 4), tap = row / KC;
    cp_async16(ws + row * C + 4 * v,
               w + ((size_t)tap * C + KC * c + row % KC) * C + 4 * v, true);
  }
}

// acc[i][j] += the chunk's 3 x KC products of filter row df: a the halo
// tile's position (0, 0) at the chunk's first channel, P floats a position;
// w the chunk's weights (tap, KC, 64). FLIP: the transposed convolution,
// which reads a at -s(tap). A kernel calls it in one loop over df (one
// copy of the unrolled code)
template <int P, bool FLIP>
__device__ __forceinline__ void products_df(float (&acc)[NP][8],
                                            const float* a, const float* w,
                                            int df) {
  const Place q = place();
  const int sf = FLIP ? 2 - df : df;
  const float* abase = a + (q.r * HC + q.c) * P;
  const float* wbase = w + q.n;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt) {
    const float* ap = abase + (sf * HC + (FLIP ? 2 - dt : dt)) * P;
    const float* wp = wbase + (3 * df + dt) * KC * C;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 av[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i)
        av[i] = lds4(ap + (prow(i) * HC + pcol(i)) * P + kk);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 b0 = lds4(wp + (kk + k) * C);
        const float4 b1 = lds4(wp + (kk + k) * C + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const float x = comp(av[i], k);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[NP][8]) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr size_t FWD_SMEM =
    sizeof(float) * (2 * WS + HR * HC * XP + XR * XCOL + 9 * C + C);

// x1 at the tile's halo positions (rows f0-1 .. f0+TR, columns t0-1 ..
// t0+TC), zero outside the image, into x1s ([position][XP]); a task is 8
// channels of one position, from xs (rows f0-2 .., columns t0-2 ..)
__device__ __forceinline__ void build_x1(float* x1s, const float* xs,
                                         const float* w1s, const float* b1s,
                                         int f0, int t0, int F, int T) {
  for (int e = threadIdx.x; e < HR * HC * 8; e += NTH) {
    const int cg = e & 7, pos = e >> 3;
    const int r = pos / HC, j = pos % HC;
    const int f = f0 - 1 + r, t = t0 - 1 + j;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (f >= 0 && f < F && t >= 0 && t < T) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv = xs[(r + tap / 3) * XCOL + j + tap % 3];
        const float4 wa = lds4(w1s + tap * C + 8 * cg);
        const float4 wb = lds4(w1s + tap * C + 8 * cg + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaf(xv, wv[k], v[k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k] + b1s[8 * cg + k], 0.f);
    }
    float* p = x1s + pos * XP + 8 * cg;
    stg4(p, v[0], v[1], v[2], v[3]);
    stg4(p + 4, v[4], v[5], v[6], v[7]);
  }
}

// grid (column tiles over 2 Tp, row tiles over 2 Fp, utterances)
__global__ void __launch_bounds__(NTH, 1)
vgg_block1_fwd_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          float* __restrict__ out,
                          uint8_t* __restrict__ idx, int F, int T) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // 2 x WS
  float* x1s = ws + 2 * WS;                     // HR x HC x XP
  float* xs = x1s + HR * HC * XP;               // XR x XCOL
  float* w1s = xs + XR * XCOL;                  // 9 x C
  float* b1s = w1s + 9 * C;                     // C
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TC, f0 = blockIdx.y * TR, b = blockIdx.z;
  stage_w(ws, w2, 0);
  cp_async_commit();
  const float* xb = x + (size_t)b * F * T;
  for (int e = tid; e < XR * XCOL; e += NTH) {
    const int f = f0 - 2 + e / XCOL, t = t0 - 2 + e % XCOL;
    xs[e] = (f >= 0 && f < F && t >= 0 && t < T)
                ? __ldg(xb + (size_t)f * T + t) : 0.f;
  }
  for (int e = tid; e < 9 * C; e += NTH) w1s[e] = __ldg(w1 + e);
  if (tid < C) b1s[tid] = __ldg(b1 + tid);
  __syncthreads();
  build_x1(x1s, xs, w1s, b1s, f0, t0, F, T);

  float acc[NP][8];
  zero(acc);
#pragma unroll 1
  for (int c = 0; c < NCHUNK; ++c) {
    if (c + 1 < NCHUNK) stage_w(ws + ((c + 1) & 1) * WS, w2, c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // x1 built; chunk c landed
#pragma unroll 1
    for (int df = 0; df < 3; ++df)
      products_df<XP, false>(acc, x1s + KC * c, ws + (c & 1) * WS, df);
    __syncthreads();  // chunk c read
  }

  // the thread's CSLOT / 2 pool windows (columns 2g, 2g+1; 2g+8, 2g+9 of
  // its row pair): first maximum wins, + b2, relu
  const Place q = place();
  const int Fp = F / 2, Tp = T / 2, pr = (f0 + q.r) / 2;
  if (pr >= Fp) return;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = __ldg(b2 + q.n + pch(j));
#pragma unroll
  for (int wdw = 0; wdw < CSLOT / 2; ++wdw) {
    const int pc = (t0 + q.c) / 2 + 4 * wdw;
    if (pc >= Tp) continue;
    // window order (0,0), (0,1), (1,0), (1,1): positions e, e+1, e+CSLOT,
    // e+CSLOT+1 of the thread, e = 2 wdw
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
    const size_t off = (((size_t)b * Fp + pr) * Tp + pc) * C + q.n;
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

// dy2 at a conv position, 4 channels: g where out > 0 and idx names the
// position's place w in its window (2 (f & 1) + (t & 1)), else 0. g, o, id
// are the window's staged pooled values, zero where the pool drops the
// position (so dy2 is zero there)
__device__ __forceinline__ float4 route(const float4& g, const float4& o,
                                        uint32_t id, uint32_t w) {
  return make_float4(
      (id & 255u) == w && o.x > 0.f ? g.x : 0.f,
      (id >> 8 & 255u) == w && o.y > 0.f ? g.y : 0.f,
      (id >> 16 & 255u) == w && o.z > 0.f ? g.z : 0.f,
      (id >> 24) == w && o.w > 0.f ? g.w : 0.f);
}

// part k of a pooled position's channels (element q of g, out and idx on)
// into its stage: parts [0, n) are 4 channels of g each, [n, 2n) of out,
// the parts after them 16 channels of idx each; zero-filled unless ok
__device__ __forceinline__ void stage_pooled(float* gs, float* os,
                                             float* is, const float* g,
                                             const float* out,
                                             const uint8_t* idx, size_t q,
                                             int k, int n, bool ok) {
  if (k < n)
    cp_async16(gs + 4 * k, g + q + 4 * k, ok);
  else if (k < 2 * n)
    cp_async16(os + 4 * (k - n), out + q + 4 * (k - n), ok);
  else
    cp_async16(is + 4 * (k - 2 * n), idx + q + 16 * (k - 2 * n), ok);
}

// ---- dx1 (+ dW1, db1) -----------------------------------------------------

// the pooled positions under a conv tile's halo: rows f0/2 - 1 .. f0/2 +
// TR/2, columns t0/2 - 1 .. t0/2 + TC/2 (f0, t0 even)
constexpr int PR_R = TR / 2 + 2;
constexpr int PR_C = TC / 2 + 2;
constexpr int RAW = PR_R * PR_C;
constexpr int RAWS = RAW * (2 * KC + KC / 4);  // floats: g, out, idx
// pooled values three steps deep (staged two steps ahead), weights and dy2
// tiles two
constexpr size_t DX1_SMEM =
    sizeof(float) *
    (3 * RAWS + 2 * WS + 2 * AS + 2 * HR * HC + 9 * C + C + 8 * RED + RED);

// dx1's conv tiles: (utterance, row tile over F, column tile over T), the
// column tile fastest
struct Tile {
  int b, f0, t0;
};
__device__ __forceinline__ Tile tile_of(int it, int nf, int nt) {
  return Tile{it / nt / nf, it / nt % nf * TR, it % nt * TC};
}

// step (tile w, chunk c): chunk c (co KC c .. +KC-1) of g, out and idx at
// the pooled positions under the tile's halo (zero outside the pool's Fp x
// Tp) into st; with chunk 0 also x at the halo's positions (zero outside
// the image) into xst. The step's weights are staged apart (stage_w)
__device__ __forceinline__ void dx1_stage(float* st, float* xst,
                                          const float* x, const float* g,
                                          const float* out,
                                          const uint8_t* idx, const Tile& w,
                                          int c, int F, int T) {
  const int Fp = F / 2, Tp = T / 2;
  const int pr0 = w.f0 / 2 - 1, pc0 = w.t0 / 2 - 1;
  constexpr int NPART = 2 * (KC / 4) + 1;
  for (int e = threadIdx.x; e < RAW * NPART; e += NTH) {
    const int k = e % NPART, p = e / NPART;
    const int pr = pr0 + p / PR_C, pc = pc0 + p % PR_C;
    const bool ok = pr >= 0 && pr < Fp && pc >= 0 && pc < Tp;
    const size_t q =
        ok ? (((size_t)w.b * Fp + pr) * Tp + pc) * C + KC * c : 0;
    stage_pooled(st + p * KC, st + RAW * KC + p * KC,
                 st + 2 * RAW * KC + p * (KC / 4), g, out, idx, q, k, KC / 4,
                 ok);
  }
  if (c == 0) {
    const float* xb = x + (size_t)w.b * F * T;
    for (int e = threadIdx.x; e < HR * HC; e += NTH) {
      const int f = w.f0 - 1 + e / HC, t = w.t0 - 1 + e % HC;
      const bool ok = f >= 0 && f < F && t >= 0 && t < T;
      cp_async4(xst + e, ok ? xb + (size_t)f * T + t : x, ok);
    }
  }
}

// the step's dy2 chunk at the tile's halo positions (rows f0-1 .. f0+TR,
// columns t0-1 .. t0+TC) into ds ([position][PA]), from the staged pooled
// values: halo row r lies in local pooled row (r + 1) / 2 at window row
// (r + 1) % 2 (f0 even), and likewise for columns
__device__ __forceinline__ void dx1_build(float* ds, const float* st) {
  const float* gs = st;
  const float* os = st + RAW * KC;
  const uint32_t* is = reinterpret_cast<const uint32_t*>(st + 2 * RAW * KC);
  for (int e = threadIdx.x; e < HR * HC * (KC / 4); e += NTH) {
    const int v = e % (KC / 4), pos = e / (KC / 4);
    const int r = pos / HC + 1, j = pos % HC + 1;
    const int p = (r >> 1) * PR_C + (j >> 1);
    const float4 d =
        route(lds4(gs + p * KC + 4 * v), lds4(os + p * KC + 4 * v),
              is[p * (KC / 4) + v], 2u * (r & 1) + (j & 1));
    stg4(ds + pos * PA + 4 * v, d.x, d.y, d.z, d.w);
  }
}

// The tile's epilogue: x1 at the thread's positions inside the image,
// recomputed from the staged input as the forward computes it; dx1 = acc
// masked by x1 > 0 (zero outside the image); the tile's dW1 (x at the 9
// taps (x) dx1) and db1, summed over the thread's positions, then its lane
// quad (lanes of one c), then the warps in order, added to the range's
// sums (each element owned by one thread)
__device__ __forceinline__ void dx1_epilogue(const float (&acc)[NP][8],
                                             const float* xs,
                                             const float* w1s,
                                             const float* b1s, float* red,
                                             float* sums, const Tile& w,
                                             int F, int T) {
  const Place q = place();
  float dw[9][8], db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) dw[tap][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int r = q.r + prow(i), cc = q.c + pcol(i);
    const bool in = w.f0 + r < F && w.t0 + cc < T;
    float xv[9], h[8];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      xv[tap] = xs[(r + tap / 3) * HC + cc + tap % 3];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float4 wa = lds4(w1s + tap * C + q.n);
      const float4 wb = lds4(w1s + tap * C + q.n + 32);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = fmaf(xv[tap], wv[j], h[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = fmaxf(h[j] + b1s[q.n + pch(j)], 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = (in && h[j] > 0.f) ? acc[i][j] : 0.f;
      db[j] += d;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        dw[tap][j] = fmaf(xv[tap], d, dw[tap][j]);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // red[warp][c][v]: v = 8 tap + j (dW1), 72 + j (db1)
  float* rw = red + (warp * 8 + (lane >> 2)) * (RED / 8);
#pragma unroll
  for (int v = 0; v < RED / 8; ++v) {
    float s = v < 72 ? dw[v / 8][v % 8] : db[v - 72];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if ((lane & 3) == 0) rw[v] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < RED; e += NTH) {
    // element e: dW1 (tap, ch) for e < 9 C, then db1 (ch)
    const int ch = e % C, kind = e / C;  // kind: the tap, or 9 for db1
    const int c = (ch & 31) >> 2, j = (ch & 3) + 4 * (ch >> 5);
    const int v = 8 * kind + j;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NTH / 32; ++k) s += red[(k * 8 + c) * (RED / 8) + v];
    sums[e] += s;
  }
}

// grid SPLITS: block sp walks the tiles of its fixed range; part[sp] gets
// the range's dW1 and db1 (its first RED floats). w2t: W2 (tap, co, ci),
// written by wgrad, the kernel before
__global__ void __launch_bounds__(NTH, 1)
vgg_block1_bwd_dx1_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ w1,
                              const float* __restrict__ b1,
                              const float* __restrict__ w2t,
                              const float* __restrict__ g,
                              const float* __restrict__ out,
                              const uint8_t* __restrict__ idx,
                              float* __restrict__ part, int B, int F,
                              int T) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // 3 x RAWS
  float* wst = raw + 3 * RAWS;                   // 2 x WS
  float* ds = wst + 2 * WS;                      // 2 x AS: dy2 chunks
  float* xst = ds + 2 * AS;                      // 2 x HR x HC
  float* w1s = xst + 2 * HR * HC;                // 9 x C
  float* b1s = w1s + 9 * C;                      // C
  float* red = b1s + C;                          // 8 warps x 8 quads x RED/8
  float* sums = red + 8 * RED;                   // RED
  const int tid = threadIdx.x;
  const int nf = (F + TR - 1) / TR, nt = (T + TC - 1) / TC;
  const long ntiles = (long)B * nf * nt;
  const int sp = blockIdx.x;
  const int lo = (int)(ntiles * sp / SPLITS);
  const int hi = (int)(ntiles * (sp + 1) / SPLITS);
  const int nsteps = (hi - lo) * NCHUNK;
  for (int e = tid; e < 9 * C; e += NTH) w1s[e] = __ldg(w1 + e);
  if (tid < C) b1s[tid] = __ldg(b1 + tid);
  for (int e = tid; e < RED; e += NTH) sums[e] = 0.f;
  // step s's pooled values are staged at step s - 2 and its dy2 chunk built
  // during step s - 1's products; its weights are staged at step s - 1
  for (int s = 0; s < 2 && s < nsteps; ++s)
    dx1_stage(raw + s * RAWS, xst, x, g, out, idx,
              tile_of(lo + s / NCHUNK, nf, nt), s % NCHUNK, F, T);
  if (nsteps > 0) stage_w(wst, w2t, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (nsteps > 0) dx1_build(ds, raw);

  float acc[NP][8];
  zero(acc);
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s's weights and dy2 chunk, step s+1's pooled
                      // values are in; step s-1's buffers are read
    if (s + 1 < nsteps)
      stage_w(wst + ((s + 1) & 1) * WS, w2t, (s + 1) % NCHUNK);
    if (s + 2 < nsteps)
      dx1_stage(raw + ((s + 2) % 3) * RAWS,
                xst + (((s + 2) / NCHUNK) & 1) * HR * HC, x, g, out, idx,
                tile_of(lo + (s + 2) / NCHUNK, nf, nt), (s + 2) % NCHUNK, F,
                T);
    cp_async_commit();
    const float* a = ds + (s & 1) * AS;
    const float* w = wst + (s & 1) * WS;
#pragma unroll 1
    for (int df = 0; df < 3; ++df) {
      products_df<PA, true>(acc, a, w, df);
      // the next step's dy2 chunk, beside this one's products
      if (df == 0 && s + 1 < nsteps)
        dx1_build(ds + ((s + 1) & 1) * AS, raw + ((s + 1) % 3) * RAWS);
    }
    if (s % NCHUNK == NCHUNK - 1) {
      const int k = s / NCHUNK;
      dx1_epilogue(acc, xst + (k & 1) * HR * HC, w1s, b1s, red, sums,
                   tile_of(lo + k, nf, nt), F, T);
      zero(acc);
    }
  }
  // each element of sums is written by the thread that stores it
  for (int e = tid; e < RED; e += NTH) part[(size_t)sp * PART + e] = sums[e];
}

// ---- wgrad: dW2, db2 ------------------------------------------------------

constexpr int WG_NT = 256;  // 8 warps: co 16 (w % 4) .. +15, ci 32 (w / 4) ..
constexpr int SEG = 16;     // columns of a K segment of 2 conv rows
constexpr int AR = 4;       // x1 rows a segment builds
constexpr int AC = SEG + 2; // x1 columns a segment builds
constexpr int WXR = AR + 2; // x rows a segment stages
constexpr int WXC = AC + 2; // x columns
constexpr int WP = SEG / 2; // pooled positions a segment stages
constexpr int WG_RAW = WXR * WXC + WP * (2 * C + C / 4);  // floats: x, g,
                                                          // out, idx
constexpr int WG_DENSE = (AR * AC + 2 * SEG) * C;  // floats: x1, then dy2
constexpr int WG_NST = 3;   // stages: staged two segments ahead
constexpr size_t WG_SMEM =
    sizeof(float) * (WG_NST * WG_RAW + 2 * WG_DENSE + 9 * C + C);
static_assert(WG_NT == AR * C, "wg_build: a thread a row and channel");

// segment e = (b, pooled row pr, column tile tc), tc fastest, into st: x at
// rows 2pr-2 .. 2pr+3, columns SEG tc-2 .. SEG tc+SEG+1 (zero outside the
// image), then g, out and idx at pooled row pr, columns WP tc .. +WP-1
// (zero past Tp)
__device__ __forceinline__ void wg_stage(float* st, const float* x,
                                         const float* g, const float* out,
                                         const uint8_t* idx, int e, int Fp,
                                         int Tp, int tch, int F, int T) {
  const int tc = e % tch, pr = e / tch % Fp, b = e / tch / Fp;
  const float* xb = x + (size_t)b * F * T;
  constexpr int NPART = 2 * (C / 4) + C / 16;
  for (int k = threadIdx.x; k < WXR * WXC + WP * NPART; k += WG_NT) {
    if (k < WXR * WXC) {
      const int f = 2 * pr - 2 + k / WXC, t = SEG * tc - 2 + k % WXC;
      const bool ok = f >= 0 && f < F && t >= 0 && t < T;
      cp_async4(st + k, ok ? xb + (size_t)f * T + t : x, ok);
    } else {
      const int m = k - WXR * WXC, p = m / NPART, part = m % NPART;
      const int pc = WP * tc + p;
      const bool ok = pc < Tp;
      const size_t q = ok ? (((size_t)b * Fp + pr) * Tp + pc) * C : 0;
      float* gs = st + WXR * WXC;
      stage_pooled(gs + p * C, gs + WP * C + p * C,
                   gs + 2 * WP * C + p * (C / 4), g, out, idx, q, part,
                   C / 4, ok);
    }
  }
}

// the segment's x1 (AR x AC positions: rows 2pr-1 .., columns SEG tc-1 ..;
// zero outside the image) and dy2 (2 rows x SEG columns) into dense, from
// the stage. x1: thread (row r, channel c) walks its row with the 3 x 3
// inputs under a position in registers, 3 new ones a column; the taps
// summed from 0 in (df, dt) order, then + b1, relu, as the forward
__device__ __forceinline__ void wg_build(float* dense, const float* st,
                                         const float* w1s, const float* b1s,
                                         int pr, int tc, int F, int T) {
  {
    const int c = threadIdx.x % C, r = threadIdx.x / C;
    const int f = 2 * pr - 1 + r, t0 = SEG * tc - 1;
    const bool row_in = f >= 0 && f < F;
    const float* xr = st + r * WXC;
    float w[9], win[3][3];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) w[tap] = w1s[tap * C + c];
    const float bias = b1s[c];
#pragma unroll
    for (int df = 0; df < 3; ++df) {
      win[df][0] = xr[df * WXC];
      win[df][1] = xr[df * WXC + 1];
    }
#pragma unroll
    for (int j = 0; j < AC; ++j) {
#pragma unroll
      for (int df = 0; df < 3; ++df) win[df][2] = xr[df * WXC + j + 2];
      float h = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        h = fmaf(win[tap / 3][tap % 3], w[tap], h);
      const int t = t0 + j;
      dense[(r * AC + j) * C + c] =
          row_in && t >= 0 && t < T ? fmaxf(h + bias, 0.f) : 0.f;
#pragma unroll
      for (int df = 0; df < 3; ++df) {
        win[df][0] = win[df][1];
        win[df][1] = win[df][2];
      }
    }
  }
  const float* gs = st + WXR * WXC;
  const float* os = gs + WP * C;
  const uint32_t* is = reinterpret_cast<const uint32_t*>(os + WP * C);
  float* dys = dense + AR * AC * C;
  for (int e = threadIdx.x; e < 2 * SEG * (C / 4); e += WG_NT) {
    const int v = e % (C / 4), pos = e / (C / 4);
    const int r = pos / SEG, j = pos % SEG, p = j >> 1;
    const float4 d = route(lds4(gs + p * C + 4 * v), lds4(os + p * C + 4 * v),
                           is[p * (C / 4) + v], 2u * r + (j & 1));
    stg4(dys + pos * C + 4 * v, d.x, d.y, d.z, d.w);
  }
}

// acc[tap] += the products of the segment's conv row q: A = x1 at the
// tap's shift, B = dy2. Lane (h = lane % 8, m = lane / 8) owns ci = 32 (w /
// 4) + 4h .. +3 and co = 16 (w % 4) + 4m .. +3 of every tap: 144 sums, a
// float4 of dy2 and one of x1 a tap for 144 FFMA a position; bsum += dy2 of
// its co (db2). The kernel calls it in one loop over q: one copy of the
// loop, unrolled by 8, as block 2's wgrad tile
__device__ __forceinline__ void wg_products(float (&acc)[9][4][4],
                                            float (&bsum)[4],
                                            const float* st, int q) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ap = st + 32 * (warp >> 2) + 4 * (lane & 7);
  const float* bp = st + AR * AC * C + 16 * (warp & 3) + 4 * (lane >> 3);
#pragma unroll 8
  for (int j = 0; j < SEG; ++j) {
    const float4 bb = lds4(bp + (q * SEG + j) * C);
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int n = 0; n < 4; ++n) bsum[n] += bv[n];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float4 a =
          lds4(ap + ((q + tap / 3) * AC + j + tap % 3) * C);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          acc[tap][i][n] = fmaf(av[i], bv[n], acc[tap][i][n]);
    }
  }
}

// grid SPLITS: block sp walks the segments of its fixed range; part[sp]
// gets the range's dW2 (tap, ci, co) and db2 after its first RED floats.
// First the blocks transpose W2 (tap, ci, co) into w2t (tap, co, ci), dx1's
// weights, a slice each
__global__ void __launch_bounds__(WG_NT, 1)
vgg_block1_bwd_wgrad_f32_kernel(const float* __restrict__ x,
                                const float* __restrict__ w1,
                                const float* __restrict__ b1,
                                const float* __restrict__ w2,
                                const float* __restrict__ g,
                                const float* __restrict__ out,
                                const uint8_t* __restrict__ idx,
                                float* __restrict__ w2t,
                                float* __restrict__ part, int B, int F,
                                int T) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // WG_NST x WG_RAW
  float* dense = raw + WG_NST * WG_RAW;          // 2 x WG_DENSE
  float* w1s = dense + 2 * WG_DENSE;             // 9 x C
  float* b1s = w1s + 9 * C;                      // C
  const int Fp = F / 2, Tp = T / 2, tch = (2 * Tp + SEG - 1) / SEG;
  const long nseg = (long)B * Fp * tch;
  const int sp = blockIdx.x;
  for (int e = sp * WG_NT + threadIdx.x; e < DW2_SIZE; e += SPLITS * WG_NT) {
    const int ci = e % C, co = e / C % C, tap = e / (C * C);
    w2t[e] = __ldg(w2 + (tap * C + ci) * C + co);
  }
  for (int e = threadIdx.x; e < 9 * C; e += WG_NT) w1s[e] = __ldg(w1 + e);
  if (threadIdx.x < C) b1s[threadIdx.x] = __ldg(b1 + threadIdx.x);
  const int lo = (int)(nseg * sp / SPLITS);
  const int n = (int)(nseg * (sp + 1) / SPLITS) - lo;
  float acc[9][4][4], bsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[tap][i][k] = 0.f;
  // segment s is staged at segment s - 2 and its x1 and dy2 built during
  // segment s - 1's products
  for (int s = 0; s < WG_NST - 1 && s < n; ++s)
    wg_stage(raw + s * WG_RAW, x, g, out, idx, lo + s, Fp, Tp, tch, F, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // w1s, b1s and the first stages are in
  if (n > 0) wg_build(dense, raw, w1s, b1s, lo / tch % Fp, lo % tch, F, T);
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // segment s's x1 and dy2 built, segment s+1's stage
                      // in; segment s-1's buffers read
    if (s + WG_NST - 1 < n)
      wg_stage(raw + ((s + WG_NST - 1) % WG_NST) * WG_RAW, x, g, out, idx,
               lo + s + WG_NST - 1, Fp, Tp, tch, F, T);
    cp_async_commit();
    const float* cur = dense + (s & 1) * WG_DENSE;
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
      wg_products(acc, bsum, cur, q);
      // the next segment's x1 and dy2, beside this one's products
      if (q == 0 && s + 1 < n) {
        const int e = lo + s + 1;
        wg_build(dense + ((s + 1) & 1) * WG_DENSE,
                 raw + ((s + 1) % WG_NST) * WG_RAW, w1s, b1s, e / tch % Fp,
                 e % tch, F, T);
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ci0 = 32 * (warp >> 2) + 4 * (lane & 7);
  const int co0 = 16 * (warp & 3) + 4 * (lane >> 3);
  float* pb = part + (size_t)sp * PART + RED;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      stg4(pb + ((size_t)tap * C + ci0 + i) * C + co0, acc[tap][i][0],
           acc[tap][i][1], acc[tap][i][2], acc[tap][i][3]);
  // every lane of a co quad summed the same dy2: one of the first ci half
  if (warp < 4 && (lane & 7) == 0)
    stg4(pb + DW2_SIZE + co0, bsum[0], bsum[1], bsum[2], bsum[3]);
}

// grads[e] = sum over the ranges, in range order, of part[range][e]
__global__ void __launch_bounds__(NT)
vgg_block1_bwd_reduce_f32_kernel(const float* __restrict__ part,
                                 float* __restrict__ grads) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PART) return;
  float s = 0.f;
  for (int k = 0; k < SPLITS; ++k) s += part[(size_t)k * PART + e];
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

// Forward. x (B, F, T) f32; w1 (3,3,1,64), b1 (64), w2 (3,3,64,64) HWIO, b2
// (64) f32; out (B, F/2, T/2, 64) f32; idx uint8 of out's shape or null.
extern "C" int vgg_block1_fwd_f32(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* idx,
                                  int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int Fp = F / 2, Tp = T / 2;
  if (Fp == 0 || Tp == 0 || B == 0) return cudaSuccess;
  cudaError_t e = smem_attr(vgg_block1_fwd_f32_kernel, FWD_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((2 * Tp + TC - 1) / TC, (2 * Fp + TR - 1) / TR, B);
  vgg_block1_fwd_f32_kernel<<<grid, NTH, FWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)out, (uint8_t*)idx, F, T);
  return cudaGetLastError();
}

// Backward. x, w1, b1, w2 as the forward's; g and out (B, F/2, T/2, 64) f32,
// idx uint8 of their shape; part: the scratch, SPLITS x PART partial sums,
// then w2t (9 x 64 x 64) f32 (ops/vgg_fused.py: bwd_scratch); grads: PART
// f32 = dW1 (3,3,1,64) | db1 (64) | dW2 (3,3,64,64) | db2 (64).
extern "C" int vgg_block1_bwd_f32(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* g, const void* out,
                                  const void* idx, void* part, void* grads,
                                  int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this call's error
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F / 2 == 0 || T / 2 == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART, s);
  cudaError_t e = smem_attr(vgg_block1_bwd_dx1_f32_kernel, DX1_SMEM);
  if (e != cudaSuccess) return e;
  e = smem_attr(vgg_block1_bwd_wgrad_f32_kernel, WG_SMEM);
  if (e != cudaSuccess) return e;
  float* pt = (float*)part;
  float* w2t = pt + (size_t)SPLITS * PART;
  vgg_block1_bwd_wgrad_f32_kernel<<<SPLITS, WG_NT, WG_SMEM, s>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)g, (const float*)out, (const uint8_t*)idx, w2t, pt, B, F,
      T);
  vgg_block1_bwd_dx1_f32_kernel<<<SPLITS, NTH, DX1_SMEM, s>>>(
      (const float*)x, (const float*)w1, (const float*)b1, w2t,
      (const float*)g, (const float*)out, (const uint8_t*)idx, pt, B, F, T);
  vgg_block1_bwd_reduce_f32_kernel<<<(PART + NT - 1) / NT, NT, 0, s>>>(
      pt, (float*)grads);
  return cudaGetLastError();
}
