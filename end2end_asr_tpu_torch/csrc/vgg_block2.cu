// vgg_block2: the second block of the vgg_cnn front end, fused, and its
// backward:
//
//   out = relu(maxpool2x2(conv4_SAME(relu(conv3_SAME(x) + b3))) + b4)
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_fwd2_kernel and
// ::_bwd2_kernel (reached from _fwd2_pallas / _bwd2_pallas). As there, the
// full-resolution conv3 activation x2 never goes to device memory: the
// forward keeps the rows it needs in shared memory, and the backward
// recomputes them from x.
//
// Layouts: x (B, F, T, 64) channels-last in the compute type cdt (f32 or
// bf16; block 1 writes exactly this); out (B, F/2, T/2, 128) cdt; idx the
// same shape, uint8, the pool's argmax in window order (0,0),(0,1),(1,0),
// (1,1) over (f, t); g = dL/d(out) in cdt; dx of x's shape in cdt; the
// weight and bias gradients f32. F and T are even. Weights arrive in cdt in
// two layouts each, "n" = HWIO (tap, in, out) and "t" = (tap, out, in); the
// entry points say which one each convolution reads.
//
// Numerics (vgg_fused.py:636-651, :668-679, :729-812):
//   * conv3: f32 sum, rounded to cdt, + b3 in cdt, relu; positions outside
//     the image are ZERO (conv4's SAME padding pads the activation, so
//     relu(0 + b3) must not leak into the border);
//   * conv4: f32 sum rounded to cdt BEFORE the pool; strict '>' so the first
//     maximum in (f, t) order wins; best + b4 in cdt, relu;
//   * backward: dy4 = g * [out > 0] routed by idx (cdt); dW4 = sum dy4 (x) x2
//     and db4 = sum dy4 in f32; dx2 = W4^T . dy4 summed in f32, masked by the
//     recomputed x2 > 0 and rounded once to cdt (dy3); dW3, db3 from dy3 and
//     x in f32; dx = W3^T . dy3 summed in f32 and rounded once to cdt.
// Products of cdt values are exact in f32, so only the order of the f32
// sums differs from a library convolution.
//
// Structure. Every convolution here is one device function, conv_gemm: an
// implicit GEMM over a shared-memory tile of positions x channels,
//   out[p][n] = sum_tap sum_k A[apos(p, tap)][k] * W[tap][n][k],
// and every weight gradient is one device function, outer_acc,
//   acc[tap][m][n] += sum_pos A[apos(pos, tap)][m] * B[bpos(pos)][n].
// Each has a bf16 version on the tensor cores (mma.sync m16n8k16, f32
// accumulate, fragments read by ldmatrix from tiles whose rows are padded
// by 16 bytes so the 8 rows of a matrix hit distinct banks) and an f32
// version on FMA. The kernels are templates over cdt and share all staging,
// index and epilogue code.
//
//   forward, grid (column chunks, F/2, B): x rows 2r-2 .. 2r+3 -> conv3 at
//     rows 2r-1 .. 2r+2 (shared memory) -> conv4 at rows 2r, 2r+1 (shared
//     memory, over the dead x tile) -> pool, bias, relu -> out, idx. The
//     bf16 weights stream through shared memory one tap at a time (w4 is
//     295 KB, more than a block may hold); the f32 kernel reads them through
//     the L1 cache.
//   backward, kernel W, grid (8 channel groups, BWD2_BLOCKS): block
//     (cg, blk) owns the 16 conv3 channels 16cg .. 16cg+15 and a fixed range
//     of work items (utterance, row pair, column chunk). Per item it
//     recomputes x2 for its 16 channels (rows 2r-1 .. 2r+2), gathers dy4
//     (all 128 channels) on the same rows, and adds to its register
//     accumulators dW4[:, 16cg.., :] (9 x 16 x 128) and, after computing its
//     16 channels of dx2 -> dy3 on the item's own two rows, dW3[:, :, 16cg..]
//     (9 x 64 x 16) and db3; group 0 also sums db4. dy3 goes to device memory
//     (it is a gradient, not the activation). Each channel group computes a
//     distinct slice, so nothing but the x tile and the dy4 gather is done
//     more than once. The partial sums of a block are written once at the
//     end and a last kernel adds them in block order: blocks run in no
//     order, the sums have one, and two runs give identical bits.
//   backward, kernel X, grid (column chunks, F/2, B): dx = W3^T . dy3, a
//     plain 3x3 convolution of dy3 (halo read from device memory, so every
//     dx element is complete inside one block; no atomics).
//
// Bound on the H100 at x (12, 80, 400, 64): conv3 56.6 + conv4 113.2 =
// 169.9 GFLOP forward (0.172 ms at the 989 TFLOP/s of the bf16 tensor cores,
// 2.54 ms at the 67 TFLOP/s of f32 FMA), twice that backward; bytes are far
// below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CI = 64;    // input channels
constexpr int C2 = 128;   // conv3 / conv4 output channels
constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int CG = 16;    // conv3 channels per backward channel group
constexpr int NCG = C2 / CG;
constexpr int BWD2_BLOCKS = 64;  // fixed: the reduction order is fixed
constexpr int DW3_SIZE = 9 * CI * C2;
constexpr int DW4_SIZE = 9 * C2 * C2;
constexpr int PART2 = DW3_SIZE + C2 + DW4_SIZE + C2;  // floats per block

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// per compute type: conv columns per tile, row padding (16 bytes), rounding
template <typename T> struct Cdt;
template <> struct Cdt<float> {
  static constexpr int W = 32;
  static constexpr int PAD = 4;
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Cdt<bf16> {
  static constexpr int W = 64;
  static constexpr int PAD = 8;
  static __device__ __forceinline__ float rnd(float v) { return bf16r(v); }
  static __device__ __forceinline__ float to_f(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f(float v) {
    return __float2bfloat16(v);
  }
};

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// rows r0 .. r0+R-1 and columns c0 .. c0+Wd-1 of one utterance's
// channels-last image src (F, Tn, CH) into dst[(i*Wd + j)][CH + PAD]; zero
// outside the image
template <typename T, int CH>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int F, int Tn,
                                           int r0, int c0, int R, int Wd) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = CH / V;
  constexpr int P = CH + Cdt<T>::PAD;
  for (int e = threadIdx.x; e < R * Wd * NV; e += NT) {
    const int v = e % NV, pos = e / NV;
    const int f = r0 + pos / Wd, t = c0 + pos % Wd;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (f >= 0 && f < F && t >= 0 && t < Tn)
      val = *reinterpret_cast<const uint4*>(src + ((size_t)f * Tn + t) * CH +
                                            v * V);
    *reinterpret_cast<uint4*>(dst + pos * P + v * V) = val;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// dy4 = g * [out > 0] routed by idx, at conv rows r0 .. r0+3 and columns
// c0 .. c0+Wd-1 of utterance b, into dst[(i*Wd + j)][C2 + PAD]; zero outside
// the image. g / out / idx are (B, F/2, Tn/2, C2).
template <typename T>
__device__ __forceinline__ void gather_dy4(T* dst, const T* g, const T* out,
                                           const uint8_t* idx, int b, int F,
                                           int Tn, int r0, int c0, int Wd) {
  constexpr int P = C2 + Cdt<T>::PAD;
  const int Fp = F / 2, Tp = Tn / 2;
  for (int e = threadIdx.x; e < 4 * Wd * (C2 / 8); e += NT) {
    const int ch = e % (C2 / 8), pos = e / (C2 / 8);
    const int R = r0 + pos / Wd, Cc = c0 + pos % Wd;
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = 0.f;
    if (R >= 0 && R < F && Cc >= 0 && Cc < Tn) {
      const size_t off =
          (((size_t)b * Fp + R / 2) * Tp + Cc / 2) * C2 + ch * 8;
      float gv[8], ov[8];
      load8(g + off, gv);
      load8(out + off, ov);
      const uint2 u = *reinterpret_cast<const uint2*>(idx + off);
      const uint8_t* iv = reinterpret_cast<const uint8_t*>(&u);
      const int wp = 2 * (R & 1) + (Cc & 1);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (iv[k] == wp && ov[k] > 0.f) d[k] = gv[k];
    }
    store8(dst + pos * P + ch * 8, d);
  }
}

// ---------------------------------------------------------------------------
// tensor-core fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t* r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t* r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// ---------------------------------------------------------------------------
// conv_gemm: out[p][n] = sum_tap sum_k A[apos(p, df, dt)][k] * W[tap][n][k]
// for p < M, n < NOUT; epi(p, n, sum) consumes each result. A is a shared
// tile [position][CIN + PAD]; apos maps an output position and a tap to a
// tile position.
//
// bf16: a warp owns 16 positions x NOUT channels per round. STREAM: wg is
// the device-memory weight (9, NOUT, CIN) and ws a one-tap buffer
// [NOUT][CIN + 8] that every warp helps fill (so every warp runs every
// round); otherwise ws holds all nine taps, staged by the caller.
// f32: a thread owns one channel n and 8 positions per pass; the weight is
// read through the cache as wg[(tap*CIN + k)*ldw + n].
// ---------------------------------------------------------------------------

template <int CIN, int NOUT, bool STREAM, typename APos, typename Epi>
__device__ __forceinline__ void conv_gemm(const bf16* A, const bf16* wg,
                                          int /*ldw*/, bf16* ws, int M,
                                          APos apos, Epi epi) {
  constexpr int PA = CIN + 8, PW = CIN + 8, NTL = NOUT / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = (M + 16 * NW - 1) / (16 * NW);
  for (int rd = 0; rd < rounds; ++rd) {
    const int mt = rd * NW + warp;
    int pa = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    if (pa >= M) pa = M - 1;  // computed and dropped
    float acc[NTL][4];
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* wt = ws + tap * NOUT * PW;
      if (STREAM) {
        __syncthreads();  // the previous tap's readers are done
        for (int e = tid; e < NOUT * (CIN / 8); e += NT) {
          const int n = e / (CIN / 8), c = e % (CIN / 8);
          *reinterpret_cast<uint4*>(ws + n * PW + c * 8) =
              *reinterpret_cast<const uint4*>(
                  wg + ((size_t)tap * NOUT + n) * CIN + c * 8);
        }
        __syncthreads();
        wt = ws;
      }
      const bf16* ap = A + apos(pa, tap / 3, tap % 3) * PA + (lane >> 4) * 8;
      const bf16* bp =
          wt + ((lane & 7) + (lane >> 4) * 8) * PW + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < CIN / 16; ++kc) {
        uint32_t a[4];
        ldsm_x4(ap + kc * 16, a);
#pragma unroll
        for (int np = 0; np < NTL / 2; ++np) {
          uint32_t q[4];
          ldsm_x4(bp + np * 16 * PW + kc * 16, q);
          mma_bf16(acc[2 * np], a, q[0], q[1]);
          mma_bf16(acc[2 * np + 1], a, q[2], q[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = mt * 16 + (lane >> 2) + 8 * (i >> 1);
        if (p < M) epi(p, n * 8 + 2 * (lane & 3) + (i & 1), acc[n][i]);
      }
  }
}

template <int CIN, int NOUT, bool STREAM, typename APos, typename Epi>
__device__ __forceinline__ void conv_gemm(const float* A, const float* wg,
                                          int ldw, float* /*ws*/, int M,
                                          APos apos, Epi epi) {
  constexpr int PA = CIN + 4, NPG = NT / NOUT, PB = 8;
  const int n = threadIdx.x % NOUT, pg = threadIdx.x / NOUT;
  for (int base = 0; base < M; base += NPG * PB) {
    float acc[PB];
    int pp[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      acc[i] = 0.f;
      const int p = base + pg + i * NPG;
      pp[i] = p < M ? p : M - 1;
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* w = wg + (size_t)tap * CIN * ldw + n;
      int ao[PB];
#pragma unroll
      for (int i = 0; i < PB; ++i) ao[i] = apos(pp[i], tap / 3, tap % 3) * PA;
#pragma unroll 2
      for (int k = 0; k < CIN; k += 4) {
        const float w0 = __ldg(w + (size_t)k * ldw);
        const float w1 = __ldg(w + (size_t)(k + 1) * ldw);
        const float w2 = __ldg(w + (size_t)(k + 2) * ldw);
        const float w3 = __ldg(w + (size_t)(k + 3) * ldw);
#pragma unroll
        for (int i = 0; i < PB; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(A + ao[i] + k);
          acc[i] = fmaf(a.x, w0, acc[i]);
          acc[i] = fmaf(a.y, w1, acc[i]);
          acc[i] = fmaf(a.z, w2, acc[i]);
          acc[i] = fmaf(a.w, w3, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = base + pg + i * NPG;
      if (p < M) epi(p, n, acc[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// outer_acc: acc[tap][.] += sum over the 2 x W positions (q, j) of
//   A[apos(q, j, df, dt)][m] * B[bpos(q, j)][n],  m < MCH, n < NCH,
// A and B shared tiles [position][channels + PAD]. The block's 256 threads
// hold the 9 x MCH x NCH sums, ACC = MCH*NCH/256 per tap and thread;
// outer_store hands each to put(tap, m, n, value).
//
// bf16: warp w owns the 16 A channels of m-tile w % MT and NPW 8-channel
// n-tiles; K = positions, both operands read with transposing ldmatrix.
// f32: thread owns B channel tid % NCH and MCH / (256 / NCH) A channels.
// ---------------------------------------------------------------------------

template <int MCH, int NCH> struct Outer {
  static constexpr int ACC = MCH * NCH / NT;
  static constexpr int MT = MCH / 16;                 // bf16: m-tiles
  static constexpr int NPW = (NCH / 8) / (NW / MT);   // bf16: n-tiles / warp
  static constexpr int MPT = MCH / (NT / NCH);        // f32: A channels
  static_assert(ACC == NPW * 4 && ACC == MPT, "accumulator layout");
};

template <int MCH, int NCH, int W, typename APos, typename BPos>
__device__ __forceinline__ void outer_acc(
    float (&acc)[9][Outer<MCH, NCH>::ACC], const bf16* As, const bf16* Bs,
    APos apos, BPos bpos) {
  typedef Outer<MCH, NCH> O;
  constexpr int PA = MCH + 8, PB = NCH + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp % O::MT, n0 = (warp / O::MT) * O::NPW * 8;
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bn = n0 + (O::NPW == 2 ? (lane >> 4) * 8 : 0);
  const int ak = (lane & 7) + (lane >> 4) * 8;
  const int am = mt * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll 1
  for (int q = 0; q < 2; ++q)
#pragma unroll 1
    for (int kb = 0; kb < W / 16; ++kb) {
      uint32_t b[4];
      ldsm_x4_t(Bs + bpos(q, kb * 16 + bk) * PB + bn, b);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t a[4];
        ldsm_x4_t(As + apos(q, kb * 16 + ak, tap / 3, tap % 3) * PA + am, a);
        mma_bf16(acc[tap], a, b[0], b[1]);
        if (O::NPW == 2) mma_bf16(acc[tap] + 4 * (O::NPW - 1), a, b[2], b[3]);
      }
    }
}

template <int MCH, int NCH, typename Put>
__device__ __forceinline__ void outer_store(
    const float (&acc)[9][Outer<MCH, NCH>::ACC], const bf16*, Put put) {
  typedef Outer<MCH, NCH> O;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp % O::MT, n0 = (warp / O::MT) * O::NPW * 8;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int e = 0; e < O::ACC; ++e) {
      const int np = e >> 2, i = e & 3;
      put(tap, mt * 16 + (lane >> 2) + 8 * (i >> 1),
          n0 + np * 8 + 2 * (lane & 3) + (i & 1), acc[tap][e]);
    }
}

template <int MCH, int NCH, int W, typename APos, typename BPos>
__device__ __forceinline__ void outer_acc(
    float (&acc)[9][Outer<MCH, NCH>::ACC], const float* As, const float* Bs,
    APos apos, BPos bpos) {
  typedef Outer<MCH, NCH> O;
  constexpr int PA = MCH + 4, PB = NCH + 4;
  const int n = threadIdx.x % NCH, m0 = (threadIdx.x / NCH) * O::MPT;
#pragma unroll 1
  for (int q = 0; q < 2; ++q)
#pragma unroll 1
    for (int j = 0; j < W; ++j) {
      const float bv = Bs[bpos(q, j) * PB + n];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* ap = As + apos(q, j, tap / 3, tap % 3) * PA + m0;
#pragma unroll
        for (int i = 0; i < O::MPT; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(ap + i);
          acc[tap][i] = fmaf(a.x, bv, acc[tap][i]);
          acc[tap][i + 1] = fmaf(a.y, bv, acc[tap][i + 1]);
          acc[tap][i + 2] = fmaf(a.z, bv, acc[tap][i + 2]);
          acc[tap][i + 3] = fmaf(a.w, bv, acc[tap][i + 3]);
        }
      }
    }
}

template <int MCH, int NCH, typename Put>
__device__ __forceinline__ void outer_store(
    const float (&acc)[9][Outer<MCH, NCH>::ACC], const float*, Put put) {
  typedef Outer<MCH, NCH> O;
  const int n = threadIdx.x % NCH, m0 = (threadIdx.x / NCH) * O::MPT;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int i = 0; i < O::MPT; ++i) put(tap, m0 + i, n, acc[tap][i]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T> struct FwdSmem {
  static constexpr int W = Cdt<T>::W, PAD = Cdt<T>::PAD;
  static constexpr int XS = 6 * (W + 4) * (CI + PAD);   // x tile (then y4)
  static constexpr int X2 = 4 * (W + 2) * (C2 + PAD);   // conv3 tile
  static constexpr int WS = sizeof(T) == 2 ? C2 * (C2 + PAD) : 0;  // one tap
  static constexpr size_t BYTES =
      sizeof(T) * (size_t)(XS + X2 + WS) + sizeof(float) * 2 * C2;
  static_assert(2 * W * (C2 + PAD) <= XS, "y4 fits over the x tile");
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
vgg_block2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w3,
                      const float* __restrict__ b3, const T* __restrict__ w4,
                      const float* __restrict__ b4, T* __restrict__ out,
                      uint8_t* __restrict__ idx, int F, int Tn) {
  typedef Cdt<T> D;
  typedef FwdSmem<T> S;
  constexpr int W = D::W, P2 = C2 + D::PAD;
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  T* x2s = xs + S::XS;
  T* ws = x2s + S::X2;
  float* b3s = reinterpret_cast<float*>(ws + S::WS);
  float* b4s = b3s + C2;
  T* y4s = xs;  // conv4's rows, written after conv3 has consumed the x tile

  const int b = blockIdx.z, r = blockIdx.y, c0 = blockIdx.x * W;
  const int Fp = F / 2, Tp = Tn / 2, tid = threadIdx.x;
  if (tid < C2) {
    b3s[tid] = D::rnd(b3[tid]);
    b4s[tid] = D::rnd(b4[tid]);
  }
  stage_tile<T, CI>(xs, x + (size_t)b * F * Tn * CI, F, Tn, 2 * r - 2, c0 - 2,
                    6, W + 4);
  __syncthreads();

  // conv3 + b3 + relu at rows 2r-1 .. 2r+2, columns c0-1 .. c0+W
  conv_gemm<CI, C2, true>(
      xs, w3, C2, ws, 4 * (W + 2),
      [&](int p, int df, int dt) {
        return (p / (W + 2) + df) * (W + 4) + p % (W + 2) + dt;
      },
      [&](int p, int n, float v) {
        const int f = 2 * r - 1 + p / (W + 2), t = c0 - 1 + p % (W + 2);
        const bool in = f >= 0 && f < F && t >= 0 && t < Tn;
        x2s[p * P2 + n] = D::from_f(
            in ? fmaxf(D::rnd(D::rnd(v) + b3s[n]), 0.f) : 0.f);
      });
  __syncthreads();

  // conv4 at rows 2r, 2r+1, columns c0 .. c0+W-1, rounded to cdt
  conv_gemm<C2, C2, true>(
      x2s, w4, C2, ws, 2 * W,
      [&](int p, int df, int dt) {
        return (p / W + df) * (W + 2) + p % W + dt;
      },
      [&](int p, int n, float v) { y4s[p * P2 + n] = D::from_f(v); });
  __syncthreads();

  // pool (first maximum wins), + b4 in cdt, relu
  for (int e = tid; e < (W / 2) * C2; e += NT) {
    const int n = e % C2, jp = e / C2, tp = c0 / 2 + jp;
    if (tp >= Tp) continue;
    float best = D::to_f(y4s[(2 * jp) * P2 + n]);
    uint8_t id = 0;
    const float v1 = D::to_f(y4s[(2 * jp + 1) * P2 + n]);
    const float v2 = D::to_f(y4s[(W + 2 * jp) * P2 + n]);
    const float v3 = D::to_f(y4s[(W + 2 * jp + 1) * P2 + n]);
    if (v1 > best) { best = v1; id = 1; }
    if (v2 > best) { best = v2; id = 2; }
    if (v3 > best) { best = v3; id = 3; }
    const size_t off = (((size_t)b * Fp + r) * Tp + tp) * C2 + n;
    out[off] = D::from_f(fmaxf(D::rnd(best + b4s[n]), 0.f));
    if (idx != nullptr) idx[off] = id;
  }
}

// ---------------------------------------------------------------------------
// backward, kernel W: dW3, db3, dW4, db4 partials and dy3
// ---------------------------------------------------------------------------

template <typename T> struct BwdSmem {
  static constexpr int W = Cdt<T>::W, PAD = Cdt<T>::PAD;
  static constexpr int XS = 6 * (W + 4) * (CI + PAD);   // x tile
  static constexpr int X2 = 4 * (W + 2) * (CG + PAD);   // x2, 16 channels
  static constexpr int DY = 4 * (W + 2) * (C2 + PAD);   // dy4 tile
  static constexpr int D3 = 2 * W * (CG + PAD);         // dy3, 16 channels
  // bf16 only: the group's conv3 rows (9, 16, 64) and W4 rows (9, 16, 128)
  static constexpr int W3S = sizeof(T) == 2 ? 9 * CG * (CI + PAD) : 0;
  static constexpr int W4S = sizeof(T) == 2 ? 9 * CG * (C2 + PAD) : 0;
  static constexpr size_t BYTES =
      sizeof(T) * (size_t)(XS + X2 + DY + D3 + W3S + W4S) +
      sizeof(float) * CG;
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
vgg_block2_bwd_w_kernel(const T* __restrict__ x, const T* __restrict__ w3c,
                        const float* __restrict__ b3,
                        const T* __restrict__ w4d, const T* __restrict__ g,
                        const T* __restrict__ out,
                        const uint8_t* __restrict__ idx, T* __restrict__ dy3,
                        float* __restrict__ part, int B, int F, int Tn) {
  typedef Cdt<T> D;
  typedef BwdSmem<T> S;
  constexpr int W = D::W, PX = CI + D::PAD, P2 = C2 + D::PAD,
                PG = CG + D::PAD;
  constexpr bool BF = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);
  T* x2s = xs + S::XS;
  T* dys = x2s + S::X2;
  T* d3s = dys + S::DY;
  T* w3s = d3s + S::D3;
  T* w4s = w3s + S::W3S;
  float* b3s = reinterpret_cast<float*>(w4s + S::W4S);

  const int cg = blockIdx.x, blk = blockIdx.y, tid = threadIdx.x;
  const int chunks = (Tn + W - 1) / W, Fp = F / 2;
  const long n_items = (long)B * Fp * chunks;
  const long lo = n_items * blk / BWD2_BLOCKS,
             hi = n_items * (blk + 1) / BWD2_BLOCKS;

  if (tid < CG) b3s[tid] = D::rnd(b3[cg * CG + tid]);
  if (BF) {
    // w3c is (9, 128 out, 64 in): this group's 16 output rows of each tap;
    // w4d is (9, 128 in, 128 out): this group's 16 input rows of each tap
    for (int e = tid; e < 9 * CG * (CI / 8); e += NT) {
      const int c = e % (CI / 8), row = e / (CI / 8);
      const int tap = row / CG, n = row % CG;
      *reinterpret_cast<uint4*>(w3s + row * PX + c * 8) =
          *reinterpret_cast<const uint4*>(
              w3c + ((size_t)tap * C2 + cg * CG + n) * CI + c * 8);
    }
    for (int e = tid; e < 9 * CG * (C2 / 8); e += NT) {
      const int c = e % (C2 / 8), row = e / (C2 / 8);
      const int tap = row / CG, n = row % CG;
      *reinterpret_cast<uint4*>(w4s + row * P2 + c * 8) =
          *reinterpret_cast<const uint4*>(
              w4d + ((size_t)tap * C2 + cg * CG + n) * C2 + c * 8);
    }
  }

  float acc4[9][Outer<CG, C2>::ACC];   // dW4[tap][16cg + m][n]
  float acc3[9][Outer<CI, CG>::ACC];   // dW3[tap][m][16cg + n]
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int i = 0; i < Outer<CG, C2>::ACC; ++i) acc4[tap][i] = 0.f;
#pragma unroll
    for (int i = 0; i < Outer<CI, CG>::ACC; ++i) acc3[tap][i] = 0.f;
  }
  float dbias = 0.f;  // db4[tid] for tid < 128 (group 0); db3 for 128..143

  for (long it = lo; it < hi; ++it) {
    const int c0 = (int)(it % chunks) * W;
    const int r = (int)((it / chunks) % Fp);
    const int b = (int)(it / chunks / Fp);
    __syncthreads();  // the previous item's tiles are consumed
    stage_tile<T, CI>(xs, x + (size_t)b * F * Tn * CI, F, Tn, 2 * r - 2,
                      c0 - 2, 6, W + 4);
    gather_dy4<T>(dys, g, out, idx, b, F, Tn, 2 * r - 1, c0 - 1, W + 2);
    __syncthreads();

    // x2 (this group's 16 channels) at rows 2r-1 .. 2r+2, cols c0-1 .. c0+W
    conv_gemm<CI, CG, false>(
        xs, w3c + cg * CG, C2, w3s, 4 * (W + 2),
        [&](int p, int df, int dt) {
          return (p / (W + 2) + df) * (W + 4) + p % (W + 2) + dt;
        },
        [&](int p, int n, float v) {
          const int f = 2 * r - 1 + p / (W + 2), t = c0 - 1 + p % (W + 2);
          const bool in = f >= 0 && f < F && t >= 0 && t < Tn;
          x2s[p * PG + n] = D::from_f(
              in ? fmaxf(D::rnd(D::rnd(v) + b3s[n]), 0.f) : 0.f);
        });
    __syncthreads();

    // dW4[tap][16cg + m][n] += x2[pos + tap - 1][m] * dy4[pos][n]
    outer_acc<CG, C2, W>(
        acc4, x2s, dys,
        [&](int q, int j, int df, int dt) {
          return (q + df) * (W + 2) + j + dt;
        },
        [&](int q, int j) { return (q + 1) * (W + 2) + j + 1; });
    if (cg == 0 && tid < C2) {
      for (int q = 0; q < 2; ++q)
        for (int j = 0; j < W; ++j)
          dbias += D::to_f(dys[((q + 1) * (W + 2) + j + 1) * P2 + tid]);
    }

    // dx2 (16 channels) on the item's own rows 2r, 2r+1: the transposed
    // convolution reads dy4 at pos - (tap - 1); then the relu mask -> dy3
    conv_gemm<C2, CG, false>(
        dys, w4d + cg * CG, C2, w4s, 2 * W,
        [&](int p, int df, int dt) {
          return (p / W + 2 - df) * (W + 2) + p % W + 2 - dt;
        },
        [&](int p, int n, float v) {
          const int q = p / W, j = p % W;
          const bool on =
              D::to_f(x2s[((q + 1) * (W + 2) + j + 1) * PG + n]) > 0.f;
          d3s[p * PG + n] = D::from_f(on ? v : 0.f);
        });
    __syncthreads();

    // dy3 out (16 channels of each position), for kernel X
    {
      constexpr int V = 16 / sizeof(T), NV = CG / V;
      for (int e = tid; e < 2 * W * NV; e += NT) {
        const int v = e % NV, p = e / NV, q = p / W, j = p % W;
        if (c0 + j < Tn)
          *reinterpret_cast<uint4*>(
              dy3 + (((size_t)b * F + 2 * r + q) * Tn + c0 + j) * C2 +
              cg * CG + v * V) =
              *reinterpret_cast<const uint4*>(d3s + p * PG + v * V);
      }
    }
    // dW3[tap][m][16cg + n] += x[pos + tap - 1][m] * dy3[pos][n]
    outer_acc<CI, CG, W>(
        acc3, xs, d3s,
        [&](int q, int j, int df, int dt) {
          return (q + 1 + df) * (W + 4) + j + 1 + dt;
        },
        [&](int q, int j) { return q * W + j; });
    if (tid >= C2 && tid < C2 + CG) {
      for (int p = 0; p < 2 * W; ++p)
        dbias += D::to_f(d3s[p * PG + tid - C2]);
    }
  }

  float* pb = part + (size_t)blk * PART2;
  outer_store<CI, CG>(acc3, xs, [&](int tap, int m, int n, float v) {
    pb[(tap * CI + m) * C2 + cg * CG + n] = v;
  });
  outer_store<CG, C2>(acc4, xs, [&](int tap, int m, int n, float v) {
    pb[DW3_SIZE + C2 + (tap * C2 + cg * CG + m) * C2 + n] = v;
  });
  if (tid >= C2 && tid < C2 + CG) pb[DW3_SIZE + cg * CG + tid - C2] = dbias;
  if (cg == 0 && tid < C2) pb[DW3_SIZE + C2 + DW4_SIZE + tid] = dbias;
}

// grads[e] = sum over blocks, in block order, of part[blk][e]
__global__ void vgg_block2_bwd_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PART2) return;
  float s = 0.f;
  for (int k = 0; k < BWD2_BLOCKS; ++k) s += part[(size_t)k * PART2 + e];
  grads[e] = s;
}

// ---------------------------------------------------------------------------
// backward, kernel X: dx = W3^T . dy3
// ---------------------------------------------------------------------------

template <typename T> struct DxSmem {
  static constexpr int W = Cdt<T>::W, PAD = Cdt<T>::PAD;
  static constexpr int D3 = 4 * (W + 2) * (C2 + PAD);
  static constexpr int WS = sizeof(T) == 2 ? CI * (C2 + PAD) : 0;
  static constexpr size_t BYTES = sizeof(T) * (size_t)(D3 + WS);
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
vgg_block2_bwd_x_kernel(const T* __restrict__ dy3, const T* __restrict__ w3d,
                        T* __restrict__ dx, int F, int Tn) {
  typedef Cdt<T> D;
  typedef DxSmem<T> S;
  constexpr int W = D::W;
  extern __shared__ float4 smem4[];
  T* d3t = reinterpret_cast<T*>(smem4);
  T* ws = d3t + S::D3;
  const int b = blockIdx.z, r = blockIdx.y, c0 = blockIdx.x * W;
  stage_tile<T, C2>(d3t, dy3 + (size_t)b * F * Tn * C2, F, Tn, 2 * r - 1,
                    c0 - 1, 4, W + 2);
  __syncthreads();
  conv_gemm<C2, CI, true>(
      d3t, w3d, CI, ws, 2 * W,
      [&](int p, int df, int dt) {
        return (p / W + 2 - df) * (W + 2) + p % W + 2 - dt;
      },
      [&](int p, int n, float v) {
        const int q = p / W, j = p % W;
        if (c0 + j < Tn)
          dx[(((size_t)b * F + 2 * r + q) * Tn + c0 + j) * CI + n] =
              D::from_f(v);
      });
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_fwd(const void* x, const void* w3, const void* b3, const void* w4,
               const void* b4, void* out, void* idx, int B, int F, int Tn,
               void* stream) {
  cudaGetLastError();  // report only this launch's error
  if (B == 0 || F == 0 || Tn == 0) return cudaSuccess;
  const size_t smem = FwdSmem<T>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block2_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int W = Cdt<T>::W;
  dim3 grid((Tn + W - 1) / W, F / 2, B);
  vgg_block2_fwd_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w3, (const float*)b3, (const T*)w4,
      (const float*)b4, (T*)out, (uint8_t*)idx, F, Tn);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w3c, const void* b3,
               const void* w4d, const void* w3d, const void* g,
               const void* out, const void* idx, void* dy3, void* dx,
               void* part, void* grads, int B, int F, int Tn, void* stream) {
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F == 0 || Tn == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART2, s);
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block2_bwd_w_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BwdSmem<T>::BYTES);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(vgg_block2_bwd_x_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DxSmem<T>::BYTES);
  if (e != cudaSuccess) return e;
  vgg_block2_bwd_w_kernel<T>
      <<<dim3(NCG, BWD2_BLOCKS), NT, BwdSmem<T>::BYTES, s>>>(
          (const T*)x, (const T*)w3c, (const float*)b3, (const T*)w4d,
          (const T*)g, (const T*)out, (const uint8_t*)idx, (T*)dy3,
          (float*)part, B, F, Tn);
  vgg_block2_bwd_reduce_kernel<<<(PART2 + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)grads);
  constexpr int W = Cdt<T>::W;
  vgg_block2_bwd_x_kernel<T>
      <<<dim3((Tn + W - 1) / W, F / 2, B), NT, DxSmem<T>::BYTES, s>>>(
          (const T*)dy3, (const T*)w3d, (T*)dx, F, Tn);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward. x (B, F, T, 64) cdt; b3, b4 (128) f32; out (B, F/2, T/2, 128)
// cdt; idx uint8 of out's shape or null. bf16: w3, w4 in layout "t" (tap,
// out, in); f32: in layout "n" (tap, in, out).
extern "C" int vgg_block2_fwd_bf16(const void* x, const void* w3t,
                                   const void* b3, const void* w4t,
                                   const void* b4, void* out, void* idx,
                                   int B, int F, int T, void* stream) {
  return launch_fwd<bf16>(x, w3t, b3, w4t, b4, out, idx, B, F, T, stream);
}

extern "C" int vgg_block2_fwd_f32(const void* x, const void* w3n,
                                  const void* b3, const void* w4n,
                                  const void* b4, void* out, void* idx,
                                  int B, int F, int T, void* stream) {
  return launch_fwd<float>(x, w3n, b3, w4n, b4, out, idx, B, F, T, stream);
}

// Backward. g, out, idx as the forward's output; dy3 (B, F, T, 128) cdt
// scratch; dx (B, F, T, 64) cdt; part BWD2_BLOCKS x PART2 f32 scratch;
// grads PART2 f32 = dW3 (3,3,64,128) | db3 (128) | dW4 (3,3,128,128) | db4
// (128). bf16: w3c = w3 "t", w4d = w4 "n", w3d = w3 "n"; f32: w3c = w3 "n",
// w4d = w4 "t", w3d = w3 "t".
extern "C" int vgg_block2_bwd_bf16(const void* x, const void* w3c,
                                   const void* b3, const void* w4d,
                                   const void* w3d, const void* g,
                                   const void* out, const void* idx,
                                   void* dy3, void* dx, void* part,
                                   void* grads, int B, int F, int T,
                                   void* stream) {
  return launch_bwd<bf16>(x, w3c, b3, w4d, w3d, g, out, idx, dy3, dx, part,
                          grads, B, F, T, stream);
}

extern "C" int vgg_block2_bwd_f32(const void* x, const void* w3c,
                                  const void* b3, const void* w4d,
                                  const void* w3d, const void* g,
                                  const void* out, const void* idx, void* dy3,
                                  void* dx, void* part, void* grads, int B,
                                  int F, int T, void* stream) {
  return launch_bwd<float>(x, w3c, b3, w4d, w3d, g, out, idx, dy3, dx, part,
                           grads, B, F, T, stream);
}
