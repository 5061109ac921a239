// stft_logmag: log1p(|DFT|) of overlapping frames of reflect-padded PCM.
//
// Replaces end2end_asr_tpu/ops/stft_pallas.py::_stft_kernel (reached from
// _batched_features_impl's pl.pallas_call). That kernel splits each frame
// into two hop-wide chunks because Mosaic cannot DMA 160-wide rows and runs
// the DFT as products with windowed cos/sin bases on the MXU. Here:
//
//   out[b, t, f] = log1p(|X_t[f]|),  X_t = DFT_n(w * pcm[b, t*hop : t*hop+n])
//
// (zeros past the row's N samples), by one of two kernels in this file,
// chosen by the wrapper (ops/stft.py) from n = n_fft alone:
//
// 1. stft_fft_kernel, for every even n whose half n/2 = M has no prime
//    factor above 5: a real-input mixed-radix FFT held in shared memory.
//    The n real samples of a frame, windowed on load, are packed as the M
//    complex values z[m] = x[2m] + i x[2m+1]; a Stockham FFT of M points
//    runs as radix passes over the plan the wrapper passes (5s and 3s first,
//    then 8s, a 4, a 2: 160 = 5 * 8 * 4); the real-input split
//      X[k] = E[k] + W_n^k O[k],  E = (Z[k] + conj Z[M-k]) / 2,
//      O = -i (Z[k] - conj Z[M-k]) / 2,  X[M-k] = conj(E - W_n^k O)
//    yields the n/2 + 1 bins. Twiddles W_M^t (t < M) and W_n^k (k <= M/2)
//    come from tables built in double on the host (ops/stft.py), so their
//    accuracy does not depend on the card's sinf. Rounding grows as
//    O(eps log n) against O(eps sqrt n) for the direct sum.
//
//    Design. A block walks runs of FR (16) consecutive frames of one
//    utterance (a persistent grid: at most as many blocks as fit on the
//    card at once). The run's (FR-1)*hop + n samples are contiguous in
//    device memory and are staged once with 16-byte cp.async copies
//    (zero-filled past N) into one of two buffers, the NEXT run's while
//    this one computes; the window and twiddle tables ride in the first
//    run's copy group. The main path's plan (n = 320: M = 160 = 5 * 8 * 4)
//    is compiled in, so its indices, loop bounds and quotients fold to
//    constants; any other plan runs the same code with them read from the
//    arguments (tools/probe_stft.py times the parts). The transform lives in two shared buffers laid out
//    [m][frame] with a row stride of FR+1 complex values: the first pass
//    (threads over m) reads the staged samples at unit stride and writes at
//    an odd stride for a radix-5 or -3 first pass; later passes put
//    neighbouring threads on neighbouring frames of the same butterfly (no
//    bank conflict whatever the index pattern; one twiddle per half-warp);
//    the split puts threads on neighbouring bins and writes each frame's
//    n/2 + 1 outputs as one coalesced row of the (B, T, F) result.
//
//    What bounds it on the H100 (B = 12, T = 800, n = 320, hop = 160): the
//    bytes. PCM in (B*N*4 = 6.15 MB), spectrogram out (B*T*F*4 = 6.18 MB),
//    window and twiddles (3.2 KB): 12.3 MB, 3.7 us at 3.35 TB/s. The
//    operations, per frame,
//      ops = n                                        (window)
//          + sum over passes p of (M/R_p) * (BF[R_p] + 6 (R_p - 1) [p > 0])
//          + 18 (floor(M/2) + 1)                      (real split, per pair)
//          + 5 (M + 1)                                (|X|^2, sqrt, log1p)
//    with the butterfly counts of the code below, BF[2] = 4, BF[3] = 16,
//    BF[4] = 16, BF[5] = 48, BF[8] = 56 (an FMA counts 2, sqrt and log1p 1
//    each; the first pass needs no twiddles): 7439 at n = 320, 71 MFLOP in
//    all, 1.1 us at the 67 TFLOP/s of f32 FMA.
//
// 2. stft_dft_kernel, for any other n (and callable at any n): the direct
//    sum re = sum_k x[k] cosb[k, f], im likewise with sinb, against the
//    (n, F) bases with the window folded in, f32 FMA in k order. One block
//    per (utterance, 64 frames, 64 frequencies); the tile's (64-1)*hop + n
//    samples go to shared memory once; the bases stream through shared
//    memory in 32-row slabs; each thread keeps 8 frames x 2 frequencies of
//    re and im in registers. Bound by its 4*B*T*n*F operations (about
//    2 GFLOP at the shape above, 30 us at 67 TFLOP/s): the FFT does the same
//    function with some 28x fewer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// 2. the direct DFT
// ---------------------------------------------------------------------------

constexpr int TT = 64;       // frames per block
constexpr int FT = 64;       // frequencies per block
constexpr int KC = 32;       // basis rows per shared-memory slab
constexpr int THREADS = 256; // 32 frequency lanes x 8 frame groups
constexpr int FPT = TT / (THREADS / 32);  // frames per thread (8)
constexpr int QPT = FT / 32;              // frequencies per thread (2)

__global__ void __launch_bounds__(THREADS)
stft_dft_kernel(const float* __restrict__ pcm, int N,
                const float* __restrict__ cosb,
                const float* __restrict__ sinb,
                float* __restrict__ out, int T, int F, int n_fft, int hop,
                int span) {
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

// ---------------------------------------------------------------------------
// 1. the real-input FFT
// ---------------------------------------------------------------------------

constexpr int FFT_THREADS = 256;
constexpr int MAX_PASSES = 16;
constexpr int MAX_FR = 16;   // frames per run (fewer where n is large)
constexpr int LG_MAX_FR = 4;

struct FftArgs {
  const float* pcm;     // (B, N)
  const float* window;  // (n)
  const float2* tw;     // (M): W_M^t
  const float2* tws;    // (M/2 + 1): W_n^k
  float* out;           // (B, T, M + 1)
  int N, T, hop, M, fr, lg_fr, S, span, stage, runs_per_utt, runs, npass;
  int radix[MAX_PASSES];
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// in-place forward DFT of R points, X[s] = sum_r v[r] exp(-2 pi i r s / R)
template <int R> __device__ __forceinline__ void dft(float2* v);

template <> __device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <> __device__ __forceinline__ void dft<4>(float2* v) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);   // t1 - i (v1 - v3)
  v[3] = csub(t1, t3);   // t1 + i (v1 - v3)
}

template <> __device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float H = 0.70710678118654752f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  // o[s] *= W_8^s
  o[1] = make_float2((o[1].x + o[1].y) * H, (o[1].y - o[1].x) * H);
  o[2] = mul_mi(o[2]);
  o[3] = make_float2((o[3].y - o[3].x) * H, -(o[3].x + o[3].y) * H);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    v[s] = cadd(e[s], o[s]);
    v[s + 4] = csub(e[s], o[s]);
  }
}

template <> __device__ __forceinline__ void dft<3>(float2* v) {
  constexpr float S3 = 0.86602540378443865f;  // sin(2 pi / 3)
  const float2 t = cadd(v[1], v[2]), d = csub(v[1], v[2]);
  const float2 m = make_float2(fmaf(-0.5f, t.x, v[0].x),
                               fmaf(-0.5f, t.y, v[0].y));
  const float2 sd = make_float2(S3 * d.x, S3 * d.y);
  v[0] = cadd(v[0], t);
  v[1] = cadd(m, mul_mi(sd));   // m - i s d
  v[2] = csub(m, mul_mi(sd));   // m + i s d
}

template <> __device__ __forceinline__ void dft<5>(float2* v) {
  constexpr float C1 = 0.30901699437494742f;   // cos(2 pi / 5)
  constexpr float C2 = -0.80901699437494742f;  // cos(4 pi / 5)
  constexpr float S1 = 0.95105651629515357f;   // sin(2 pi / 5)
  constexpr float S2 = 0.58778525229247313f;   // sin(4 pi / 5)
  const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const float2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 a1 = make_float2(fmaf(C2, t2.x, fmaf(C1, t1.x, x0.x)),
                                fmaf(C2, t2.y, fmaf(C1, t1.y, x0.y)));
  const float2 a2 = make_float2(fmaf(C1, t2.x, fmaf(C2, t1.x, x0.x)),
                                fmaf(C1, t2.y, fmaf(C2, t1.y, x0.y)));
  const float2 b1 = make_float2(fmaf(S2, d2.x, S1 * d1.x),
                                fmaf(S2, d2.y, S1 * d1.y));
  const float2 b2 = make_float2(fmaf(-S1, d2.x, S2 * d1.x),
                                fmaf(-S1, d2.y, S2 * d1.y));
  v[0] = cadd(x0, cadd(t1, t2));
  v[1] = cadd(a1, mul_mi(b1));   // a1 - i b1
  v[4] = csub(a1, mul_mi(b1));
  v[2] = cadd(a2, mul_mi(b2));
  v[3] = csub(a2, mul_mi(b2));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// a / d for 0 <= a < 2^22 from inv = 1.f / d (d >= 1): the quotient
// (a + 0.5) / d lies at least 0.5 / d from an integer, and the two roundings
// move it by at most (a + 0.5) / d * 2^-23, less than that
__device__ __forceinline__ int fdiv(int a, float inv) {
  return (int)(((float)a + 0.5f) * inv);
}

// run -> (utterance, first frame, row-relative first sample); `sh` is the
// first sample's offset in its 16-byte chunk, where the staged copy starts
__device__ __forceinline__ void run_geom(const FftArgs& a, int run, int& b,
                                         int& t0, long long& g0, int& sh) {
  b = run / a.runs_per_utt;
  t0 = (run - b * a.runs_per_utt) * a.fr;
  g0 = (long long)t0 * a.hop;
  const float* p = a.pcm + (size_t)b * a.N + g0;
  sh = (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// issue the cp.async copies of one run's samples into xs: xs[sh + i] =
// pcm[b, g0 + i] for i < span (zero at and past N). The wrapper keeps pcm
// 16-byte aligned, so every chunk lies at or after the row of utterance 0.
__device__ __forceinline__ void stage_run(const FftArgs& a, int run,
                                          float* xs) {
  int b, t0, sh;
  long long g0;
  run_geom(a, run, b, t0, g0, sh);
  const float* row = a.pcm + (size_t)b * a.N;
  const long long c0 = g0 - sh;
  const int nch = (sh + a.span + 3) >> 2;
  for (int v = threadIdx.x; v < nch; v += FFT_THREADS) {
    const long long c = c0 + 4 * v;
    const long long left = (long long)a.N - c;
    const int valid = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
    cp_async16(xs + 4 * v, valid ? row + c : a.pcm, 4 * valid);
  }
}

// The transform's geometry: compile-time for the specialised plan (kM > 0:
// M = kM, MAX_FR frames per run), else read from the arguments. With it
// constant, every index, loop bound and quotient below folds at compile time.
template <int kM> struct Geo {
  int M, fr, lg_fr, S;
  __device__ __forceinline__ explicit Geo(const FftArgs& a)
      : M(kM ? kM : a.M),
        fr(kM ? MAX_FR : a.fr),
        lg_fr(kM ? LG_MAX_FR : a.lg_fr),
        S((kM ? MAX_FR : a.fr) + 1) {}
};

// first pass (no twiddles): z[m] = (x[2m] w[2m], x[2m+1] w[2m+1]) of each
// frame from the staged samples; threads over the butterflies of a frame
template <int R, int kM>
__device__ __forceinline__ void first_pass(const FftArgs& a,
                                           const Geo<kM>& g,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ win,
                                           float2* __restrict__ out) {
  const int Q = g.M / R;
  const float inv_q = 1.f / Q;
  const int tasks = g.fr * Q;
#pragma unroll
  for (int t = threadIdx.x; t < tasks; t += FFT_THREADS) {
    const int f = kM ? t / Q : fdiv(t, inv_q), j = t - f * Q;
    const float* xf = xs + f * a.hop;
    const bool even = (reinterpret_cast<uintptr_t>(xf) & 7) == 0;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = j + r * Q;
      const float2 w = reinterpret_cast<const float2*>(win)[m];
      const float2 x = even ? reinterpret_cast<const float2*>(xf)[m]
                            : make_float2(xf[2 * m], xf[2 * m + 1]);
      v[r] = make_float2(x.x * w.x, x.y * w.y);
    }
    dft<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) out[(j * R + r) * g.S + f] = v[r];
  }
}

// Stockham pass after Ns points are done (kNs, or ns where kNs is 0):
// threads over frames
template <int R, int kM, int kNs>
__device__ __forceinline__ void fft_pass(const Geo<kM>& g,
                                         const float2* __restrict__ in,
                                         float2* __restrict__ out,
                                         const float2* __restrict__ tw,
                                         int ns) {
  const int Ns = kNs ? kNs : ns;
  const int Q = g.M / R;
  const int stride = g.M / (Ns * R);
  const float inv_ns = 1.f / Ns;
  const int tasks = g.fr * Q;
#pragma unroll
  for (int t = threadIdx.x; t < tasks; t += FFT_THREADS) {
    const int f = t & (g.fr - 1), j = t >> g.lg_fr;
    const int k = kNs ? j % Ns : j - Ns * fdiv(j, inv_ns);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[(j + r * Q) * g.S + f];
    const int step = k * stride;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * step]);
    dft<R>(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[(base + r * Ns) * g.S + f] = v[r];
  }
}

// the real-input split of the run's frames from Z (`in`): warps over frames,
// lanes over the bin pairs (k, M - k); log1p(m) as the hardware log2 of
// 1 + m times ln 2 (the rounding of 1 + m moves the log by at most 6e-8,
// lg2.approx by at most ~1e-6 for m < 100)
template <int kM>
__device__ __forceinline__ void real_split(const FftArgs& a,
                                           const Geo<kM>& g,
                                           const float2* __restrict__ in,
                                           const float2* __restrict__ tws,
                                           int b, int t0) {
  const int P = g.M / 2 + 1, F = g.M + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int f = warp; f < g.fr; f += FFT_THREADS / 32) {
    if (t0 + f >= a.T) break;
    float* o_f = a.out + ((size_t)b * a.T + t0 + f) * F;
#pragma unroll
    for (int k = lane; k < P; k += 32) {
      const int km = k == 0 ? 0 : g.M - k;
      const float2 zk = in[k * g.S + f], zm = in[km * g.S + f];
      const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
      const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
      const float2 wo = cmul(tws[k], o);
      const float2 x1 = cadd(e, wo), x2 = csub(e, wo);
      o_f[k] = __logf(1.f + sqrtf(fmaf(x1.x, x1.x, x1.y * x1.y)));
      if (g.M - k != k)
        o_f[g.M - k] = __logf(1.f + sqrtf(fmaf(x2.x, x2.x, x2.y * x2.y)));
    }
  }
}

// kM = 0: any plan, read from the arguments; kM > 0: the plan (R0, R1, R2)
// of M = kM points, fixed at compile time
template <int kM, int R0, int R1, int R2>
__global__ void __launch_bounds__(FFT_THREADS)
stft_fft_kernel(const __grid_constant__ FftArgs a) {
  extern __shared__ __align__(16) float fsm[];
  const Geo<kM> g(a);
  float* xs[2] = {fsm, fsm + a.stage};
  float2* bufA = reinterpret_cast<float2*>(fsm + 2 * a.stage);
  float2* bufB = bufA + g.M * g.S;
  float2* tw = bufB + g.M * g.S;
  float2* tws = tw + g.M;
  float* win = reinterpret_cast<float*>(tws + g.M / 2 + 1);

  // the tables ride in the first run's copy group
  for (int i = threadIdx.x; i < g.M; i += FFT_THREADS)
    cp_async8(tw + i, a.tw + i);
  for (int i = threadIdx.x; i < g.M / 2 + 1; i += FFT_THREADS)
    cp_async8(tws + i, a.tws + i);
  for (int i = threadIdx.x; i < g.M; i += FFT_THREADS)
    cp_async8(win + 2 * i, a.window + 2 * i);
  int run = blockIdx.x;
  if (run < a.runs) stage_run(a, run, xs[0]);
  cp_async_commit();
  for (int it = 0; run < a.runs; run += gridDim.x, ++it) {
    // the next run's samples go into the other buffer, whose last reader
    // (the previous run's first pass) is behind a barrier
    const int next = run + gridDim.x;
    if (next < a.runs) stage_run(a, next, xs[(it + 1) & 1]);
    cp_async_commit();
    cp_async_wait_one();     // this run's copies have landed
    __syncthreads();

    int b, t0, sh;
    long long g0;
    run_geom(a, run, b, t0, g0, sh);
    const float* x = xs[it & 1] + sh;
    float2* in = bufA;
    if constexpr (kM > 0) {
      first_pass<R0>(a, g, x, win, bufA);
      __syncthreads();
      fft_pass<R1, kM, R0>(g, bufA, bufB, tw, 0);
      __syncthreads();
      fft_pass<R2, kM, R0 * R1>(g, bufB, bufA, tw, 0);
    } else {
      switch (a.radix[0]) {
        case 2: first_pass<2>(a, g, x, win, bufA); break;
        case 3: first_pass<3>(a, g, x, win, bufA); break;
        case 4: first_pass<4>(a, g, x, win, bufA); break;
        case 5: first_pass<5>(a, g, x, win, bufA); break;
        default: first_pass<8>(a, g, x, win, bufA); break;
      }
      float2* out = bufB;
      int Ns = a.radix[0];
      for (int p = 1; p < a.npass; ++p) {
        __syncthreads();
        switch (a.radix[p]) {
          case 2: fft_pass<2, 0, 0>(g, in, out, tw, Ns); break;
          case 3: fft_pass<3, 0, 0>(g, in, out, tw, Ns); break;
          case 4: fft_pass<4, 0, 0>(g, in, out, tw, Ns); break;
          case 5: fft_pass<5, 0, 0>(g, in, out, tw, Ns); break;
          default: fft_pass<8, 0, 0>(g, in, out, tw, Ns); break;
        }
        Ns *= a.radix[p];
        float2* tmp = in;
        in = out;
        out = tmp;
      }
    }
    __syncthreads();
    real_split(a, g, in, tws, b, t0);
  }
}

// shared memory of the FFT kernel for `fr` frames per run
size_t fft_smem(int M, int hop, int fr, int* span, int* stage) {
  *span = (fr - 1) * hop + 2 * M;
  *stage = 4 * ((*span + 6) / 4);   // sh <= 3 and whole 16-byte chunks
  return sizeof(float) * (2 * (size_t)*stage + 2 * M) +
         sizeof(float2) * (2 * (size_t)M * (fr + 1) + M + M / 2 + 1);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The direct DFT. pcm (B, N) f32, cosb/sinb (n_fft, F) f32, out (B, T, F)
// f32; frame t reads pcm[b, t*hop : t*hop + n_fft] (zeros past N).
extern "C" int stft_logmag_dft_f32(const void* pcm, const void* cosb,
                                   const void* sinb, void* out, int B, int N,
                                   int T, int F, int n_fft, int hop,
                                   void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int span = (TT - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (size_t)(span + 2 * KC * FT);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stft_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + TT - 1) / TT, (F + FT - 1) / FT, B);
  stft_dft_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pcm, N, (const float*)cosb, (const float*)sinb,
      (float*)out, T, F, n_fft, hop, span);
  return cudaGetLastError();
}

// The FFT. pcm (B, N) f32, 16-byte aligned; window (n_fft) f32; tw (M, 2),
// tws (M/2 + 1, 2) f32 twiddles; out (B, T, M + 1) f32; M = n_fft / 2.
// `plan` holds the radices (2, 3, 4, 5 or 8) of the passes in order, four
// bits each from the lowest, ending at the first 0; their product must be M.
extern "C" int stft_logmag_fft_f32(const void* pcm, const void* window,
                                   const void* tw, const void* tws, void* out,
                                   int B, int N, int T, int n_fft, int hop,
                                   unsigned long long plan, void* stream) {
  cudaGetLastError();
  FftArgs a;
  a.M = n_fft / 2;
  a.npass = 0;
  long long prod = 1;
  for (; a.npass < MAX_PASSES && ((plan >> (4 * a.npass)) & 15); ++a.npass) {
    const int r = (int)((plan >> (4 * a.npass)) & 15);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8)
      return cudaErrorInvalidValue;
    a.radix[a.npass] = r;
    prod *= r;
  }
  if (n_fft % 2 || a.npass == 0 || prod != a.M || hop < 1 || N < 0 ||
      (reinterpret_cast<uintptr_t>(pcm) & 15))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  int fr = MAX_FR, span = 0, stage = 0;
  size_t smem = fft_smem(a.M, hop, fr, &span, &stage);
  while (smem > 227 * 1024 && fr > 1) {
    fr /= 2;
    smem = fft_smem(a.M, hop, fr, &span, &stage);
  }
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // the compile-time plan of the main path's n_fft = 320, else any plan
  const bool fixed = fr == MAX_FR && a.M == 160 && a.npass == 3 &&
                     a.radix[0] == 5 && a.radix[1] == 8 && a.radix[2] == 4;
  void (*kernel)(const FftArgs) = fixed ? stft_fft_kernel<160, 5, 8, 4>
                                        : stft_fft_kernel<0, 0, 0, 0>;
  static void (*set_kernel)(const FftArgs) = nullptr;  // last configured
  static size_t set_smem = 0;
  static int blocks_per_sm = 0, sms = 0;
  if (kernel != set_kernel || smem != set_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks_per_sm, kernel, FFT_THREADS, smem)) != cudaSuccess)
      return e;
    if (blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    set_kernel = kernel;
    set_smem = smem;
  }
  a.pcm = (const float*)pcm;
  a.window = (const float*)window;
  a.tw = (const float2*)tw;
  a.tws = (const float2*)tws;
  a.out = (float*)out;
  a.N = N;
  a.T = T;
  a.hop = hop;
  a.fr = fr;
  a.lg_fr = 0;
  while ((1 << a.lg_fr) < fr) ++a.lg_fr;
  a.S = fr + 1;
  a.span = span;
  a.stage = stage;
  a.runs_per_utt = (T + fr - 1) / fr;
  a.runs = B * a.runs_per_utt;
  const int grid = a.runs < blocks_per_sm * sms ? a.runs : blocks_per_sm * sms;
  kernel<<<grid, FFT_THREADS, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}
