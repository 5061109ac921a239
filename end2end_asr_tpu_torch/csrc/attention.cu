// The training attention with in-kernel dropout (kernels 4, 5 and 9 of the
// port):
//
//   out = dropout(softmax(q k^T / sqrt(dk) + bias)) @ v
//
// Replaces end2end_asr_tpu/ops/attention_fused.py: _kernels.fwd (forward),
// _kernels.bwd (backward) and the dropout_bits body. As there, nothing
// (Tq, Tk)-sized reaches device memory: the forward streams key tiles with
// an online softmax and keeps two f32 statistics per query row, the max m
// and the sum l of exp(x - m); the backward recomputes the probabilities
// from them and regenerates the same dropout mask from the seed. (One
// log-sum-exp m + log l is not enough under the -1e9 mask: where every key
// of a row is masked, m is about -1e9, whose f32 spacing is 64, and log l
// <= log Tk vanishes in the sum.)
//
// ---------------------------------------------------------------------------
// SPEC of the dropout bits (shared with ops/attention_fused.py, whose
// philox_bits computes the same function in int64 tensor arithmetic):
//
//   bits[b, h, q, k] = word (k & 3) of
//       Philox4x32-10(counter = (k >> 2, q, h, b), key = (seed & 0xffffffff,
//                                                         seed >> 32))
//   keep[b, h, q, k] = bits[b, h, q, k] < thresh16 * 65536   (uint32)
//
// thresh16 = round((1 - rate) * 65536); rate 0 (thresh16 = 65536) draws
// nothing. Philox4x32-10 is Salmon et al.'s (SC'11, Random123): 10 rounds of
//   (hi0, lo0) = mulhilo(0xD2511F53, c0), (hi1, lo1) = mulhilo(0xCD9E8D57, c2)
//   c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
// with the key bumped by (0x9E3779B9, 0xBB67AE85) after each round.
// dropout_bits writes bits[b, h*Tq + q, k] for the (B, H*Tq, Tk) view.
// ---------------------------------------------------------------------------
//
// Layouts: q (B, H, Tq, D), k (B, H, Tk, D), v (B, H, Tk, D) in the compute
// type (bf16 or f32); bias (B, Tq, Tk) f32 (0 or -1e9, shared by the heads);
// out (B, H, Tq, D) in the compute type; stats (B, H, Tq, 2) f32 = (m, l) per
// row. D = 64.
//
// Numerics: scores x = (q.k) * (1/sqrt(dk)) + bias in f32, as the JAX
// kernel; keys past Tk are -inf (exactly no weight); a row whose real keys
// all carry -1e9 comes out uniform over them. The forward rounds the
// unnormalised probabilities exp(x - m) (dropped and scaled by
// 65536/thresh16) to the compute type for the P.V product (a no-op in f32)
// and divides by the f32 sum of the UNdropped terms at the end. The backward
// uses D_i = dO_i . O_i, dS = P o (keep * s * dO V^T - D), dQ = dS K /
// sqrt(dk), dK = dS^T Q / sqrt(dk), dV = (keep * s * P)^T dO: the JAX
// kernel's algebra (attention_fused.py:108-134) with P = exp(x - m) / l
// rebuilt.
//
// What bounds it on the H100: at the flagship (B = 12, H = 8, T = 200,
// dk = 64) one encoder layer is ~1 GFLOP forward and ~2.5 backward (about
// 1 and 3 us on the bf16 tensor cores, 15 and 37 us on f32 FMA) and reads
// ~9 MB in bf16, ~17 MB in f32 (~3 and ~5 us): launch cost, not the card,
// bounds the bf16 kernels; f32 FMA bounds the f32 ones. The design keeps it
// simple: one block of 4 warps per (b, h, 64-query tile) in the forward,
// each warp owning 16 query rows. The kernels are templates over the compute
// type and share staging, the softmax, the dropout and the epilogues; only
// the two products differ, and both keep the accumulators in the m16n8
// layout of mma.sync (lane holds rows lane/4 and lane/4 + 8, columns
// 2 (lane % 4) + {0, 1} of each 8-column tile):
//   * bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate) for q.k^T and P.v
//     with ldmatrix from XOR-swizzled shared tiles; the A operand lives in
//     registers and the P tile goes from the accumulator registers straight
//     into the A operand of P.v;
//   * f32: FMA, in f32 throughout (no TF32, no tensor cores): tiles padded
//     to 68 floats a row (float4 reads from 8 rows hit distinct banks); the
//     A operand stays in shared memory, and P goes through a per-warp
//     16 x 64 shared scratch so each lane can read its rows whole. Each
//     product sums over d (or k) in order.
// The backward is deterministic: kernel A computes D, kernel B loops over
// query tiles for one key tile (dK, dV: each warp owns 16 keys), kernel C
// over key tiles for one query tile (dQ); no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;          // head width
constexpr int TILE = 64;       // queries per block / keys per tile
constexpr int WARPS = 4;       // 16 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int LDF = D + 4;     // f32 tile row stride (floats)

struct U4 {
  uint32_t w[4];
};

__device__ __forceinline__ U4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                     uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  U4 r;
  r.w[0] = c0;
  r.w[1] = c1;
  r.w[2] = c2;
  r.w[3] = c3;
  return r;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core fragments
// ---------------------------------------------------------------------------

// Offset (in bf16 elements) of 16-byte chunk `ch` of row `row` of a
// [rows][64] bf16 tile whose chunks are XOR-swizzled by row.
__device__ __forceinline__ int swz(int row, int ch) {
  return row * D + ((ch ^ (row & 7)) << 3);
}

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

__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// per compute type: tiles, the A operand, the two products, stores
// ---------------------------------------------------------------------------

template <typename T> struct Cdt;

template <> struct Cdt<bf16> {
  static constexpr int TILE_ELEMS = TILE * D;   // swizzled, unpadded
  static constexpr bool A_IN_SMEM = false;      // A lives in registers
  static constexpr int SCRATCH = 0;             // floats of P scratch
  struct AFrag {
    uint32_t r[4][4];  // r[kc]: k-step kc (columns 16kc .. 16kc+15)
  };

  // rows row0 .. row0+63 of a (T, 64) matrix into a swizzled tile; rows at
  // or past Tn are zero
  static __device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                                   int row0, int Tn,
                                                   int tid) {
    for (int e = tid; e < TILE * 8; e += THREADS) {
      const int r = e >> 3, ch = e & 7;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < Tn)
        v = reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D)[ch];
      *reinterpret_cast<uint4*>(s + swz(r, ch)) = v;
    }
  }

  // A operand (16 rows x 64) of a warp, rows r0 .. r0+15 of a tile
  static __device__ __forceinline__ void load_a(AFrag& a, const bf16* s,
                                                int r0, int lane) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldsm_x4(s + swz(r0 + (lane & 15), 2 * kc + (lane >> 4)), a.r[kc]);
  }

  // acc[n] (16 x 64: 8 n-tiles) += A (16 x 64) . B^T where B's rows are the
  // 64 rows of a tile (the "col" operand, no transpose)
  static __device__ __forceinline__ void mma_abt(float (*acc)[4],
                                                 const AFrag& a,
                                                 const bf16* s, int lane) {
    const int bn = ((lane >> 4) << 3) + (lane & 7), bkc = (lane >> 3) & 1;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(s + swz(np * 16 + bn, 2 * kc + bkc), b);
        mma(acc[2 * np], a.r[kc], b[0], b[1]);
        mma(acc[2 * np + 1], a.r[kc], b[2], b[3]);
      }
  }

  // acc[n] (16 x 64) += P (16 x 64, accumulator layout, as bf16) . S where S
  // is a 64 x 64 tile (rows = the k dimension): ldmatrix.trans
  static __device__ __forceinline__ void mma_ps(float (*acc)[4],
                                                const float (*p)[4],
                                                const bf16* s, int lane,
                                                float*) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      a[0] = pack(p[2 * j][0], p[2 * j][1]);
      a[1] = pack(p[2 * j][2], p[2 * j][3]);
      a[2] = pack(p[2 * j + 1][0], p[2 * j + 1][1]);
      a[3] = pack(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(s + swz(16 * j + (lane & 15), 2 * np + (lane >> 4)), b);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  static __device__ __forceinline__ float2 ld2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack(a, b);
  }
};

template <> struct Cdt<float> {
  static constexpr int TILE_ELEMS = TILE * LDF;  // rows padded to 68 floats
  static constexpr bool A_IN_SMEM = true;
  static constexpr int SCRATCH = WARPS * 16 * LDF;
  struct AFrag {
    const float* s;    // the warp's 16 rows in a shared tile
  };

  static __device__ __forceinline__ void load_tile(float* s, const float* g,
                                                   int row0, int Tn,
                                                   int tid) {
    for (int e = tid; e < TILE * (D / 4); e += THREADS) {
      const int r = e >> 4, ch = e & 15;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < Tn)
        v = reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * D)[ch];
      *reinterpret_cast<float4*>(s + r * LDF + 4 * ch) = v;
    }
  }

  static __device__ __forceinline__ void load_a(AFrag& a, const float* s,
                                                int r0, int) {
    a.s = s + r0 * LDF;
  }

  // acc[n][i] += sum_d A[row_i][d] B[col][d], d in order
  static __device__ __forceinline__ void mma_abt(float (*acc)[4],
                                                 const AFrag& a,
                                                 const float* s, int lane) {
    const float* a0 = a.s + (lane >> 2) * LDF;
    const float* a1 = a0 + 8 * LDF;
    const float* b0 = s + 2 * (lane & 3) * LDF;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 y =
              *reinterpret_cast<const float4*>(b0 + (n * 8 + j) * LDF + d);
          float u = acc[n][j], w = acc[n][2 + j];
          u = fmaf(x0.x, y.x, u); w = fmaf(x1.x, y.x, w);
          u = fmaf(x0.y, y.y, u); w = fmaf(x1.y, y.y, w);
          u = fmaf(x0.z, y.z, u); w = fmaf(x1.z, y.z, w);
          u = fmaf(x0.w, y.w, u); w = fmaf(x1.w, y.w, w);
          acc[n][j] = u;
          acc[n][2 + j] = w;
        }
    }
  }

  // acc[n][i] += sum_k P[row_i][k] S[k][col], k in order; P goes through the
  // warp's scratch pw (16 x LDF floats)
  static __device__ __forceinline__ void mma_ps(float (*acc)[4],
                                                const float (*p)[4],
                                                const float* s, int lane,
                                                float* pw) {
    const int r0 = lane >> 2, c0 = 2 * (lane & 3);
    __syncwarp();  // the previous product's reads of pw are done
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(pw + r0 * LDF + n * 8 + c0) =
          make_float2(p[n][0], p[n][1]);
      *reinterpret_cast<float2*>(pw + (r0 + 8) * LDF + n * 8 + c0) =
          make_float2(p[n][2], p[n][3]);
    }
    __syncwarp();
    const float* p0 = pw + r0 * LDF;
    const float* p1 = p0 + 8 * LDF;
#pragma unroll 2
    for (int k = 0; k < TILE; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(p0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(p1 + k);
      const float a0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* srow = s + (k + kk) * LDF + c0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(srow + n * 8);
          acc[n][0] = fmaf(a0[kk], y.x, acc[n][0]);
          acc[n][1] = fmaf(a0[kk], y.y, acc[n][1]);
          acc[n][2] = fmaf(a1[kk], y.x, acc[n][2]);
          acc[n][3] = fmaf(a1[kk], y.y, acc[n][3]);
        }
      }
    }
  }

  static __device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// dynamic shared memory of the three tiled kernels: the forward holds Q, K,
// V tiles; the backward kernels two B tiles, plus their two A tiles where
// the A operand stays in shared memory; plus the P scratch
template <typename T> constexpr size_t fwd_smem() {
  return 3 * Cdt<T>::TILE_ELEMS * sizeof(T) + Cdt<T>::SCRATCH * 4;
}
template <typename T> constexpr size_t bwd_smem() {
  return (Cdt<T>::A_IN_SMEM ? 4 : 2) * Cdt<T>::TILE_ELEMS * sizeof(T) +
         Cdt<T>::SCRATCH * 4;
}

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

template <typename T> struct Params {
  const T *q, *k, *v, *o, *g;
  const float *bias, *stats, *delta;
  int H, Tq, Tk;
  uint32_t thresh32;  // keep below this; 0 = no dropout
  float keep_scale, scale;
  uint32_t k0, k1;
};

// keep flags of the two adjacent keys key, key+1 (key even) of query q
template <typename T>
__device__ __forceinline__ void keep_pair(const Params<T>& p, int b, int h,
                                          int q, int key, bool& k0,
                                          bool& k1) {
  const U4 r = philox((uint32_t)key >> 2, q, h, b, p.k0, p.k1);
  const int w = key & 3;
  k0 = r.w[w] < p.thresh32;
  k1 = r.w[w + 1] < p.thresh32;
}

template <typename T>
__device__ __forceinline__ bool keep_one(const Params<T>& p, int b, int h,
                                         int q, int key) {
  const U4 r = philox((uint32_t)key >> 2, q, h, b, p.k0, p.k1);
  return r.w[key & 3] < p.thresh32;
}

template <typename T>
__device__ __forceinline__ float score(const Params<T>& p, float s, int b,
                                       int q, int key) {
  if (key >= p.Tk) return -INFINITY;
  const float bias = q < p.Tq ? p.bias[((size_t)b * p.Tq + q) * p.Tk + key]
                              : 0.f;
  return s * p.scale + bias;
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, H, B)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(Params<T> p, T* __restrict__ out,
                float2* __restrict__ stats) {
  using C = Cdt<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + C::TILE_ELEMS;
  T* vs = ks + C::TILE_ELEMS;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pw = reinterpret_cast<float*>(vs + C::TILE_ELEMS) + warp * 16 * LDF;
  const size_t bh = (size_t)b * p.H + h;
  const T* qg = p.q + bh * p.Tq * D;
  const T* kg = p.k + bh * p.Tk * D;
  const T* vg = p.v + bh * p.Tk * D;

  C::load_tile(qs, qg, q0, p.Tq, tid);
  __syncthreads();
  typename C::AFrag qa;
  C::load_a(qa, qs, warp * 16, lane);

  const int rq[2] = {q0 + warp * 16 + (lane >> 2),
                     q0 + warp * 16 + (lane >> 2) + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4];
  zero(o);

  for (int k0 = 0; k0 < p.Tk; k0 += TILE) {
    __syncthreads();  // previous tile consumed
    C::load_tile(ks, kg, k0, p.Tk, tid);
    C::load_tile(vs, vg, k0, p.Tk, tid);
    __syncthreads();
    float s[8][4];
    zero(s);
    C::mma_abt(s, qa, ks, lane);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * (lane & 3) + (i & 1);
        s[n][i] = score(p, s[n][i], b, rq[i >> 1], key);
        tmax[i >> 1] = fmaxf(tmax[i >> 1], s[n][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mn = fmaxf(m[r], tmax[r]);  // finite: key k0 is real
      const float c = expf(m[r] - mn);
      l[r] *= c;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * r] *= c;
        o[n][2 * r + 1] *= c;
      }
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        l[i >> 1] += s[n][i];
      }
      if (p.thresh32) {
        const int key = k0 + n * 8 + 2 * (lane & 3);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool ka, kb;
          keep_pair(p, b, h, rq[r], key, ka, kb);
          s[n][2 * r] = ka ? s[n][2 * r] * p.keep_scale : 0.f;
          s[n][2 * r + 1] = kb ? s[n][2 * r + 1] * p.keep_scale : 0.f;
        }
      }
    }
    C::mma_ps(o, s, vs, lane, pw);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rq[r] >= p.Tq) continue;
    const float inv = 1.f / l[r];
    T* og = out + (bh * p.Tq + rq[r]) * D;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      C::st2(og + n * 8 + 2 * (lane & 3), o[n][2 * r] * inv,
             o[n][2 * r + 1] * inv);
    if ((lane & 3) == 0) stats[bh * p.Tq + rq[r]] = make_float2(m[r], l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward A: delta = rowsum(dO o O), one thread per query row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void attn_delta_kernel(const T* __restrict__ o,
                                  const T* __restrict__ g,
                                  float* __restrict__ delta, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* a = o + (size_t)r * D;
  const T* c = g + (size_t)r * D;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < D / 2; ++i) {
    const float2 x = Cdt<T>::ld2(a + 2 * i), y = Cdt<T>::ld2(c + 2 * i);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  delta[r] = acc;
}

// ---------------------------------------------------------------------------
// backward B: dK, dV for one key tile; grid (key tiles, H, B). Each warp owns
// 16 keys (rows of S^T); the block walks the query tiles.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_dkdv_kernel(Params<T> p, T* __restrict__ dk, T* __restrict__ dv) {
  using C = Cdt<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float ms[TILE], linv[TILE], dels[TILE];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + C::TILE_ELEMS;
  // the K and V tiles (A operands): their own where A stays in shared
  // memory, else staged through qs / gs into registers
  T* kt = C::A_IN_SMEM ? gs + C::TILE_ELEMS : qs;
  T* vt = C::A_IN_SMEM ? gs + 2 * C::TILE_ELEMS : gs;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pw = reinterpret_cast<float*>(
                  qs + (C::A_IN_SMEM ? 4 : 2) * C::TILE_ELEMS) +
              warp * 16 * LDF;
  const size_t bh = (size_t)b * p.H + h;

  typename C::AFrag ka, va;
  C::load_tile(kt, p.k + bh * p.Tk * D, k0, p.Tk, tid);
  C::load_tile(vt, p.v + bh * p.Tk * D, k0, p.Tk, tid);
  __syncthreads();
  C::load_a(ka, kt, warp * 16, lane);
  C::load_a(va, vt, warp * 16, lane);

  const int rk[2] = {k0 + warp * 16 + (lane >> 2),
                     k0 + warp * 16 + (lane >> 2) + 8};
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);

  for (int q0 = 0; q0 < p.Tq; q0 += TILE) {
    __syncthreads();  // previous tiles consumed
    C::load_tile(qs, p.q + bh * p.Tq * D, q0, p.Tq, tid);
    C::load_tile(gs, p.g + bh * p.Tq * D, q0, p.Tq, tid);
    if (tid < TILE) {
      const bool in = q0 + tid < p.Tq;
      const float2 st = in ? reinterpret_cast<const float2*>(
                                 p.stats)[bh * p.Tq + q0 + tid]
                           : make_float2(INFINITY, 1.f);
      ms[tid] = st.x;
      linv[tid] = in ? 1.f / st.y : 0.f;
      dels[tid] = in ? p.delta[bh * p.Tq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float st[8][4], dp[8][4];
    zero(st);
    zero(dp);
    C::mma_abt(st, ka, qs, lane);  // S^T: keys x queries
    C::mma_abt(dp, va, gs, lane);  // (dO V^T)^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = n * 8 + 2 * (lane & 3) + (i & 1);
        const int key = rk[i >> 1];
        const float x = key < p.Tk ? score(p, st[n][i], b, q0 + ql, key)
                                   : -INFINITY;
        const float pr = expf(x - ms[ql]) * linv[ql];
        float kp = p.keep_scale;  // keep * 65536/thresh16 (1 at rate 0)
        if (p.thresh32 && !(key < p.Tk && q0 + ql < p.Tq &&
                            keep_one(p, b, h, q0 + ql, key)))
          kp = 0.f;
        st[n][i] = pr * kp;                           // dropped P^T
        dp[n][i] = pr * (dp[n][i] * kp - dels[ql]);   // dS^T
      }
    C::mma_ps(dva, st, gs, lane, pw);  // dV += Pd^T dO
    C::mma_ps(dka, dp, qs, lane, pw);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rk[r] >= p.Tk) continue;
    T* kg = dk + (bh * p.Tk + rk[r]) * D;
    T* vg = dv + (bh * p.Tk + rk[r]) * D;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * (lane & 3);
      C::st2(kg + c, dka[n][2 * r] * p.scale, dka[n][2 * r + 1] * p.scale);
      C::st2(vg + c, dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward C: dQ for one query tile; grid (query tiles, H, B)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_dq_kernel(Params<T> p, T* __restrict__ dq) {
  using C = Cdt<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + C::TILE_ELEMS;
  T* qt = C::A_IN_SMEM ? vs + C::TILE_ELEMS : ks;
  T* gt = C::A_IN_SMEM ? vs + 2 * C::TILE_ELEMS : vs;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pw = reinterpret_cast<float*>(
                  ks + (C::A_IN_SMEM ? 4 : 2) * C::TILE_ELEMS) +
              warp * 16 * LDF;
  const size_t bh = (size_t)b * p.H + h;

  typename C::AFrag qa, ga;
  C::load_tile(qt, p.q + bh * p.Tq * D, q0, p.Tq, tid);
  C::load_tile(gt, p.g + bh * p.Tq * D, q0, p.Tq, tid);
  __syncthreads();
  C::load_a(qa, qt, warp * 16, lane);
  C::load_a(ga, gt, warp * 16, lane);

  const int rq[2] = {q0 + warp * 16 + (lane >> 2),
                     q0 + warp * 16 + (lane >> 2) + 8};
  float mr[2], li[2], de[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rq[r] < p.Tq;
    const float2 st = in ? reinterpret_cast<const float2*>(
                               p.stats)[bh * p.Tq + rq[r]]
                         : make_float2(INFINITY, 1.f);
    mr[r] = st.x;
    li[r] = in ? 1.f / st.y : 0.f;
    de[r] = in ? p.delta[bh * p.Tq + rq[r]] : 0.f;
  }
  float dqa[8][4];
  zero(dqa);

  for (int k0 = 0; k0 < p.Tk; k0 += TILE) {
    __syncthreads();
    C::load_tile(ks, p.k + bh * p.Tk * D, k0, p.Tk, tid);
    C::load_tile(vs, p.v + bh * p.Tk * D, k0, p.Tk, tid);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    C::mma_abt(s, qa, ks, lane);   // S
    C::mma_abt(dp, ga, vs, lane);  // dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = k0 + n * 8 + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool kp[2] = {true, true};
        if (p.thresh32 && rq[r] < p.Tq) keep_pair(p, b, h, rq[r], key,
                                                  kp[0], kp[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 2 * r + j;
          const float pr =
              expf(score(p, s[n][i], b, rq[r], key + j) - mr[r]) * li[r];
          const float ks_ = kp[j] ? p.keep_scale : 0.f;
          s[n][i] = pr * (dp[n][i] * ks_ - de[r]);  // dS
        }
      }
    }
    C::mma_ps(dqa, s, ks, lane, pw);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rq[r] >= p.Tq) continue;
    T* qg = dq + (bh * p.Tq + rq[r]) * D;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      C::st2(qg + n * 8 + 2 * (lane & 3), dqa[n][2 * r] * p.scale,
             dqa[n][2 * r + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// kernel 9: the bits themselves, (B, H*Tq, Tk) uint32
// ---------------------------------------------------------------------------

__global__ void dropout_bits_kernel(uint32_t* __restrict__ out, int B, int H,
                                    int Tq, int Tk, uint32_t k0,
                                    uint32_t k1) {
  const int kw = (Tk + 3) / 4;
  const size_t n = (size_t)B * H * Tq * kw;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = e % kw;
    const size_t row = e / kw;  // (b, h, q)
    const int q = row % Tq, h = (row / Tq) % H, b = row / ((size_t)Tq * H);
    const U4 r = philox(c, q, h, b, k0, k1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * c + j < Tk) out[row * Tk + 4 * c + j] = r.w[j];
  }
}

template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v,
                      const void* bias, int H, int Tq, int Tk, int thresh16,
                      unsigned long long seed) {
  Params<T> p;
  p.q = (const T*)q;
  p.k = (const T*)k;
  p.v = (const T*)v;
  p.o = p.g = nullptr;
  p.bias = (const float*)bias;
  p.stats = p.delta = nullptr;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  const bool drop = thresh16 > 0 && thresh16 < 65536;
  p.thresh32 = drop ? (uint32_t)thresh16 << 16 : 0u;
  p.keep_scale = drop ? 65536.f / (float)thresh16 : 1.f;
  p.scale = 1.f / sqrtf((float)D);
  p.k0 = (uint32_t)(seed & 0xffffffffull);
  p.k1 = (uint32_t)(seed >> 32);
  return p;
}

template <typename T>
int attn_fwd(const void* q, const void* k, const void* v, const void* bias,
             void* out, void* stats, int B, int H, int Tq, int Tk, int d,
             int thresh16, unsigned long long seed, void* stream) {
  cudaGetLastError();  // report only this call's error
  if (d != D || thresh16 <= 0 || Tk < 1) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return cudaSuccess;
  constexpr size_t smem = fwd_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const Params<T> p =
      make_params<T>(q, k, v, bias, H, Tq, Tk, thresh16, seed);
  dim3 grid((Tq + TILE - 1) / TILE, H, B);
  attn_fwd_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      p, (T*)out, (float2*)stats);
  return cudaGetLastError();
}

template <typename T>
int attn_bwd(const void* q, const void* k, const void* v, const void* bias,
             const void* out, const void* stats, const void* g, void* dq,
             void* dk, void* dv, int B, int H, int Tq, int Tk, int d,
             int thresh16, unsigned long long seed, void* delta,
             void* stream) {
  cudaGetLastError();
  if (d != D || thresh16 <= 0 || Tk < 1) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return cudaSuccess;
  constexpr size_t smem = bwd_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  Params<T> p = make_params<T>(q, k, v, bias, H, Tq, Tk, thresh16, seed);
  p.o = (const T*)out;
  p.g = (const T*)g;
  p.stats = (const float*)stats;
  p.delta = (const float*)delta;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * H * Tq;
  attn_delta_kernel<T><<<(rows + 255) / 256, 256, 0, s>>>(
      p.o, p.g, (float*)delta, rows);
  attn_dkdv_kernel<T>
      <<<dim3((Tk + TILE - 1) / TILE, H, B), THREADS, smem, s>>>(
          p, (T*)dk, (T*)dv);
  attn_dq_kernel<T><<<dim3((Tq + TILE - 1) / TILE, H, B), THREADS, smem, s>>>(
      p, (T*)dq);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry point returns cudaGetLastError() after its launches; a D other
// than 64 or a thresh16 of 0 is refused (cudaErrorInvalidValue). The _bf16
// entries take bf16 q, k, v, out, g, dq, dk, dv; the _f32 entries f32 ones.
extern "C" int attn_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* stats, int B,
                             int H, int Tq, int Tk, int d, int thresh16,
                             unsigned long long seed, void* stream) {
  return attn_fwd<bf16>(q, k, v, bias, out, stats, B, H, Tq, Tk, d, thresh16,
                        seed, stream);
}

extern "C" int attn_fwd_f32(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* stats, int B,
                            int H, int Tq, int Tk, int d, int thresh16,
                            unsigned long long seed, void* stream) {
  return attn_fwd<float>(q, k, v, bias, out, stats, B, H, Tq, Tk, d, thresh16,
                         seed, stream);
}

// g = dL/d(out); delta: (B, H, Tq) f32 scratch
extern "C" int attn_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* bias, const void* out,
                             const void* stats, const void* g, void* dq,
                             void* dk, void* dv, int B, int H, int Tq, int Tk,
                             int d, int thresh16, unsigned long long seed,
                             void* delta, void* stream) {
  return attn_bwd<bf16>(q, k, v, bias, out, stats, g, dq, dk, dv, B, H, Tq,
                        Tk, d, thresh16, seed, delta, stream);
}

extern "C" int attn_bwd_f32(const void* q, const void* k, const void* v,
                            const void* bias, const void* out,
                            const void* stats, const void* g, void* dq,
                            void* dk, void* dv, int B, int H, int Tq, int Tk,
                            int d, int thresh16, unsigned long long seed,
                            void* delta, void* stream) {
  return attn_bwd<float>(q, k, v, bias, out, stats, g, dq, dk, dv, B, H, Tq,
                         Tk, d, thresh16, seed, delta, stream);
}

// out: (B, H*Tq, Tk) uint32
extern "C" int dropout_bits_u32(void* out, int B, int H, int Tq, int Tk,
                                unsigned long long seed, void* stream) {
  cudaGetLastError();
  const size_t n = (size_t)B * H * Tq * ((Tk + 3) / 4);
  if (n == 0) return cudaSuccess;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  dropout_bits_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, B, H, Tq, Tk, (uint32_t)(seed & 0xffffffffull),
      (uint32_t)(seed >> 32));
  return cudaGetLastError();
}
