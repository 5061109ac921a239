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
// Layouts: q (B, H, Tq, D), k and v (B, H, Tk, D), out and g (B, H, Tq, D)
// and the gradients are read and written through (batch, head, row)
// strides, so the (B, T, H, D) layout of the projections, transposed,
// needs no copy either way; rows are contiguous and 16-byte aligned; in
// the compute type (bf16 or f32). bias (B, Tq, Tk) f32 (0 or -1e9, shared
// by the heads); stats (B, H, Tq, 2) f32 = (m, l) per row. D = 64.
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
// rebuilt; the dropped P and dS are rounded to the compute type before
// their products, as there (1/sqrt(dk) = 1/8 is a power of two, so rounding
// dS or dS/8 is the same).
//
// What bounds it on the H100: at the flagship (B = 12, H = 8, T = 200,
// dk = 64) one encoder layer is ~1 GFLOP forward and ~2.5 backward (about
// 1 and 3 us on the bf16 tensor cores, 15 and 37 us on f32 FMA) and reads
// ~9 MB in bf16, ~17 MB in f32 (~3 and ~5 us): latency and issue slots,
// not the card's peaks, bound the bf16 kernels; f32 FMA bounds the f32
// ones. The kernels are templates over the compute type and share
// staging, the dropout and the epilogues; only the products differ, and all
// keep the accumulators in the m16n8 layout of mma.sync (lane holds rows
// lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1} of each 8-column
// tile):
//   * bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix from
//     XOR-swizzled shared tiles; the A operand lives in registers and a P
//     tile goes from the accumulator registers straight into the A operand
//     of the next product;
//   * f32: FMA, in f32 throughout (no TF32, no tensor cores): tiles padded
//     to 68 floats a row (float4 reads from 8 rows hit distinct banks); the
//     A operand stays in shared memory, and P goes through a per-warp
//     16 x 64 shared scratch so each lane can read its rows whole. Each
//     product sums over d (or k) in order.
//
// The forward (attn_fwd_kernel<T, WK>): a block of 4 warps takes QT = 64 /
// WK query rows of one (b, h) and walks the 64-key tiles; its warps are
// 4 / WK query groups of 16 rows times WK key groups, and key group wk
// takes keys 64 / WK * wk .. of every tile with its own online softmax
// (m, l, o in registers). With WK > 1 the groups' partial rows meet in
// shared memory after the loop and are added in group order (m the max of
// the groups', l and o rescaled to it). The wrapper takes WK = 1 where
// ceil(Tq / 64) blocks a (b, h) give every SM two blocks, else the
// smallest WK that does (else 4): at the decoder's Tq = 51, WK = 4 makes
// 384 blocks of 16 rows for 132 SMs instead of 96 of 64 rows. f32 keeps WK
// = 1: its FMA products, not latency, bound it. K, V and the bias tile of
// the next key tile come in by cp.async while the current one's products
// run (bf16: two stages; f32: one, which keeps three blocks an SM); key
// tiles and 16-key chunks past Tk, and warps whose 16 rows are past Tq,
// are skipped. The mask: one Philox call per four elements, each word
// used (keep_bits_fwd).
//
// The backward is one deterministic pass (attn_bwd_kernel), grid (key
// tiles, H, B), 8 warps a block. The keys are cut into 16-key chunks, and
// the chunks into ceil(chunks / 8) tiles as even as they come (Tk = 200:
// 13 chunks in tiles of 6 and 7; Tk = 51: one tile of 4); each warp owns
// one chunk, so a warp past Tk has no work until the dQ product. A block
// walks the 64-query tiles once: S^T = K Q^T and dP^T = V dO^T on the
// tensor cores, P rebuilt from the saved (m, l), the dropout mask and dS
// formed once per element, then dV += Pd^T dO and dK += dS^T Q in
// registers, and dS^T through shared memory (in the compute type) for this
// key tile's share of dQ = dS K, 16 queries x 32 columns a warp.
// D = rowsum(dO o O) is computed in the block for the query tile it holds.
// Products over 16-query chunks past Tq are skipped. The next query tile's
// Q, dO and bias tiles come in by cp.async while the current one's
// products run (bf16: two stages, 132 KB; f32 keeps one stage, 170 KB,
// whose copies overlap the dQ product only). Tiles of 128 keys, not 64,
// halve what every key tile reads again (Q, dO, bias, O) and the dQ shares.
// dQ's shares go to an f32 scratch (B, H, key tiles, Tq, 64); the last
// block of each (b, h) to arrive (an arrival counter behind __threadfence,
// reset by that block) adds them up in key-tile order, so two runs give the
// same bits. With one key tile (Tk <= 128) the block writes dQ itself. No
// atomics touch the data.
//
// The mask: the 4 words of one Philox call are keys 4c..4c+3 of one (q, h,
// b); in the S^T layout those are rows of 4 lanes (lane bits 2-3). Each
// lane draws one call per 8-query tile (its key group hh + 2 (wd >> 1),
// query 2 (lane % 4) + (wd & 1), wd = lane bits 2-3, hh = lane bit 4), and
// three __shfl_xor_sync rounds (lane ^ 4x) hand every lane word wd of the
// four calls its elements need: one call per four elements, each used
// whole.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;          // head width
constexpr int TILE = 64;       // keys per tile; queries per tile
constexpr int WARPS = 4;       // the forward's warps
constexpr int THREADS = 32 * WARPS;
// the backward: 8 warps of 16 keys, key tiles of up to 128 keys
constexpr int BWD_WARPS = 8;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int KT = 16 * BWD_WARPS;
constexpr int LDB = KT + 4;    // bias tile row stride (floats)
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

// cp.async: 16 or 4 bytes, zero-filled where !valid (no byte is read)
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// per compute type: tiles, the A operand, the two products, stores
// ---------------------------------------------------------------------------

template <typename T> struct Cdt;

template <> struct Cdt<bf16> {
  static constexpr int ROW = D;                 // swizzled, unpadded rows
  static constexpr int TILE_ELEMS = TILE * ROW;
  static constexpr bool A_IN_SMEM = false;      // A lives in registers
  static constexpr int STAGES = 2;              // backward query tiles
  static constexpr int FWD_STAGES = 2;          // forward key tiles
  static constexpr int OV = 2;                  // uint4 in 16 elements
  struct AFrag {
    uint32_t r[4][4];  // r[kc]: k-step kc (columns 16kc .. 16kc+15)
  };

  // `rows` rows row0 .. of a (T, 64) matrix, rows `rs` elements apart,
  // into a swizzled tile by cp.async, by NT threads; rows at or past Tn
  // are zero-filled
  template <int NT = BWD_THREADS>
  static __device__ __forceinline__ void load_tile_async(
      bf16* s, const bf16* g, long long rs, int row0, int Tn, int tid,
      int rows = TILE) {
    for (int e = tid; e < rows * 8; e += NT) {
      const int r = e >> 3, ch = e & 7;
      const bool in = row0 + r < Tn;
      cp_async16(s + swz(r, ch), in ? g + (row0 + r) * rs + ch * 8 : g, in);
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
  // n-tile pairs np < nj only (the rest stay as they are)
  static __device__ __forceinline__ void mma_abt(float (*acc)[4],
                                                 const AFrag& a,
                                                 const bf16* s, int lane,
                                                 int nj = 4) {
    const int bn = ((lane >> 4) << 3) + (lane & 7), bkc = (lane >> 3) & 1;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np >= nj) break;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b[4];
        ldsm_x4(s + swz(np * 16 + bn, 2 * kc + bkc), b);
        mma(acc[2 * np], a.r[kc], b[0], b[1]);
        mma(acc[2 * np + 1], a.r[kc], b[2], b[3]);
      }
    }
  }

  // acc[n] (16 x 64) += P (16 x 64, accumulator layout, as bf16) . S where S
  // is a 64 x 64 tile (rows = the k dimension): ldmatrix.trans; k-chunks of
  // 16 below 16 nj only
  static __device__ __forceinline__ void mma_ps(float (*acc)[4],
                                                const float (*p)[4],
                                                const bf16* s, int lane,
                                                float*, int nj = 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nj) break;
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

  // dS^T (the warp's 16 key rows, accumulator layout) into the [key][query]
  // tile as bf16: the rounding the dK product's A operand gets too
  static __device__ __forceinline__ void store_ds(bf16* s,
                                                  const float (*ds)[4],
                                                  int warp, int lane) {
    const int r = 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(s + swz(r, n) + c) = pack(ds[n][0],
                                                             ds[n][1]);
      *reinterpret_cast<uint32_t*>(s + swz(r + 8, n) + c) = pack(ds[n][2],
                                                                 ds[n][3]);
    }
  }

  // acc (query rows qr0 .. qr0+15 x columns 32 dh .. 32 dh + 31) += dS . K
  // over the first nk keys: A = dS from the [key][query] tile ds by
  // ldmatrix.trans, B = the [key][d] K tile by ldmatrix.trans
  static __device__ __forceinline__ void mma_dq(float (*acc)[4],
                                                const bf16* ds,
                                                const bf16* ks, int qr0,
                                                int dh, int nk, int lane) {
    const int nkc = (nk + 15) >> 4;
#pragma unroll
    for (int kc = 0; kc < BWD_WARPS; ++kc) {
      if (kc >= nkc) break;
      uint32_t a[4];
      ldsm_x4_t(ds + swz(16 * kc + (lane & 7) + ((lane >> 4) << 3),
                         (qr0 >> 3) + ((lane >> 3) & 1)),
                a);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(ks + swz(16 * kc + (lane & 15),
                           4 * dh + 2 * np + (lane >> 4)),
                  b);
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // sum over quarter qr of row r of a tile times the same quarter of an
  // O row
  static __device__ __forceinline__ float dot_quarter(const bf16* s, int r,
                                                      int qr,
                                                      const uint4* o) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < OV; ++c) {
      const uint4 x = *reinterpret_cast<const uint4*>(s + swz(r, 2 * qr + c));
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t os[4] = {o[c].x, o[c].y, o[c].z, o[c].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&os[j]));
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
    return acc;
  }

  static __device__ __forceinline__ float2 ld2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack(a, b);
  }
};

template <> struct Cdt<float> {
  static constexpr int ROW = LDF;                // rows padded to 68 floats
  static constexpr int TILE_ELEMS = TILE * ROW;
  static constexpr bool A_IN_SMEM = true;
  // one stage: the backward's tiles then fit an SM's shared memory, and
  // the forward keeps three blocks an SM
  static constexpr int STAGES = 1;
  static constexpr int FWD_STAGES = 1;
  static constexpr int OV = 4;
  struct AFrag {
    const float* s;    // the warp's 16 rows in a shared tile
  };

  template <int NT = BWD_THREADS>
  static __device__ __forceinline__ void load_tile_async(
      float* s, const float* g, long long rs, int row0, int Tn, int tid,
      int rows = TILE) {
    for (int e = tid; e < rows * (D / 4); e += NT) {
      const int r = e >> 4, ch = e & 15;
      const bool in = row0 + r < Tn;
      cp_async16(s + r * LDF + 4 * ch, in ? g + (row0 + r) * rs + 4 * ch : g,
                 in);
    }
  }

  static __device__ __forceinline__ void load_a(AFrag& a, const float* s,
                                                int r0, int) {
    a.s = s + r0 * LDF;
  }

  // acc[n][i] += sum_d A[row_i][d] B[col][d], d in order; n < 2 nj
  static __device__ __forceinline__ void mma_abt(float (*acc)[4],
                                                 const AFrag& a,
                                                 const float* s, int lane,
                                                 int nj = 4) {
    const float* a0 = a.s + (lane >> 2) * LDF;
    const float* a1 = a0 + 8 * LDF;
    const float* b0 = s + 2 * (lane & 3) * LDF;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n >= 2 * nj) continue;
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
  }

  // acc[n][i] += sum_k P[row_i][k] S[k][col], k < 16 nj in order; P goes
  // through the warp's scratch pw (16 x LDF floats), where it stays
  static __device__ __forceinline__ void mma_ps(float (*acc)[4],
                                                const float (*p)[4],
                                                const float* s, int lane,
                                                float* pw, int nj = 4) {
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
    for (int k = 0; k < 16 * nj; k += 4) {
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

  // dS^T is already in the warps' scratch, which together is the [key]
  // [query] tile (the dK product put it there)
  static __device__ __forceinline__ void store_ds(float*, const float (*)[4],
                                                  int, int) {}

  // acc (query rows qr0 .. qr0+15 x columns 32 dh .. 32 dh + 31) += dS . K
  // over the first nk keys in order; ds = the [key][query] tile, ks the
  // [key][d] K tile
  static __device__ __forceinline__ void mma_dq(float (*acc)[4],
                                                const float* ds,
                                                const float* ks, int qr0,
                                                int dh, int nk, int lane) {
    const int r0 = qr0 + (lane >> 2), c0 = 32 * dh + 2 * (lane & 3);
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float a0 = ds[k * LDF + r0], a1 = ds[k * LDF + r0 + 8];
      const float* krow = ks + k * LDF + c0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(krow + n * 8);
        acc[n][0] = fmaf(a0, y.x, acc[n][0]);
        acc[n][1] = fmaf(a0, y.y, acc[n][1]);
        acc[n][2] = fmaf(a1, y.x, acc[n][2]);
        acc[n][3] = fmaf(a1, y.y, acc[n][3]);
      }
    }
  }

  static __device__ __forceinline__ float dot_quarter(const float* s, int r,
                                                      int qr,
                                                      const uint4* o) {
    float acc = 0.f;
    const float* x = s + r * LDF + 16 * qr;
#pragma unroll
    for (int c = 0; c < OV; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(x + 4 * c);
      const float4 b = *reinterpret_cast<const float4*>(&o[c]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
    return acc;
  }

  static __device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// dynamic shared memory. The forward: the Q tile (QT rows), FWD_STAGES
// stages of the K and V tiles and of the bias tile [QT][LDF] f32 (f32: a
// warp's P scratch is its own 16 rows of the current bias tile, which it
// has read before it writes P); after the key loop, the K and V stages
// take the key groups' partial rows for the combine. The backward: Q and
// dO tiles per stage, the K and V tiles of KT rows (bf16: V staged there
// once, then the dS^T tile), bias tiles [64][LDB] f32 and (m, 1/l, D)
// rows per stage, plus the P scratch of its 8 warps
template <typename T, int WK> constexpr size_t fwd_smem() {
  return (16 * (WARPS / WK) + 2 * Cdt<T>::FWD_STAGES * TILE) * Cdt<T>::ROW *
             sizeof(T) +
         Cdt<T>::FWD_STAGES * 16 * (WARPS / WK) * LDF * 4;
}
template <typename T> constexpr size_t bwd_smem() {
  return (2 * Cdt<T>::STAGES + 4) * Cdt<T>::TILE_ELEMS * sizeof(T) +
         Cdt<T>::STAGES * (TILE * LDB * 4 + TILE * 16) +
         (Cdt<T>::A_IN_SMEM ? BWD_WARPS * 16 * LDF * 4 : 0);
}

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

template <typename T> struct Params {
  const T *q, *k, *v;  // row 0 of (b, h) at b * s.b + h * s.h
  const float* bias;
  int H, Tq, Tk;
  uint32_t thresh32;  // keep below this; 0 = no dropout
  float keep_scale, scale;
  uint32_t k0, k1;    // the Philox key: the seed's low and high words
  // where not null, the seed is read from here instead (device memory,
  // written before the launch: a CUDA graph replays the launch with the
  // seed of its step)
  const unsigned long long* seed_at;
};

// the Philox key of a launch: (k0, k1), or the words of *seed_at
struct Key {
  uint32_t k0, k1;
};

template <typename T>
__device__ __forceinline__ Key philox_key(const Params<T>& f) {
  if (f.seed_at == nullptr) return Key{f.k0, f.k1};
  const unsigned long long s = __ldg(f.seed_at);
  return Key{(uint32_t)(s & 0xffffffffull), (uint32_t)(s >> 32)};
}

struct Strides {
  long long b, h, t;  // elements between batches, heads, rows
};

template <typename T> struct FwdParams {
  Params<T> f;
  T* o;              // row 0 of (b, h) at b * so.b + h * so.h
  float2* stats;     // (B, H, Tq): (m, l)
  Strides sq, sk, sv, so;
  bool bias16;       // bias rows 16-byte aligned: 16-byte copies
};

template <typename T> struct BwdParams {
  Params<T> f;
  const T *o, *g;
  const float* stats;
  T *dq, *dk, *dv;
  Strides sq, sk, sv, sg, sdq, sdk, sdv, so;
  float* part;        // (B, H, key tiles, Tq, D) f32 shares of dQ
  unsigned* arrive;   // (B * H) arrival counters, 0 between launches
  int nch, nkt;       // 16-key chunks, key tiles
  bool bias16;        // bias rows 16-byte aligned: 16-byte copies
};

// ---------------------------------------------------------------------------
// forward: grid (query tiles of QT = 16 WQ rows, H, B); 4 warps, WQ query
// groups of 16 rows times WK key groups (warp = wq * WK + wk)
// ---------------------------------------------------------------------------

// keep flags of a warp's elements in n-tiles n < 2 nj of one key tile
// (keys key0 + 8n + 2 (lane % 4) + {0, 1} of rows r0 and r0 + 8, r0 the
// query row of lane / 4), as bits 4n + i (i = 2 * row half + column).
// Lanes 2j and 2j + 1 of a quad hold the same group of four keys for both
// rows: the even lane draws the call of row r0, the odd lane that of row
// r0 + 8; each keeps the two words of its own elements and sends the two
// its partner needs, as flags, in one __shfl_xor_sync for the whole tile
template <int NJ, typename T>
__device__ __forceinline__ uint32_t keep_bits_fwd(const Params<T>& f,
                                                  Key key, int b, int h,
                                                  int key0, int r0, int lane,
                                                  int nj) {
  const bool odd = lane & 1;
  const uint32_t g0 = ((uint32_t)key0 >> 2) + ((lane & 3) >> 1);
  const uint32_t row = (uint32_t)r0 + (odd ? 8u : 0u);
  uint32_t own = 0, snd = 0;
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n) {
    if (n >= 2 * nj) break;
    const U4 r = philox(g0 + 2 * n, row, h, b, key.k0, key.k1);
    const uint32_t lo = (uint32_t)(r.w[0] < f.thresh32) |
                        (uint32_t)(r.w[1] < f.thresh32) << 1;
    const uint32_t hi = (uint32_t)(r.w[2] < f.thresh32) |
                        (uint32_t)(r.w[3] < f.thresh32) << 1;
    own |= (odd ? hi : lo) << (2 * n);
    snd |= (odd ? lo : hi) << (2 * n);
  }
  const uint32_t got = __shfl_xor_sync(0xffffffffu, snd, 1);
  const uint32_t top = odd ? got : own, bot = odd ? own : got;
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n)
    bits |= ((top >> (2 * n)) & 3u) << (4 * n) |
            ((bot >> (2 * n)) & 3u) << (4 * n + 2);
  return bits;
}

template <typename T, int WK>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const FwdParams<T> p) {
  using C = Cdt<T>;
  constexpr int WQ = WARPS / WK, QT = 16 * WQ;
  constexpr int KC = TILE / WK, NJ = KC / 16;  // a warp's keys of a tile
  constexpr int ST = C::FWD_STAGES, TE = C::TILE_ELEMS;
  static_assert(WK == 1 || !C::A_IN_SMEM,
                "f32: a warp's P scratch is its own bias rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);              // the Q tile
  T* ks = qs + QT * C::ROW;                             // [ST] K tiles
  T* vs = ks + ST * TE;                                 // [ST] V tiles
  float* bs = reinterpret_cast<float*>(vs + ST * TE);  // [ST][QT][LDF]
  const Params<T>& f = p.f;
  const Key pkey = philox_key(f);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp / WK, wk = warp % WK;
  const bool qwarp = q0 + 16 * wq < f.Tq;  // the warp holds a real query
  const T* kg = f.k + b * p.sk.b + h * p.sk.h;
  const T* vg = f.v + b * p.sv.b + h * p.sv.h;
  const int nkt = (f.Tk + TILE - 1) / TILE;

  // the K, V and bias tiles of key tile `it` into stage `buf`: one group
  auto fetch = [&](int it, int buf) {
    const int k0 = it * TILE, nk = min(TILE, f.Tk - k0);
    const int rows = (nk + 15) & ~15;  // the rows the products read
    C::template load_tile_async<THREADS>(ks + buf * TE, kg, p.sk.t, k0,
                                         f.Tk, tid, rows);
    C::template load_tile_async<THREADS>(vs + buf * TE, vg, p.sv.t, k0,
                                         f.Tk, tid, rows);
    float* bb = bs + buf * QT * LDF;
    const float* bg = f.bias + ((size_t)b * f.Tq + q0) * f.Tk + k0;
    // bias columns past nk are never read: not even zero-filled
    if (p.bias16) {
      const int cw = nk >> 2;  // nk is a multiple of 4 here
      for (int e = tid; e < QT * cw; e += THREADS) {
        const int r = e / cw, c = 4 * (e - r * cw);
        const bool in = q0 + r < f.Tq;
        cp_async16(bb + r * LDF + c, in ? bg + (size_t)r * f.Tk + c : f.bias,
                   in);
      }
    } else {
      for (int e = tid; e < QT * nk; e += THREADS) {
        const int r = e / nk, c = e - r * nk;
        const bool in = q0 + r < f.Tq;
        cp_async4(bb + r * LDF + c, in ? bg + (size_t)r * f.Tk + c : f.bias,
                  in);
      }
    }
    cp_async_commit();
  };

  // the Q tile goes in the first tile's group
  C::template load_tile_async<THREADS>(qs, f.q + b * p.sq.b + h * p.sq.h,
                                       p.sq.t, q0, f.Tq, tid, QT);
  fetch(0, 0);
  typename C::AFrag qa;
  const int r0 = q0 + 16 * wq + (lane >> 2);  // the lane's rows r0, r0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4];
  zero(o);

  for (int it = 0; it < nkt; ++it) {
    const int cur = ST == 2 ? (it & 1) : 0;
    if (ST == 1 && it > 0) {
      __syncthreads();  // the last tile is consumed
      fetch(it, 0);
    }
    cp_async_wait_all();
    __syncthreads();  // tile it landed; the other stage is consumed
    if (ST == 2 && it + 1 < nkt) fetch(it + 1, cur ^ 1);
    if (it == 0) C::load_a(qa, qs, 16 * wq, lane);
    const int kw = it * TILE + KC * wk;  // the warp's first key
    const int nkw = min(KC, f.Tk - kw);  // and how many are real
    if (!qwarp || nkw <= 0) continue;
    const int nj = NJ == 1 ? 1 : min(NJ, (nkw + 15) >> 4);
    const T* kt = ks + cur * TE + KC * wk * C::ROW;
    const T* vt = vs + cur * TE + KC * wk * C::ROW;
    float* bt = bs + (cur * QT + 16 * wq) * LDF;  // the warp's 16 rows
    float s[8][4];
    zero(s);
    C::mma_abt(s, qa, kt, lane, nj);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * NJ; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = KC * wk + n * 8 + 2 * (lane & 3);  // tile column
        const float2 x = *reinterpret_cast<const float2*>(
            bt + ((lane >> 2) + 8 * r) * LDF + c);
        const int key = it * TILE + c;
        s[n][2 * r] = key < f.Tk ? s[n][2 * r] * f.scale + x.x : -INFINITY;
        s[n][2 * r + 1] =
            key + 1 < f.Tk ? s[n][2 * r + 1] * f.scale + x.y : -INFINITY;
        tmax[r] = fmaxf(tmax[r], fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mn = fmaxf(m[r], tmax[r]);  // finite: key kw is real
      const float c = expf(m[r] - mn);
      l[r] *= c;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * r] *= c;
        o[n][2 * r + 1] *= c;
      }
      m[r] = mn;
    }
    // rate 0: every flag set and keep_scale 1
    const uint32_t kb =
        f.thresh32 ? keep_bits_fwd<NJ>(f, pkey, b, h, kw, r0, lane, nj)
                   : 0xffffffffu;
#pragma unroll
    for (int n = 0; n < 2 * NJ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[n][i] - m[i >> 1]);
        l[i >> 1] += e;
        s[n][i] = (kb >> (4 * n + i)) & 1u ? e * f.keep_scale : 0.f;
      }
    C::mma_ps(o, s, vt, lane, bt, nj);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t bh = (size_t)b * f.H + h;
  T* ob = p.o + b * p.so.b + h * p.so.h;
  if (WK == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r0 + 8 * r;
      if (q >= f.Tq) continue;
      const float inv = 1.f / l[r];
      T* og = ob + q * p.so.t + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        C::st2(og + n * 8, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      if ((lane & 3) == 0) p.stats[bh * f.Tq + q] = make_float2(m[r], l[r]);
    }
    return;
  }

  // WK > 1: every key group's partial rows through shared memory, added
  // in key-group order (a group with no real key has m = -inf, l = 0)
  __syncthreads();  // every warp is done with the stages
  float* po = reinterpret_cast<float*>(ks);                        // o
  float2* pml = reinterpret_cast<float2*>(po + WARPS * 16 * LDF);  // (m, l)
  {
    float* pr = po + (warp * 16 + (lane >> 2)) * LDF + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(pr + n * 8) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(pr + 8 * LDF + n * 8) =
          make_float2(o[n][2], o[n][3]);
    }
    if ((lane & 3) == 0) {
      pml[warp * 16 + (lane >> 2)] = make_float2(m[0], l[0]);
      pml[warp * 16 + (lane >> 2) + 8] = make_float2(m[1], l[1]);
    }
  }
  __syncthreads();
  // a thread a row's 8-column chunk
  for (int e = tid; e < QT * 8; e += THREADS) {
    const int r = e >> 3, ch = e & 7, q = q0 + r;
    if (q >= f.Tq) continue;
    const int w0 = (r >> 4) * WK, rr = r & 15;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WK; ++w) mx = fmaxf(mx, pml[(w0 + w) * 16 + rr].x);
    float sum = 0.f, acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float2 ml = pml[(w0 + w) * 16 + rr];
      const float c = expf(ml.x - mx);  // finite mx: key 0 is in group 0
      sum += ml.y * c;
      const float4* src = reinterpret_cast<const float4*>(
          po + ((w0 + w) * 16 + rr) * LDF + 8 * ch);
      const float4 u = src[0], v = src[1];
      acc[0] += c * u.x;
      acc[1] += c * u.y;
      acc[2] += c * u.z;
      acc[3] += c * u.w;
      acc[4] += c * v.x;
      acc[5] += c * v.y;
      acc[6] += c * v.z;
      acc[7] += c * v.w;
    }
    const float inv = 1.f / sum;
    T* og = ob + q * p.so.t + 8 * ch;
#pragma unroll
    for (int j = 0; j < 8; j += 2) C::st2(og + j, acc[j] * inv, acc[j + 1] * inv);
    if (ch == 0) p.stats[bh * f.Tq + q] = make_float2(mx, sum);
  }
}

// ---------------------------------------------------------------------------
// backward: one pass; grid (key tiles, H, B)
// ---------------------------------------------------------------------------

// keep flags of the 32 elements a lane holds in one 64-query tile of the
// S^T layout (queries q0 ..), as bits 4 n + i (n: 8-query tile, i = 2 * row
// half + column). Every lane draws one Philox call per 8-query tile, all
// eight in straight-line code, and the four lanes of a key group swap
// words with branch-free selects (see the top)
__device__ __forceinline__ uint32_t keep_bits(Key key, uint32_t thresh32,
                                              int b, int h, int key0, int q0,
                                              int lane) {
  const int wd = (lane >> 2) & 3;
  const bool a = wd & 1, c = wd & 2;
  const uint32_t grp = (uint32_t)key0 / 4 + (lane >> 4) + (wd & 2);
  const uint32_t q = q0 + 2 * (lane & 3) + (wd & 1);
  U4 r[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    r[n] = philox(grp, q + 8 * n, h, b, key.k0, key.k1);
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    // u[x] = word wd ^ x of this lane's call: what round x sends
    const uint32_t t0 = a ? r[n].w[1] : r[n].w[0];
    const uint32_t t1 = a ? r[n].w[0] : r[n].w[1];
    const uint32_t t2 = a ? r[n].w[3] : r[n].w[2];
    const uint32_t t3 = a ? r[n].w[2] : r[n].w[3];
    const uint32_t u[4] = {c ? t2 : t0, c ? t3 : t1, c ? t0 : t2,
                           c ? t1 : t3};
    // bit x: the flag round x brings, that of element wd ^ x
    uint32_t f = u[0] < thresh32;
#pragma unroll
    for (int x = 1; x < 4; ++x)
      f |= (uint32_t)(__shfl_xor_sync(0xffffffffu, u[x], x << 2) <
                      thresh32) << x;
    f = a ? ((f & 5u) << 1) | ((f >> 1) & 5u) : f;  // to bit wd ^ x
    f = c ? ((f & 3u) << 2) | ((f >> 2) & 3u) : f;
    bits |= f << (4 * n);
  }
  return bits;
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attn_bwd_kernel(const BwdParams<T> p) {
  using C = Cdt<T>;
  constexpr int ST = C::STAGES, TE = C::TILE_ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  T* qs = reinterpret_cast<T*>(smem_raw);  // [ST] Q tiles
  T* gs = qs + ST * TE;                      // [ST] dO tiles
  T* ks = gs + ST * TE;                      // the K tile (KT rows)
  T* vs = ks + 2 * TE;  // the V tile; bf16: then the dS^T tile
  float* bs = reinterpret_cast<float*>(vs + 2 * TE);  // [ST][64][LDB] bias
  float4* rowp = reinterpret_cast<float4*>(bs + ST * TILE * LDB);
  float* pw_all = reinterpret_cast<float*>(rowp + ST * TILE);
  const Params<T>& f = p.f;
  const Key pkey = philox_key(f);
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pw = pw_all + warp * 16 * LDF;
  const size_t bh = (size_t)b * f.H + h;
  // this block's chunks c_lo .. c_hi - 1: keys k0 .. k0 + nk - 1
  const int c_lo = kt * p.nch / p.nkt, c_hi = (kt + 1) * p.nch / p.nkt;
  const int k0 = 16 * c_lo, nk = min(16 * (c_hi - c_lo), f.Tk - k0);
  const int krows = 16 * (c_hi - c_lo);  // key rows any product reads
  const bool kwarp = warp < c_hi - c_lo;  // this warp owns keys
  const T* qg = f.q + b * p.sq.b + h * p.sq.h;
  const T* gg = p.g + b * p.sg.b + h * p.sg.h;
  const int nqt = (f.Tq + TILE - 1) / TILE;

  // Q, dO and bias tiles of query tile `it` into stage `buf`: one group
  auto fetch = [&](int it, int buf) {
    const int q0 = it * TILE;
    C::load_tile_async(qs + buf * TE, qg, p.sq.t, q0, f.Tq, tid);
    C::load_tile_async(gs + buf * TE, gg, p.sg.t, q0, f.Tq, tid);
    float* bb = bs + buf * TILE * LDB;
    const float* bg = f.bias + ((size_t)b * f.Tq + q0) * f.Tk + k0;
    // bias columns past nk are never read: not even zero-filled
    if (p.bias16) {
      const int cw = nk / 4;  // nk is a multiple of 4 here
      for (int e = tid; e < TILE * cw; e += BWD_THREADS) {
        const int r = e / cw, c = 4 * (e % cw);
        const bool in = q0 + r < f.Tq && c < nk;
        cp_async16(bb + r * LDB + c, in ? bg + (size_t)r * f.Tk + c : f.bias,
                   in);
      }
    } else {
      for (int e = tid; e < TILE * nk; e += BWD_THREADS) {
        const int r = e / nk, c = e % nk;
        const bool in = q0 + r < f.Tq && c < nk;
        cp_async4(bb + r * LDB + c, in ? bg + (size_t)r * f.Tk + c : f.bias,
                  in);
      }
    }
    cp_async_commit();
  };
  // a quarter of an O row and the row's (m, l) of query tile `it`, into
  // registers
  uint4 orow[C::OV];
  float2 ml = make_float2(INFINITY, 1.f);
  auto load_rows = [&](int it) {
    const int q = it * TILE + (tid >> 2);
    const bool in = q < f.Tq;
    const uint4* src =
        reinterpret_cast<const uint4*>(p.o + b * p.so.b + h * p.so.h +
                                       (in ? q : 0) * p.so.t) +
        (tid & 3) * C::OV;
#pragma unroll
    for (int c = 0; c < C::OV; ++c)
      orow[c] = in ? src[c] : make_uint4(0, 0, 0, 0);
    ml = in ? reinterpret_cast<const float2*>(p.stats)[bh * f.Tq + q]
             : make_float2(INFINITY, 1.f);
  };
  // (m, 1/l, D = dO . O) of query tile `it` (its dO in stage buf): four
  // threads a row; past Tq (+inf, 0, 0), so P is exactly 0 there
  auto d_phase = [&](int it, int buf) {
    const int r = tid >> 2;
    float d = C::dot_quarter(gs + buf * TE, r, tid & 3, orow);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if ((tid & 3) == 0) {
      const bool in = it * TILE + r < f.Tq;
      rowp[buf * TILE + r] =
          make_float4(ml.x, in ? 1.f / ml.y : 0.f, in ? d : 0.f, 0.f);
    }
  };

  // the K and V tiles, the first query tile, its (m, 1/l, D)
  C::load_tile_async(ks, f.k + b * p.sk.b + h * p.sk.h, p.sk.t, k0, k0 + nk,
                     tid, krows);
  C::load_tile_async(vs, f.v + b * p.sv.b + h * p.sv.h, p.sv.t, k0, k0 + nk,
                     tid, krows);
  fetch(0, 0);
  load_rows(0);
  cp_async_wait_all();
  __syncthreads();
  typename C::AFrag ka, va;
  C::load_a(ka, ks, warp * 16, lane);
  C::load_a(va, vs, warp * 16, lane);
  d_phase(0, 0);

  const int kw0 = k0 + 16 * warp;                  // the warp's first key
  const int rk[2] = {kw0 + (lane >> 2), kw0 + (lane >> 2) + 8};
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  // bf16: the dS^T tile takes the V tile's place once its A operand is out
  const T* dsrc = C::A_IN_SMEM ? reinterpret_cast<const T*>(pw_all) : vs;

  for (int it = 0; it < nqt; ++it) {
    const int cur = ST == 2 ? (it & 1) : 0, nxt = ST == 2 ? cur ^ 1 : 0;
    const int q0 = it * TILE, nq = min(TILE, f.Tq - q0);
    const int nj = (nq + 15) >> 4;  // 16-query chunks with a real query
    __syncthreads();  // stage cur, its rows, and the last dQ reads are done
    if (ST == 2 && it + 1 < nqt) fetch(it + 1, nxt);
    if (kwarp) {
      const T* qt = qs + cur * TE;
      const T* gt = gs + cur * TE;
      const float* bt = bs + cur * TILE * LDB;
      const float4* rp = rowp + cur * TILE;
      // the keep flags first (4 bits an 8-query tile): integer work the
      // scheduler can put beside the products
      const uint32_t kbits =
          f.thresh32 ? keep_bits(pkey, f.thresh32, b, h, kw0, q0, lane)
                      : 0xffffffffu;
      float st[8][4], dp[8][4];
      zero(st);
      zero(dp);
      C::mma_abt(st, ka, qt, lane, nj);  // S^T: keys x queries
      C::mma_abt(dp, va, gt, lane, nj);  // (dO V^T)^T
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n >= 2 * nj) break;
        const int qc = n * 8 + 2 * (lane & 3);
        const uint32_t kb = kbits >> (4 * n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = qc + (i & 1), key = rk[i >> 1];
          const float4 r = rp[ql];  // (m, 1/l, D)
          const float x =
              key < f.Tk ? st[n][i] * f.scale + bt[ql * LDB + key - k0]
                         : -INFINITY;
          const float pr = expf(x - r.x) * r.y;
          const float kp = (kb >> i) & 1 ? f.keep_scale : 0.f;
          st[n][i] = pr * kp;                      // dropped P^T
          dp[n][i] = pr * (dp[n][i] * kp - r.z);   // dS^T
        }
      }
      C::mma_ps(dva, st, gt, lane, pw, nj);  // dV += Pd^T dO
      C::mma_ps(dka, dp, qt, lane, pw, nj);  // dK += dS^T Q
      C::store_ds(vs, dp, warp, lane);
    }
    if (ST == 2) cp_async_wait_all();
    __syncthreads();  // dS^T complete (bf16: stage nxt landed)
    if (ST == 1 && it + 1 < nqt) fetch(it + 1, 0);
    if (it + 1 < nqt) load_rows(it + 1);
    // this key tile's share of dQ: a warp takes 16 queries x 32 columns
    const int qw = 16 * (warp & 3), dh = warp >> 2;
    if (qw < nq) {
      float dqa[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[n][i] = 0.f;
      C::mma_dq(dqa, dsrc, ks, qw, dh, nk, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + qw + (lane >> 2) + 8 * r;
        if (q >= f.Tq) continue;
        const int c = 32 * dh + 2 * (lane & 3);
        if (p.nkt == 1) {
          T* o = p.dq + b * p.sdq.b + h * p.sdq.h + q * p.sdq.t + c;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            C::st2(o + n * 8, dqa[n][2 * r] * f.scale,
                   dqa[n][2 * r + 1] * f.scale);
        } else {
          float* o = p.part + ((bh * p.nkt + kt) * f.Tq + q) * D + c;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<float2*>(o + n * 8) =
                make_float2(dqa[n][2 * r], dqa[n][2 * r + 1]);
        }
      }
    }
    if (it + 1 < nqt) {
      if (ST == 1) {
        cp_async_wait_all();
        __syncthreads();  // stage 0 holds query tile it + 1
      }
      d_phase(it + 1, nxt);
    }
  }

  if (kwarp) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rk[r] >= f.Tk) continue;
      T* kg = p.dk + b * p.sdk.b + h * p.sdk.h + rk[r] * p.sdk.t;
      T* vg = p.dv + b * p.sdv.b + h * p.sdv.h + rk[r] * p.sdv.t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + 2 * (lane & 3);
        C::st2(kg + c, dka[n][2 * r] * f.scale, dka[n][2 * r + 1] * f.scale);
        C::st2(vg + c, dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
  if (p.nkt == 1) return;

  // the last block of (b, h) to arrive adds the shares in key-tile order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(p.arrive + bh, 1u) == (unsigned)(p.nkt - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const float* src = p.part + bh * p.nkt * f.Tq * D;
  T* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
  // U float4 a thread at a time, all their loads in flight together
  constexpr int U = 8;
  const int n4 = f.Tq * (D / 4);
  for (int e0 = tid; e0 < n4; e0 += U * BWD_THREADS) {
    float4 acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = min(e0 + u * BWD_THREADS, n4 - 1);
      acc[u] = __ldcg(reinterpret_cast<const float4*>(src) + e);
    }
    for (int t = 1; t < p.nkt; ++t) {
      const float4* st = reinterpret_cast<const float4*>(
          src + (size_t)t * f.Tq * D);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 x = __ldcg(st + min(e0 + u * BWD_THREADS, n4 - 1));
        acc[u].x += x.x;
        acc[u].y += x.y;
        acc[u].z += x.z;
        acc[u].w += x.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * BWD_THREADS;
      if (e >= n4) break;
      T* o = dqb + (e >> 4) * p.sdq.t + 4 * (e & 15);
      C::st2(o, acc[u].x * f.scale, acc[u].y * f.scale);
      C::st2(o + 2, acc[u].z * f.scale, acc[u].w * f.scale);
    }
  }
  if (tid == 0) p.arrive[bh] = 0;
}

// ---------------------------------------------------------------------------
// kernel 9: the bits themselves, (B, H*Tq, Tk) uint32
// ---------------------------------------------------------------------------
//
// What bounds it on the H100: the bytes it writes (4 a bit) and its integer
// work (one Philox call, ten rounds of two 32x32 -> 64-bit products and two
// three-way XORs, for each 16 bytes: 76 vector integer instructions a group
// as built) take about the same time at the card's peaks, bytes slightly
// more (PERF.md, row 9). So a thread does nothing else: the grid is (blocks
// over the Tq * ceil(Tk / 4) word groups of one (b, h), H, B), one group a
// thread, whose (q, c) come from its flat index by a multiply-high with a
// magic number (no division), with 32-bit offsets inside the (b, h) slab; a
// group is one streaming 16-byte store where Tk % 4 == 0 (every row then
// starts on a 16-byte boundary; write-back stores measured the same), and
// up to four scalar ones otherwise.

constexpr int BITS_THREADS = 256;

// n / d for 0 <= n < 2^31 by one multiply-high and a shift (the method of
// CUTLASS's FastDivmod; mirrored in ops/attention_fused.py, fast_div_magic)
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv make_fast_div(uint32_t d) {
  if (d == 1) return FastDiv{1, 0, 0};
  uint32_t l = 0;  // ceil(log2 d)
  while ((1ull << l) < d) ++l;
  const uint32_t p = 31 + l;
  return FastDiv{d, (uint32_t)(((1ull << p) + d - 1) / d), p - 32};
}

__device__ __forceinline__ uint32_t fast_div(uint32_t n, const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

template <bool VEC>
__global__ void __launch_bounds__(BITS_THREADS)
dropout_bits_kernel(uint32_t* __restrict__ out, int Tq, int Tk, FastDiv kw,
                    uint32_t k0, uint32_t k1,
                    const unsigned long long* __restrict__ seed_at) {
  const uint32_t f = blockIdx.x * BITS_THREADS + threadIdx.x;
  const uint32_t q = fast_div(f, kw);
  if (q >= (uint32_t)Tq) return;
  if (seed_at != nullptr) {
    const unsigned long long s = __ldg(seed_at);
    k0 = (uint32_t)(s & 0xffffffffull);
    k1 = (uint32_t)(s >> 32);
  }
  const uint32_t c = f - q * kw.d, h = blockIdx.y, b = blockIdx.z;
  const U4 r = philox(c, q, h, b, k0, k1);
  uint32_t* o = out + ((size_t)b * gridDim.y + h) * ((size_t)Tq * Tk) +
                (q * (uint32_t)Tk + 4 * c);
  if (VEC) {
    __stcs(reinterpret_cast<uint4*>(o),
           make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]));
  } else {
    const int n = Tk - 4 * (int)c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) __stcs(o + j, r.w[j]);
  }
}

template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v,
                      const void* bias, int H, int Tq, int Tk, int thresh16,
                      unsigned long long seed,
                      const unsigned long long* seed_at) {
  Params<T> p;
  p.q = (const T*)q;
  p.k = (const T*)k;
  p.v = (const T*)v;
  p.bias = (const float*)bias;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  const bool drop = thresh16 > 0 && thresh16 < 65536;
  p.thresh32 = drop ? (uint32_t)thresh16 << 16 : 0u;
  p.keep_scale = drop ? 65536.f / (float)thresh16 : 1.f;
  p.scale = 1.f / sqrtf((float)D);
  p.k0 = (uint32_t)(seed & 0xffffffffull);
  p.k1 = (uint32_t)(seed >> 32);
  p.seed_at = seed_at;
  return p;
}

template <typename T, int WK>
int launch_fwd(const FwdParams<T>& p, int B, void* stream) {
  constexpr size_t smem = fwd_smem<T, WK>();
  constexpr int QT = 16 * (WARPS / WK);
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<T, WK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.f.Tq + QT - 1) / QT, p.f.H, B);
  attn_fwd_kernel<T, WK><<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

// strides: (batch, head, row) element strides of q, k, v, out
template <typename T>
int attn_fwd(const void* q, const void* k, const void* v, const void* bias,
             void* out, void* stats, const long long* strides, int B, int H,
             int Tq, int Tk, int d, int thresh16, unsigned long long seed,
             const unsigned long long* seed_at, int wk, void* stream) {
  cudaGetLastError();  // report only this call's error
  if (d != D || thresh16 <= 0 || Tk < 1) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return cudaSuccess;
  FwdParams<T> p;
  p.f = make_params<T>(q, k, v, bias, H, Tq, Tk, thresh16, seed, seed_at);
  p.o = (T*)out;
  p.stats = (float2*)stats;
  Strides* ss[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i)
    *ss[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.bias16 = Tk % 4 == 0 && ((uintptr_t)bias & 15) == 0;
  if (wk == 1) return launch_fwd<T, 1>(p, B, stream);
  if constexpr (sizeof(T) == 2) {
    if (wk == 2) return launch_fwd<T, 2>(p, B, stream);
    if (wk == 4) return launch_fwd<T, 4>(p, B, stream);
  }
  return cudaErrorInvalidValue;
}

// strides: (batch, head, row) element strides of q, k, v, g, dq, dk, dv,
// out
template <typename T>
int attn_bwd(const void* q, const void* k, const void* v, const void* bias,
             const void* out, const void* stats, const void* g, void* dq,
             void* dk, void* dv, const long long* strides, int B, int H,
             int Tq, int Tk, int d, int thresh16, unsigned long long seed,
             const unsigned long long* seed_at, void* part, void* arrive,
             void* stream) {
  cudaGetLastError();
  if (d != D || thresh16 <= 0 || Tk < 1) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0) return cudaSuccess;
  BwdParams<T> p;
  p.f = make_params<T>(q, k, v, bias, H, Tq, Tk, thresh16, seed, seed_at);
  p.o = (const T*)out;
  p.g = (const T*)g;
  p.stats = (const float*)stats;
  p.dq = (T*)dq;
  p.dk = (T*)dk;
  p.dv = (T*)dv;
  Strides* ss[8] = {&p.sq, &p.sk,  &p.sv,  &p.sg,
                    &p.sdq, &p.sdk, &p.sdv, &p.so};
  for (int i = 0; i < 8; ++i)
    *ss[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.part = (float*)part;
  p.arrive = (unsigned*)arrive;
  p.nch = (Tk + 15) / 16;
  p.nkt = (p.nch + BWD_WARPS - 1) / BWD_WARPS;
  if (p.nkt > 1 && (part == nullptr || arrive == nullptr))
    return cudaErrorInvalidValue;
  p.bias16 = Tk % 4 == 0 && ((uintptr_t)bias & 15) == 0;
  constexpr size_t smem = bwd_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<T><<<dim3(p.nkt, H, B), BWD_THREADS, smem,
                       (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry point returns cudaGetLastError() after its launches; a D other
// than 64 or a thresh16 of 0 is refused (cudaErrorInvalidValue). Each has
// a device-seed twin (the _ds entries at the end): the seed's address in
// device memory in place of its value. The _bf16
// entries take bf16 q, k, v, out, g, dq, dk, dv; the _f32 entries f32 ones.
// q, k, v, out, g, dq, dk, dv are read and written through (batch, head,
// row) element strides: rows contiguous and 16-byte aligned.

// strides: 12 int64, those of q, k, v, out; stats (B, H, Tq, 2) f32; wk:
// the key groups of a block, 1 (64 query rows a block) or, bf16 only, 2
// (32 rows) or 4 (16 rows)
extern "C" int attn_fwd_bf16(const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* stats,
                             const long long* strides, int B, int H, int Tq,
                             int Tk, int d, int thresh16,
                             unsigned long long seed, int wk, void* stream) {
  return attn_fwd<bf16>(q, k, v, bias, out, stats, strides, B, H, Tq, Tk, d,
                        thresh16, seed, nullptr, wk, stream);
}

extern "C" int attn_fwd_f32(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* stats,
                            const long long* strides, int B, int H, int Tq,
                            int Tk, int d, int thresh16,
                            unsigned long long seed, int wk, void* stream) {
  return attn_fwd<float>(q, k, v, bias, out, stats, strides, B, H, Tq, Tk, d,
                         thresh16, seed, nullptr, wk, stream);
}

// g = dL/d(out); strides: 24 int64, those of q, k, v, g, dq, dk, dv, out;
// stats as the forward wrote them; part: (B, H, key tiles, Tq, 64) f32
// scratch and arrive: B * H uint32 counters that are 0 (the kernel leaves
// them 0), both unused (may be null) when Tk <= 128 (one key tile: key tiles =
// ceil(ceil(Tk / 16) / 8))
extern "C" int attn_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* bias, const void* out,
                             const void* stats, const void* g, void* dq,
                             void* dk, void* dv, const long long* strides,
                             int B, int H, int Tq, int Tk, int d,
                             int thresh16, unsigned long long seed,
                             void* part, void* arrive, void* stream) {
  return attn_bwd<bf16>(q, k, v, bias, out, stats, g, dq, dk, dv, strides, B,
                        H, Tq, Tk, d, thresh16, seed, nullptr, part, arrive,
                        stream);
}

extern "C" int attn_bwd_f32(const void* q, const void* k, const void* v,
                            const void* bias, const void* out,
                            const void* stats, const void* g, void* dq,
                            void* dk, void* dv, const long long* strides,
                            int B, int H, int Tq, int Tk, int d,
                            int thresh16, unsigned long long seed,
                            void* part, void* arrive, void* stream) {
  return attn_bwd<float>(q, k, v, bias, out, stats, g, dq, dk, dv, strides,
                         B, H, Tq, Tk, d, thresh16, seed, nullptr, part, arrive,
                         stream);
}

namespace {

int dropout_bits(void* out, int B, int H, int Tq, int Tk,
                 unsigned long long seed, const unsigned long long* seed_at,
                 void* stream) {
  cudaGetLastError();
  if (B < 0 || H < 0 || Tq < 0 || Tk < 0) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Tq == 0 || Tk == 0) return cudaSuccess;
  const long long kw = (Tk + 3) / 4, groups = (long long)Tq * kw;
  if (B > 65535 || H > 65535 || groups > (1ll << 31) - BITS_THREADS ||
      (long long)Tq * Tk > 0xffffffffll)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((groups + BITS_THREADS - 1) / BITS_THREADS), H,
                  B);
  const FastDiv fd = make_fast_div((uint32_t)kw);
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull),
                 k1 = (uint32_t)(seed >> 32);
  if (Tk % 4 == 0 && ((uintptr_t)out & 15) == 0)
    dropout_bits_kernel<true><<<grid, BITS_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, Tq, Tk, fd, k0, k1, seed_at);
  else
    dropout_bits_kernel<false><<<grid, BITS_THREADS, 0,
                                 (cudaStream_t)stream>>>((uint32_t*)out, Tq,
                                                         Tk, fd, k0, k1,
                                                         seed_at);
  return cudaGetLastError();
}

}  // namespace

// out: (B, H*Tq, Tk) uint32; B, H < 65536, Tq * ceil(Tk / 4) < 2^31 - 256
// and Tq * Tk < 2^32
extern "C" int dropout_bits_u32(void* out, int B, int H, int Tq, int Tk,
                                unsigned long long seed, void* stream) {
  return dropout_bits(out, B, H, Tq, Tk, seed, nullptr, stream);
}

// ---------------------------------------------------------------------------
// The device-seed entries: as the entries above, with the 64-bit seed read
// by the kernel from device memory at seed_at (slot i of a buffer of
// int64 seeds that the host writes before each step: a CUDA graph captured
// once then reads each replay's seeds); the training path calls these
// ---------------------------------------------------------------------------

extern "C" int attn_fwd_bf16_ds(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* stats,
                                const long long* strides, int B, int H,
                                int Tq, int Tk, int d, int thresh16,
                                const unsigned long long* seed_at, int wk,
                                void* stream) {
  if (seed_at == nullptr) return cudaErrorInvalidValue;
  return attn_fwd<bf16>(q, k, v, bias, out, stats, strides, B, H, Tq, Tk, d,
                        thresh16, 0ull, seed_at, wk, stream);
}

extern "C" int attn_fwd_f32_ds(const void* q, const void* k, const void* v,
                               const void* bias, void* out, void* stats,
                               const long long* strides, int B, int H, int Tq,
                               int Tk, int d, int thresh16,
                               const unsigned long long* seed_at, int wk,
                               void* stream) {
  if (seed_at == nullptr) return cudaErrorInvalidValue;
  return attn_fwd<float>(q, k, v, bias, out, stats, strides, B, H, Tq, Tk, d,
                         thresh16, 0ull, seed_at, wk, stream);
}

extern "C" int attn_bwd_bf16_ds(const void* q, const void* k, const void* v,
                                const void* bias, const void* out,
                                const void* stats, const void* g, void* dq,
                                void* dk, void* dv, const long long* strides,
                                int B, int H, int Tq, int Tk, int d,
                                int thresh16,
                                const unsigned long long* seed_at, void* part,
                                void* arrive, void* stream) {
  if (seed_at == nullptr) return cudaErrorInvalidValue;
  return attn_bwd<bf16>(q, k, v, bias, out, stats, g, dq, dk, dv, strides, B,
                        H, Tq, Tk, d, thresh16, 0ull, seed_at, part, arrive,
                        stream);
}

extern "C" int attn_bwd_f32_ds(const void* q, const void* k, const void* v,
                               const void* bias, const void* out,
                               const void* stats, const void* g, void* dq,
                               void* dk, void* dv, const long long* strides,
                               int B, int H, int Tq, int Tk, int d,
                               int thresh16,
                               const unsigned long long* seed_at, void* part,
                               void* arrive, void* stream) {
  if (seed_at == nullptr) return cudaErrorInvalidValue;
  return attn_bwd<float>(q, k, v, bias, out, stats, g, dq, dk, dv, strides,
                         B, H, Tq, Tk, d, thresh16, 0ull, seed_at, part,
                         arrive, stream);
}

extern "C" int dropout_bits_u32_ds(void* out, int B, int H, int Tq, int Tk,
                                   const unsigned long long* seed_at,
                                   void* stream) {
  if (seed_at == nullptr) return cudaErrorInvalidValue;
  return dropout_bits(out, B, H, Tq, Tk, 0ull, seed_at, stream);
}
