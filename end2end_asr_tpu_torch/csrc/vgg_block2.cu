// vgg_block2: the second block of the vgg_cnn front end, fused, and its
// backward, at compute type bf16 (csrc/vgg_block2_f32.cu holds the f32
// entries):
//
//   out = relu(maxpool2x2(conv4_SAME(relu(conv3_SAME(x) + b3))) + b4)
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_fwd2_kernel and
// ::_bwd2_kernel (reached from _fwd2_pallas / _bwd2_pallas). As there, the
// full-resolution conv3 activation x2 never goes to device memory: the
// forward keeps the rows it needs in shared memory, and the backward
// recomputes them from x.
//
// Layouts: x (B, F, T, 64) channels-last bf16 (block 1 writes exactly
// this); out (B, F/2, T/2, 128) bf16; idx the same shape, uint8, the
// pool's argmax in window order (0,0),(0,1),(1,0),(1,1) over (f, t); g =
// dL/d(out) in bf16; dx of x's shape in bf16; the weight and bias
// gradients f32. F and T are even. Weights arrive in bf16, packed (the
// forward) or in two layouts each, "n" = HWIO (tap, in, out) and "t" =
// (tap, out, in); the entry points say which one each convolution reads.
//
// Numerics (vgg_fused.py:636-651, :668-679, :729-812):
//   * conv3: f32 sum, rounded to bf16, + b3 in bf16, relu; positions
//     outside the image are ZERO (conv4's SAME padding pads the activation,
//     so relu(0 + b3) must not leak into the border);
//   * conv4: f32 sum rounded to bf16 BEFORE the pool; strict '>' so the
//     first maximum in (f, t) order wins; best + b4 in bf16, relu;
//   * backward: dy4 = g * [out > 0] routed by idx (bf16); dW4 = sum dy4 (x)
//     x2 and db4 = sum dy4 in f32; dx2 = W4^T . dy4 summed in f32, masked by
//     the recomputed x2 > 0 and rounded once to bf16 (dy3); dW3, db3 from
//     dy3 and x in f32; dx = W3^T . dy3 summed in f32 and rounded once.
// Products of bf16 values are exact in f32, so only the order of the f32
// sums differs from a library convolution.
//
// Structure. Products on the tensor cores, with f32 accumulation: the
// forward and the backward's dx kernel on wgmma, the backward's row pass
// on mma.sync m16n8k16 with fragments read by ldmatrix from tiles whose
// rows are padded by 16 bytes so that the 8 rows of a matrix hit distinct
// banks.
//
//   forward, bf16 (vgg_block2_fwd_wgmma_kernel): one persistent pass, a
//     block an SM, each walking down 100-column strips (work items:
//     utterance, strip, pooled row r, r fastest). An item computes x2 rows
//     2r+1, 2r+2 (conv3) into a ring of x2 rows, then conv4 rows 2r, 2r+1,
//     the pool, b4 and relu in registers: each x2 row is computed once a
//     strip (plus two rows where a block's range or a strip starts).
//     Products on wgmma m64n104k16: M = 64 channels a warpgroup (the weight
//     stage's rows), N = a tile row of 104 positions (100 own columns and
//     the halo), a tap's operand the row above, at or below read from
//     position dt (the 128-byte swizzle follows the address bits); x2 is
//     held as two 64-channel halves so that a position is one 128-byte row.
//     W3 and W4 (442 KB) stream through a ring of three 16 KB stages by
//     bulk copies with mbarriers, each stage feeding 208 positions; a copy
//     warpgroup stages the x rows of the next conv3 pass by cp.async.
//   backward, bf16, two kernels:
//   * vgg_block2_bwd_rows_kernel, grid (8 channel groups, RBLK blocks): block
//     (cg, blk) owns the 16 conv3 channels 16cg .. 16cg+15 and a fixed range
//     of work items (utterance, 40-column strip, conv row pair r), taken r
//     fastest, so that it walks down its strips and stages each x row, each
//     pooled row of g / out / idx and each x2 row once per strip (the halo
//     rows only at a strip's first item) in rings indexed by row; the next
//     item's rows arrive by cp.async while the item's products run. Per
//     item: dy4 built once from the pooled rows (routed by idx); phase 1
//     runs dx2 = W4^T . dy4 transposed (warps 0-3: an own row and half of
//     the c4 each, the 16 channels as M and 40 positions as N) beside x2 of
//     the two new rows (the other warps, an m16 tile of positions each);
//     phase 2 the relu mask on the sum of dx2's halves -> dy3 and dW4 +=
//     x2 (x) dy4 (all warps, 3 taps x 32 channels each);
//     phase 3 dW3 += x (x) dy3, db3, db4 and dy3 to device memory. The
//     weight-gradient slices (72 sums a thread) stay in registers for the
//     block's life and are written once, as the block's partial sums.
//   * vgg_block2_bwd_dx_kernel, one persistent block an SM: dx = W3^T . dy3
//     on wgmma (m64n64k16: 64 positions of a row pair x the 64 input
//     channels), W3 resident in shared memory in the 128-byte swizzle, each
//     item's four dy3 rows in a flat tile of 32 positions a row (30 own
//     columns and their halo) so that a tap's operand is the tile read from
//     another row (as vgg_block1_fwd_wgmma_kernel does); one warpgroup
//     stages the next item's tile while the other runs the products. First,
//     each block adds up its share of the partial sums in block order. dy3
//     goes through device memory because dx needs all 128 of its channels
//     and each group of the first kernel holds 16.
//   Sums have one order whatever order the blocks run in: two runs give the
//   same bits.
//
// Bound on the H100 at x (12, 80, 400, 64): conv3 56.6 + conv4 113.2 =
// 169.9 GFLOP forward (0.172 ms at the 989 TFLOP/s of the bf16 tensor
// cores), twice that backward (0.343 ms; 0.401 with the x2 recompute);
// bytes are far below that. The bf16 forward runs 182.2 GFLOP of products (1.07x: 104 positions a row for 100 own
// columns, the warm passes) and reads ~0.88 GB of weight stages from L2
// (a stage feeds 832 cycles of products at the peak rate). What bounds
// the bf16 row-walking pass is shared-memory reads: its products' ldmatrix
// loads (an SM reads 128 bytes a cycle; with 16 channels a group a
// fragment feeds few products) and the staging of each item's rows, which
// every channel group repeats; PERF.md has the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CI = 64;    // input channels
constexpr int C2 = 128;   // conv3 / conv4 output channels
constexpr int CG = 16;    // conv3 channels per backward channel group
constexpr int NCG = C2 / CG;
constexpr int DW3_SIZE = 9 * CI * C2;
constexpr int DW4_SIZE = 9 * C2 * C2;
constexpr int PART2 = DW3_SIZE + C2 + DW4_SIZE + C2;  // floats per block

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t* r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
// backward, bf16: the row-walking pass (dW3, db3, dW4, db4 partials and dy3)
// ---------------------------------------------------------------------------

constexpr int RW = 40;          // conv columns a strip owns
constexpr int RX = RW + 4;      // x columns held: c0-2 .. c0+RW+1
constexpr int RD = RW + 2;      // x2 / dy4 columns held: c0-1 .. c0+RW
constexpr int RP = RW / 2 + 2;  // pooled columns staged: c0/2-1 .. c0/2+RW/2
constexpr int RT = 384;         // threads: 12 warps
constexpr int RWARPS = RT / 32;
constexpr int RBLK = 16;        // blocks per channel group; fixed: the
                                // reduction order is fixed
constexpr int DX2_WARPS = 4;  // (own row, half of the c4) each
constexpr int XRING = 8, DRING = 5, X2RING = 4;  // rows each ring holds
constexpr int PXB = CI + 8, PDB = C2 + 8, PGB = CG + 8;  // bf16 row pitches
constexpr int RAW_POS = 2 * C2 * 2 + C2;  // bytes a pooled position: g, out, idx
constexpr int DXS_P = 2 * RW + 4;  // f32 pitch of a dx2 half's channel row

struct RowsSmem {
  static constexpr int XS = XRING * RX * PXB;    // x rows
  static constexpr int DY = DRING * RD * PDB;    // dy4 rows, 128 channels
  static constexpr int X2 = X2RING * RD * PGB;   // x2 rows, the group's 16
  static constexpr int D3 = 2 * RW * PGB;        // dy3 of the own rows
  static constexpr int W3S = 9 * CG * PXB;       // (tap, 16 c3, 64 ci)
  static constexpr int W4S = 9 * CG * PDB;       // (tap, 16 c3, 128 c4)
  static constexpr int RAW = 3 * RP * RAW_POS;   // bytes: 3 pooled rows
  static constexpr size_t BYTES =
      2 * (size_t)(XS + DY + X2 + D3 + W3S + W4S) + RAW +
      sizeof(float) * (CG + 2 * 8 * CG);
};

// ring slot of conv row f (f >= -2)
__device__ __forceinline__ int xslot(int f) {
  return (f + 2 * XRING) & (XRING - 1);
}
__device__ __forceinline__ int dslot(int f) { return (f + 2 * DRING) % DRING; }
__device__ __forceinline__ int x2slot(int f) {
  return (f + X2RING) & (X2RING - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = smem_u32(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rows f0 .. f0+n-1 of utterance b, columns c0-2 .. c0+RW+1 (zero outside
// the image), into the x ring
__device__ __forceinline__ void issue_x_rows(const bf16* x, int b, int F,
                                             int Tn, int f0, int n, int c0,
                                             bf16* xs, int t, int nt) {
  for (int e = t; e < n * RX * (CI / 8); e += nt) {
    const int v = e % (CI / 8), pos = e / (CI / 8);
    const int f = f0 + pos / RX, j = pos % RX, t = c0 - 2 + j;
    const bool ok = f >= 0 && f < F && t >= 0 && t < Tn;
    cp_async16(xs + (xslot(f) * RX + j) * PXB + v * 8,
               ok ? x + (((size_t)b * F + f) * Tn + t) * CI + v * 8 : x, ok);
  }
}

// pooled rows pr0 .. pr0+n-1 of utterance b, columns c0/2-1 .. c0/2+RW/2,
// of g and out (16 chunks of 8 channels each) and idx (8 chunks of 16),
// into raw slots 0 .. n-1; zero outside the pool
__device__ __forceinline__ void issue_raw(const bf16* g, const bf16* out,
                                          const uint8_t* idx, int b, int Fp,
                                          int Tp, int pr0, int n, int c0,
                                          char* raw, int t, int nt) {
  for (int e = t; e < n * RP * 40; e += nt) {
    const int k = e % 40, pp = e / 40;
    const int R = pr0 + pp / RP, P = c0 / 2 - 1 + pp % RP;
    const bool ok = R >= 0 && R < Fp && P >= 0 && P < Tp;
    const size_t off =
        (((size_t)b * Fp + (ok ? R : 0)) * Tp + (ok ? P : 0)) * C2;
    char* dst = raw + pp * RAW_POS;
    if (k < 16)
      cp_async16(dst + 16 * k, reinterpret_cast<const char*>(g + off) + 16 * k,
                 ok);
    else if (k < 32)
      cp_async16(dst + 256 + 16 * (k - 16),
                 reinterpret_cast<const char*>(out + off) + 16 * (k - 16), ok);
    else
      cp_async16(dst + 512 + 16 * (k - 32), idx + off + 16 * (k - 32), ok);
  }
}

// dy4 = g * [out > 0] routed by idx (g is bf16: no rounding) at the conv
// rows 2pr, 2pr+1 of raw slot s's pooled row pr = pr0 + s (s < n), those
// rows >= flo only, columns c0-1 .. c0+RW, into the dy4 ring. One task a
// pooled position and 8 channels: its four conv positions, on packed bf16
// pairs (out > 0 is a signed 16-bit compare of its bits: bf16 orders as
// sign-magnitude, and +0 and -0 are not > 0)
__device__ __forceinline__ void build_dy4(const char* raw, bf16* dys,
                                          int pr0, int n, int flo, int t,
                                          int nt) {
  for (int e = t; e < n * RP * 16; e += nt) {
    const int ch = e & 15, pp = e >> 4, s = pp / RP, P = pp % RP;
    const char* src = raw + pp * RAW_POS;
    const uint4 gv = *reinterpret_cast<const uint4*>(src + ch * 16);
    const uint4 ov = *reinterpret_cast<const uint4*>(src + 256 + ch * 16);
    const uint2 iv = *reinterpret_cast<const uint2*>(src + 512 + ch * 8);
    // g where out > 0, a 16-bit lane each
    const uint32_t gp[4] = {gv.x & __vcmpgts2(ov.x, 0u),
                            gv.y & __vcmpgts2(ov.y, 0u),
                            gv.z & __vcmpgts2(ov.z, 0u),
                            gv.w & __vcmpgts2(ov.w, 0u)};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int f = 2 * (pr0 + s) + a;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 2 * P - 1 + c;  // column c0-1+j = c0-2+2P+c
        if (f < flo || j < 0 || j >= RD) continue;
        // idx == this window element, a byte a channel, widened to lanes
        const uint32_t wp = 0x01010101u * (uint32_t)(2 * a + c);
        const uint32_t m0 = __vcmpeq4(iv.x, wp), m1 = __vcmpeq4(iv.y, wp);
        *reinterpret_cast<uint4*>(dys + (dslot(f) * RD + j) * PDB + ch * 8) =
            make_uint4(gp[0] & __byte_perm(m0, 0, 0x1100),
                       gp[1] & __byte_perm(m0, 0, 0x3322),
                       gp[2] & __byte_perm(m1, 0, 0x1100),
                       gp[3] & __byte_perm(m1, 0, 0x3322));
      }
    }
  }
}

// x2 = relu(bf16(bf16(conv3) + b3)) of the group's 16 channels at the new
// rows (2r+1, 2r+2; a warm item also 2r-1, 2r), zero outside the image:
// position p = q * RD + j is conv (2r-1+q, c0-1+j). M = positions (m16
// tiles taken in turn by the warps DX2_WARPS..: each SM sub-partition holds
// one dx2 warp and two of these), N = 16, K = 9 taps x 64, summed in three
// chains (by dt) so that a warp keeps six products in flight
__device__ __forceinline__ int x2_rank(int warp) { return warp - DX2_WARPS; }

__device__ __forceinline__ void x2_products(const bf16* xs, const bf16* w3s,
                                            bf16* x2s, const float* b3s,
                                            bool warm, int r, int c0, int F,
                                            int Tn, int warp, int lane) {
  const int base = warm ? 0 : 2 * RD, npos = 4 * RD - base;
  for (int t = x2_rank(warp); t * 16 < npos; t += RWARPS - DX2_WARPS) {
    int pa = base + 16 * t + (lane & 7) + ((lane >> 3) & 1) * 8;
    if (pa >= 4 * RD) pa = 4 * RD - 1;  // computed and dropped
    const int fa = 2 * r - 1 + pa / RD, ja = pa % RD;
    float acc[3][2][4];
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[dt][n][i] = 0.f;
#pragma unroll 1
    for (int df = 0; df < 3; ++df) {
      const bf16* ap = xs + (xslot(fa - 1 + df) * RX + ja) * PXB + (lane >> 4) * 8;
      const bf16* bp = w3s + (3 * df * CG + (lane & 7) + (lane >> 4) * 8) * PXB +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < CI / 16; ++kc)
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          uint32_t a[4], q[4];
          ldsm_x4(ap + dt * PXB + kc * 16, a);
          ldsm_x4(bp + dt * CG * PXB + kc * 16, q);
          mma_bf16(acc[dt][0], a, q[0], q[1]);
          mma_bf16(acc[dt][1], a, q[2], q[3]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = base + 16 * t + (lane >> 2) + 8 * h;
        if (p >= 4 * RD) continue;
        const int f = 2 * r - 1 + p / RD, j = p % RD, tc = c0 - 1 + j;
        const int n = nt * 8 + 2 * (lane & 3);
        const bool in = f >= 0 && f < F && tc >= 0 && tc < Tn;
        float v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int i = 2 * h + k;
          const float sum = acc[0][nt][i] + acc[1][nt][i] + acc[2][nt][i];
          v[k] = in ? fmaxf(bf16r(bf16r(sum) + b3s[n + k]), 0.f) : 0.f;
        }
        *reinterpret_cast<uint32_t*>(x2s + (x2slot(f) * RD + j) * PGB + n) =
            pack_bf16(v[0], v[1]);
      }
  }
}

// dx2 of the group's 16 channels at the 40 own positions of conv row 2r+q,
// columns c0 .. c0+RW-1, over the 64 c4 of half h, for warp (q, h): the
// transposed convolution reads dy4 at (2r+q+1-df, c0+j+1-dt). The product is
// transposed so that one weight fragment feeds five: M = the 16 channels
// (W4's rows as the A operand), N = the 40 positions in five n8 tiles, K =
// 9 taps x 64. The half's sums go to dxs[h][channel][position] (f32);
// mask_dy3 adds the two halves in order.
__device__ __forceinline__ void dx2_products(const bf16* dys, const bf16* w4s,
                                             float* dxs, int r, int warp,
                                             int lane) {
  const int q = warp >> 1, h = warp & 1;
  float acc[5][4];
#pragma unroll
  for (int t = 0; t < 5; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  const bf16* ap = w4s + ((lane & 7) + ((lane >> 3) & 1) * 8) * PDB + 64 * h +
                   (lane >> 4) * 8;
#pragma unroll 1
  for (int df = 0; df < 3; ++df) {
    // position j = 8 (2 pair + (lane >> 4)) + (lane & 7) of tap (df, dt)
    // reads dy4 column j + 2 - dt of the ring
    const bf16* bp = dys +
                     (dslot(2 * r + q + 1 - df) * RD + (lane & 7) +
                      (lane >> 4) * 8) * PDB +
                     64 * h + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[4], b[3][4];
        ldsm_x4(ap + (3 * df + dt) * CG * PDB + kc * 16, a);
        const bf16* bq = bp + (2 - dt) * PDB + kc * 16;
        ldsm_x4(bq, b[0]);
        ldsm_x4(bq + 16 * PDB, b[1]);
        ldsm_x2(bq + (32 - (lane >> 4) * 8) * PDB, b[2]);
#pragma unroll
        for (int t = 0; t < 5; ++t)
          mma_bf16(acc[t], a, b[t >> 1][2 * (t & 1)],
                   b[t >> 1][2 * (t & 1) + 1]);
      }
  }
  // acc[t][2 hi + k]: channel lane / 4 + 8 hi, position 8 t + 2 (lane % 4) + k
#pragma unroll
  for (int t = 0; t < 5; ++t)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      *reinterpret_cast<float2*>(
          dxs + (h * CG + (lane >> 2) + 8 * hi) * DXS_P + q * RW + 8 * t +
          2 * (lane & 3)) = make_float2(acc[t][2 * hi], acc[t][2 * hi + 1]);
}

// dy3 = bf16((dx2 of half 0 + half 1) * [x2 > 0]) at the own positions, into
// the dy3 tile: a task a position and two channels
__device__ __forceinline__ void mask_dy3(const float* dxs, const bf16* x2s,
                                         bf16* d3s, int r, int t, int nt) {
  for (int e = t; e < 2 * RW * CG / 2; e += nt) {
    const int p = e % (2 * RW), n = 2 * (e / (2 * RW));
    const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(
        x2s + (x2slot(2 * r + p / RW) * RD + p % RW + 1) * PGB + n);
    const float v0 = dxs[n * DXS_P + p] + dxs[(CG + n) * DXS_P + p];
    const float v1 = dxs[(n + 1) * DXS_P + p] + dxs[(CG + n + 1) * DXS_P + p];
    *reinterpret_cast<uint32_t*>(d3s + p * PGB + n) =
        pack_bf16(__low2float(m) > 0.f ? v0 : 0.f,
                  __high2float(m) > 0.f ? v1 : 0.f);
  }
}

// dW4[3df+dt][16cg+m][32c4g+n] += sum over the own positions p of
// x2[p + (df-1, dt-1)][m] * dy4[p][n]: warp = (df, c4g), 3 taps x 4 n8
// tiles; K = the 80 own positions in m16 steps
__device__ __forceinline__ void dw4_products(const bf16* x2s, const bf16* dys,
                                             float (&acc)[3][4][4], int r,
                                             int warp, int lane) {
  const int df = warp >> 2, c4g = warp & 3;
  const int ak = (lane & 7) + (lane >> 4) * 8, am = ((lane >> 3) & 1) * 8;
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bn = 32 * c4g + (lane >> 4) * 8;
#pragma unroll 1
  for (int kb = 0; kb < 2 * RW / 16; ++kb) {
    const int pb = 16 * kb + bk, pa = 16 * kb + ak;
    const bf16* bptr =
        dys + (dslot(2 * r + pb / RW) * RD + pb % RW + 1) * PDB + bn;
    uint32_t b[2][4];
    ldsm_x4_t(bptr, b[0]);
    ldsm_x4_t(bptr + 16, b[1]);
    const bf16* aptr =
        x2s + (x2slot(2 * r + pa / RW + df - 1) * RD + pa % RW) * PGB + am;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      uint32_t a[4];
      ldsm_x4_t(aptr + dt * PGB, a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[dt][nt], a, b[nt >> 1][2 * (nt & 1)],
                 b[nt >> 1][2 * (nt & 1) + 1]);
    }
  }
}

// dW3[3df+dt][16mt+m][16cg+n] += sum over the own positions p of
// x[p + (df-1, dt-1)][16mt+m] * dy3[p][n]: warp = (df, mt), 3 taps x 2 n8
// tiles
__device__ __forceinline__ void dw3_products(const bf16* xs, const bf16* d3s,
                                             float (&acc)[3][2][4], int r,
                                             int warp, int lane) {
  const int df = warp >> 2, mt = warp & 3;
  const int ak = (lane & 7) + (lane >> 4) * 8;
  const int am = 16 * mt + ((lane >> 3) & 1) * 8;
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll 1
  for (int kb = 0; kb < 2 * RW / 16; ++kb) {
    const int pa = 16 * kb + ak;
    uint32_t b[4];
    ldsm_x4_t(d3s + (16 * kb + bk) * PGB + (lane >> 4) * 8, b);
    const bf16* aptr =
        xs + (xslot(2 * r + pa / RW + df - 1) * RX + pa % RW + 1) * PXB + am;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      uint32_t a[4];
      ldsm_x4_t(aptr + dt * PXB, a);
      mma_bf16(acc[dt][0], a, b[0], b[1]);
      mma_bf16(acc[dt][1], a, b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(RT, 1)
vgg_block2_bwd_rows_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w3c,
                           const float* __restrict__ b3,
                           const bf16* __restrict__ w4d,
                           const bf16* __restrict__ g,
                           const bf16* __restrict__ out,
                           const uint8_t* __restrict__ idx,
                           bf16* __restrict__ dy3, float* __restrict__ part,
                           int B, int F, int Tn) {
  typedef RowsSmem S;
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);
  bf16* dys = xs + S::XS;
  bf16* x2s = dys + S::DY;
  bf16* d3s = x2s + S::X2;
  bf16* w3s = d3s + S::D3;
  bf16* w4s = w3s + S::W3S;
  char* raw = reinterpret_cast<char*>(w4s + S::W4S);
  float* b3s = reinterpret_cast<float*>(raw + S::RAW);
  float* red = b3s + CG;  // [2][8][CG]: db3, db4 by thread part
  // dx2's two halves, in raw slots 1 and 2: from the dy4 build to the next
  // item's, only slot 0 is loaded
  float* dxs = reinterpret_cast<float*>(raw + RP * RAW_POS);

  const int cg = blockIdx.x, blk = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int Fp = F / 2, Tp = Tn / 2, chunks = (Tn + RW - 1) / RW;
  const long n_items = (long)B * chunks * Fp;
  const long lo = n_items * blk / RBLK, hi = n_items * (blk + 1) / RBLK;

  // the group's rows of w3c (9, 128 c3, 64 ci) and w4d (9, 128 c3, 128 c4),
  // in the first copy group
  for (int e = tid; e < 9 * CG * (CI / 8); e += RT) {
    const int c = e % (CI / 8), row = e / (CI / 8);
    cp_async16(w3s + row * PXB + c * 8,
               w3c + ((size_t)(row / CG) * C2 + cg * CG + row % CG) * CI +
                   c * 8,
               true);
  }
  for (int e = tid; e < 9 * CG * (C2 / 8); e += RT) {
    const int c = e % (C2 / 8), row = e / (C2 / 8);
    cp_async16(w4s + row * PDB + c * 8,
               w4d + ((size_t)(row / CG) * C2 + cg * CG + row % CG) * C2 +
                   c * 8,
               true);
  }
  cp_async_commit();
  if (tid < CG) b3s[tid] = bf16r(b3[cg * CG + tid]);

  float acc4[3][4][4], acc3[3][2][4];
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int n = 0; n < 4; ++n) acc4[dt][n][i] = 0.f;
      acc3[dt][0][i] = acc3[dt][1][i] = 0.f;
    }
  float dbias = 0.f;  // db3 (threads 0..127: 8 parts x 16), db4 (288..383)

  for (long it = lo; it < hi; ++it) {
    const int r = (int)(it % Fp);
    const int c0 = (int)((it / Fp) % chunks) * RW;
    const int b = (int)(it / Fp / chunks);
    // the first item of a strip (or of the block) stages its halo rows too
    const bool warm = it == lo || r == 0;
    if (warm) {
      __syncthreads();  // the previous item's readers of the x ring are done
      issue_x_rows(x, b, F, Tn, 2 * r - 2, 6, c0, xs, tid, RT);
      issue_raw(g, out, idx, b, Fp, Tp, r - 1, 3, c0, raw, tid, RT);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // this item's x rows and pooled rows have landed
    if (warm)
      build_dy4(raw, dys, r - 1, 3, 2 * r - 1, tid, RT);
    else
      build_dy4(raw, dys, r + 1, 1, 2 * r + 2, tid, RT);
    __syncthreads();  // dy4 rows 2r-1 .. 2r+3 built; raw consumed
    if (it + 1 < hi && r + 1 < Fp) {  // the next item continues the strip
      issue_x_rows(x, b, F, Tn, 2 * r + 4, 2, c0, xs, tid, RT);
      issue_raw(g, out, idx, b, Fp, Tp, r + 2, 1, c0, raw, tid, RT);
    }
    cp_async_commit();

    if (warp < DX2_WARPS) {
      dx2_products(dys, w4s, dxs, r, warp, lane);
    } else {
      x2_products(xs, w3s, x2s, b3s, warm, r, c0, F, Tn, warp, lane);
    }
    __syncthreads();  // x2 rows 2r+1, 2r+2 and dx2's halves written
    mask_dy3(dxs, x2s, d3s, r, tid, RT);
    dw4_products(x2s, dys, acc4, r, warp, lane);
    __syncthreads();  // dy3 written; x2 and dy4 read
    dw3_products(xs, d3s, acc3, r, warp, lane);
    if (tid < 128) {  // db3
      const int ch = tid & 15;
      for (int p = tid >> 4; p < 2 * RW; p += 8)
        dbias += __bfloat162float(d3s[p * PGB + ch]);
    } else if (tid < 128 + 4 * RW) {  // dy3 out, for the dx kernel
      const int e = tid - 128, p = e >> 1, j = p % RW;
      if (c0 + j < Tn)
        *reinterpret_cast<uint4*>(
            dy3 + (((size_t)b * F + 2 * r + p / RW) * Tn + c0 + j) * C2 +
            cg * CG + (e & 1) * 8) =
            *reinterpret_cast<const uint4*>(d3s + p * PGB + (e & 1) * 8);
    } else {  // db4 of the group's channels (6 parts of 16 threads)
      const int ch = tid & 15;
      for (int p = (tid - 288) >> 4; p < 2 * RW; p += 6)
        dbias += __bfloat162float(
            dys[(dslot(2 * r + p / RW) * RD + p % RW + 1) * PDB + cg * CG +
                ch]);
    }
  }
  cp_async_wait_all();

  // the block's partial sums: its group's slices of dW3, db3, dW4, db4
  float* pb = part + (size_t)blk * PART2;
  {
    const int df = warp >> 2, c4g = warp & 3;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (lane >> 2) + 8 * h;
          const int n = 32 * c4g + 8 * nt + 2 * (lane & 3);
          *reinterpret_cast<float2*>(
              pb + DW3_SIZE + C2 +
              ((size_t)(3 * df + dt) * C2 + cg * CG + m) * C2 + n) =
              make_float2(acc4[dt][nt][2 * h], acc4[dt][nt][2 * h + 1]);
        }
  }
  {
    const int df = warp >> 2, mt = warp & 3;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * mt + (lane >> 2) + 8 * h;
          const int n = cg * CG + 8 * nt + 2 * (lane & 3);
          *reinterpret_cast<float2*>(
              pb + ((size_t)(3 * df + dt) * CI + m) * C2 + n) =
              make_float2(acc3[dt][nt][2 * h], acc3[dt][nt][2 * h + 1]);
        }
  }
  if (tid < 128)
    red[tid] = dbias;
  else if (tid >= 288)
    red[8 * CG + tid - 288] = dbias;
  __syncthreads();
  if (tid < 2 * CG) {  // the parts of each channel in order
    const int k = tid / CG, ch = tid % CG;
    float s = 0.f;
    for (int p = 0; p < (k == 0 ? 8 : 6); ++p)
      s += red[k * 8 * CG + p * CG + ch];
    pb[(k == 0 ? DW3_SIZE : DW3_SIZE + C2 + DW4_SIZE) + cg * CG + ch] = s;
  }
}

// ---------------------------------------------------------------------------
// backward, bf16: dx = W3^T . dy3 on wgmma, and the sum of the partials
// ---------------------------------------------------------------------------

constexpr int DXW = 30;              // conv columns an item owns
constexpr int DXP = DXW + 2;         // positions a tile row holds: c0-1 ..
constexpr int DX_ROWS = 4 * DXP + 2;  // a pad, conv rows 2r-1 .. 2r+2, a pad
// bytes of one 64-channel half of a dy3 tile (rows of 128 bytes), kept on
// 1024-byte boundaries: the 128-byte swizzle follows the address bits
constexpr int DX_HALF = (DX_ROWS * 128 + 1023) / 1024 * 1024;
constexpr int DX_W3 = 9 * 2 * CI * 128;  // W3 as 18 (tap, c3 half) tiles
constexpr int DX_THREADS = 256;      // warpgroup 0: products; 1: staging
constexpr int DX_BLOCKS = 132;       // persistent: one an SM
constexpr size_t DX_SMEM = DX_W3 + 4 * DX_HALF + 1024;  // + alignment
enum { DX_FULL = 1, DX_EMPTY = 3 };  // named barriers, one a tile buffer

// offset in bytes of 16-byte chunk c of row `row` in a tile of 128-byte
// rows in the 128-byte swizzle (on a 1024-byte boundary)
__device__ __forceinline__ int swz128(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 64 bf16, 8-row groups 1024 bytes apart); the start may lie any
// whole number of 16-byte units past a 1024-byte boundary (the swizzle is
// taken from the address bits), so a tap's shifted operand is the tile
// read from another row
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) += A (64 x 16) . B (16 x 64), both from shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// named barriers between the two warpgroups: `count` threads take part,
// those that only signal arrive
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// grads[e] = sum over the nparts blocks, in block order, of part[k][e], for
// this block's share of the elements
__device__ __forceinline__ void reduce_partials(const float* part,
                                                float* grads, int nparts) {
  const int lo = (int)((long)PART2 * blockIdx.x / gridDim.x);
  const int hi = (int)((long)PART2 * (blockIdx.x + 1) / gridDim.x);
  for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nparts; ++k) s += part[(size_t)k * PART2 + e];
    grads[e] = s;
  }
}

// Work item (utterance, 30-column strip, conv row pair r), r fastest, in
// fixed block ranges. Warpgroup 1 stages each item's dy3 rows 2r-1 ..
// 2r+2, columns c0-1 .. c0+30 (zero outside the image), into one of two
// tiles: flat row 1 + 32 i + p holds (2r-1+i, c0-1+p). Warpgroup 0 runs
// dx[m = 32 q + j] = sum over taps (df, dt) and the 128 c3 of
// tile[m + 2 + 32 (2-df) - dt] . W3[tap]^T as wgmma m64n64k16 (M = the 64
// positions (q, j) of the item's two rows, N = the 64 input channels, K =
// 16 c3): a tap's operand is the tile read from another row. Outputs at
// j = 0 and j = 31 read the pads or the neighbouring row: computed and
// dropped. W3 stays in shared memory for the block's life.
__global__ void __launch_bounds__(DX_THREADS, 1)
vgg_block2_bwd_dx_kernel(const bf16* __restrict__ dy3,
                         const bf16* __restrict__ w3d,
                         const float* __restrict__ part,
                         float* __restrict__ grads, bf16* __restrict__ dx,
                         int B, int F, int Tn, int nparts) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4) +
               ((1024 - (smem_u32(smem4) & 1023)) & 1023);
  char* w3s = base;             // (tap, half) tiles of 64 ci x 64 c3
  char* tiles = base + DX_W3;   // (buffer, half) dy3 tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Fp = F / 2, chunks = (Tn + DXW - 1) / DXW;
  const long n_items = (long)B * chunks * Fp;
  const long lo = n_items * blockIdx.x / DX_BLOCKS,
             hi = n_items * (blockIdx.x + 1) / DX_BLOCKS;

  // w3d (9, 64 ci, 128 c3), for the block's life; the tiles' pad rows
  for (int e = tid; e < 9 * CI * 16; e += DX_THREADS) {
    const int k = e & 15, row = e >> 4;  // row = tap * 64 + ci
    cp_async16(w3s + ((row / CI) * 2 + k / 8) * CI * 128 +
                   swz128(row % CI, k % 8),
               w3d + 8 * e, true);
  }
  cp_async_commit();
  for (int e = tid; e < 4 * 2 * 8; e += DX_THREADS)
    *reinterpret_cast<uint4*>(tiles + (e >> 4) * DX_HALF +
                              swz128((e & 8) ? DX_ROWS - 1 : 0, e & 7)) =
        make_uint4(0, 0, 0, 0);
  reduce_partials(part, grads, nparts);
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= 128) {  // staging, two items' copies in flight
    const int t = tid - 128;
    for (long it = lo; it <= hi; ++it) {
      const int k = (int)(it - lo), sb = k & 1;
      if (it < hi) {
        const int r = (int)(it % Fp);
        const int c0 = (int)((it / Fp) % chunks) * DXW;
        const int b = (int)(it / Fp / chunks);
        if (k >= 2) bar_sync(DX_EMPTY + sb, DX_THREADS);  // item k-2 read
        for (int e = t; e < 4 * DXP * 16; e += 128) {
          const int c = e & 15, pos = e >> 4, i = pos / DXP, p = pos % DXP;
          const int f = 2 * r - 1 + i, tt = c0 - 1 + p;
          const bool ok = f >= 0 && f < F && tt >= 0 && tt < Tn;
          cp_async16(tiles + (2 * sb + c / 8) * DX_HALF +
                         swz128(1 + i * DXP + p, c % 8),
                     ok ? dy3 + (((size_t)b * F + f) * Tn + tt) * C2 + 8 * c
                        : dy3,
                     ok);
        }
        cp_async_commit();
      }
      if (k >= 1) {  // item k-1's copies have landed
        if (it < hi)
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else
          cp_async_wait_all();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(DX_FULL + (sb ^ 1), DX_THREADS);
      }
    }
  } else {  // products and stores
    for (long it = lo; it < hi; ++it) {
      const int k = (int)(it - lo), sb = k & 1;
      const int r = (int)(it % Fp);
      const int c0 = (int)((it / Fp) % chunks) * DXW;
      const int b = (int)(it / Fp / chunks);
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      bar_sync(DX_FULL + sb, DX_THREADS);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int start = 2 + DXP * (2 - tap / 3) - tap % 3;
#pragma unroll
        for (int kc = 0; kc < 8; ++kc)  // descriptors count 16-byte units
          wgmma_m64n64k16(
              acc,
              smem_desc(tiles + (2 * sb + kc / 4) * DX_HALF) + start * 8 +
                  (kc % 4) * 2,
              smem_desc(w3s + (tap * 2 + kc / 4) * CI * 128) + (kc % 4) * 2);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (k + 2 < hi - lo) bar_arrive(DX_EMPTY + sb, DX_THREADS);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * warp + (lane >> 2) + 8 * h, j = m % DXP;
          const int tt = c0 - 1 + j;
          if (j < 1 || j > DXW || tt >= Tn) continue;
          *reinterpret_cast<uint32_t*>(
              dx + (((size_t)b * F + 2 * r + m / DXP) * Tn + tt) * CI +
              8 * jn + 2 * (lane & 3)) =
              pack_bf16(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// forward, bf16: one persistent pass, conv3 and conv4 on wgmma
// ---------------------------------------------------------------------------
//
// A block walks a fixed range of work items (utterance, 100-column strip,
// pooled row r), r fastest, so it walks down its strips. Every tile row
// holds FQ = 104 positions of 64 channels, 128 bytes a position in the
// 128-byte swizzle: an x row holds columns c0-2 .. c0+101, an x2 row
// c0-1 .. c0+102 (two 64-channel halves, each its own tile), conv4's output
// row c0 .. c0+103, of which the strip owns the first 100. A tap (df, dt)
// reads the row above, at or below, from position dt of its slot (a
// descriptor may start on any 128-byte row of a swizzled tile); positions
// past a row's end read the next slot: garbage, only ever in the last two
// x2 and the last four conv4 columns, which are never used.
//   * rings of 4 x rows and 4 x2 rows, indexed by row (slot4): an item
//     computes x2 rows 2r+1, 2r+2 (conv3), then conv4 rows 2r, 2r+1 from x2
//     rows 2r-1 .. 2r+2, so each x2 row is computed once a strip; the first
//     item of a block's range or of a strip computes rows 2r-1, 2r first
//     (its warm pass);
//   * the weights stream through a ring of FRING stages of 16 KB by bulk
//     copies (one thread, mbarriers): W3 as 9 (tap) stages of 128 conv3 x 64
//     input channels, W4 as 18 (tap, input half) stages of 128 x 64, packed
//     by the wrapper in the swizzle, 27 stages an item (36 warm);
//   * warpgroup c (0, 1) owns conv3 channels and conv4 outputs 64c .. 64c+63
//     (M = the channels, A = the stage's rows; N = a row's 104 positions,
//     B = the x or x2 row): wgmma m64n104k16, two rows an item, 52 sums a
//     row and thread; conv3's half c of x2 is written by stmatrix (its
//     epilogue: round, + b3 in bf16, relu, zero outside the image);
//   * warpgroup 2: warp 8 issues the weight stages, warps 9-11 copy each
//     pass's new x rows (cp.async, zero outside the image) while the
//     products of the previous pass run;
//   * the pool epilogue in registers: a thread holds both conv rows and
//     both columns of its windows; out and idx leave through swizzled
//     staging tiles as 16-byte stores.
// The ring (3 stages) is shallower than conv3's 9, so a warpgroup's conv3
// epilogue, which overwrites x2 slots, follows both warpgroups' last conv4
// products of the item before.

constexpr int FQ = 104;                 // positions a tile row holds
constexpr int FOWN = FQ - 4;            // conv columns a strip owns
constexpr int FROW = FQ * 128;          // bytes of a 64-channel tile row
constexpr int FSTAGE = C2 * 128;        // bytes of a weight stage
constexpr int FRING = 3;                // weight stages in flight
constexpr int FW3 = 9, FW4 = 18;        // weight stages of conv3, conv4
constexpr int FSTG = 56;                // pooled positions a staging tile holds
constexpr int F_THREADS = 384;          // warpgroups 0-1 products, 2 copies
constexpr int F_CREGS = 232, F_PREGS = 40;  // registers after setmaxnreg
constexpr int F_XS = FRING * FSTAGE;          // x ring (weights before it)
constexpr int F_X2 = F_XS + 4 * FROW;         // x2 ring, (row, half) tiles
constexpr int F_OUT = F_X2 + 8 * FROW;        // out staging, a warpgroup each
constexpr int F_IDX = F_OUT + 2 * FSTG * 128;  // idx staging
constexpr int F_BIAS = F_IDX + 2 * FSTG * 64;  // b3, b4 in bf16
constexpr int F_BAR = F_BIAS + 2 * C2 * 2;     // mbarriers: full, empty
constexpr size_t F_SMEM = F_BAR + 2 * FRING * 8 + 1024;  // + alignment
static_assert(F_SMEM <= 232448, "the forward's shared memory");
// named barriers: x rows landed / read (copy warps and products), x2 written
// (both product warpgroups), a warpgroup's staging tiles (FB_EPI + c)
enum { FB_XFULL = 1, FB_XEMPTY = 2, FB_X2 = 3, FB_EPI = 4 };
constexpr int FB_XCOUNT = 256 + 96;

__device__ __forceinline__ int slot4(int f) { return (f + 4) & 3; }

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// bytes from device memory to shared memory by the bulk-copy engine; the
// mbarrier counts them in
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// stmatrix, transposed: 8 x 8 b16 matrices from the mma fragment layout;
// row k of matrix j is written at the address lane 8j + k holds
__device__ __forceinline__ void stsm_x2_t(void* p, uint32_t r0, uint32_t r1) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::
          "r"(smem_u32(p)),
      "r"(r0), "r"(r1)
      : "memory");
}
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 104, f32) += A (64 x 16) . B (16 x 104), both from shared memory
__device__ __forceinline__ void wgmma_n104(float (&d)[52], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
      "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void fence_acc2(float (&d)[2][52]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 52; ++i) asm volatile("" : "+f"(d[q][i])::"memory");
}
__device__ __forceinline__ void zero_acc2(float (&d)[2][52]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 52; ++i) d[q][i] = 0.f;
  fence_acc2(d);
}
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[2][52]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_acc2(d);
}

struct F2Item {
  int b, c0, r;  // utterance, the strip's first column, pooled row
  bool warm;     // the block's first item or the strip's first row
};

__device__ __forceinline__ F2Item f2_item(long it, long lo, int Fp,
                                          int strips) {
  F2Item w;
  w.r = (int)(it % Fp);
  const long q = it / Fp;
  w.c0 = (int)(q % strips) * FOWN;
  w.b = (int)(q / strips);
  w.warm = it == lo || w.r == 0;
  return w;
}

// conv3 of x2 rows f0, f0 + 1 for tap t, issued and committed: x2 row f
// reads x row f + df - 1 from position dt of its slot. `a`: the stage's
// rows of the warpgroup's 64 conv3 channels
__device__ __forceinline__ void conv3_stage(float (&acc)[2][52],
                                            const char* a, const char* xs,
                                            int f0, int t) {
  const int df = t / 3, dt = t % 3;
  const uint64_t ad = smem_desc(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const uint64_t bd =
        smem_desc(xs + slot4(f0 + rr + df - 1) * FROW) + dt * 8;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // descriptors count 16-byte units
      wgmma_n104(acc[rr], ad + kc * 2, bd + kc * 2);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// conv4 of rows 2r, 2r + 1 for tap t over input half h, issued and
// committed: row g reads half h of x2 row g + df - 1 from position dt
__device__ __forceinline__ void conv4_stage(float (&acc)[2][52],
                                            const char* a, const char* x2s,
                                            int r, int t, int h) {
  const int df = t / 3, dt = t % 3;
  const uint64_t ad = smem_desc(a);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint64_t bd =
        smem_desc(x2s + (slot4(2 * r + q + df - 1) * 2 + h) * FROW) + dt * 8;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_n104(acc[q], ad + kc * 2, bd + kc * 2);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// x2 = relu(bf16(bf16(conv3) + b3)) of x2 rows f0, f0 + 1, half c, zero
// outside the image (and in the two garbage columns), into the x2 ring.
// acc[rr][4i + 2h + e]: channel 16 warp + lane / 4 + 8h of the half,
// position 8i + 2 (lane % 4) + e; stmatrix.trans writes each n8 block's
// 8 positions x 16 channels as 16-byte rows
__device__ __forceinline__ void conv3_epilogue(const float (&acc)[2][52],
                                               char* x2s, const bf16* b3s,
                                               int f0, int c0, int F, int Tn,
                                               int c) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  __nv_bfloat162 bb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bb[h] = __bfloat162bfloat162(b3s[64 * c + 16 * warp + (lane >> 2) + 8 * h]);
  const int kk = lane & 7, chunk = 2 * warp + ((lane >> 3) & 1);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int f = f0 + rr;
    const bool rowok = f >= 0 && f < F;
    char* base = x2s + (slot4(f) * 2 + c) * FROW;
#pragma unroll
    for (int i = 0; i < FQ / 8; ++i) {
      const int n = 8 * i + 2 * (lane & 3), t = c0 - 1 + n;
      const uint32_t keep =
          (rowok && n < FQ - 2 && t >= 0 && t < Tn ? 0xFFFFu : 0u) |
          (rowok && n + 1 < FQ - 2 && t + 1 >= 0 && t + 1 < Tn ? 0xFFFF0000u
                                                                : 0u);
      uint32_t v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h] = keep & bf16x2_bits(__hmax2(
                          __hadd2(__floats2bfloat162_rn(acc[rr][4 * i + 2 * h],
                                                        acc[rr][4 * i + 2 * h + 1]),
                                  bb[h]),
                          zero2));
      const int row = 8 * i + kk;  // row & 7 == kk
      stsm_x2_t(base + row * 128 + ((chunk ^ kk) << 4), v[0], v[1]);
    }
  }
}

// pool (first maximum in (f, t) order), + b4 in bf16, relu of conv4 rows
// 2r, 2r + 1, channels 64c .. 64c + 63, into the warpgroup's staging tiles,
// then out (and idx) as 16-byte stores. acc[q][4i + 2h + e]: row 2r + q,
// column 8i + 2 (lane % 4) + e, channel 16 warp + lane / 4 + 8h: pooled
// column p = 4i + lane % 4. Blocks i, i + 1 go out as one transposed
// stmatrix: fragment column 2a + e holds p = 4i + a + 4e.
__device__ __forceinline__ void pool_epilogue(
    const float (&acc)[2][52], const bf16* b4s, char* outs, uint8_t* idxs,
    bf16* out, uint8_t* idx, int b, int r, int c0, int Fp, int Tp, int c) {
  const int wt = threadIdx.x & 127, lane = wt & 31, warp = wt >> 5;
  char* ob = outs + c * FSTG * 128;
  uint8_t* ib = idxs + c * FSTG * 64;
  const int ch = 16 * warp + (lane >> 2);  // and ch + 8
  const float b4v[2] = {__bfloat162float(b4s[64 * c + ch]),
                        __bfloat162float(b4s[64 * c + ch + 8])};
  const int kk = lane & 7, chunk = 2 * warp + ((lane >> 3) & 1);
  const int prow = (kk >> 1) + 4 * (kk & 1);
  bar_sync(FB_EPI + c, 128);  // the previous item's stores read the staging
  uint32_t lo[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < FQ / 8 + 1; ++i) {
    uint32_t v[2] = {0u, 0u};
    if (i < FQ / 8) {
      float tv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 r0 = __floats2bfloat162_rn(
            acc[0][4 * i + 2 * h], acc[0][4 * i + 2 * h + 1]);
        const __nv_bfloat162 r1 = __floats2bfloat162_rn(
            acc[1][4 * i + 2 * h], acc[1][4 * i + 2 * h + 1]);
        const float e[4] = {__low2float(r0), __high2float(r0),
                            __low2float(r1), __high2float(r1)};
        float best = e[0];
        uint8_t id = 0;
#pragma unroll
        for (int m = 1; m < 4; ++m)
          if (e[m] > best) { best = e[m]; id = m; }
        tv[h] = best + b4v[h];
        if (idx != nullptr) ib[(4 * i + (lane & 3)) * 64 + ch + 8 * h] = id;
      }
      const uint32_t pv = bf16x2_bits(
          __hmax2(__floats2bfloat162_rn(tv[0], tv[1]),
                  __floats2bfloat162_rn(0.f, 0.f)));
      v[0] = pv & 0xFFFFu;
      v[1] = pv >> 16;
    }
    if (i & 1) {  // blocks i - 1, i: pooled columns 4 (i - 1) .. 4i + 3
      const int p = 4 * (i - 1) + prow;
      stsm_x2_t(ob + p * 128 + ((chunk ^ (p & 7)) << 4), lo[0] | (v[0] << 16),
                lo[1] | (v[1] << 16));
    } else {
      lo[0] = v[0];
      lo[1] = v[1];
    }
  }
  bar_sync(FB_EPI + c, 128);
  const int np = min(FOWN / 2, Tp - c0 / 2);
  const size_t row = ((size_t)b * Fp + r) * Tp + c0 / 2;
  for (int e = wt; e < np * 8; e += 128) {
    const int p = e >> 3, q = e & 7;
    *reinterpret_cast<uint4*>(out + (row + p) * C2 + 64 * c + 8 * q) =
        *reinterpret_cast<const uint4*>(ob + p * 128 + ((q ^ (p & 7)) << 4));
  }
  if (idx != nullptr)
    for (int e = wt; e < np * 4; e += 128) {
      const int p = e >> 2, q = e & 3;
      *reinterpret_cast<uint4*>(idx + (row + p) * C2 + 64 * c + 16 * q) =
          *reinterpret_cast<const uint4*>(ib + p * 64 + 16 * q);
    }
}

__global__ void __launch_bounds__(F_THREADS, 1)
vgg_block2_fwd_wgmma_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ w3p,
                            const float* __restrict__ b3,
                            const bf16* __restrict__ w4p,
                            const float* __restrict__ b4,
                            bf16* __restrict__ out,
                            uint8_t* __restrict__ idx, int B, int F,
                            int Tn) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4) +
               ((1024 - (smem_u32(smem4) & 1023)) & 1023);
  char* wring = base;
  char* xs = base + F_XS;
  char* x2s = base + F_X2;
  char* outs = base + F_OUT;
  uint8_t* idxs = reinterpret_cast<uint8_t*>(base + F_IDX);
  bf16* b3s = reinterpret_cast<bf16*>(base + F_BIAS);
  bf16* b4s = b3s + C2;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + F_BAR);
  uint64_t* empty = full + FRING;

  const int Fp = F / 2, Tp = Tn / 2, strips = (Tn + FOWN - 1) / FOWN;
  const long n = (long)B * strips * Fp;
  const long lo = n * blockIdx.x / gridDim.x;
  const long hi = n * (blockIdx.x + 1) / gridDim.x;
  const int tid = threadIdx.x;
  if (tid < C2) {
    b3s[tid] = __float2bfloat16(b3[tid]);
    b4s[tid] = __float2bfloat16(b4[tid]);
  }
  if (tid == 0) {
    for (int s = 0; s < FRING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each product warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PREGS));
    if (tid == 256) {
      // the weight stages, in the order the products take them
      int s = 0, ph = 0;
      long k = 0;
      for (long it = lo; it < hi; ++it) {
        const bool warm = it == lo || it % Fp == 0;
        const int nst = (warm ? FW3 : 0) + FW3 + FW4;
        for (int j = 0; j < nst; ++j, ++k) {
          const int st = warm && j >= FW3 ? j - FW3 : j;
          if (k >= FRING) mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], FSTAGE);
          bulk_g2s(wring + s * FSTAGE,
                   st < FW3 ? w3p + (size_t)st * (FSTAGE / 2)
                            : w4p + (size_t)(st - FW3) * (FSTAGE / 2),
                   FSTAGE, &full[s]);
          if (++s == FRING) { s = 0; ph ^= 1; }
        }
      }
    } else if (tid >= 288) {
      // each conv3 pass's new x rows, once the previous pass has read
      // the slots they replace
      const int lt = tid - 288;
      long pass = 0;
      for (long it = lo; it < hi; ++it) {
        const F2Item w = f2_item(it, lo, Fp, strips);
        const bf16* xb = x + (size_t)w.b * F * Tn * CI;
        for (int ps = 0; ps < (w.warm ? 2 : 1); ++ps, ++pass) {
          const bool pre = w.warm && ps == 0;
          const int nr = pre ? 4 : 2;
          const int fr = pre ? 2 * w.r - 2 : 2 * w.r + 2;
          if (pass > 0) bar_sync(FB_XEMPTY, FB_XCOUNT);
          for (int e = lt; e < nr * FQ * 8; e += 96) {
            const int q = e & 7, pos = e >> 3;
            const int f = fr + pos / FQ, j = pos % FQ, t = w.c0 - 2 + j;
            const bool ok = f >= 0 && f < F && t >= 0 && t < Tn;
            cp_async16(xs + slot4(f) * FROW + j * 128 + ((q ^ (j & 7)) << 4),
                       ok ? xb + ((size_t)f * Tn + t) * CI + 8 * q : x, ok);
          }
          cp_async_commit();
          cp_async_wait_all();
          fence_proxy_async();
          bar_arrive(FB_XFULL, FB_XCOUNT);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CREGS));
    const int c = tid >> 7, lane = tid & 31;
    int s = 0, ph = 0, prev = 0;
    for (long it = lo; it < hi; ++it) {
      const F2Item w = f2_item(it, lo, Fp, strips);
      const int b = w.b, r = w.r, c0 = w.c0;
      for (int ps = 0; ps < (w.warm ? 2 : 1); ++ps) {
        const int f0 = w.warm && ps == 0 ? 2 * r - 1 : 2 * r + 1;
        float acc3[2][52];
        zero_acc2(acc3);
        bar_sync(FB_XFULL, FB_XCOUNT);
        for (int t = 0; t < FW3; ++t) {
          mbar_wait(&full[s], ph);
          const char* wst = wring + s * FSTAGE;
          conv3_stage(acc3, wst + c * 8192, xs, f0, t);
          if (t > 0) {  // the previous stage's products are done
            wgmma_wait<1>(acc3);
            if (lane == 0) mbar_arrive(&empty[prev]);
          }
          prev = s;
          if (++s == FRING) { s = 0; ph ^= 1; }
        }
        wgmma_wait<0>(acc3);
        if (lane == 0) mbar_arrive(&empty[prev]);
        if (it + 1 < hi || ps + 1 < (w.warm ? 2 : 1))
          bar_arrive(FB_XEMPTY, FB_XCOUNT);  // the x slots may be refilled
        conv3_epilogue(acc3, x2s, b3s, f0, c0, F, Tn, c);
        fence_proxy_async();
        bar_sync(FB_X2, 256);  // both halves of the new x2 rows written
      }
      float acc4[2][52];
      zero_acc2(acc4);
      for (int j = 0; j < FW4; ++j) {
        const int t = j >> 1, h = j & 1;
        mbar_wait(&full[s], ph);
        const char* wst = wring + s * FSTAGE;
        conv4_stage(acc4, wst + c * 8192, x2s, r, t, h);
        if (j > 0) {
          wgmma_wait<1>(acc4);
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
        if (++s == FRING) { s = 0; ph ^= 1; }
      }
      wgmma_wait<0>(acc4);
      if (lane == 0) mbar_arrive(&empty[prev]);
      pool_epilogue(acc4, b4s, outs, idxs, out, idx, b, r, c0, Fp, Tp, c);
    }
  }
}

int launch_fwd_wgmma(const void* x, const void* w3p, const void* b3,
                     const void* w4p, const void* b4, void* out, void* idx,
                     int B, int F, int Tn, void* stream) {
  cudaGetLastError();  // report only this launch's error
  if (B == 0 || F == 0 || Tn == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block2_fwd_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // persistent: one block an SM, or one an item where there are fewer
  const long n = (long)B * ((Tn + FOWN - 1) / FOWN) * (F / 2);
  const int grid = (int)(n < sms ? n : sms);
  vgg_block2_fwd_wgmma_kernel<<<grid, F_THREADS, F_SMEM,
                                (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w3p, (const float*)b3, (const bf16*)w4p,
      (const float*)b4, (bf16*)out, (uint8_t*)idx, B, F, Tn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int launch_bwd_rows(const void* x, const void* w3c, const void* b3,
                    const void* w4d, const void* w3d, const void* g,
                    const void* out, const void* idx, void* dy3, void* dx,
                    void* part, void* grads, int B, int F, int Tn,
                    void* stream) {
  typedef bf16 T;
  cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F == 0 || Tn == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART2, s);
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block2_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)RowsSmem::BYTES);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(vgg_block2_bwd_dx_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DX_SMEM);
  if (e != cudaSuccess) return e;
  vgg_block2_bwd_rows_kernel<<<dim3(NCG, RBLK), RT, RowsSmem::BYTES, s>>>(
      (const T*)x, (const T*)w3c, (const float*)b3, (const T*)w4d,
      (const T*)g, (const T*)out, (const uint8_t*)idx, (T*)dy3, (float*)part,
      B, F, Tn);
  vgg_block2_bwd_dx_kernel<<<DX_BLOCKS, DX_THREADS, DX_SMEM, s>>>(
      (const T*)dy3, (const T*)w3d, (const float*)part, (float*)grads,
      (T*)dx, B, F, Tn, RBLK);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward. x (B, F, T, 64) bf16; b3, b4 (128) f32; out (B, F/2, T/2, 128)
// bf16; idx uint8 of out's shape or null; w3p, w4p the packed weight
// stages (9 and 18 of 128 x 64, each row in the 128-byte swizzle: see
// ops/vgg_fused._fwd2_stages).
extern "C" int vgg_block2_fwd_bf16(const void* x, const void* w3p,
                                   const void* b3, const void* w4p,
                                   const void* b4, void* out, void* idx,
                                   int B, int F, int T, void* stream) {
  return launch_fwd_wgmma(x, w3p, b3, w4p, b4, out, idx, B, F, T, stream);
}

// Backward. g, out, idx as the forward's output; dy3 (B, F, T, 128) bf16
// scratch; dx (B, F, T, 64) bf16; part RBLK x PART2 f32 scratch; grads
// PART2 f32 = dW3 (3,3,64,128) | db3 (128) | dW4 (3,3,128,128) | db4 (128).
// w3c = w3 "t", w4d = w4 "n", w3d = w3 "n".
extern "C" int vgg_block2_bwd_bf16(const void* x, const void* w3c,
                                   const void* b3, const void* w4d,
                                   const void* w3d, const void* g,
                                   const void* out, const void* idx,
                                   void* dy3, void* dx, void* part,
                                   void* grads, int B, int F, int T,
                                   void* stream) {
  return launch_bwd_rows(x, w3c, b3, w4d, w3d, g, out, idx, dy3, dx, part,
                         grads, B, F, T, stream);
}
