// vgg_block1: the bf16 entries of the first block of the vgg_cnn front end,
// fused, and of its backward (csrc/vgg_block1_f32.cu holds the f32 entries):
//
//   out = relu(maxpool2x2(conv2_SAME(relu(conv1_SAME(x) + b1))) + b2)
//
// Replaces end2end_asr_tpu/ops/vgg_fused.py::_fwd_kernel (reached from
// _fwd_pallas's pl.pallas_call). As there, the conv1 activations never go
// to device memory: each block computes the ones it needs into shared
// memory, and conv2, the pool, the bias and the relu run on them.
//
// Layouts: x (B, F, T) f32; w1 (3,3,1,64) HWIO f32; b1, b2 (64,) f32;
// conv2's weight bf16 (3,3,64 out,64 in) (the wrapper packs it, as the JAX
// package packs its weights outside its kernel, vgg_fused.py:315-325);
// out (B, F/2, T/2, 64) NHWC in the compute type cdt (bf16); idx,
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
// What bounds it on the H100: conv2 at the 2Fp x 2Tp positions the pool
// keeps and conv1 at the F x T of the image, 115.0 GFLOP at B=12, F=161,
// T=800 (chip_smoke.py: vgg1_work): 0.116 ms at the 989 TFLOP/s of the
// bf16 tensor cores (the serving path's compute type), 1.72 ms at the 67
// TFLOP/s of f32 FMA. Bytes are small beside it (~80 MB in and out with
// idx).
//
// bf16 (vgg_block1_fwd_wgmma_kernel): one persistent pass, a block of four
// warpgroups on each SM. Work item = (utterance, pair of pooled rows = 4
// conv rows, 31 pooled = 62 conv columns); each block walks a fixed range
// of items, and each output is written by exactly one item.
//   * W2 (72 KB bf16, (tap, co, ci)) is copied into shared memory once for
//     the block's life;
//   * warpgroups 2-3 (conv1) stage each item's input one item ahead, in
//     registers, store it rounded to bf16, and build the item's x1 (f32 FMA,
//     6 rows x 64 positions x 64 channels) into one of two buffers while
//     warpgroups 0-1 run the previous item's products: conv1's FMA issues
//     beside the tensor cores. Its roundings run on packed bf16 pairs (a
//     conversion costs eight FMAs' issue slots);
//   * warpgroup c (0, 1) runs conv2 of conv rows 2c, 2c+1 as 36
//     wgmma.m64n128k16 (M = the 64 output channels, A = W2's tap slice; N =
//     2 conv rows x 64 positions, B = the x1 tile). A row of 64 x1 positions
//     holds the item's 62 columns and their halo, so tap (df, dt)'s operand
//     is the same tile read from position 64 (2c + df) + dt on (a descriptor
//     may start on any 128-byte row of the swizzled tile: the swizzle
//     follows the address bits): no shifted copies. The last two columns of
//     each row of the product read the next row: garbage, never stored. The
//     two warpgroups take turns on the tensor cores, so one's epilogue runs
//     while the other's products do;
//   * the epilogue: a thread's accumulators hold both columns and both rows
//     of each of its windows (its fragment pair, and the block 8 further
//     on), so pool, argmax, b2 and relu run in registers; out and idx leave
//     through a swizzled shared-memory tile as 16-byte stores;
//   * setmaxnreg moves registers from the products' warpgroups (64 sums a
//     thread) to conv1's (72 weights and 32 sums a thread).
// The products sum in the order of the mma.sync kernel this one replaced
// (taps, then 16-channel steps); at the main path's shape the two gave the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;  // channels of conv1 out / conv2 in and out

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// bf16: one persistent pass, conv2 on wgmma (sm_90a), conv1 beside it
// ---------------------------------------------------------------------------

// Offset (in bf16 elements) of 16-byte chunk `ch` (8 channels) of row
// `row` in a [rows][64] bf16 tile whose chunks are XOR-swizzled by row: on
// a 1024-byte boundary this is the 128-byte swizzle of wgmma's shared-
// memory descriptors (and of ldmatrix tiles without bank conflicts).
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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16x2_bits(__floats2bfloat162_rn(lo, hi));
}

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

// named barriers of the forward: `count` threads take part, those that
// only signal arrive, those that must wait sync
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// generic-proxy shared-memory writes made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 64 bf16, 8-row groups 1024 bytes apart); the start may lie any
// whole number of 16-byte units past a 1024-byte boundary: the swizzle is
// taken from the address bits, as swz() writes it
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128), both from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr int FW_THREADS = 512;   // warpgroups 0-1: products; 2-3: conv1
constexpr int FW_PTHREADS = 256;  // conv1's threads
// registers a thread after setmaxnreg, 65536 in all: the products (64
// sums), conv1 (72 weights, 32 sums); neither spills
constexpr int FW_CREGS = 112;
constexpr int FW_PREGS = 144;
constexpr int FW_COLS = 62;       // conv columns per item
constexpr int FW_PCOLS = FW_COLS / 2;  // pooled columns per item
constexpr int FW_X1POS = 6 * 64 + 8;  // x1 positions a buffer holds
constexpr int FW_XC = 68;         // row pitch of the staged input tile
constexpr int FW_XS = 8 * FW_XC;  // floats of one staged input tile
constexpr size_t FW_SMEM =
    1024 +                                  // room to align to 1024 bytes
    2 * (size_t)(9 * C * C) +               // W2, (tap, co, ci)
    2 * 2 * (size_t)(FW_X1POS * C) +        // two x1 buffers
    2 * (size_t)(2 * 32 * C) +              // out staging, bf16
    (size_t)(2 * 32 * C) +                  // idx staging
    4 * (size_t)(2 * FW_XS + 9 * C + 2 * C);  // inputs, w1, b1, b2
// named barriers: the producers' own; x1 buffer s built, for consumer
// warpgroup c (BAR_FULL + 2c + s); buffer s read by both (BAR_EMPTY + s);
// consumer c's turn on the tensor cores (BAR_ORDER + c); c's staging tile
enum { BAR_PROD = 1, BAR_FULL = 2, BAR_EMPTY = 6, BAR_ORDER = 8,
       BAR_EPI = 10 };

struct FwdItem {
  int b, rp, chunk;  // utterance, pooled row pair, FW_PCOLS-column chunk
};

__device__ __forceinline__ FwdItem fwd_item(long it, int rps, int chunks) {
  FwdItem w;
  w.chunk = (int)(it % chunks);
  it /= chunks;
  w.rp = (int)(it % rps);
  w.b = (int)(it / rps);
  return w;
}

// an item's input, rows 4rp-2 .. 4rp+5, columns c0-2 .. c0+63 (zero
// outside the image): producer thread ptid loads elements ptid + 256 m into
// registers one item ahead, and stores them rounded to bf16 (once per
// element: a conversion costs eight FMAs' issue) after the current x1
__device__ __forceinline__ void load_x(const float* x, const FwdItem& w,
                                       int F, int T, int ptid,
                                       float (&v)[3]) {
  const float* xb = x + (size_t)w.b * F * T;
  const int c0 = FW_COLS * w.chunk;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int e = ptid + FW_PTHREADS * m, i = e / 66, j = e % 66;
    const int g = 4 * w.rp - 2 + i, t = c0 - 2 + j;
    v[m] = (e < 8 * 66 && g >= 0 && g < F && t >= 0 && t < T)
               ? __ldg(xb + (size_t)g * T + t) : 0.f;
  }
}
__device__ __forceinline__ void store_x(const float (&v)[3], float* xs,
                                        int ptid) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int e = ptid + FW_PTHREADS * m;
    if (e < 8 * 66) xs[(e / 66) * FW_XC + e % 66] = bf16r(v[m]);
  }
}

// x1 = relu(bf16(bf16(conv1) + b1)) at the item's 6 x 64 positions,
// position i * 64 + j = conv (4rp-1+i, c0-1+j), zero outside the image, as
// bf16 [position][64] swizzled by position. Task e: channels 8cg .. 8cg+7
// of four columns (their 3 x 6 inputs in six 16- and 8-byte loads); the
// thread's channel group is fixed, so its weights live in registers. FMA
// over the
// taps 0..8 in order: the backward's build_x1_task computes the same bits.
// The roundings run on packed pairs: one conversion rounds two sums, and
// bf16 add and max give bf16(bf16(s) + b1) and the relu exactly (a sum of
// two bf16 values is exact in f32 or rounds to the larger one either way;
// `probe_vgg_fwd.py --bf16-ops` checks both over every bf16 pair).
__device__ __forceinline__ void build_x1(const float* xs,
                                         const float (&wr)[9][8],
                                         const __nv_bfloat162 (&bp)[4],
                                         __nv_bfloat16* x1, const FwdItem& w,
                                         int F, int T, int ptid) {
  const int cg = ptid & 7;
  const int c0 = FW_COLS * w.chunk;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll 1
  for (int e = ptid; e < 6 * 16 * 8; e += FW_PTHREADS) {
    const int pq = e >> 3, i = pq >> 4, j = 4 * (pq & 15);
    float xv[3][6];
#pragma unroll
    for (int df = 0; df < 3; ++df) {
      const float* row = xs + (i + df) * FW_XC + j;
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float2 b = *reinterpret_cast<const float2*>(row + 4);
      xv[df][0] = a.x; xv[df][1] = a.y; xv[df][2] = a.z; xv[df][3] = a.w;
      xv[df][4] = b.x; xv[df][5] = b.y;
    }
    float o[4][8];
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int k = 0; k < 8; ++k) o[h][k] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int h = 0; h < 4; ++h)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[h][k] = fmaf(xv[tap / 3][tap % 3 + h], wr[tap][k], o[h][k]);
    const int g = 4 * w.rp - 1 + i;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int t = c0 - 1 + j + h;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (g >= 0 && g < F && t >= 0 && t < T) {
        uint32_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          r[k] = bf16x2_bits(__hmax2(
              __hadd2(__floats2bfloat162_rn(o[h][2 * k], o[h][2 * k + 1]),
                      bp[k]),
              zero2));
        v = make_uint4(r[0], r[1], r[2], r[3]);
      }
      *reinterpret_cast<uint4*>(x1 + swz(i * 64 + j + h, cg)) = v;
    }
  }
}

// conv2 of a consumer warpgroup's half item: 64 output channels x 128
// positions (2 conv rows x 64 columns) over K = 9 taps x 64 input channels,
// issued and committed. Tap (df, dt) reads the x1 tile from position
// df * 64 + dt past the half's own first row (x1d): the 128 positions it
// gives are the conv outputs' own; the last two columns of each row read
// the next row (garbage, never stored).
__device__ __forceinline__ void conv2_products(float (&acc)[64],
                                               uint64_t w2d, uint64_t x1d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // descriptors count 16-byte units
      wgmma_m64n128k16(acc, w2d + tap * (C * C * 2 / 16) + kc * 2,
                       x1d + ((tap / 3) * 64 + tap % 3) * 8 + kc * 2);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait(float (&acc)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// the pool window of the thread's channels co (h = 0) and co + 8 (h = 1) in
// the n8 block bi of the half's first conv row (its second row is block
// bi + 8): columns {0, 1} of the block's fragment pair are the window's two
// columns. v = relu(bf16(max + b2)) of the two channels, rounded in pairs
// as in build_x1
__device__ __forceinline__ void pool_window(const float (&acc)[64], int bi,
                                            const float (&b2v)[2],
                                            __nv_bfloat162& v,
                                            uint8_t (&id)[2]) {
  float t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat162 r0 =
        __floats2bfloat162_rn(acc[4 * bi + 2 * h], acc[4 * bi + 2 * h + 1]);
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(
        acc[4 * (bi + 8) + 2 * h], acc[4 * (bi + 8) + 2 * h + 1]);
    const float e[4] = {__low2float(r0), __high2float(r0), __low2float(r1),
                        __high2float(r1)};
    float best = e[0];
    uint8_t k = 0;
#pragma unroll
    for (int m = 1; m < 4; ++m)
      if (e[m] > best) { best = e[m]; k = m; }
    t[h] = best + b2v[h];
    id[h] = k;
  }
  v = __hmax2(__floats2bfloat162_rn(t[0], t[1]),
              __floats2bfloat162_rn(0.f, 0.f));
}

__global__ void __launch_bounds__(FW_THREADS, 1)
vgg_block1_fwd_wgmma_kernel(const float* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const __nv_bfloat16* __restrict__ w2p,
                            const float* __restrict__ b2,
                            __nv_bfloat16* __restrict__ out,
                            uint8_t* __restrict__ idx, int B, int F, int T) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~(uintptr_t)1023);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(base);  // 576 x 64
  __nv_bfloat16* x1s = w2s + 9 * C * C;           // 2 x FW_X1POS x 64
  __nv_bfloat16* outs = x1s + 2 * FW_X1POS * C;   // 2 x 32 x 64
  uint8_t* idxs = reinterpret_cast<uint8_t*>(outs + 2 * 32 * C);  // same
  float* xs = reinterpret_cast<float*>(idxs + 2 * 32 * C);  // 2 x FW_XS
  float* w1s = xs + 2 * FW_XS;                              // 9 x C
  float* b1s = w1s + 9 * C;                                 // C
  float* b2s = b1s + C;                                     // C

  const int Fp = F / 2, Tp = T / 2;
  const int rps = (Fp + 1) / 2, chunks = (Tp + FW_PCOLS - 1) / FW_PCOLS;
  const long n = (long)B * rps * chunks;
  const long lo = n * blockIdx.x / gridDim.x;
  const long hi = n * (blockIdx.x + 1) / gridDim.x;
  const int tid = threadIdx.x;

  // W2 once for the block's life; w1, b1, b2 rounded to bf16; the x1
  // buffers' pad positions (read only for garbage columns) zeroed
  for (int e = tid; e < 9 * C * 8; e += FW_THREADS)
    cp_async16(w2s + swz(e >> 3, e & 7), w2p + 8 * e, true);
  cp_async_commit();
  for (int e = tid; e < 9 * C; e += FW_THREADS) w1s[e] = bf16r(w1[e]);
  for (int e = tid; e < C; e += FW_THREADS) {
    b1s[e] = bf16r(b1[e]);
    b2s[e] = bf16r(b2[e]);
  }
  for (int e = tid; e < 2 * 8 * 8; e += FW_THREADS)
    *reinterpret_cast<uint4*>(x1s + ((e >> 6) * FW_X1POS + 6 * 64) * C +
                              8 * (e & 63)) = make_uint4(0, 0, 0, 0);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  if (tid >= 256) {
    // conv1: stage each item's input, build its x1 into the free buffer;
    // the products' warpgroups hand over registers they do not use
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FW_PREGS));
    const int ptid = tid - 256, cg = ptid & 7;
    float wr[9][8], xr[3];
    __nv_bfloat162 bp[4];
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) wr[k][i] = w1s[k * C + cg * 8 + i];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bp[k] = __floats2bfloat162_rn(b1s[cg * 8 + 2 * k],
                                    b1s[cg * 8 + 2 * k + 1]);
    if (lo < hi) {
      load_x(x, fwd_item(lo, rps, chunks), F, T, ptid, xr);
      store_x(xr, xs, ptid);
    }
    for (long it = lo; it < hi; ++it) {
      const int k = (int)(it - lo), s = k & 1;
      const FwdItem w = fwd_item(it, rps, chunks);
      const bool next = it + 1 < hi;
      bar_sync(BAR_PROD, FW_PTHREADS);  // this item's input stored; the
                                        // other tile's readers are done
      if (next) load_x(x, fwd_item(it + 1, rps, chunks), F, T, ptid, xr);
      if (k >= 2) bar_sync(BAR_EMPTY + s, FW_THREADS);  // item k-2 read
      {
        const float* xs_cur = xs + s * FW_XS;
        __nv_bfloat16* x1b = x1s + s * FW_X1POS * C;
        build_x1(xs_cur, wr, bp, x1b, w, F, T, ptid);
      }
      fence_proxy_async();
      bar_arrive(BAR_FULL + s, FW_PTHREADS + 128);      // consumer 0
      bar_arrive(BAR_FULL + 2 + s, FW_PTHREADS + 128);  // consumer 1
      if (next) store_x(xr, xs + (s ^ 1) * FW_XS, ptid);
    }
  } else {
    // consumer warpgroup c: conv2 of conv rows 2c, 2c+1 of each item on the
    // tensor cores, then pooled row c's epilogue. The two take turns on the
    // tensor cores (BAR_ORDER), so one's epilogue runs beside the other's
    // products
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FW_CREGS));
    const int c = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
    const int coa = 16 * warp + (lane >> 2);   // and coa + 8
    const float b2v[2] = {b2s[coa], b2s[coa + 8]};
    const uint64_t w2d = smem_desc(w2s);
    __nv_bfloat16* outc = outs + c * 32 * C;
    uint8_t* idxc = idxs + c * 32 * C;
    for (long it = lo; it < hi; ++it) {
      const int k = (int)(it - lo), s = k & 1;
      const FwdItem w = fwd_item(it, rps, chunks);
      float acc[64];
      bar_sync(BAR_FULL + 2 * c + s, FW_PTHREADS + 128);
      if (c == 1 || k > 0) bar_sync(BAR_ORDER + c, 256);
      {
        const uint64_t x1d =
            smem_desc(x1s + (s * FW_X1POS + 2 * c * 64) * C);
        conv2_products(acc, w2d, x1d);
      }
      if (c == 0 || it + 1 < hi) bar_arrive(BAR_ORDER + (c ^ 1), 256);
      wgmma_wait(acc);
      if (k + 2 < hi - lo) bar_arrive(BAR_EMPTY + s, FW_THREADS);

      bar_sync(BAR_EPI + c, 128);  // the previous item's stores read staging
#pragma unroll
      for (int b0 = 0; b0 < 8; ++b0) {
        __nv_bfloat162 v;
        uint8_t id[2];
        pool_window(acc, b0, b2v, v, id);
        const int kk = 4 * b0 + (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          outc[kk * C + (((2 * warp + h) ^ (kk & 7)) << 3) + (lane >> 2)] =
              h ? __high2bfloat16(v) : __low2bfloat16(v);
          idxc[kk * C + coa + 8 * h] = id[h];
        }
      }
      bar_sync(BAR_EPI + c, 128);
      const int tp0 = FW_PCOLS * w.chunk, np = min(FW_PCOLS, Tp - tp0);
      const int fp = 2 * w.rp + c;
      if (fp < Fp) {
        const size_t row = ((size_t)w.b * Fp + fp) * Tp + tp0;
        for (int e = tid & 127; e < FW_PCOLS * 8; e += 128) {
          const int kk = e >> 3, q = e & 7;
          if (kk < np)
            *reinterpret_cast<uint4*>(out + (row + kk) * C + 8 * q) =
                *reinterpret_cast<const uint4*>(outc + kk * C +
                                                ((q ^ (kk & 7)) << 3));
        }
        if (idx != nullptr)
          for (int e = tid & 127; e < FW_PCOLS * 4; e += 128) {
            const int kk = e >> 2, q = e & 3;
            if (kk < np)
              *reinterpret_cast<uint4*>(idx + (row + kk) * C + 16 * q) =
                  *reinterpret_cast<const uint4*>(idxc + kk * C + 16 * q);
          }
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
// of blocks walks a fixed range of work items, keeps its partial sums in
// registers and writes them out, and a last kernel adds the partials in
// block order: two runs give identical bits.
//
// Work item = (utterance, pair of conv rows 2r, 2r+1, 64 conv columns c0 ..
// c0+63), r over the (F + 1) / 2 row pairs so an odd last row is covered.
// Everything an item needs lies at rows 2r-1 .. 2r+2 and columns c0-1 ..
// c0+64: x1 there feeds its dW2, dy2 there (the halo comes from the
// neighbouring items' pool windows) feeds its dx1, so every x1 position's
// dx1 is complete inside one item and no partial dx1 crosses blocks.
//
// Bound on the H100 (B=12, F=161, T=800): dW2 at the 2Fp x 2Tp positions
// the pool keeps (113.2 GFLOP), dx1 at the F x T of the image (114.0),
// conv1's recompute and dW1 2 x 1.8: 230.8 GFLOP, 0.233 ms on the bf16
// tensor cores (3.44 ms at the f32 FMA rate); bytes (~130 MB) are small
// beside it.
//
// bf16 (vgg_block1_bwd_fused_kernel): ONE pass. FUSED_BLOCKS persistent
// blocks of 12 warps, one per SM; W2 (72 KB, (tap, ci, co)) stays in shared
// memory for the block's life. Per item:
//   * its input tile (f32) and its three pooled rows of g / out / idx arrive
//     by cp.async while the previous item's dW2 products run;
//   * x1 (conv1 on f32 FMA, in the forward kernel's order: the same bits)
//     and dy2 are built ONCE, as bf16 [position][64] tiles of 4 x 66
//     positions whose 16-byte chunks are XOR-swizzled by position; the
//     relu mask of the item's own positions is kept as bits;
//   * dW2 on the tensor cores (mma.sync m16n8k16), all 12 warps:
//     warpgroup df holds dW2[df] (3 taps x 64 ci x 64 co, 96 f32 a thread)
//     for the block's life, each warp 16 ci; K = the item's 128 positions;
//     dy2 fragments are shared by the three taps, x1 fragments by the eight
//     co tiles;
//   * then, at once: warps 0-7 run dx1 = sum_taps dy2_shift . W2_tap^T on
//     the tensor cores (M = 128 positions, N = 64 ci, K = 9 x 64 co; each
//     SM sub-partition's two warps own 32 positions and 4 ci tiles each),
//     the relu mask, db1, and write cdt(dx1) to a [position][64] tile,
//     while warps 8-11 build the NEXT item's x1 and mask on the CUDA cores
//     (the x1 tile is free once dW2 has read it): the FMA work issues
//     beside the tensor-core products, and no warp holds both the dx1
//     accumulators and conv1's registers;
//   * dW1 (64 ci x 9 taps padded to 16) = cdt(dx1)^T . im2col(cdt(x)), an
//     mma.sync product over the item's positions (warps 0-7, a tile each).
//   Three block-wide barriers per item (the two kernels of the earlier
//   design took six). The products run on mma.sync with the tap-shifted
//   operand from registers (ldmatrix with per-lane rows). A wgmma
//   descriptor can start on any 128-byte row of a swizzled tile (the
//   forward's products rely on it), so a wgmma design is open.

constexpr int FUSED_BLOCKS = 132;  // one per SM; fixed: the reduction order
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

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

// ---- the fused pass, bf16 --------------------------------------------------

constexpr int FT = 384;                 // threads: 12 warps, 3 warpgroups
constexpr int PCOLS = CW / 2 + 2;       // pooled columns staged per item
constexpr int PPOS = 3 * PCOLS;         // pooled positions staged (3 rows)
constexpr int RAW = PPOS * C * 5;       // bytes: g, out (bf16), idx (u8)
constexpr int CP = 2 * CW + 8;          // row pitch of the im2col tile
constexpr int X1_TASKS = 4 * (XW / 2) * 8;  // column pairs x channel groups
constexpr int DX_WARPS = 8;                 // warps of dx1 and dW1
constexpr size_t FUSED_SMEM =
    2 * (size_t)(9 * C * C + 2 * 4 * XW * C + 2 * CW * C + 2 * 16 * CP) +
    2 * (size_t)(2 * CW * 8) + (size_t)RAW +
    4 * (size_t)(6 * XS + 9 * C + C + FT * 8 + FT * 8);

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t& r0,
                                        uint32_t& r1) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// cp.async of an item's inputs: x at rows 2r-2 .. 2r+3, columns c0-2 ..
// c0+65 (f32, zero outside the image) into xs; the pooled rows r-1 .. r+1,
// columns c0/2-1 .. c0/2+32 of g, out (16-byte chunks of 8 channels) and
// idx (16 channels) into raw, zero outside the pool
__device__ __forceinline__ void issue_item(
    const float* x, const __nv_bfloat16* g, const __nv_bfloat16* out,
    const uint8_t* idx, const Item& w, int F, int T, char* raw, float* xs,
    int tid) {
  const int Fp = F / 2, Tp = T / 2;
  const float* xb = x + (size_t)w.b * F * T;
  for (int e = tid; e < 6 * XS; e += FT) {
    const int i = e / XS, j = e % XS;
    const int gr = 2 * w.r - 2 + i, t = w.c0 - 2 + j;
    const bool ok = gr >= 0 && gr < F && t >= 0 && t < T;
    cp_async4(xs + e, ok ? xb + (size_t)gr * T + t : x, ok);
  }
  for (int e = tid; e < PPOS * 20; e += FT) {
    const int p = e / 20, k = e % 20;
    const int R = w.r - 1 + p / PCOLS, P = w.c0 / 2 - 1 + p % PCOLS;
    const bool ok = R >= 0 && R < Fp && P >= 0 && P < Tp;
    const size_t off =
        (((size_t)w.b * Fp + (ok ? R : 0)) * Tp + (ok ? P : 0)) * C;
    if (k < 8)
      cp_async16(raw + p * 128 + 16 * k,
                 reinterpret_cast<const char*>(g + off) + 16 * k, ok);
    else if (k < 16)
      cp_async16(raw + (PPOS + p) * 128 + 16 * (k - 8),
                 reinterpret_cast<const char*>(out + off) + 16 * (k - 8), ok);
    else
      cp_async16(raw + 2 * PPOS * 128 + p * 64 + 16 * (k - 16),
                 idx + off + 16 * (k - 16), ok);
  }
}

// dy2 at tile position (i, j) = conv (2r-1+i, c0-1+j), 8 channels a
// thread; db2 of the item's own pooled positions (tile rows 1-2, columns
// 1-64) into the thread's own 8 slots of db2s ([8][FT])
__device__ __forceinline__ void build_dy2(const char* raw,
                                          __nv_bfloat16* dys, float* db2s,
                                          int tid) {
  const int ch = tid & 7;  // fixed: FT % 8 == 0
  for (int e = tid; e < 4 * XW * 8; e += FT) {
    const int pos = e >> 3, i = pos / XW, j = pos % XW;
    const int p = ((i + 1) >> 1) * PCOLS + ((j + 1) >> 1);
    const int wp = 2 * ((i + 1) & 1) + ((j + 1) & 1);
    const uint4 gv = *reinterpret_cast<const uint4*>(raw + p * 128 + ch * 16);
    const uint4 ov =
        *reinterpret_cast<const uint4*>(raw + (PPOS + p) * 128 + ch * 16);
    const uint2 iv = *reinterpret_cast<const uint2*>(
        raw + 2 * PPOS * 128 + p * 64 + ch * 8);
    const __nv_bfloat16* ga = reinterpret_cast<const __nv_bfloat16*>(&gv);
    const __nv_bfloat16* oa = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const uint8_t* ia = reinterpret_cast<const uint8_t*>(&iv);
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[k] = (ia[k] == wp && __bfloat162float(oa[k]) > 0.f)
                 ? __bfloat162float(ga[k]) : 0.f;
    *reinterpret_cast<uint4*>(dys + swz(pos, ch)) =
        make_uint4(pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]),
                   pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7]));
    if (i >= 1 && i <= 2 && j >= 1 && j <= CW)
#pragma unroll
      for (int k = 0; k < 8; ++k) db2s[k * FT + tid] += d[k];
  }
}

// x1 at tile positions (i, j) and (i, j+1) = conv (2r-1+i, c0-1+j ..) for
// channel group cg (task e: 8 channels of a column pair), as
// vgg_block1_fwd_wgmma_kernel computes it (the same FMA order and
// roundings), zero outside the image; and the relu mask of the item's own
// positions as bits, mask[p][cg] (own position p = (i-1) * CW + j-1). Two
// columns a task share six of their nine inputs and give the FMA chains
// twice the independent work
__device__ __forceinline__ void build_x1_task(const float* xs,
                                              const float* w1s,
                                              const float* b1s,
                                              __nv_bfloat16* x1s,
                                              uint8_t* mask, const Item& w,
                                              int F, int T, int e) {
  const int cg = e & 7, pp = e >> 3;
  const int i = pp / (XW / 2), j = 2 * (pp % (XW / 2));
  const float4* w4 = reinterpret_cast<const float4*>(w1s);
  float xv[3][4];
#pragma unroll
  for (int df = 0; df < 3; ++df)
#pragma unroll
    for (int c = 0; c < 4; ++c) xv[df][c] = bf16r(xs[(i + df) * XS + j + c]);
  float o[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 8; ++k) o[h][k] = 0.f;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float4 a = w4[tap * 16 + 2 * cg], b = w4[tap * 16 + 2 * cg + 1];
    const float wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xt = xv[tap / 3][tap % 3 + h];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[h][k] = fmaf(xt, wv[k], o[h][k]);
    }
  }
  const int gr = 2 * w.r - 1 + i;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = w.c0 - 1 + j + h;
    uint4 v = make_uint4(0, 0, 0, 0);
    uint32_t bits = 0;
    if (gr >= 0 && gr < F && t >= 0 && t < T) {
      float r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        r[k] = fmaxf(bf16r(bf16r(o[h][k]) + b1s[cg * 8 + k]), 0.f);
        bits |= (r[k] > 0.f ? 1u : 0u) << k;
      }
      v = make_uint4(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]),
                     pack_bf16(r[4], r[5]), pack_bf16(r[6], r[7]));
    }
    *reinterpret_cast<uint4*>(x1s + swz(i * XW + j + h, cg)) = v;
    const int jj = j + h - 1;
    if (i >= 1 && i <= 2 && jj >= 0 && jj < CW)
      mask[((i - 1) * CW + jj) * 8 + cg] = (uint8_t)bits;
  }
}

// im2col of cdt(x) at the item's own positions for dW1: cols[tap][p], p =
// q * CW + j (rows 9-15 stay zero)
__device__ __forceinline__ void build_cols(const float* xs,
                                           __nv_bfloat16* cols, int tid) {
  for (int e = tid; e < 9 * 2 * CW; e += FT) {
    const int tap = e / (2 * CW), p = e % (2 * CW);
    const int q = p / CW, j = p % CW;
    cols[tap * CP + p] =
        __float2bfloat16(xs[(q + tap / 3 + 1) * XS + j + tap % 3 + 1]);
  }
}

// dW2[df] += x1_shift^T . dy2 over the item's 128 positions: warpgroup df,
// warp c16 owns ci 16 c16 .. +15 of its three taps
__device__ __forceinline__ void dw2_products(const __nv_bfloat16* x1s,
                                             const __nv_bfloat16* dys,
                                             float (&acc)[3][8][4], int warp,
                                             int lane) {
  const int df = warp >> 2, c16 = warp & 3;
#pragma unroll 1
  for (int q = 0; q < 2; ++q)
#pragma unroll 1
    for (int kb = 0; kb < CW / 16; ++kb) {
      uint32_t a[3][4];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int pos = (q + df) * XW + 16 * kb + dt + (lane & 7) +
                        ((lane >> 4) << 3);
        ldsm_x4_t(x1s + swz(pos, 2 * c16 + ((lane >> 3) & 1)), a[dt][0],
                  a[dt][1], a[dt][2], a[dt][3]);
      }
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {  // co 32 nh .. +31: 8 registers
        uint32_t b[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm_x4_t(dys + swz((q + 1) * XW + 1 + 16 * kb + (lane & 15),
                              4 * nh + 2 * np + (lane >> 4)),
                    b[np][0], b[np][1], b[np][2], b[np][3]);
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int nt = 4 * nh + 2 * np;
            mma_bf16(acc[dt][nt], a[dt], b[np][0], b[np][1]);
            mma_bf16(acc[dt][nt + 1], a[dt], b[np][2], b[np][3]);
          }
      }
    }
}

// the share of dx1 of warp w < DX_WARPS: sub-partition s = w % 4 owns the
// own positions 32 s .. 32 s + 31 (two m16 tiles of 16 columns of row
// s / 2), k = w / 4 the ci tiles 4 k .. 4 k + 3
__device__ __forceinline__ void dx1_products(const __nv_bfloat16* dys,
                                             const __nv_bfloat16* w2s,
                                             float (&acc)[2][4][4], int warp,
                                             int lane) {
  const int s = warp & 3, k = warp >> 2;
  const int bn = ((lane >> 4) << 3) + (lane & 7), bkc = (lane >> 3) & 1;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int df = tap / 3, dt = tap % 3;
    int arow[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mt = 2 * s + mi;
      arow[mi] = ((mt >> 2) + 2 - df) * XW + 16 * (mt & 3) + (lane & 15) +
                 2 - dt;
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(dys + swz(arow[mi], 2 * kc + (lane >> 4)), a[mi][0],
                a[mi][1], a[mi][2], a[mi][3]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // ci tiles 4k + 2np, 4k + 2np + 1
        uint32_t b[4];
        ldsm_x4(w2s + swz(tap * C + 32 * k + 16 * np + bn, 2 * kc + bkc),
                b[0], b[1], b[2], b[3]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// the relu mask from its bits (build_x1_task), and db1 from the masked
// dx1 into the thread's own 8 slots of db1s ([8][FT]: ci tile ni of the
// warp's four, channel parity)
__device__ __forceinline__ void relu_mask(const uint8_t* mask,
                                          float (&acc)[2][4][4], float* db1s,
                                          int warp, int lane, int tid) {
  const int s = warp & 3, k = warp >> 2;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int nt = 4 * k + ni;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mt = 2 * s + mi, q = mt >> 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 16 * (mt & 3) + (lane >> 2) + 8 * (i >> 1);
        const int c = 2 * (lane & 3) + (i & 1);
        const bool on = (mask[(q * CW + j) * 8 + nt] >> c) & 1;
        const float d = on ? acc[mi][ni][i] : 0.f;
        acc[mi][ni][i] = d;
        if (i & 1) s1 += d; else s0 += d;
      }
    }
    db1s[(2 * ni) * FT + tid] += s0;
    db1s[(2 * ni + 1) * FT + tid] += s1;
  }
}

// cdt(dx1) at the own positions, [p][64 ci] swizzled
__device__ __forceinline__ void store_dx1(__nv_bfloat16* dxs,
                                          const float (&acc)[2][4][4],
                                          int warp, int lane) {
  const int s = warp & 3, k = warp >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int mt = 2 * s + mi;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mt >> 2) * CW + 16 * (mt & 3) + (lane >> 2) + 8 * h;
        *reinterpret_cast<uint32_t*>(dxs + swz(p, 4 * k + ni) +
                                     2 * (lane & 3)) =
            pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  }
}

// dW1 (ci x tap) += cdt(dx1)^T . cols^T: warps 0-7, one m16n8 tile each;
// the item's sum in two chains (even and odd k blocks), then added
__device__ __forceinline__ void dw1_products(const __nv_bfloat16* dxs,
                                             const __nv_bfloat16* cols,
                                             float (&acc)[4], int warp,
                                             int lane) {
  const int mt = warp & 3, nt = warp >> 2;
  float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kb = 0; kb < 2 * CW / 16; ++kb) {
    uint32_t a[4], b0, b1;
    ldsm_x4_t(dxs + swz(16 * kb + (lane & 7) + ((lane >> 4) << 3),
                        2 * mt + ((lane >> 3) & 1)),
              a[0], a[1], a[2], a[3]);
    ldsm_x2(cols + (nt * 8 + (lane & 7)) * CP + 16 * kb +
                8 * ((lane >> 3) & 1),
            b0, b1);
    mma_bf16(part[kb & 1], a, b0, b1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += part[0][i] + part[1][i];
}

__global__ void __launch_bounds__(FT, 1)
vgg_block1_bwd_fused_kernel(const float* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const __nv_bfloat16* __restrict__ w2n,
                            const __nv_bfloat16* __restrict__ g,
                            const __nv_bfloat16* __restrict__ out,
                            const uint8_t* __restrict__ idx,
                            float* __restrict__ part, int B, int F, int T) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);  // 576 x 64
  __nv_bfloat16* x1s = w2s + 9 * C * C;                          // 4XW x 64
  __nv_bfloat16* dys = x1s + 4 * XW * C;                         // 4XW x 64
  __nv_bfloat16* dxs = dys + 4 * XW * C;                         // 2CW x 64
  __nv_bfloat16* cols0 = dxs + 2 * CW * C;                       // 2 x 16CP
  uint8_t* mask0 = reinterpret_cast<uint8_t*>(cols0 + 2 * 16 * CP);
  char* raw = reinterpret_cast<char*>(mask0 + 2 * 2 * CW * 8);   // RAW
  float* xs = reinterpret_cast<float*>(raw + RAW);               // 6 x XS
  float* w1s = xs + 6 * XS;                                      // 9 x C
  float* b1s = w1s + 9 * C;                                      // C
  float* db2s = b1s + C;                                         // 8 x FT
  float* db1s = db2s + 8 * FT;                                   // 8 x FT

  const int rows = (F + 1) / 2, chunks = (T + CW - 1) / CW;
  const long n = (long)B * rows * chunks;
  const int blk = blockIdx.x;
  const long lo = n * blk / FUSED_BLOCKS, hi = n * (blk + 1) / FUSED_BLOCKS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // W2 with the first item's inputs in the first copy group
  for (int e = tid; e < 9 * C * 8; e += FT)
    cp_async16(w2s + swz(e >> 3, e & 7), w2n + 8 * e, true);
  if (lo < hi)
    issue_item(x, g, out, idx, item_of(lo, rows, chunks), F, T, raw, xs,
               tid);
  cp_async_commit();
  for (int e = tid; e < 9 * C; e += FT) w1s[e] = bf16r(w1[e]);
  for (int e = tid; e < C; e += FT) b1s[e] = bf16r(b1[e]);
  for (int e = tid; e < 7 * CP; e += FT)
    cols0[9 * CP + e] = cols0[(16 + 9) * CP + e] = __float2bfloat16(0.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) db2s[k * FT + tid] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) db1s[k * FT + tid] = 0.f;

  float acc2[3][8][4], acc1[4];
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[dt][nt][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc1[i] = 0.f;

  // x1 of the first item here; each later item's x1 is built by warps
  // DX_WARPS.. while warps 0..DX_WARPS-1 run the previous item's dx1
  // products (the x1 tile is free once dW2 has read it)
  cp_async_wait_all();
  __syncthreads();
  if (lo < hi)
    for (int e = tid; e < X1_TASKS; e += FT)
      build_x1_task(xs, w1s, b1s, x1s, mask0, item_of(lo, rows, chunks), F,
                    T, e);

  for (long it = lo; it < hi; ++it) {
    const int buf = (int)((it - lo) & 1);
    __nv_bfloat16* cols = cols0 + buf * 16 * CP;
    build_dy2(raw, dys, db2s, tid);
    build_cols(xs, cols, tid);
    __syncthreads();  // dy2, x1, its mask and cols built; inputs consumed
    const bool next = it + 1 < hi;
    const Item wn = item_of(next ? it + 1 : it, rows, chunks);
    if (next)  // the next item's copies run while this item's products do
      issue_item(x, g, out, idx, wn, F, T, raw, xs, tid);
    cp_async_commit();
    dw2_products(x1s, dys, acc2, warp, lane);
    cp_async_wait_all();
    __syncthreads();  // x1 read by every warp; the next item's inputs landed
    if (warp < DX_WARPS) {
      float accx[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) accx[mi][ni][i] = 0.f;
      dx1_products(dys, w2s, accx, warp, lane);
      relu_mask(mask0 + buf * 2 * CW * 8, accx, db1s, warp, lane, tid);
      store_dx1(dxs, accx, warp, lane);
    } else if (next) {
      for (int e = tid - 32 * DX_WARPS; e < X1_TASKS; e += FT - 32 * DX_WARPS)
        build_x1_task(xs, w1s, b1s, x1s, mask0 + (buf ^ 1) * 2 * CW * 8, wn,
                      F, T, e);
    }
    __syncthreads();  // cdt(dx1) stored; dy2 and the next x1 done
    if (warp < DX_WARPS) dw1_products(dxs, cols, acc1, warp, lane);
  }
  cp_async_wait_all();
  __syncthreads();

  float* p = part + (size_t)blk * PART;
  {  // dW2: warpgroup df, warp c16; layout (df, dt, ci, co) after 9C + C
    const int df = warp >> 2, c16 = warp & 3;
    float* pd = p + 9 * C + C + df * 3 * C * C;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = 16 * c16 + (lane >> 2) + 8 * h;
          const int co = 8 * nt + 2 * (lane & 3);
          *reinterpret_cast<float2*>(pd + (dt * C + ci) * C + co) =
              make_float2(acc2[dt][nt][2 * h], acc2[dt][nt][2 * h + 1]);
        }
  }
  if (warp < 8) {  // dW1 (3,3,1,64): tap * 64 + ci
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tap = 8 * (warp >> 2) + 2 * (lane & 3) + (i & 1);
      const int ci = 16 * (warp & 3) + (lane >> 2) + 8 * (i >> 1);
      if (tap < 9) p[tap * C + ci] = acc1[i];
    }
  }
  // db1: lanes that share lane & 3 hold the same channels; then the 12
  // warps in order. db2: the threads of a channel chunk in order
  float* red = reinterpret_cast<float*>(raw);  // 12 x 64
  for (int e = tid; e < 12 * C; e += FT) red[e] = 0.f;
  float db1[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v = db1s[(2 * ni + k) * FT + tid];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      db1[ni][k] = v;
    }
  __syncthreads();
  if (lane < 4 && warp < DX_WARPS)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        red[warp * C + 8 * (4 * (warp >> 2) + ni) + 2 * lane + k] =
            db1[ni][k];
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
    for (int k = 0; k < FT / 32; ++k) s += red[k * C + tid];
    p[9 * C + tid] = s;
  } else if (tid < 2 * C) {
    const int c = tid - C;
    float s = 0.f;
    for (int t = 0; t < FT / 8; ++t) s += db2s[(c % 8) * FT + 8 * t + c / 8];
    p[9 * C + C + DW2_SIZE + c] = s;
  }
}

// grads[e] = sum over the nblocks blocks, in block order, of part[blk][e]
__global__ void vgg_block1_bwd_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ grads,
                                             int nblocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PART) return;
  float s = 0.f;
  for (int k = 0; k < nblocks; ++k) s += part[(size_t)k * PART + e];
  grads[e] = s;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// As above with w2p the bf16 conv2 weight packed as (3,3,64 out,64 in) and
// out bf16; out and idx 16-byte aligned (they leave as 16-byte stores).
extern "C" int vgg_block1_fwd_bf16(const void* x, const void* w1,
                                   const void* b1, const void* w2p,
                                   const void* b2, void* out, void* idx,
                                   int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this launch's error
  const int Fp = F / 2, Tp = T / 2;
  if (Fp == 0 || Tp == 0 || B == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(vgg_block1_fwd_wgmma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)FW_SMEM);
  if (e != cudaSuccess) return e;
  // one block per SM, or one per item where there are fewer items
  const long items =
      (long)B * ((Fp + 1) / 2) * ((Tp + FW_PCOLS - 1) / FW_PCOLS);
  const int grid = (int)(items < sms ? items : sms);
  vgg_block1_fwd_wgmma_kernel<<<grid, FW_THREADS, FW_SMEM,
                                (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1,
      (const __nv_bfloat16*)w2p, (const float*)b2, (__nv_bfloat16*)out,
      (uint8_t*)idx, B, F, T);
  return cudaGetLastError();
}

// Backward. x (B, F, T) f32; w1 (3,3,1,64), b1 (64) f32; w2 bf16 HWIO
// (3,3,64 ci,64 co); g and out (B, F/2, T/2, 64) NHWC bf16; idx uint8 of the
// same shape (g, out and idx are copied in 16-byte chunks: 16-byte
// aligned); part: FUSED_BLOCKS x PART f32 scratch; grads: PART f32 = dW1
// (3,3,1,64) | db1 (64) | dW2 (3,3,64,64) | db2 (64).
extern "C" int vgg_block1_bwd_bf16(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* g, const void* out,
                                   const void* idx, void* part, void* grads,
                                   int B, int F, int T, void* stream) {
  cudaGetLastError();  // report only this call's error
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || F / 2 == 0 || T / 2 == 0)
    return cudaMemsetAsync(grads, 0, sizeof(float) * PART, s);
  cudaError_t e = cudaFuncSetAttribute(
      vgg_block1_bwd_fused_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FUSED_SMEM);
  if (e != cudaSuccess) return e;
  vgg_block1_bwd_fused_kernel<<<FUSED_BLOCKS, FT, FUSED_SMEM, s>>>(
      (const float*)x, (const float*)w1, (const float*)b1,
      (const __nv_bfloat16*)w2, (const __nv_bfloat16*)g,
      (const __nv_bfloat16*)out, (const uint8_t*)idx, (float*)part, B, F, T);
  vgg_block1_bwd_reduce_kernel<<<(PART + 255) / 256, 256, 0, s>>>(
      (const float*)part, (float*)grads, FUSED_BLOCKS);
  return cudaGetLastError();
}
