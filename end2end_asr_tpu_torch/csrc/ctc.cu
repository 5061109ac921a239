// ctc: the CTC loss's negative log-likelihood per row and its gradient with
// respect to the log-probabilities, reading every length from device
// memory.
//
// The JAX package computes the loss in plain XLA (end2end_asr_tpu/ops/
// ctc.py, ctc_loss: a lax.scan over the alpha recursion), so it has no TPU
// kernel. The port's plain version is PyTorch's ctc_loss, whose CUDA path
// copies the lengths to the host at every call (a device sync): a CUDA
// graph cannot hold it. These kernels compute the JAX function (its
// -1e30 sentinel, its recursion, +inf for an infeasible row) with the
// lengths read on the device, so a train step with --loss ctc can be
// captured and replayed.
//
//   z_s = blank (s even), targets[b][(s - 1) / 2] (s odd), s < S = 2U + 1
//   valid(s) = s < 2 tl + 1; skip(s) = z_s != blank && z_s != z_{s-2}
//   alpha_0(s) = s <= 1 && valid(s) ? lp[0][z_s] : NEG
//   alpha_t(s) = valid(s) ? lse(alpha(s), alpha(s-1), skip(s) ? alpha(s-2)
//                               : NEG) + lp[t][z_s] : NEG,  0 < t < il
//   ll = lse(alpha_{il-1}(2 tl), tl > 0 ? alpha_{il-1}(2 tl - 1) : NEG)
//   nll = ll <= NEG / 2 (or il < 1 or il > T) ? +inf : -ll
//
// with lse(a, b, c) = m + log(e^(a-m) + e^(b-m) + e^(c-m)), m = max, and
// NEG where m <= NEG / 2. The backward: beta_{il-1}(s) = 0 at the two end
// states (one where tl = 0), NEG elsewhere, beta_t(s) = lse over the
// successors s' of s (s, s+1, and s+2 where skip(s+2)) of beta_{t+1}(s')
// + lp[t+1][z_s']; d nll / d lp[t][c] = -sum over s with z_s = c of
// exp(alpha_t(s) + beta_t(s) - ll), times the row's incoming gradient, for
// t < il; zero at t >= il and on an infeasible row.
//
// One block a row, threads over the extended labels, the time steps in
// order with a __syncthreads between them (each thread reads its
// neighbours' previous values from shared memory); every sum is in a fixed
// order, so two runs give the same bits. The backward keeps the posterior
// occupation of each (t, s) in a scratch and then lets thread t add its
// states' shares into the gradient row in label order.
//
// What bounds it on the H100: latency. At the AiShell width (B = 12,
// T = U = 50 decoder positions, S = 101, C = 4364) the work is ~10^5
// exponentials in T sequential steps; the bytes are the (B, T, C) gradient
// written once (10.5 MB, ~3 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  if (m <= NEG / 2) return NEG;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG / 2) return NEG;
  return m + logf(expf(a - m) + expf(b - m));
}

struct Row {
  int il, tl;  // input and target length of the row
};

// the row's lengths (il clamped at T: beyond it the row is infeasible,
// marked by il = T + 1) and its extended labels into z[0 .. S)
__device__ Row load_row(const long long* targets, const long long* in_len,
                        const long long* tgt_len, int b, int T, int U, int S,
                        int blank, int* z) {
  for (int s = threadIdx.x; s < S; s += THREADS)
    z[s] = (s & 1) ? (int)targets[(size_t)b * U + (s >> 1)] : blank;
  __syncthreads();
  const long long il = in_len[b], tl = tgt_len[b];
  return Row{(int)(il > T ? T + 1 : il), (int)(tl > U ? U : tl)};
}

__device__ __forceinline__ bool can_skip(const int* z, int s, int blank) {
  return s >= 2 && z[s] != blank && z[s] != z[s - 2];
}

// grid B; dynamic shared memory: S ints (z) and 2 S floats (alpha)
__global__ void __launch_bounds__(THREADS)
ctc_fwd_kernel(const float* __restrict__ lp, const long long* targets,
               const long long* in_len, const long long* tgt_len,
               float* __restrict__ nll, float* __restrict__ alpha_out,
               int T, int C, int U, int blank) {
  extern __shared__ int smem[];
  const int S = 2 * U + 1, b = blockIdx.x;
  int* z = smem;
  float* a = reinterpret_cast<float*>(z + S);  // [2][S]
  const Row r = load_row(targets, in_len, tgt_len, b, T, U, S, blank, z);
  const float* lpb = lp + (size_t)b * T * C;
  float* ab = alpha_out ? alpha_out + (size_t)b * T * S : nullptr;
  const int steps = r.il < 1 ? 1 : (r.il > T ? T : r.il);
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const float v = (s <= 1 && s < 2 * r.tl + 1) ? lpb[z[s]] : NEG;
    a[s] = v;
    if (ab) ab[s] = v;
  }
  __syncthreads();
  for (int t = 1; t < steps; ++t) {
    const float* prev = a + ((t - 1) & 1) * S;
    float* cur = a + (t & 1) * S;
    const float* lpt = lpb + (size_t)t * C;
    for (int s = threadIdx.x; s < S; s += THREADS) {
      float v = NEG;
      if (s < 2 * r.tl + 1) {
        const float a1 = prev[s], a2 = s >= 1 ? prev[s - 1] : NEG;
        const float a3 = can_skip(z, s, blank) ? prev[s - 2] : NEG;
        const float m = lse3(a1, a2, a3);
        v = m <= NEG / 2 ? NEG : m + lpt[z[s]];
      }
      cur[s] = v;
      if (ab) ab[(size_t)t * S + s] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float ll = NEG;
    if (r.il >= 1 && r.il <= T) {
      const float* end = a + ((steps - 1) & 1) * S;
      ll = lse2(end[2 * r.tl], r.tl > 0 ? end[2 * r.tl - 1] : NEG);
    }
    nll[b] = ll <= NEG / 2 ? INFINITY : -ll;
  }
}

// grid B; dynamic shared memory: S ints (z) and 2 S floats (beta). grad
// (B, T, C) comes in zeroed; post (B, T, S) is scratch
__global__ void __launch_bounds__(THREADS)
ctc_bwd_kernel(const float* __restrict__ lp, const long long* targets,
               const long long* in_len, const long long* tgt_len,
               const float* __restrict__ alpha, const float* __restrict__ nll,
               const float* __restrict__ g, float* __restrict__ grad,
               float* __restrict__ post, int T, int C, int U, int blank) {
  extern __shared__ int smem[];
  const int S = 2 * U + 1, b = blockIdx.x;
  int* z = smem;
  float* be = reinterpret_cast<float*>(z + S);  // [2][S]
  const Row r = load_row(targets, in_len, tgt_len, b, T, U, S, blank, z);
  const float nl = nll[b];
  if (r.il < 1 || r.il > T || isinf(nl)) return;  // infeasible: zeros
  const float ll = -nl, gb = g[b];
  const float* lpb = lp + (size_t)b * T * C;
  const float* ab = alpha + (size_t)b * T * S;
  float* pb = post + (size_t)b * T * S;
  const int last = r.il - 1;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    const bool end = s == 2 * r.tl || (r.tl > 0 && s == 2 * r.tl - 1);
    const float v = end ? 0.f : NEG;
    be[(last & 1) * S + s] = v;
    pb[(size_t)last * S + s] =
        v <= NEG / 2 ? 0.f : expf(ab[(size_t)last * S + s] + v - ll);
  }
  __syncthreads();
  for (int t = last - 1; t >= 0; --t) {
    const float* nxt = be + ((t + 1) & 1) * S;
    float* cur = be + (t & 1) * S;
    const float* lpn = lpb + (size_t)(t + 1) * C;
    for (int s = threadIdx.x; s < S; s += THREADS) {
      float v = NEG;
      if (s < 2 * r.tl + 1) {
        const float b1 = nxt[s] + lpn[z[s]];
        const float b2 = s + 1 < 2 * r.tl + 1 ? nxt[s + 1] + lpn[z[s + 1]]
                                                : NEG;
        const float b3 = s + 2 < 2 * r.tl + 1 && can_skip(z, s + 2, blank)
                             ? nxt[s + 2] + lpn[z[s + 2]]
                             : NEG;
        v = lse3(b1, b2, b3);
      }
      cur[s] = v;
      const float x = ab[(size_t)t * S + s] + v;
      pb[(size_t)t * S + s] = x <= NEG / 2 ? 0.f : expf(x - ll);
    }
    __syncthreads();
  }
  // thread t adds its states' occupations into the gradient row, in label
  // order (the post rows were written by this block before the barrier)
  for (int t = threadIdx.x; t < r.il; t += THREADS) {
    float* gr = grad + ((size_t)b * T + t) * C;
    const float* pt = pb + (size_t)t * S;
    for (int s = 0; s < 2 * r.tl + 1; ++s) gr[z[s]] -= gb * pt[s];
  }
}

size_t smem_bytes(int U) { return (size_t)(2 * U + 1) * 3 * 4; }

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp: (B, T, C) f32 log-probabilities; targets (B, U) int64; in_len,
// tgt_len (B,) int64 on the device; nll (B,) f32 out; alpha (B, T, 2U + 1)
// f32 out for the backward (null: not kept). U <= 2000
extern "C" int ctc_fwd_f32(const void* lp, const void* targets,
                           const void* in_len, const void* tgt_len,
                           void* nll, void* alpha, int B, int T, int C,
                           int U, int blank, void* stream) {
  cudaGetLastError();
  if (B < 0 || T < 1 || C < 1 || U < 0 || U > 2000 || blank < 0 ||
      blank >= C)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  ctc_fwd_kernel<<<B, THREADS, smem_bytes(U), (cudaStream_t)stream>>>(
      (const float*)lp, (const long long*)targets, (const long long*)in_len,
      (const long long*)tgt_len, (float*)nll, (float*)alpha, T, C, U, blank);
  return cudaGetLastError();
}

// g: (B,) f32, d(loss)/d(nll); grad: (B, T, C) f32, zeroed by the caller;
// post: (B, T, 2U + 1) f32 scratch; alpha and nll as ctc_fwd_f32 wrote them
extern "C" int ctc_bwd_f32(const void* lp, const void* targets,
                           const void* in_len, const void* tgt_len,
                           const void* alpha, const void* nll, const void* g,
                           void* grad, void* post, int B, int T, int C, int U,
                           int blank, void* stream) {
  cudaGetLastError();
  if (B < 0 || T < 1 || C < 1 || U < 0 || U > 2000 || blank < 0 ||
      blank >= C)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  ctc_bwd_kernel<<<B, THREADS, smem_bytes(U), (cudaStream_t)stream>>>(
      (const float*)lp, (const long long*)targets, (const long long*)in_len,
      (const long long*)tgt_len, (const float*)alpha, (const float*)nll,
      (const float*)g, (float*)grad, (float*)post, T, C, U, blank);
  return cudaGetLastError();
}
