"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: skipped where torch.cuda.is_available() is False. Shapes
beyond the serving path's (odd F and T, short and ragged time axes,
other STFT geometries) that chip_smoke.py does not cover. Imports no JAX,
so it runs on a machine without it (no JAX means no tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Every f32 comparison runs with TF32 off: cuDNN's convolutions default to
TF32 on Hopper, which would put the plain version ~1e-3 off.
"""

from collections import Counter

import pytest
import torch

from end2end_asr_tpu_torch.ops import features as PF
from end2end_asr_tpu_torch.ops import stft as S
from end2end_asr_tpu_torch.ops import vgg_fused as V

pytestmark = pytest.mark.gpu

# f32: sums in another order; outputs O(1)
F32_TOL = 1e-4
# bf16: one bf16 ulp (2^-8 relative) where a conv output rounds the other
# way, plus a possible flip of a near-tied pool choice
BF16_ATOL = BF16_RTOL = 2 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_fft,hop,T", [(320, 160, 800), (320, 160, 37),
                                         (160, 80, 65), (400, 160, 101),
                                         (240, 120, 97)])
def test_stft_kernel_matches_plain(dev, n_fft, hop, T):
    """The FFT path: every n_fft here is even with n_fft/2 a product of 2s,
    3s and 5s."""
    g = torch.Generator().manual_seed(T)
    N = (T - 1) * hop + n_fft - 7   # short: the kernel zero-fills past N
    pcm = (torch.randn(3, N, generator=g) * 0.3).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(n_fft, "hann"))
    S.reset_launches()
    got = S.stft_logmag(pcm, n_fft, hop, T, "hann")
    assert (S.FFT.launches, S.DFT.launches) == (1, 0)
    want = PF.stft_logmag_plain(pcm, cos, sin, hop, T)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    # a row that does not start on a 16-byte boundary (N odd) and a pcm
    # view that does not either (the wrapper copies it)
    got = S.stft_logmag(pcm[1:], n_fft, hop, T, "hann")
    torch.testing.assert_close(got, want[1:], rtol=F32_TOL, atol=F32_TOL)
    flat = torch.cat([torch.zeros(1, device=dev), pcm.reshape(-1)])
    got = S.stft_logmag(flat[1:].view(3, N), n_fft, hop, T, "hann")
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n_fft,hop,T", [(322, 161, 50), (321, 160, 33)])
def test_stft_dft_path_matches_plain(dev, n_fft, hop, T):
    """n_fft/2 with a prime factor above 5 (161 = 7·23), or n_fft odd:
    the wrapper takes the direct-sum kernel."""
    g = torch.Generator().manual_seed(n_fft)
    N = (T - 1) * hop + n_fft - 3
    pcm = (torch.randn(2, N, generator=g) * 0.3).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(n_fft, "hamming"))
    S.reset_launches()
    got = S.stft_logmag(pcm, n_fft, hop, T, "hamming")
    assert (S.FFT.launches, S.DFT.launches) == (0, 1)
    want = PF.stft_logmag_plain(pcm, cos, sin, hop, T)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    # the direct sum at the main path's n_fft too
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(320, "hamming"))
    got = S.stft_logmag_dft(pcm, cos, sin, 160, 20)
    assert S.DFT.launches == 2
    torch.testing.assert_close(
        got, PF.stft_logmag_plain(pcm, cos, sin, 160, 20), rtol=F32_TOL,
        atol=F32_TOL)


def _block_args(dev, B, F, T, seed):
    g = torch.Generator().manual_seed(seed)
    return [t.to(dev) for t in (torch.randn(B, F, T, generator=g),
                                torch.randn(3, 3, 1, 64, generator=g) * 0.2,
                                torch.randn(64, generator=g) * 0.1,
                                torch.randn(3, 3, 64, 64, generator=g) * 0.05,
                                torch.randn(64, generator=g) * 0.1)]


# (2, 161, 1600): the 1600-frame bucket that tempo-augmented ~8 s
# utterances land in
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,T", [(2, 16, 16), (1, 17, 9), (2, 161, 129),
                                   (1, 161, 801), (3, 5, 300),
                                   (2, 19, 70), (1, 42, 97),
                                   (2, 161, 1600)])
def test_vgg_block1_kernel_matches_plain(dev, cdt, B, F, T):
    args = _block_args(dev, B, F, T, seed=F * T)
    idx = torch.empty((B, F // 2, T // 2, 64), dtype=torch.uint8,
                      device=dev)
    V.reset_launches()
    got = V.vgg_block1(*args, cdt=cdt, idx_out=idx)
    assert V.launches() == 1 and got.dtype == cdt
    want, want_idx = V.vgg_block1_plain(*args, cdt=cdt)
    if cdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        assert (idx == want_idx).float().mean().item() > 0.999
    else:
        diff = (got.float() - want.float()).abs()
        assert (diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()
        assert (idx == want_idx).float().mean().item() > 0.99


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_vgg_block1_ties_go_to_first_window_element(dev, cdt):
    """conv2 weights of zero make every pool window a 4-way tie."""
    args = _block_args(dev, 1, 10, 70, seed=7)
    args[3] = torch.zeros_like(args[3])
    idx = torch.empty((1, 5, 35, 64), dtype=torch.uint8, device=dev)
    got = V.vgg_block1(*args, cdt=cdt, idx_out=idx)
    assert not idx.any()
    want = torch.relu(args[4].to(cdt)).expand(1, 5, 35, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,F,T", [(12, 161, 800), (1, 9, 70)])
def test_vgg_block1_bf16_forward_runs_and_modes(dev, B, F, T):
    """The bf16 forward at the main path's shape (6240 work items on the
    persistent grid) and at one with fewer items than SMs (4): within the
    card's tolerance of the plain version, one launch a call, two runs
    bit-identical, and the same out with and without the pool argmax."""
    args = _block_args(dev, B, F, T, seed=F + T)
    pooled = (B, F // 2, T // 2, 64)
    idx = torch.empty(pooled, dtype=torch.uint8, device=dev)
    idx2 = torch.empty_like(idx)
    V.reset_launches()
    got = V.vgg_block1(*args, cdt=torch.bfloat16, idx_out=idx)
    assert V.launches() == 1
    want, want_idx = V.vgg_block1_plain(*args, cdt=torch.bfloat16)
    diff = (got.float() - want.float()).abs()
    assert (diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()
    assert (idx == want_idx).float().mean().item() > 0.99
    again = V.vgg_block1(*args, cdt=torch.bfloat16, idx_out=idx2)
    assert torch.equal(got, again) and torch.equal(idx, idx2)
    serve = V.vgg_block1(*args, cdt=torch.bfloat16)
    assert torch.equal(got, serve) and V.launches() == 3
    # idx leaves as 16-byte stores: a misaligned idx_out is refused
    flat = torch.empty(idx.numel() + 1, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        V.vgg_block1(*args, cdt=torch.bfloat16,
                     idx_out=flat[1:].view(pooled))


# every finite bf16 pair (a, b): the packed bf16 add against the f32 sum
# rounded to bf16, and (b = 0) the packed max against fmaxf, by bits;
# bad[0] counts add mismatches, bad[1] relu mismatches
BF16_OPS_SRC = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void bf16_ops_kernel(unsigned long long* bad) {
  const unsigned short a = (unsigned short)blockIdx.x;
  const __nv_bfloat16 ba = __ushort_as_bfloat16(a);
  const float fa = __bfloat162float(ba);
  if (((a >> 7) & 0xFF) == 0xFF) return;  // inf or NaN
  unsigned long long n = 0;
  for (uint32_t b = threadIdx.x; b < 65536; b += blockDim.x) {
    if (((b >> 7) & 0xFF) == 0xFF) continue;
    const __nv_bfloat16 bb = __ushort_as_bfloat16((unsigned short)b);
    const __nv_bfloat162 r =
        __hadd2(__halves2bfloat162(ba, bb), __halves2bfloat162(bb, ba));
    const unsigned short want =
        __bfloat16_as_ushort(__float2bfloat16(fa + __bfloat162float(bb)));
    n += (__bfloat16_as_ushort(__low2bfloat16(r)) != want) +
         (__bfloat16_as_ushort(__high2bfloat16(r)) != want);
  }
  if (n) atomicAdd(bad, n);
  if (threadIdx.x == 0) {
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    const __nv_bfloat16 r =
        __low2bfloat16(__hmax2(__halves2bfloat162(ba, ba), z));
    if (__bfloat16_as_ushort(r) !=
        __bfloat16_as_ushort(__float2bfloat16(fmaxf(fa, 0.f))))
      atomicAdd(bad + 1, 1ull);
  }
}

extern "C" int bf16_ops(void* bad) {
  bf16_ops_kernel<<<65536, 256>>>((unsigned long long*)bad);
  return cudaGetLastError();
}
"""


def test_vgg_block1_forward_x1_roundings_match_the_backwards(dev):
    """The bf16 forward rounds conv1 (+ b1, relu) with packed bf16 add and
    max; the backward recomputes x1 through the f32 path (the f32 sum
    rounded to bf16, fmaxf with 0). Its relu mask and dW2 see the
    forward's x1 only while the two give the same bits for every finite
    bf16 pair, as built by this toolchain."""
    import ctypes
    from end2end_asr_tpu_torch.tools import probe_lib as P
    path = P.write_source("test_bf16_ops", BF16_OPS_SRC)
    so = P.build({"bf16_ops": path}, "test_bf16_ops")["bf16_ops"][0]
    fn = ctypes.CDLL(so).bf16_ops
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    assert fn(bad.data_ptr()) == 0
    torch.cuda.synchronize()
    assert bad.tolist() == [0, 0]


def test_no_pallas_features_launches_no_stft_kernel(dev):
    """--no-pallas-features: the train step's features take the plain STFT
    on the card (no launch) and agree with the kernel's."""
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.training import steps as TS
    cfg = Config(use_pallas_features=False)
    T = 101
    g = torch.Generator().manual_seed(3)
    pcm = (torch.randn(2, (T - 1) * cfg.hop_length + cfg.n_fft, generator=g)
           * 3000).to(torch.int16).to(dev)
    n_frames = torch.tensor([T, 60], device=dev)
    S.reset_launches()
    plain = TS.features(cfg, pcm, n_frames, T)
    assert S.launches() == 0
    kern = TS.features(cfg.replace(use_pallas_features=True), pcm, n_frames,
                       T)
    assert S.launches() == 1
    torch.testing.assert_close(plain, kern, rtol=F32_TOL, atol=F32_TOL)


def test_kernels_reject_what_they_do_not_take(dev):
    args = _block_args(dev, 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        V.vgg_block1(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        V.vgg_block1(args[0], *args[1:], cdt=torch.float16)
    with pytest.raises(ValueError):
        S.stft_logmag(torch.zeros(2, 500, device=dev, dtype=torch.float64),
                      320, 160, 2)
    with pytest.raises(ValueError, match="no FFT plan"):
        S.stft_logmag_fft(torch.zeros(2, 500, device=dev),
                          torch.ones(322, device=dev), 161, 2)


# ---------------------------------------------------------------------------
# training kernels: attention (4, 5, 9), vgg block-1 backward (3), pool (6)
# ---------------------------------------------------------------------------

from end2end_asr_tpu_torch.ops import attention_fused as AF  # noqa: E402
from end2end_asr_tpu_torch.ops import pool_vjp as PV  # noqa: E402

# bf16 attention: probabilities round to bf16 (2^-8 relative) at another
# point than the plain version's (before normalisation), and the backward's
# dS is rounded to bf16 before its products: errors relative to the largest
# value of each tensor stay under 2e-2
ATTN_TOL = 2e-2


def _rel_err(got, want, floor=1e-3):
    """max |got - want| over max |want| (at least `floor`)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(floor)).item()


def _attn_inputs(dev, B, H, Tq, Tk, seed, mask_row=False, causal=False):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, 64, generator=g).to(dev, torch.bfloat16)
               for T in (Tq, Tk, Tk))
    mask = torch.rand(B, Tq, Tk, generator=g) < 0.2
    if causal:
        mask |= torch.ones(Tq, Tk, dtype=torch.bool).triu(1)
    if mask_row:
        mask[0, Tq - 1] = True         # every key masked for this query
    bias = torch.where(mask, -1e9, 0.0).to(dev)
    return q, k, v, bias


# (257, 257): three key tiles, the dQ shares summed by the last block;
# (51, 51): the decoder self-attention, whose bias carries the causal mask;
# (400, 400) and (51, 400): the encoder and cross shapes at the 1600-frame
# bucket (tempo-augmented ~8 s utterances)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (7, 33), (33, 7), (201, 201),
                                   (51, 200), (257, 257), (51, 51),
                                   (400, 400), (51, 400)])
def test_attention_kernels_match_plain(dev, rate, Tq, Tk):
    q, k, v, bias = _attn_inputs(dev, 2, 3, Tq, Tk, seed=Tq * 1000 + Tk,
                                 mask_row=True, causal=(Tq, Tk) == (51, 51))
    g = torch.Generator().manual_seed(7)
    dout = torch.randn(2, 3, Tq, 64, generator=g).to(dev, torch.bfloat16)
    seed = 0x1234_5678_9ABC_DEF0
    AF.reset_launches()
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = AF.flash_mha_train(*qkv, bias, seed, rate)
    grads = torch.autograd.grad(out, qkv, dout)
    assert AF.FWD.launches == 1 and AF.BWD.launches == 1
    qkv = [t.float().requires_grad_() for t in (q, k, v)]
    want = AF.flash_mha_train_plain(*qkv, bias, seed, rate)
    want_g = torch.autograd.grad(want, qkv, dout.float())
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, want) < ATTN_TOL
    # with one key dq and dk are exactly zero; the kernel's D = dO.O takes
    # the bf16-rounded output, so they come out at rounding level: at
    # Tk = 1 every gradient is held relative to the largest of the three
    floor = max(g.abs().max().item() for g in want_g) if Tk == 1 else 1e-3
    for a, b in zip(grads, want_g):
        assert _rel_err(a, b, floor) < ATTN_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H", [2, 4])
def test_attention_on_local_heads_matches_plain(dev, dtype, H):
    """Tensor parallelism runs the kernels on a rank's local heads: 4 or 2
    of 8, on the projections' (B, T, H_local·64) layout (transposed
    views), at the encoder's shape, rate 0.1: forward and backward against
    the plain version."""
    B, T = 12, 200
    g0 = torch.Generator().manual_seed(H)
    q, k, v, dout = (torch.randn(B, T, H, 64, generator=g0).to(dev, dtype)
                     .transpose(1, 2) for _ in range(4))
    bias = torch.where(torch.rand(B, T, T, generator=g0) < 0.1, -1e9,
                       0.0).to(dev)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    out = AF.flash_mha_train(*qkv, bias, 0x10CA1, 0.1)
    grads = torch.autograd.grad(out, qkv, dout)
    assert out.transpose(1, 2).is_contiguous()
    qf = [t.float().requires_grad_() for t in (q, k, v)]
    want = AF.flash_mha_train_plain(*qf, bias, 0x10CA1, 0.1)
    want_g = torch.autograd.grad(want, qf, dout.float())
    tol = ATTN_TOL if dtype == torch.bfloat16 else 2e-5
    assert _rel_err(out, want) < tol
    for a, b in zip(grads, want_g):
        assert _rel_err(a, b) < tol


@pytest.mark.parametrize("H", [2, 4])
def test_local_heads_draw_the_same_masks_on_every_rank(dev, H):
    """The kernel seeds by LOCAL head: two model ranks' calls on their own
    H of the heads, with the run's seed, keep the same elements for each
    local head (q = k = 0 makes the probabilities uniform and V = I makes
    the output's non-zeros the kept ones), and that mask is the plain
    Philox mask of H heads."""
    T = 64
    zero = torch.zeros(2, H, T, T, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(T, device=dev, dtype=torch.bfloat16).expand(
        2, H, T, T).contiguous()
    bias = torch.zeros(2, T, T, device=dev)
    g0 = torch.Generator().manual_seed(5)
    masks = []
    for rank in range(2):
        # each rank's own scores leave the mask alone; uniform ones show it
        q = torch.randn(2, H, T, T, generator=g0).to(dev, torch.bfloat16)
        assert torch.isfinite(AF.flash_mha_train(q, q, eye, bias, 0xFACE,
                                                 0.1).float()).all()
        masks.append(AF.flash_mha_train(zero, zero, eye, bias, 0xFACE,
                                        0.1) != 0)
    assert torch.equal(masks[0], masks[1])
    assert torch.equal(masks[0], AF.keep_mask(
        0xFACE, 2, H, T, T, AF.dropout_thresh16(0.1), dev))


def _grads_of(q, k, v, bias, dout, seed, rate):
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = AF.flash_mha_train(*qkv, bias, seed, rate)
    return (out, *torch.autograd.grad(out, qkv, dout))


def test_attention_bf16_backward_is_bit_identical(dev):
    """Two runs of the bf16 backward give the same bits: two key tiles,
    dQ's shares added in key-tile order whichever block comes last."""
    q, k, v, bias = _attn_inputs(dev, 2, 3, 201, 201, seed=21, mask_row=True)
    dout = torch.randn(2, 3, 201, 64, generator=torch.Generator()
                       .manual_seed(8)).to(dev, torch.bfloat16)
    a = _grads_of(q, k, v, bias, dout, 0xB1, 0.1)
    b = _grads_of(q, k, v, bias, dout, 0xB1, 0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_backward_is_one_kernel_on_the_projections_layout(dev,
                                                                    dtype):
    """q, k, v and g as the training path hands them over (transposed
    (B, T, H, D) views): the backward launches exactly one kernel (no
    copies), and its gradients come back in the projections' layout, equal
    to those of contiguous inputs."""
    B, H, Tq, Tk = 2, 8, 51, 200
    g0 = torch.Generator().manual_seed(4)
    qp, kp, vp, gp = (torch.randn(B, T, H, 64, generator=g0).to(dev, dtype)
                      for T in (Tq, Tk, Tk, Tq))
    q, k, v, g = (t.transpose(1, 2) for t in (qp, kp, vp, gp))
    bias = torch.where(torch.rand(B, Tq, Tk, generator=g0) < 0.2, -1e9,
                       0.0).to(dev)
    out, stats = AF.attn_fwd(q, k, v, bias, 9, 0.1)
    want = AF.attn_bwd(*(t.contiguous() for t in (q, k, v)), bias, out,
                       stats, g.contiguous(), 9, 0.1)
    AF.attn_bwd(q, k, v, bias, out, stats, g, 9, 0.1)   # warm
    runs = []
    names = _kernel_names(lambda: runs.append(
        AF.attn_bwd(q, k, v, bias, out, stats, g, 9, 0.1)), "")
    assert len(names) == 1 and "attn_bwd_kernel" in names[0], names
    for a, b, t in zip(runs[0], want, (q, k, v)):
        assert a.stride() == t.stride() and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Tq,Tk", [(200, 200), (51, 200), (51, 51), (7, 33)])
def test_attention_forward_on_the_projections_layout(dev, dtype, Tq, Tk):
    """q, k, v as the training path hands them over (transposed (B, T, H,
    D) views): out lies in (B, Tq, H, D) memory, out and stats equal those
    of contiguous inputs bit for bit, two runs too; through the autograd
    Function, as the step calls it, the forward and the backward are one
    kernel each and nothing else (no copy of q, k, v, out or g)."""
    B, H = 2, 8
    g0 = torch.Generator().manual_seed(Tq + Tk)
    q, k, v, g = (torch.randn(B, T, H, 64, generator=g0).to(dev, dtype)
                  .transpose(1, 2) for T in (Tq, Tk, Tk, Tq))
    bias = torch.where(torch.rand(B, Tq, Tk, generator=g0) < 0.2, -1e9,
                       0.0).to(dev)
    out, stats = AF.attn_fwd(q, k, v, bias, 9, 0.1)
    assert out.shape == q.shape and out.transpose(1, 2).is_contiguous()
    dense = AF.attn_fwd(*(t.contiguous() for t in (q, k, v)), bias, 9, 0.1)
    again = AF.attn_fwd(q, k, v, bias, 9, 0.1)
    for a, b, c in zip((out, stats), dense, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = AF.flash_mha_train(*leaves, bias, 9, 0.1)     # warm
    torch.autograd.grad(o, leaves, g)
    runs = []

    def step():
        o = AF.flash_mha_train(*leaves, bias, 9, 0.1)
        runs.append((o, torch.autograd.grad(o, leaves, g)))
    names = _kernel_names(step, "")
    o, grads = runs[0]
    assert len(names) == 2, names
    assert "attn_fwd_kernel" in names[0] and "attn_bwd_kernel" in names[1]
    assert torch.equal(o, out)
    for a, t in zip(grads, (q, k, v)):
        assert a.stride() == t.stride()


@pytest.mark.parametrize("key_split", [1, 2, 4])
@pytest.mark.parametrize("Tq,Tk", [(51, 200), (200, 200), (51, 51), (33, 7),
                                   (1, 1), (17, 300)])
def test_attention_forward_key_splits_match_plain(dev, monkeypatch,
                                                  key_split, Tq, Tk):
    """bf16, each number of key groups a block (the wrapper's rule set to
    it), at rate 0.3 on the dropout_bits mask: out within ATTN_TOL of the
    plain version on the same mask, the statistics (row max, row sum)
    within f32 sum order of the plain ones, a fully masked row finite."""
    monkeypatch.setattr(AF, "fwd_key_split", lambda *a: key_split)
    q, k, v, bias = _attn_inputs(dev, 2, 3, Tq, Tk, seed=Tq + 31 * Tk,
                                 mask_row=True)
    rate, seed = 0.3, 0xC0DE
    out, stats = AF.attn_fwd(q, k, v, bias, seed, rate)
    keep = (AF.dropout_bits(seed, 2, 3, Tq, Tk, device=dev)
            .view(2, 3, Tq, Tk) < AF.dropout_thresh16(rate) * 65536)
    want = AF.flash_mha_train_plain(q.float(), k.float(), v.float(), bias,
                                    0, rate, keep=keep)
    want_stats = AF.attn_stats_plain(q, k, bias)
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, want) < ATTN_TOL
    # f32 scores of bf16 inputs, summed in another order
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5)


def test_attention_forward_f32_takes_one_key_group(dev, monkeypatch):
    """The f32 entry refuses more than one key group (its P scratch is a
    warp's own bias rows); the wrapper never asks it for more."""
    monkeypatch.setattr(AF, "fwd_key_split", lambda *a: 4)
    q, k, v, bias = _attn_inputs(dev, 1, 2, 9, 20, seed=2)
    q, k, v = (t.float() for t in (q, k, v))
    out, stats = AF.attn_fwd(q, k, v, bias, 1, 0.1)
    strides = AF._strides(q, k, v, out)
    with pytest.raises(RuntimeError, match="attn_fwd_f32"):
        AF.FWD_F32.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                          AF.ctypes.addressof(strides), 1, 2, 9, 20, 64,
                          AF.dropout_thresh16(0.1), 1, 4, AF._stream())


def test_attention_fully_masked_row_is_uniform(dev):
    q, k, v, bias = _attn_inputs(dev, 1, 2, 4, 9, seed=3)
    bias[0, 2] = -1e9
    out = AF.flash_mha_train(q, k, v, bias, 5, 0.0)
    torch.testing.assert_close(out[0, :, 2].float(),
                               v[0].float().mean(dim=1), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("B,H,Tq,Tk", [(2, 3, 37, 201), (2, 3, 37, 200),
                                       (12, 8, 400, 400)])
def test_dropout_bits_kernel_is_the_plain_stream(dev, B, H, Tq, Tk):
    """Tk % 4 != 0 (scalar stores) and == 0 (one 16-byte store a group),
    the latter also at the 1600-frame bucket's encoder shape; int64 holding
    the uint32 bits."""
    for seed in (0, 1, 2 ** 64 - 1, 0xDEADBEEF_00C0FFEE):
        got = AF.dropout_bits(seed, B, H, Tq, Tk, device=dev)
        want = AF.dropout_bits_plain(seed, B, H, Tq, Tk, device=dev)
        assert got.dtype == torch.int64 and torch.equal(got, want)
        assert torch.equal(got, AF.dropout_bits(seed, B, H, Tq, Tk,
                                                device=dev))


def test_attention_mask_is_the_bits_mask_and_deterministic(dev):
    """Forward and backward draw the mask dropout_bits gives."""
    q, k, v, bias = _attn_inputs(dev, 2, 2, 40, 70, seed=11)
    rate, seed = 0.3, 99
    keep = (AF.dropout_bits(seed, 2, 2, 40, 70, device=dev).view(2, 2, 40, 70)
            < AF.dropout_thresh16(rate) * 65536)
    dout = torch.ones(2, 2, 40, 64, device=dev, dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = AF.flash_mha_train(*qkv, bias, seed, rate)
        runs.append((out, *torch.autograd.grad(out, qkv, dout)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    qkv = [t.float().requires_grad_() for t in (q, k, v)]
    want = AF.flash_mha_train_plain(*qkv, bias, 0, rate, keep=keep)
    want_g = torch.autograd.grad(want, qkv, dout.float())
    assert _rel_err(runs[0][0], want) < ATTN_TOL
    for a, b in zip(runs[0][1:], want_g):
        assert _rel_err(a, b) < ATTN_TOL


# f32 attention (TF32 off on both sides): the same f32 arithmetic as the
# plain version, summed in another order (over d = 64 for the scores, over
# 64-key tiles with an online softmax for P.V, over query tiles in the
# backward); relative to the largest value of each tensor a few 1e-6
ATTN_F32_TOL = 2e-5


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk", [(200, 200), (51, 200), (7, 33), (1, 1)])
def test_attention_f32_kernels_match_plain(dev, rate, Tq, Tk):
    """Encoder self-attention (200, 200) and decoder cross-attention
    (51, 200) shapes, ragged tiles, one query with every key masked; two
    runs give the same bits."""
    g = torch.Generator().manual_seed(Tq * 1000 + Tk)
    q, k, v = (torch.randn(2, 3, T, 64, generator=g).to(dev)
               for T in (Tq, Tk, Tk))
    mask = torch.rand(2, Tq, Tk, generator=g) < 0.2
    mask[1, Tq - 1] = True               # every key masked for this query
    bias = torch.where(mask, -1e9, 0.0).to(dev)
    dout = torch.randn(2, 3, Tq, 64, generator=g).to(dev)
    seed = 0x0F32_5EED
    runs = []
    for _ in range(2):
        AF.reset_launches()
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = AF.flash_mha_train(*qkv, bias, seed, rate)
        runs.append((out, *torch.autograd.grad(out, qkv, dout)))
        assert (AF.FWD_F32.launches, AF.BWD_F32.launches) == (1, 1)
        assert (AF.FWD.launches, AF.BWD.launches) == (0, 0)
    for a, b in zip(*runs):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    want = AF.flash_mha_train_plain(*qkv, bias, seed, rate)
    want_g = torch.autograd.grad(want, qkv, dout)
    out, *grads = runs[0]
    assert torch.isfinite(out).all()
    assert _rel_err(out, want) < ATTN_F32_TOL
    # at Tk = 1, dq and dk are exactly zero: held relative to the largest
    # gradient of the three, as the bf16 case
    floor = max(g.abs().max().item() for g in want_g) if Tk == 1 else 1e-3
    for a, b in zip(grads, want_g):
        assert _rel_err(a, b, floor) < ATTN_F32_TOL
    if rate == 0:   # the fully masked query attends uniformly
        torch.testing.assert_close(out[1, :, Tq - 1], v[1].mean(dim=1),
                                   rtol=1e-5, atol=1e-5)


def test_attention_rejects_mixed_and_other_dtypes(dev):
    q, k, v, bias = _attn_inputs(dev, 1, 1, 4, 4, seed=1)
    with pytest.raises(ValueError, match="k is torch.float32"):
        AF.flash_mha_train(q, k.float(), v, bias, 1, 0.1)
    with pytest.raises(ValueError, match="bf16 or f32"):
        AF.flash_mha_train(q.half(), k.half(), v.half(), bias, 1, 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 128, 80, 400), (1, 3, 7, 9),
                                   (2, 5, 4, 11), (1, 2, 1, 1)])
def test_pool_bwd_kernel_matches_plain(dev, dtype, shape):
    g0 = torch.Generator().manual_seed(sum(shape))
    y = torch.randn(*shape, generator=g0).to(dev, dtype)
    if shape[-1] > 1:
        y[..., ::3] = y[..., 1::3].max()    # ties inside windows
    B, Cc, F, T = shape
    g = torch.randn(B, Cc, F // 2, T // 2, generator=g0).to(dev, dtype)
    PV.reset_launches()
    got = PV.pool_bwd(y, g)
    assert PV.launches() == 1
    assert got.is_contiguous()
    assert torch.equal(got, PV.pool_bwd_plain(y, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 128, 80, 400), (1, 8, 7, 9),
                                   (2, 16, 4, 11), (1, 3, 5, 6),
                                   (1, 2, 1, 1)])
def test_pool_bwd_channels_last_matches_plain(dev, dtype, shape):
    """The train step's layout ((B, F, T, C) memory, as cuDNN's conv4
    returns it): exact, one launch, dy channels-last; a g in the other
    layout and a y of neither layout (a strided view) are copied, exact
    too. C % 8 != 0 takes the kernel's one-channel path."""
    cl = torch.channels_last
    g0 = torch.Generator().manual_seed(sum(shape) + 1)
    y = torch.randn(*shape, generator=g0).to(dev, dtype)
    if shape[-1] > 1:
        y[..., ::3] = y[..., 1::3].max()    # ties inside windows
    B, Cc, F, T = shape
    g = torch.randn(B, Cc, F // 2, T // 2, generator=g0).to(dev, dtype)
    y, g = y.contiguous(memory_format=cl), g.contiguous(memory_format=cl)
    want = PV.pool_bwd_plain(y, g)
    PV.reset_launches()
    got = PV.pool_bwd(y, g)
    assert PV.launches() == 1
    assert got.is_contiguous(memory_format=cl) and torch.equal(got, want)
    assert torch.equal(PV.pool_bwd(y, g.contiguous()), want)
    wide = torch.zeros(B, Cc, F, 2 * T, device=dev, dtype=dtype)
    wide[..., ::2] = y
    ys = wide[..., ::2]                     # neither layout
    got = PV.pool_bwd(ys, g)
    assert got.is_contiguous(memory_format=cl) and torch.equal(got, want)


# block-1 backward against the plain backward on the same forward out/idx,
# relative to the largest gradient of the tensor: f32 sums over ~B*F*T
# terms in another order; bf16: the same, plus a dx1 sum by a bf16
# rounding boundary that rounds to the neighbouring value before dW1 takes
# it; dropping that rounding moves dW1 by more than 1e-3
# (test_torch_vgg_block1.py::test_bf16_card_tolerance_catches_unrounded_dx1)
VGG_BWD_F32_TOL, VGG_BWD_BF16_TOL = 1e-4, 1e-3


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,T", [(2, 16, 16), (1, 17, 9), (2, 161, 129),
                                   (1, 9, 801), (3, 5, 300),
                                   (2, 19, 70), (1, 42, 97),
                                   (2, 161, 1600)])
def test_vgg_block1_bwd_kernel_matches_plain(dev, cdt, B, F, T):
    args = _block_args(dev, B, F, T, seed=F + T)
    idx = torch.empty((B, F // 2, T // 2, 64), dtype=torch.uint8, device=dev)
    out = V.vgg_block1(*args, cdt=cdt, idx_out=idx)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dev, cdt)
    V.reset_launches()
    got = V.vgg_block1_bwd(*args[:4], out, idx, g, cdt)
    assert V.bwd_launches() == 1
    want = V.vgg_block1_bwd_plain(*args[:4], out, idx, g, cdt)
    tol = VGG_BWD_F32_TOL if cdt == torch.float32 else VGG_BWD_BF16_TOL
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_err(a, b) < tol
    again = V.vgg_block1_bwd(*args[:4], out, idx, g, cdt)
    for a, b in zip(got, again):
        assert torch.equal(a, b)          # fixed-order reduction


# the f32 entries' kernels as the profiler names them (csrc/vgg_block1_f32.cu)
FWD1_F32_KERNELS = ("vgg_block1_fwd_f32_kernel",)
BWD1_F32_KERNELS = ("vgg_block1_bwd_wgrad_f32_kernel",
                    "vgg_block1_bwd_dx1_f32_kernel",
                    "vgg_block1_bwd_reduce_f32_kernel")


@pytest.mark.parametrize("B,F,T,all_on", [
    (2, 161, 129, False), (2, 161, 129, True), (3, 25, 95, False),
    (1, 2, 2, False)])
def test_vgg_block1_f32_kernels(dev, B, F, T, all_on):
    """The f32 forward and backward where the 8-row and 32-column tiles
    are cut at the bottom and the right edge (odd F: the backward's last
    row tile holds row F-1 alone), and with every x1 positive (b1 + 10: a
    border that took relu(b1) instead of zero would show, and no mask
    decision is near): the forward within F32_TOL of the plain version,
    out with and without idx bit-identical; the backward within
    VGG_BWD_F32_TOL of the plain backward, two runs bit-identical; one
    launch through each wrapper, whose kernels are the entry's."""
    cdt = torch.float32
    args = _block_args(dev, B, F, T, seed=3 * F + T)
    if all_on:
        args[2] = args[2].abs() + 10.0
    idx = torch.empty((B, F // 2, T // 2, 64), dtype=torch.uint8, device=dev)
    V.reset_launches()
    out = V.vgg_block1(*args, cdt=cdt, idx_out=idx)
    assert V.launches() == 1
    want, want_idx = V.vgg_block1_plain(*args, cdt=cdt)
    torch.testing.assert_close(out, want, rtol=F32_TOL, atol=F32_TOL)
    assert (idx == want_idx).float().mean().item() > 0.999
    assert torch.equal(V.vgg_block1(*args, cdt=cdt), out)
    names = _kernel_names(lambda: V.vgg_block1(*args, cdt=cdt), "vgg_block1")
    assert [k for n in names for k in FWD1_F32_KERNELS if k in n] == list(
        FWD1_F32_KERNELS) and len(names) == 1, names

    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(T)
                    ).to(dev, cdt)
    V.reset_launches()
    got = V.vgg_block1_bwd(*args[:4], out, idx, g, cdt)
    assert V.bwd_launches() == 1
    want = V.vgg_block1_bwd_plain(*args[:4], out, idx, g, cdt)
    for name, a, b in zip(("dw1", "db1", "dw2", "db2"), got, want):
        assert a.shape == b.shape and _rel_err(a, b) < VGG_BWD_F32_TOL, name
    again = V.vgg_block1_bwd(*args[:4], out, idx, g, cdt)
    for a, b in zip(got, again):
        assert torch.equal(a, b)          # fixed-order sums
    names = _kernel_names(
        lambda: V.vgg_block1_bwd(*args[:4], out, idx, g, cdt), "vgg_block1")
    assert [k for n in names for k in BWD1_F32_KERNELS if k in n] == list(
        BWD1_F32_KERNELS) and len(names) == len(BWD1_F32_KERNELS), names


# ---------------------------------------------------------------------------
# block 2 (kernels 7 and 8) and the streaming probes (kernels 10 and 11)
# ---------------------------------------------------------------------------

def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _block2_args(dev, cdt, B, F, T, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, F, T, 64, generator=g).relu().to(dev, cdt)
    return [x] + [t.to(dev) for t in (
        torch.randn(3, 3, 64, 128, generator=g) * (2 / 576) ** 0.5,
        torch.randn(128, generator=g) * 0.1,
        torch.randn(3, 3, 128, 128, generator=g) * (2 / 1152) ** 0.5,
        torch.randn(128, generator=g) * 0.1)]


BLOCK2_SHAPES = [(2, 4, 2), (1, 6, 70), (3, 18, 34), (1, 82, 130),
                 (2, 8, 258)]
# f32: 576- and 1152-term sums (forward) and sums over B*F*T positions
# (backward) in another order
BLOCK2_F32_TOL = 1e-4
# bf16 backward, relative L2 per tensor against the plain backward on the
# same out / idx: a dx2 or dx sum by a bf16 rounding boundary rounds to the
# neighbouring value (one bf16 ulp, 2^-8 relative, on a share of elements)
BLOCK2_BWD_BF16_TOL = 2 ** -8


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,T", BLOCK2_SHAPES)
def test_vgg_block2_kernel_matches_plain(dev, cdt, B, F, T):
    args = _block2_args(dev, cdt, B, F, T, seed=F * T)
    idx = torch.empty((B, F // 2, T // 2, 128), dtype=torch.uint8, device=dev)
    V.reset_launches2()
    got = V.vgg_block2(*args, cdt=cdt, idx_out=idx)
    assert V.launches2() == 1
    want, want_idx = V.vgg_block2_plain(*args, cdt=cdt)
    assert got.dtype == cdt and got.shape == want.shape
    if cdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
    assert (idx == want_idx).float().mean() > 0.99
    got_noidx = V.vgg_block2(*args, cdt=cdt)
    assert torch.equal(got_noidx, got)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_vgg_block2_border_and_ties(dev, cdt):
    """Zero input, large b3, negative w4: the border's fewer taps win the
    pool, so a bias leaking into conv4's padding would show; and all-zero
    weights tie every window, which the first element wins."""
    x, w3, b3, w4, b4 = _block2_args(dev, cdt, 1, 8, 70, seed=5)
    args = (x * 0, w3, b3.abs() + 1.0, -w4.abs(), b4 * 0 + 100.0)
    got = V.vgg_block2(*args, cdt=cdt)
    want, _ = V.vgg_block2_plain(*args, cdt=cdt)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    assert (got[0, 0, 0].float() - got[0, 1, 3].float()).abs().max() > 1.0
    idx = torch.full((1, 4, 35, 128), 9, dtype=torch.uint8, device=dev)
    V.vgg_block2(x, w3 * 0, b3, w4 * 0, b4, cdt=cdt, idx_out=idx)
    assert not idx.any()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,T", BLOCK2_SHAPES)
def test_vgg_block2_bwd_kernel_matches_plain(dev, cdt, B, F, T):
    args = _block2_args(dev, cdt, B, F, T, seed=F + T)
    idx = torch.empty((B, F // 2, T // 2, 128), dtype=torch.uint8, device=dev)
    out = V.vgg_block2(*args, cdt=cdt, idx_out=idx)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dev, cdt)
    V.reset_launches2()
    got = V.vgg_block2_bwd(*args[:4], out, idx, g, cdt)
    assert V.bwd2_launches() == 1
    want = V.vgg_block2_bwd_plain(*args[:4], out, idx, g, cdt)
    tol = BLOCK2_F32_TOL if cdt == torch.float32 else BLOCK2_BWD_BF16_TOL
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_l2(a, b) < tol, name
    again = V.vgg_block2_bwd(*args[:4], out, idx, g, cdt)
    for a, b in zip(got, again):
        assert torch.equal(a, b)          # fixed-order reduction


# the bf16 forward's kernel as the profiler names it (csrc/vgg_block2.cu)
FWD2_BF16_KERNEL = "vgg_block2_fwd_wgmma_kernel"


@pytest.mark.parametrize("B,F,T", [(12, 80, 400), (2, 82, 398),
                                   (1, 4, 70), (3, 8, 202)])
def test_vgg_block2_bf16_forward_wgmma_kernel(dev, B, F, T):
    """The bf16 forward at the train cell's shape, with fewer work items
    than SMs (1, 4, 70: 2 items), T not a multiple of the 100-column
    strip: within VGG_BF16_ATOL + VGG_BF16_RTOL * |plain| of the plain
    version elementwise, the argmax equal wherever the plain conv4's two
    best window values lie more than 2^-6 * max(|best|, 1) apart, out
    with and without idx bit-identical, and one launch of its kernel a
    call."""
    import torch.nn.functional as Fn
    cdt = torch.bfloat16
    args = _block2_args(dev, cdt, B, F, T, seed=7 * F + T)
    idx = torch.empty((B, F // 2, T // 2, 128), dtype=torch.uint8, device=dev)
    got = V.vgg_block2(*args, cdt=cdt, idx_out=idx)
    want, want_idx = V.vgg_block2_plain(*args, cdt=cdt)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    x, w3, b3, w4, _ = args
    y4 = Fn.conv2d(V._x2_plain(x, w3, b3, cdt), V._nchw(w4, cdt),
                   padding=1).float()
    win = y4.reshape(B, 128, F // 2, 2, T // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(B, F // 2, T // 2, 128, 4)
    top = win.topk(2, dim=-1).values
    clear = (top[..., 0] - top[..., 1]) > 2 ** -6 * top[..., 0].abs(
        ).clamp_min(1.0)
    assert clear.float().mean() > 0.9
    assert bool((idx == want_idx)[clear].all())
    runs = []

    def call():  # once more where the profiler lost the window
        V.reset_launches2()
        runs.append(V.vgg_block2(*args, cdt=cdt))
    names = _kernel_names(call, "vgg_block2")
    assert torch.equal(runs[0], got)
    assert V.launches2() == 1
    assert len(names) == 1 and FWD2_BF16_KERNEL in names[0], names


# the bf16 backward's kernels as the profiler names them (csrc/vgg_block2.cu):
# the row-walking pass and the dx kernel, which also adds up the partials
BWD2_BF16_KERNELS = ("vgg_block2_bwd_rows_kernel", "vgg_block2_bwd_dx_kernel")


@pytest.mark.parametrize("B,F,T,all_on", [
    (12, 80, 400, False), (12, 80, 400, True), (1, 4, 70, False),
    (2, 8, 130, True), (3, 24, 200, False)])
def test_vgg_block2_bwd_bf16_kernels(dev, B, F, T, all_on):
    """The bf16 backward at the train cell's shape, with fewer work items
    than blocks (1, 4, 70), T not a multiple of the 40-column strip, and
    with every activation positive (b3 + 10: the relu mask out of play):
    within BLOCK2_BWD_BF16_TOL of the plain backward on the same out / idx,
    two runs bit-identical, and one launch of each of its two kernels."""
    cdt = torch.bfloat16
    x, w3, b3, w4, b4 = _block2_args(dev, cdt, B, F, T, seed=B * F + T)
    if all_on:
        b3 = b3.abs() + 10.0
    idx = torch.empty((B, F // 2, T // 2, 128), dtype=torch.uint8, device=dev)
    out = V.vgg_block2(x, w3, b3, w4, b4, cdt=cdt, idx_out=idx)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(T)
                    ).to(dev, cdt)
    got = V.vgg_block2_bwd(x, w3, b3, w4, out, idx, g, cdt)
    want = V.vgg_block2_bwd_plain(x, w3, b3, w4, out, idx, g, cdt)
    for name, a, b in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_l2(a, b) < BLOCK2_BWD_BF16_TOL, name
    again = []
    names = _kernel_names(lambda: again.append(
        V.vgg_block2_bwd(x, w3, b3, w4, out, idx, g, cdt)), "vgg_block2_bwd")
    for a, b in zip(got, again[0]):
        assert torch.equal(a, b)          # fixed-order sums
    assert len(names) == len(BWD2_BF16_KERNELS), names
    assert sorted(k for n in names for k in BWD2_BF16_KERNELS if k in n) \
        == sorted(BWD2_BF16_KERNELS), names


# the f32 entries' kernels as the profiler names them (csrc/vgg_block2_f32.cu):
# every kernel of an entry carries the prefix chip_smoke.py's device_ms sums
FWD2_F32_KERNELS = ("vgg_block2_fwd_x2_f32_kernel",
                    "vgg_block2_fwd_conv4_f32_kernel")
BWD2_F32_KERNELS = ("vgg_block2_bwd_x2_f32_kernel",
                    "vgg_block2_bwd_dy4_f32_kernel",
                    "vgg_block2_bwd_dy3_f32_kernel",
                    "vgg_block2_bwd_wgrad_f32_kernel",
                    "vgg_block2_bwd_reduce_f32_kernel",
                    "vgg_block2_bwd_dx_f32_kernel")
# f32 backward, the tensors downstream of the relu mask (dx, dW3, db3): an
# activation within one f32 sum error of zero may be masked the other way
# (chip_smoke.py VGG2_F32_MASK_TOL); with b3 + 10 no mask decision is near
BLOCK2_F32_MASK_TOL = 1e-3


def _kernel_names(fn, key):
    """The device kernels of one fn() call whose names hold `key`, in
    launch order, from a profiling window that opens with kernels of its
    own (probe_lib.kernel_names: a window can lose its first launch, and
    now and then all of it)."""
    from end2end_asr_tpu_torch.tools import probe_lib as P
    return P.kernel_names(torch, fn, key)


@pytest.mark.parametrize("B,F,T,all_on", [
    (2, 82, 398, False), (2, 82, 398, True), (3, 10, 34, False)])
def test_vgg_block2_f32_kernels(dev, B, F, T, all_on):
    """The f32 forward and backward at chip_smoke.py's second shape and at
    one whose F and T are multiples of neither tile (8 or 16 rows, 16
    columns), and with every activation positive (b3 + 10): the forward
    within F32_TOL of the plain version, its argmax equal wherever the
    plain conv4's two best window values lie more than 1e-4 * max(|best|,
    1) apart, out with and without idx bit-identical; the backward within
    BLOCK2_F32_TOL (BLOCK2_F32_MASK_TOL for dx, dW3, db3 where a mask
    decision can be near) of the plain backward on the same out / idx, two
    runs bit-identical; one launch through each wrapper, whose kernels are
    the entry's and carry its prefix."""
    import torch.nn.functional as Fn
    cdt = torch.float32
    x, w3, b3, w4, b4 = _block2_args(dev, cdt, B, F, T, seed=5 * F + T)
    if all_on:
        b3 = b3.abs() + 10.0
    idx = torch.empty((B, F // 2, T // 2, 128), dtype=torch.uint8, device=dev)
    V.reset_launches2()
    out = V.vgg_block2(x, w3, b3, w4, b4, cdt=cdt, idx_out=idx)
    assert V.launches2() == 1
    want, want_idx = V.vgg_block2_plain(x, w3, b3, w4, b4, cdt=cdt)
    torch.testing.assert_close(out, want, rtol=F32_TOL, atol=F32_TOL)
    y4 = Fn.conv2d(V._x2_plain(x, w3, b3, cdt), V._nchw(w4, cdt), padding=1)
    win = y4.reshape(B, 128, F // 2, 2, T // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(B, F // 2, T // 2, 128, 4)
    top = win.topk(2, dim=-1).values
    clear = (top[..., 0] - top[..., 1]) > 1e-4 * top[..., 0].abs(
        ).clamp_min(1.0)
    assert clear.float().mean() > 0.9
    assert bool((idx == want_idx)[clear].all())
    names = _kernel_names(lambda: V.vgg_block2(x, w3, b3, w4, b4, cdt=cdt),
                          "vgg_block2")
    assert len(names) == len(FWD2_F32_KERNELS), names
    assert all("vgg_block2_fwd" in n for n in names), names
    assert sorted(k for n in names for k in FWD2_F32_KERNELS if k in n) \
        == sorted(FWD2_F32_KERNELS), names
    assert torch.equal(V.vgg_block2(x, w3, b3, w4, b4, cdt=cdt), out)

    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(T)
                    ).to(dev, cdt)
    V.reset_launches2()
    got = V.vgg_block2_bwd(x, w3, b3, w4, out, idx, g, cdt)
    assert V.bwd2_launches() == 1
    want = V.vgg_block2_bwd_plain(x, w3, b3, w4, out, idx, g, cdt)
    tols = [BLOCK2_F32_TOL if all_on else BLOCK2_F32_MASK_TOL] * 3 + [
        BLOCK2_F32_TOL] * 2
    for name, a, b, tol in zip(("dx", "dw3", "db3", "dw4", "db4"), got, want,
                               tols):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_l2(a, b) < tol, name
    again = V.vgg_block2_bwd(x, w3, b3, w4, out, idx, g, cdt)
    for a, b in zip(got, again):
        assert torch.equal(a, b)          # fixed-order sums
    names = _kernel_names(
        lambda: V.vgg_block2_bwd(x, w3, b3, w4, out, idx, g, cdt),
        "vgg_block2")
    assert len(names) == len(BWD2_F32_KERNELS), names
    assert all("vgg_block2_bwd" in n for n in names), names
    assert sorted(k for n in names for k in BWD2_F32_KERNELS if k in n) \
        == sorted(BWD2_F32_KERNELS), names


def test_vgg_block2_autograd_function_and_rejections(dev):
    x, w3, b3, w4, b4 = _block2_args(dev, torch.float32, 1, 6, 10, seed=2)
    leaves = [t.requires_grad_() for t in (x, w3, b3, w4, b4)]
    out = V.VggBlock2.apply(*leaves, torch.float32)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    want = V.vgg_block2_bwd_plain(x, w3, b3, w4, out.detach(),
                                  V.vgg_block2_plain(x, w3, b3, w4, b4,
                                                     torch.float32)[1],
                                  g, torch.float32)
    for a, b in zip(got, want):
        assert _rel_l2(a, b) < BLOCK2_F32_TOL
    with torch.no_grad():
        with pytest.raises(ValueError, match="even F and T"):
            V.vgg_block2(x[:, :5], w3, b3, w4, b4, torch.float32)
        with pytest.raises(ValueError, match="even F and T"):
            V.vgg_block2(x[:, :, :9].contiguous(), w3, b3, w4, b4,
                         torch.float32)
        with pytest.raises(ValueError, match="b4 must be f32"):
            V.vgg_block2(x, w3, b3, w4, b4[:64], torch.float32)
        with pytest.raises(ValueError, match="in torch.bfloat16"):
            V.vgg_block2(x, w3, b3, w4, b4, torch.bfloat16)
        with pytest.raises(ValueError, match="not supported"):
            V.vgg_block2(x.half(), w3, b3, w4, b4, torch.float16)


@pytest.mark.parametrize("n", [4, 1023, 4096 * 33 + 5, 5 * 2 ** 20 + 3,
                               38400 * 1024 - 5])
def test_stream_kernels_match_plain(dev, n):
    """stream_copy's tiles, the last one partial, and its scalar tail (n +
    4 not a multiple of 4 floats, nor of a tile), up to the probe's size;
    and stream_adam."""
    from end2end_asr_tpu_torch.tools import probe_stream as PS
    g = torch.Generator().manual_seed(n)
    p, m, v, gr = (torch.randn(n + 4, generator=g).to(dev) for _ in range(4))
    v = v.abs()
    PS.reset_launches()
    # n + 4 floats keep every array 16-byte aligned; n odd ends in a tail
    out = PS.stream_copy(p)
    assert PS.copy_launches() == 1 and torch.equal(out, p + 1.0)
    want = PS.adam_plain(p, m, v, gr, 3.0)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    res = PS.stream_adam(pk, mk, vk, gr, 3.0)
    assert PS.adam_launches() == 1 and res[0] is pk
    for a, b in zip((pk, mk, vk), want):
        assert (a - b).abs().max().item() <= 1e-6
    with pytest.raises(ValueError, match="16-byte"):
        PS.stream_copy(p[1:])


def test_lm_evaluate_on_the_card_equals_cpu(dev, tmp_path):
    """The rescoring LM's scores on the card (cuDNN's LSTM, TF32 off)
    equal the CPU's: summed CE of <= 20 words of f32 log-softmax."""
    from end2end_asr_tpu_torch.models.lm import LM, init_lm, save_npz_lm
    words = ["<eos>", "<oov>"] + [f"w{i}" for i in range(300)]
    path = str(tmp_path / "lm.npz")
    save_npz_lm(path, init_lm(len(words), 256, 256, 2, False,
                              torch.Generator().manual_seed(0)),
                {w: i for i, w in enumerate(words)})
    gpu, cpu = LM(path, dev), LM(path, "cpu")
    g = torch.Generator().manual_seed(1)
    for n in (1, 2, 7, 19):
        ids = torch.randint(0, 320, (n,), generator=g).tolist()
        seq = " ".join(f"w{i}" for i in ids)
        (ce_g, oov_g), (ce_c, oov_c) = gpu.evaluate(seq), cpu.evaluate(seq)
        assert oov_g == oov_c and abs(ce_g - ce_c) <= 1e-4, (seq, ce_g,
                                                            ce_c)


def test_quantized_f32_serving_on_the_card_equals_cpu(dev):
    """The int8 model at f32 (TF32 off): the encoder output (features,
    the vgg kernels, 2 layers) and 8 KV-cached decode steps on the card
    equal the CPU path's; sums in another order."""
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.evaluation import encode_pcm, prepare_params
    from end2end_asr_tpu_torch.models import decoder as D
    from end2end_asr_tpu_torch.models.quantize import quantize_for_inference
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          init_params)
    cfg = Config(feat_extractor="vgg_cnn", num_layers=2, num_heads=4,
                 dim_model=128, dim_key=32, dim_value=32, dim_inner=256,
                 dim_emb=128, dtype="float32")
    dims = dims_from_config(cfg)
    q = quantize_for_inference(init_params(cfg, 50,
                                           torch.Generator().manual_seed(2)))
    T = 200
    pcm = torch.randn(2, (T - 1) * cfg.hop_length + cfg.n_fft,
                      generator=torch.Generator().manual_seed(3)) * 0.3
    frames = torch.tensor([T, T - 37])
    toks = torch.randint(0, 50, (8, 2), generator=torch.Generator()
                         .manual_seed(4))
    outs = []
    for d in (dev, torch.device("cpu")):
        p = prepare_params(q, dims, d)
        enc, _ = encode_pcm(p, cfg, dims, pcm.to(d), frames.to(d), T)
        cache = D.init_cache(p["decoder"], enc, 8, dims.num_heads,
                             dims.dim_key, dims.dim_value,
                             dtype=torch.float32)
        logits = torch.stack([D.decode_step(
            p["decoder"], cache, toks[t].to(d), t, dims.num_heads,
            dims.dim_key, dims.dim_value, dims.dim_model,
            dtype=torch.float32) for t in range(8)])
        outs.append((enc.cpu(), logits.cpu()))
    assert outs[0][0].shape == (2, T // 4, 128)
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=2e-3)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=2e-3)


def test_group_of_one_nccl_step_equals_the_plain_step(dev, monkeypatch):
    """A world-1 NCCL group, joined as under torchrun (the port's
    parallel/mesh.py: NCCL, since the one rank has a card): one train
    step of a narrow model equals the step without a group (at world size
    1 no collective runs): the loss within 1e-6, the parameters within
    Adam's first-step bound of 2·lr (library backward kernels with
    atomics may sum a gradient in another order, and a gradient at noise
    level may then move its parameter the other way)."""
    import socket

    import torch.distributed as dist
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          init_params)
    from end2end_asr_tpu_torch.parallel import mesh
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_train_step_impl)
    cfg = Config(feat_extractor="vgg_cnn", num_layers=1, num_heads=2,
                 dim_model=64, dim_key=32, dim_value=32, dim_inner=128,
                 dim_emb=64, dropout=0.0, dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, 12, g)
    T = 200
    pcm = (torch.randn(2, (T - 1) * 160 + 320, generator=g) * 0.2).to(dev)
    n_frames = torch.tensor([T, T - 30], device=dev)
    targets = torch.tensor([[1, 5, 6, 7, 2, 0], [1, 8, 9, 2, 0, 0]],
                           device=dev)
    lengths = torch.tensor([5, 4], device=dev)

    def one_step():
        fp = FlatParams(params, dev)
        step = make_train_step_impl(cfg, dims_from_config(cfg))
        out = step(fp, fp.data, init_opt_state(cfg, fp.data), None, pcm,
                   n_frames, targets, lengths, T)
        torch.cuda.synchronize()
        return out[0], out[3]["loss"], out[3]["lr"].item()

    want_data, want_loss, lr = one_step()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(port))):
        monkeypatch.setenv(k, v)
    assert mesh.maybe_initialize_distributed(dev) == 1
    try:
        assert dist.get_backend() == "nccl"
        got_data, got_loss, _ = one_step()
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-6, atol=0)
    assert (got_data - want_data).abs().max().item() <= 2 * lr


def test_pipeline_stage_on_the_card(dev, tmp_path):
    """Two gloo ranks sharing cuda:0 as the stages of --mesh-pipe 2
    (tests/torch_pp_worker.py `gpu_run`): the hand-off goes through pinned
    host memory (gloo's point-to-point takes host tensors) and is exact
    both ways; one pipelined train step at dropout 0.1 launches each
    stage's attention kernels, and the vgg front end's on stage 0 alone;
    the ranks report the same finite loss."""
    import json
    import os
    import sys

    import torch.multiprocessing as mp
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_pp_worker
    mp.spawn(torch_pp_worker.gpu_run, args=(str(tmp_path),), nprocs=2)
    ranks = [json.loads((tmp_path / f"gpu.r{r}.json").read_text())
             for r in range(2)]
    for r, rk in enumerate(ranks):
        assert rk["transport"] == "host" and rk["hand_off_exact"], rk
        assert min(rk["attn"]) > 0, rk
        assert (min(rk["vgg"]) > 0) == (r == 0), rk
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert torch.isfinite(torch.tensor(ranks[0]["loss"]))


def test_graphed_attention_reads_each_replays_seeds(dev):
    """The attention forward and backward with their seeds in device
    memory (the device-seed entries), captured once in a CUDA graph and
    replayed with new seeds written before each replay: each replay's
    output and gradients are the eager calls' with those seeds, bit for
    bit, and the eager device-seed calls the by-value ones."""
    q, k, v, bias = _attn_inputs(dev, 2, 3, 51, 200, seed=5, mask_row=True)
    g = torch.Generator().manual_seed(3)
    dout = torch.randn(2, 3, 51, 64, generator=g).to(dev, torch.bfloat16)
    seeds = torch.zeros(4, dtype=torch.int64, device=dev)

    def run(seed):
        # leaves made on the stream that runs the call, as the train step
        # makes its parameter leaves: a capture cannot wait on another's
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = AF.flash_mha_train(*qkv, bias, seed, 0.1)
        return (out, *torch.autograd.grad(out, qkv, dout))

    values = [0x1234_5678_9ABC_DEF0, 7, 2 ** 62 + 11]
    want = [[t.clone() for t in run(s)] for s in values]
    for s, w in zip(values, want):
        seeds[2] = s
        got = run(AF.DeviceSeed(seeds, 2))
        assert all(torch.equal(a, b) for a, b in zip(got, w))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(AF.DeviceSeed(seeds, 2))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run(AF.DeviceSeed(seeds, 2))
    for s, w in zip(values, want):
        seeds[2] = s
        graph.replay()
        assert all(torch.equal(a, b) for a, b in zip(outs, w))


def test_pipeline_streams_of_a_graphed_group_equal_single_steps(dev):
    """The pipeline's (stack, layer, microbatch) dropout streams
    (models/layers.PipeStream) under a CUDA graph of 2 steps: the graph
    is captured once, after a warm-up whose streams are put back, with
    the streams' generators registered; each replay, its group's own
    seeds drawn before it (DropoutRng.group), draws on the device the
    kernel seeds and bits that 2 single steps draw, bit for bit, over 3
    replays."""
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from torch_pipe_draws import pipe_step_draws
    single = DropoutRng(7, dev)
    want = [torch.cat(pipe_step_draws(single)) for _ in range(7)]
    rng = DropoutRng(7, dev)
    assert torch.equal(torch.cat(pipe_step_draws(rng)), want[0])
    body = lambda: torch.stack([torch.cat(pipe_step_draws(rng))
                                for _ in range(2)])
    st = rng.state()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), rng.group(2):
        body()
    torch.cuda.current_stream().wait_stream(side)
    rng.set_state(st)
    graph = torch.cuda.CUDAGraph()
    for gen in rng.generators():
        graph.register_generator_state(gen)
    with rng.group(2), torch.cuda.graph(graph):
        out = body()
    rng.set_state(st)
    for r in range(3):
        with rng.group(2):
            graph.replay()
            rng.slot = rng.drawn
        assert torch.equal(out[0], want[1 + 2 * r]), r
        assert torch.equal(out[1], want[2 + 2 * r]), r


def test_steps_per_dispatch_refuses_a_gloo_group_on_the_card(dev, tmp_path):
    """--steps-per-dispatch K > 1 on the card captures a CUDA graph; a
    gloo group's collectives run on the host: make_multi_train_step raises a
    ValueError that names NCCL."""
    import torch.distributed as dist
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.models.transformer import dims_from_config
    from end2end_asr_tpu_torch.training.steps import (make_multi_train_step,
                                                      make_train_step_impl)
    cfg = Config(feat_extractor="vgg_cnn", num_layers=1, num_heads=2,
                 dim_model=64, dim_key=32, dim_value=32, dim_inner=128,
                 dim_emb=64)
    step = make_train_step_impl(cfg, dims_from_config(cfg))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="NCCL"):
            make_multi_train_step(cfg, step, 2, dev)
        make_multi_train_step(cfg, step, 2, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("T,U,case", [(51, 51, "aishell"), (7, 4, "edges"),
                                      (30, 12, "repeats")])
def test_ctc_kernels_match_plain(dev, T, U, case):
    """csrc/ctc.cu against PyTorch's ctc_loss on the card: the nll and the
    logits' gradient (through log_softmax) of the feasible rows within
    1e-4 of the largest value, +inf on the infeasible ones; "edges" holds
    an empty target, input lengths 0 and 1 and one beyond T (clamped),
    "repeats" labels repeated back to back (a blank between them)."""
    from end2end_asr_tpu_torch.ops import ctc as CT
    g = torch.Generator().manual_seed(T * 100 + U)
    B, C = 6, 40
    logits = (torch.randn(B, T, C, generator=g) * 2).to(dev)
    targets = torch.randint(1, C, (B, U), generator=g)
    tl = torch.randint(0, min(U, T // 2) + 1, (B,), generator=g)
    il = torch.randint(T // 2, T + 1, (B,), generator=g)
    if case == "edges":
        tl[0], il[1], il[2], il[3], tl[1] = 0, 0, 1, T + 3, 1
    if case == "repeats":
        targets[:, 1::2] = targets[:, 0::2]
    targets, tl, il = targets.to(dev), tl.to(dev), il.to(dev)

    def run(fn):
        x = logits.detach().requires_grad_()
        nll = fn(torch.log_softmax(x, -1), targets, il, tl)
        ok = torch.isfinite(nll)
        grad, = torch.autograd.grad(nll[ok].sum(), x)
        return nll.detach(), ok, grad

    CT.reset_launches()
    got, ok, got_g = run(CT.ctc_nll)
    assert (CT.FWD.launches, CT.BWD.launches) == (1, 1)
    want, want_ok, want_g = run(
        lambda lp, t, i, l: CT.ctc_nll_plain(lp, t, i.clamp(max=T), l))
    assert torch.equal(ok, want_ok) and ok.any()
    scale = want[ok].abs().max().item()
    assert (got[ok] - want[ok]).abs().max().item() <= 1e-4 * scale
    # the feasible rows: PyTorch's backward puts NaN on an infeasible row
    assert torch.isfinite(got_g).all()
    assert (got_g[ok] - want_g[ok]).abs().max().item() <= \
        1e-4 * want_g[ok].abs().max().item()


def test_captured_stamps_append_a_set_a_replay(dev):
    """The tracer's stamps (utils/profiling.py, csrc/trace.cu) captured
    into a CUDA graph: each replay appends its own set, in order, on the
    card's clock mapped to the host's, nothing lost; a stamp under capture
    with no ring yet raises (the ring is made outside any capture)."""
    from end2end_asr_tpu_torch.utils import profiling as P
    rec = P.RECORDER
    x = torch.ones(1 << 20, device=dev)
    rec.stamp("test.a", dev)        # the ring, made and anchored
    rec.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rec.stamp("test.a", dev)
        x.mul_(1.5)
        rec.stamp("test.b", dev)
        x.add_(1.0)
        rec.stamp("test.c", dev)
    rec.collect()
    assert not rec.stamps           # a capture runs nothing
    for _ in range(3):
        graph.replay()
    rec.collect()
    got = [s for s in rec.stamps if s[2] == dev.index]
    assert [s[0] for s in got] == ["test.a", "test.b", "test.c"] * 3
    assert all(a[1] <= b[1] for a, b in zip(got, got[1:]))
    assert rec.summary()["lost"] == {"spans": 0, "stamps": 0}
    fresh = P.Recorder()
    side = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="stamp ring"):
        with torch.cuda.graph(side):
            x.add_(1.0)
            fresh.stamp("test.a", dev)
    assert not fresh._rings


def test_capture_counts_each_parts_nodes(dev):
    """Recorder.counting inside a capture: each part's kernel, memcpy,
    memset and other nodes a step, the stamps left out, add up to the
    nodes cudaGraphGetNodes finds in the finished graph."""
    from end2end_asr_tpu_torch.utils import profiling as P
    rec = P.RECORDER
    rec.stamp("test.a", dev)
    x = torch.ones(1024, device=dev)
    y = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        with rec.counting("test", ("k",), 2):
            for _ in range(2):
                rec.stamp(P.STEP_START, dev)
                x.mul_(2.0)
                x.add_(1.0)
                rec.stamp(P.FORWARD, dev)
                y.copy_(x)
                rec.stamp(P.BACKWARD, dev)
            x.add_(3.0)
    entry = rec.graph("test", ("k",))
    nodes = P.graph_nodes(graph.raw_cuda_graph())
    assert entry["stamps"] == 6 and entry["steps"] == 2
    assert entry["nodes"]["forward"]["kernel"] == 2
    assert entry["nodes"]["outputs"]["kernel"] == 0.5     # one, over 2 steps
    assert nodes["kernel"] == entry["kernel_nodes"] + entry["stamps"]
    for kind in P.NODE_KINDS:
        got = sum(p[kind] for p in entry["nodes"].values()) * 2
        assert got == nodes[kind] - (entry["stamps"] if kind == "kernel"
                                     else 0), kind


def test_graphed_step_parts_sum_to_the_dispatch(dev):
    """Three dispatches of the K-step CUDA graph (GraphedSteps, K = 2) of
    a narrow VGG model: the stamped parts between each call's first and
    last stamp sum to within 3% of the call's device time by CUDA events
    around it; forward, backward, update and write-back are stamped each
    step; the graph's counters hold its kernel nodes by part and its
    replays (the capture's call is the first)."""
    from end2end_asr_tpu_torch.config import Config
    from end2end_asr_tpu_torch.models.layers import DropoutRng
    from end2end_asr_tpu_torch.models.transformer import (dims_from_config,
                                                          init_params)
    from end2end_asr_tpu_torch.training.optimizer import init_opt_state
    from end2end_asr_tpu_torch.training.steps import (FlatParams,
                                                      make_multi_train_step,
                                                      make_train_step_impl)
    from end2end_asr_tpu_torch.utils import profiling as P
    cfg = Config(feat_extractor="vgg_cnn", num_layers=2, num_heads=4,
                 dim_model=256, dim_key=64, dim_value=64, dim_inner=1024,
                 dim_emb=256, dropout=0.1, dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, 100, g)
    B, T, K = 4, 400, 2
    pcm = (torch.randn(B, (T - 1) * 160 + 320, generator=g) * 0.2).to(dev)
    targets = torch.randint(3, 100, (B, 20), generator=g)
    targets[:, 0], targets[:, -1] = 1, 2
    batch = (pcm, torch.full((B,), T, device=dev), targets.to(dev),
             torch.full((B,), 20, device=dev))
    fp = FlatParams(params, dev)
    step = make_train_step_impl(cfg, dims_from_config(cfg))
    multi = make_multi_train_step(cfg, step, K, dev)
    rng = DropoutRng(1, dev)
    data, opt, state = fp.data, init_opt_state(cfg, fp.data), {}
    data, opt, state, _, _, _ = step(fp, data, opt, rng, *batch, T,
                                     model_state=state)
    rec = P.RECORDER
    rec.clear()
    event_ms = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        data, opt, state, _, _, _ = multi(fp, data, opt, rng, [batch] * K,
                                          T, model_state=state)
        b.record()
        torch.cuda.synchronize()
        event_ms.append(a.elapsed_time(b))
    # each call's intervals, from its "stage" to its "outputs"
    calls, cur = [], None
    for part, t0, t1, key in rec.intervals():
        if key != dev.index:
            continue
        if part == "stage":
            cur = []
        if cur is not None:
            cur.append((part, t1 - t0))
        if part == "outputs":
            calls.append(cur)
            cur = None
    assert len(calls) == 3
    for parts, ms in zip(calls[1:], event_ms[1:]):        # the replays
        assert Counter(p for p, _ in parts) == {
            "stage": 1, "forward": K, "backward": K, "update": K,
            "writeback": K, "between": K - 1, "outputs": 1}
        got = 1e3 * sum(s for _, s in parts)
        assert abs(got - ms) <= 0.03 * ms, (got, ms, parts)
    (key, counters), = rec.graphs_of(multi.tag).items()
    assert counters["replays"] == 3 and counters["steps"] == K
    assert counters["stamps"] == 5 * K
    for part in ("forward", "backward", "update"):
        assert counters["nodes"][part]["kernel"] > 0, part
    assert sum(counters["nodes"]["writeback"].values()) > 0
    assert counters["kernel_nodes"] == K * sum(
        p["kernel"] for p in counters["nodes"].values())
    multi.close()


# -- the train step's update kernel (ops/adam.py, csrc/adam.cu) -------------

ADAM_MAX_NORM = 0.5     # below the gradients' norm: the clip binds


def adam_noam():
    from end2end_asr_tpu_torch.training.optimizer import NoamConfig
    return NoamConfig(model_size=640, factor=1.0, warmup=25, min_lr=1e-6)


def adam_inputs(dev, mdt, n: int, layout: str, step: int = 6):
    """p, g (f32), a state at `step` with moments in `mdt`, and inv, on
    the card. layout "aligned": each array its own allocation; "offset":
    each 3 elements into a larger buffer; "mixed": each at another phase
    (the parameters at 0)."""
    gen = torch.Generator().manual_seed(n)
    k = iter(range(4))

    def place(x):
        o = {"aligned": 0, "offset": 3, "mixed": next(k)}[layout]
        buf = torch.zeros(n + 4, dtype=x.dtype, device=dev)
        buf[o:o + n] = x.to(dev)
        return buf[o:o + n]
    p = place(torch.randn(n, generator=gen))
    g = place(torch.randn(n, generator=gen) * 30.0)
    m = place(torch.randn(n, generator=gen).mul(0.1).to(mdt))
    v = place(torch.rand(n, generator=gen).mul(1e-2).to(mdt))
    state = {"step": torch.tensor(step, dtype=torch.int32, device=dev),
             "mu": m, "nu": v}
    return p, g, state, torch.tensor(1.0, device=dev) / 7.0


def adam_plain_update(p, g, inv, finite, state, clip=False):
    """The step's update as the plain chain on the card: adam_noam_update
    on g * inv, then the torch.where picks."""
    from end2end_asr_tpu_torch.training import optimizer as TO
    upd, new, lr = TO.adam_noam_update(p, g * inv, state, adam_noam(),
                                       clip=clip, max_norm=ADAM_MAX_NORM)
    pick = lambda a, b: torch.where(finite, a, b)
    return pick(upd, p), TO.tree_map(pick, new, state), lr


def same_bits(a, b) -> bool:
    bits = lambda x: x.reshape(-1).view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("layout", ["aligned", "offset", "mixed"])
@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_adam_kernel_is_the_plain_chain(dev, mdt, clip, finite, layout):
    """The step's update (training/optimizer.adam_noam_step) on the card is
    one launch of csrc/adam.cu and equals the plain chain of
    adam_noam_update and the picks bit for bit, at lengths that are not
    multiples of 4 (1, 7 and 135173 elements), with the clip on and off;
    where the step is not finite, p, m and v come back unchanged. Arrays
    that do not start 16-byte aligned are refused, before any launch."""
    from end2end_asr_tpu_torch.ops import adam as A
    from end2end_asr_tpu_torch.training import optimizer as TO
    for n in (1, 7, 4096 * 33 + 5):
        p, g, state, inv = adam_inputs(dev, mdt, n, layout)
        fin = torch.tensor(finite, device=dev)
        A.reset_launches()
        step = lambda: TO.adam_noam_step(p, g, inv, fin, state, adam_noam(),
                                         clip=clip, max_norm=ADAM_MAX_NORM)
        if layout != "aligned":
            with pytest.raises(ValueError, match="16-byte aligned"):
                step()
            assert A.ADAM.launches == 0
            continue
        got = step()
        assert A.ADAM.launches == 1
        want = adam_plain_update(p, g, inv, fin, state, clip)
        assert same_bits(got[0], want[0]), n
        for k in ("step", "mu", "nu"):
            assert same_bits(got[1][k], want[1][k]), (n, k)
        assert same_bits(got[2], want[2])
        if not finite:
            assert same_bits(got[0], p) and same_bits(got[1]["mu"],
                                                      state["mu"])
            assert same_bits(got[1]["nu"], state["nu"])


def test_adam_kernel_in_a_graph_reads_each_replays_scalars(dev):
    """A CUDA graph of 3 updates (adam_noam_step, the new state copied
    back into the static buffers, as GraphedSteps does) replayed twice
    equals 6 eager updates of the plain chain bit for bit: the kernel
    reads the rate, the bias corrections and inv (changed between the
    replays) from device memory at each replay."""
    from end2end_asr_tpu_torch.ops import adam as A
    from end2end_asr_tpu_torch.training import optimizer as TO
    n = 4096 * 5 + 3
    p, g, state, inv = adam_inputs(dev, torch.float32, n, "aligned", step=0)
    fin = torch.tensor(True, device=dev)
    invs = (1.0 / 7.0, 1.0 / 3.0)
    ref_p, ref_s = p.clone(), {k: t.clone() for k, t in state.items()}
    for r in range(6):
        ref_p, ref_s, _ = adam_plain_update(
            ref_p, g, torch.tensor(invs[r // 3], device=dev), fin, ref_s)
    sp, ss = p.clone(), {k: t.clone() for k, t in state.items()}
    sinv = torch.tensor(invs[0], device=dev)

    def body():
        for _ in range(3):
            new_p, new_s, _ = TO.adam_noam_step(sp, g, sinv, fin, ss,
                                                adam_noam())
            sp.copy_(new_p)
            for k in ss:
                ss[k].copy_(new_s[k])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the warm-up: the library loaded
        body()
    torch.cuda.current_stream().wait_stream(side)
    sp.copy_(p)
    for k in ss:
        ss[k].copy_(state[k])
    graph = torch.cuda.CUDAGraph()
    A.reset_launches()
    with torch.cuda.graph(graph):
        body()
    assert A.ADAM.launches == 3
    graph.replay()
    sinv.fill_(invs[1])
    graph.replay()
    torch.cuda.synchronize()
    assert int(ss["step"]) == 6
    assert same_bits(sp, ref_p)
    for k in ("mu", "nu"):
        assert same_bits(ss[k], ref_s[k]), k
    graph.reset()
