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
                                         (160, 80, 65), (400, 160, 101)])
def test_stft_kernel_matches_plain(dev, n_fft, hop, T):
    g = torch.Generator().manual_seed(T)
    N = (T - 1) * hop + n_fft - 7   # short: the kernel zero-fills past N
    pcm = (torch.randn(3, N, generator=g) * 0.3).to(dev)
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in PF.dft_matrices(n_fft, "hann"))
    S.reset_launches()
    got = S.stft_logmag(pcm, cos, sin, hop, T)
    assert S.launches() == 1
    want = PF.stft_logmag_plain(pcm, cos, sin, hop, T)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def _block_args(dev, B, F, T, seed):
    g = torch.Generator().manual_seed(seed)
    return [t.to(dev) for t in (torch.randn(B, F, T, generator=g),
                                torch.randn(3, 3, 1, 64, generator=g) * 0.2,
                                torch.randn(64, generator=g) * 0.1,
                                torch.randn(3, 3, 64, 64, generator=g) * 0.05,
                                torch.randn(64, generator=g) * 0.1)]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,T", [(2, 16, 16), (1, 17, 9), (2, 161, 129),
                                   (1, 161, 801), (3, 5, 300)])
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


def test_kernels_reject_what_they_do_not_take(dev):
    args = _block_args(dev, 1, 8, 8, seed=1)
    with pytest.raises(ValueError):
        V.vgg_block1(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        V.vgg_block1(args[0], *args[1:], cdt=torch.float16)
    with pytest.raises(ValueError):
        S.stft_logmag(torch.zeros(2, 500, device=dev, dtype=torch.float64),
                      *(torch.zeros(320, 161, device=dev),) * 2, 160, 2)
