"""Port parity: features (STFT → log1p → masked normalize).

The port's plain featurizer (end2end_asr_tpu_torch.ops.features, the
CPU side of the STFT kernel's wrapper) against the JAX package's Pallas
featurizer in interpret mode and its XLA featurizer, on the same
reflect-padded PCM made from a numpy seed. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from end2end_asr_tpu.data.features import get_window as jax_get_window
from end2end_asr_tpu.ops.features import batched_features as jax_features
from end2end_asr_tpu.ops.stft_pallas import batched_features_pallas
from end2end_asr_tpu_torch.data.features import num_frames
from end2end_asr_tpu_torch.ops import features as TF
from end2end_asr_tpu_torch.ops import stft as TS

SR = 16000
N_FFT, HOP = 320, 160
# f32 DFT products of depth 320 summed in another order: ~1e-5 absolute
# on log-magnitudes of O(1); normalization divides by a std of O(1)
TOL = 1e-4


def _batch(lengths, seed, int16=False):
    rs = np.random.RandomState(seed)
    pcms = [rs.randn(n).astype(np.float32) * 0.3 for n in lengths]
    T = max(num_frames(n, N_FFT, HOP) for n in lengths)
    n_pcm = (T - 1) * HOP
    pcm = np.zeros((len(pcms), n_pcm + N_FFT), np.float32)
    frames = np.zeros(len(pcms), np.int32)
    for i, y in enumerate(pcms):
        pcm[i] = TF.reflect_pad_pcm(y[:n_pcm], N_FFT, n_pcm)
        frames[i] = num_frames(min(len(y), n_pcm), N_FFT, HOP)
    if int16:
        pcm = np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)
    return pcm, frames, T


@pytest.mark.parametrize("window", ["hamming", "hann"])
@pytest.mark.parametrize("normalize", [True, False])
def test_plain_features_match_jax_pallas_and_xla(window, normalize):
    pcm, frames, T = _batch([4801, 3200, 2099], seed=1)  # odd lengths
    got = TF.batched_features(torch.from_numpy(pcm),
                              torch.from_numpy(frames.astype(np.int64)),
                              N_FFT, HOP, window, T_out=T,
                              normalize=normalize).numpy()
    pallas = np.asarray(batched_features_pallas(
        jnp.asarray(pcm), jnp.asarray(frames), N_FFT, HOP, window,
        T_out=T, normalize=normalize))
    xla = np.asarray(jax_features(
        jnp.asarray(pcm), jnp.asarray(frames), N_FFT, HOP, window,
        T_out=T, normalize=normalize))
    assert got.shape == pallas.shape == (3, N_FFT // 2 + 1, T)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, xla, rtol=TOL, atol=TOL)
    for i, n in enumerate(frames):  # masked pad frames are exactly zero
        assert not got[i, :, n:].any()


def test_int16_wire_and_kernel_wrapper_cpu_path():
    """int16 PCM de-scales exactly; on a CPU tensor the kernel wrapper
    (ops.stft.batched_features) takes the plain version."""
    pcm16, frames, T = _batch([3000, 2500], seed=2, int16=True)
    fr = torch.from_numpy(frames.astype(np.int64))
    got = TS.batched_features(torch.from_numpy(pcm16), fr, N_FFT, HOP,
                              "hamming", T_out=T).numpy()
    f32 = TF.batched_features(
        torch.from_numpy(pcm16.astype(np.float32) / 32768.0), fr, N_FFT,
        HOP, "hamming", T_out=T).numpy()
    np.testing.assert_array_equal(got, f32)
    ref = np.asarray(batched_features_pallas(
        jnp.asarray(pcm16), jnp.asarray(frames), N_FFT, HOP, "hamming",
        T_out=T))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert TS.launches() == 0  # CPU tensors never reach the kernels


def test_stft_logmag_plain_matches_numpy_rfft():
    """The plain log-magnitude against numpy's rfft of the framed,
    windowed signal (the librosa convention of the host oracle)."""
    pcm, _, T = _batch([2400], seed=3)
    got = TS.stft_logmag(torch.from_numpy(pcm), N_FFT, HOP, T,
                         "hamming").numpy()[0]
    idx = np.arange(T)[:, None] * HOP + np.arange(N_FFT)[None, :]
    w = np.hamming(N_FFT).astype(np.float32)
    ref = np.log1p(np.abs(np.fft.rfft(pcm[0][idx] * w, axis=1)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", ["hamming", "hann", "blackman"])
def test_fft_kernel_window_is_the_jax_window(window):
    """The window vector the FFT kernel's wrapper builds (and `dft_matrices`
    folds into its bases) is the JAX package's `get_window`, bit for bit."""
    for n in (N_FFT, 400, 240):
        got = TS.window_vector(n, window, "cpu")
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), jax_get_window(window, n))
        cos, _ = TF.dft_matrices(n, window)
        np.testing.assert_array_equal(cos[:, 0], got.numpy())


def _stockham_logmag(frames, plan, tw, tws):
    """The FFT kernel's arithmetic in numpy (f64) from its plan and its
    f32 twiddle tables: even/odd packing, Stockham passes, real split."""
    n = frames.shape[-1]
    M = n // 2
    z = frames[..., 0::2] + 1j * frames[..., 1::2]
    w = tw[:, 0] + 1j * tw[:, 1]
    ns = 1
    for r in plan:
        q, stride = M // r, M // (ns * r)
        out = np.empty_like(z)
        j = np.arange(q)
        k = j % ns
        v = np.stack([z[..., j + s * q] * w[k * s * stride]
                      for s in range(r)], -1)
        y = np.fft.fft(v, axis=-1)          # the radix-r butterfly
        for s in range(r):
            out[..., (j - k) * r + k + s * ns] = y[..., s]
        z, ns = out, ns * r
    kk = np.arange(M // 2 + 1)
    zk, zm = z[..., kk], np.conj(z[..., (M - kk) % M])
    e, o = (zk + zm) / 2, -0.5j * (zk - zm)
    ws = tws[:, 0] + 1j * tws[:, 1]
    spec = np.empty(frames.shape[:-1] + (M + 1,), complex)
    spec[..., kk] = e + ws * o
    spec[..., M - kk] = np.conj(e - ws * o)
    return np.log1p(np.abs(spec))


@pytest.mark.parametrize("n_fft,plan", [(320, (5, 8, 4)), (160, (5, 8, 2)),
                                        (400, (5, 5, 8)), (240, (5, 3, 8)),
                                        (256, (8, 8, 2)), (322, None),
                                        (321, None), (2, None)])
def test_fft_plan_and_twiddles_give_the_rfft(n_fft, plan):
    """`fft_plan` routes n_fft (None: the direct-sum kernel), its passes
    multiply to n_fft/2, the op count follows them, and the kernel's
    algorithm on these tables is numpy's rfft (f32 tables: 1e-5)."""
    assert TS.fft_plan(n_fft) == plan
    if plan is None:
        return
    assert int(np.prod(plan)) == n_fft // 2
    tw, tws = (t.numpy().astype(np.float64)
               for t in TS.twiddles(n_fft, "cpu"))
    frames = np.random.RandomState(n_fft).randn(5, n_fft)
    got = _stockham_logmag(frames, plan, tw, tws)
    want = np.log1p(np.abs(np.fft.rfft(frames, axis=-1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if n_fft == 320:
        assert TS.fft_ops_per_frame(n_fft) == 7439


def test_stft_probe_cuts_apply_to_the_source():
    """tools/probe_stft.py times the FFT kernel's parts by cutting lines
    out of csrc/stft.cu: each cut must still find its line, and the full
    copy is the shipped source."""
    from end2end_asr_tpu_torch.ops import cuda_lib
    from end2end_asr_tpu_torch.tools import probe_stft as PS
    import os
    with open(os.path.join(cuda_lib.CSRC_DIR, PS.SOURCE)) as f:
        src = f.read()
    copies = {name: PS.variant(src, cuts) for name, cuts in PS.PARTS}
    assert copies["full"] == src
    assert len(set(copies.values())) == len(PS.PARTS)
