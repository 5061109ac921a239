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
    assert TS.KERNEL.launches == 0  # CPU tensors never reach the kernel


def test_stft_logmag_plain_matches_numpy_rfft():
    """The plain log-magnitude against numpy's rfft of the framed,
    windowed signal (the librosa convention of the host oracle)."""
    pcm, _, T = _batch([2400], seed=3)
    cos, sin = TF.dft_matrices(N_FFT, "hamming")
    got = TS.stft_logmag(torch.from_numpy(pcm), torch.from_numpy(cos),
                         torch.from_numpy(sin), HOP, T).numpy()[0]
    idx = np.arange(T)[:, None] * HOP + np.arange(N_FFT)[None, :]
    w = np.hamming(N_FFT).astype(np.float32)
    ref = np.log1p(np.abs(np.fft.rfft(pcm[0][idx] * w, axis=1)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
