"""Batched feature extraction around the STFT kernel (ops/stft.py).

Port of the JAX package's ``ops/features.py``: the host only decodes WAV
and reflect-pads the edges; the batch is framed, windowed,
Fourier-transformed (DFT as a product with a windowed cos/sin basis),
magnitude'd, log1p'd and masked-normalized on the device.

`batched_features` here is the plain PyTorch version of the whole
pipeline; the serving path calls `ops.stft.batched_features`, which runs
the STFT kernel and then the same `mask_normalize` epilogue.

Numerics match the reference's librosa pipeline (utils/data_loader.py:
60-91), including unbiased std (torch.Tensor.std semantics).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from end2end_asr_tpu_torch.data.features import get_window


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int, window: str) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed DFT basis: returns (W_cos, W_sin), each (n_fft, n_freq)
    float32, built in float64 as the JAX package builds it."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    w = get_window(window, n_fft).astype(np.float64)[:, None]
    cos = (np.cos(ang) * w).astype(np.float32)
    sin = (-np.sin(ang) * w).astype(np.float32)
    return cos, sin


def reflect_pad_pcm(y: np.ndarray, n_fft: int, out_len: int) -> np.ndarray:
    """Host-side prep for one utterance: center reflect-pad (librosa
    center=True) then zero-fill to out_len + 2*pad. The reflection depends
    on each utterance's true length, so it is done per row on the host."""
    pad = n_fft // 2
    ypad = np.pad(np.asarray(y, np.float32), pad, mode="reflect")
    out = np.zeros(out_len + 2 * pad, np.float32)
    out[:len(ypad)] = ypad[:len(out)]
    return out


def pcm_to_f32(pcm: torch.Tensor) -> torch.Tensor:
    """De-scale int16 wire-format PCM on the device: int16/32768 is
    bit-identical to the host-side normalization of the WAV decode."""
    if pcm.dtype == torch.int16:
        return pcm.to(torch.float32) * (1.0 / 32768.0)
    return pcm


def stft_logmag_plain(pcm: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, hop: int, T_out: int
                      ) -> torch.Tensor:
    """log1p(|DFT|) of T_out frames of `pcm` (B, N) f32 against the
    windowed bases (n_fft, F). Returns (B, T_out, F) f32."""
    n_fft = cos.shape[0]
    need = (T_out - 1) * hop + n_fft
    if pcm.shape[1] < need:
        pcm = torch.nn.functional.pad(pcm, (0, need - pcm.shape[1]))
    frames = pcm.unfold(1, n_fft, hop)[:, :T_out]  # (B, T_out, n_fft)
    re = frames @ cos
    im = frames @ sin
    return torch.log1p(torch.sqrt(re * re + im * im))


def mask_normalize(spect: torch.Tensor, n_valid_frames: torch.Tensor,
                   n_freq: int, T_out: int, normalize: bool) -> torch.Tensor:
    """Shared epilogue of the plain and kernel featurizers: zero the pad
    frames and apply per-utterance mean/std over the valid (F × T_i)
    region — unbiased std like torch.Tensor.std (data_loader.py:85-89).
    spect: (B, T_out, F) → returns (B, F, T_out)."""
    t = torch.arange(T_out, device=spect.device)
    t_valid = (t[None, :] < n_valid_frames[:, None]).to(spect.dtype)
    spect = spect * t_valid[:, :, None]

    if normalize:
        count = (n_valid_frames * n_freq).to(torch.float32)[:, None, None]
        mean = spect.sum(dim=(1, 2), keepdim=True) / count
        sq = (torch.square(spect - mean) * t_valid[:, :, None]).sum(
            dim=(1, 2), keepdim=True)
        std = torch.sqrt(sq / torch.clamp(count - 1.0, min=1.0))
        spect = (spect - mean) / torch.clamp(std, min=1e-10)
        spect = spect * t_valid[:, :, None]

    return spect.transpose(1, 2).contiguous()  # (B, F, T_out)


def batched_features(pcm_padded: torch.Tensor, n_valid_frames: torch.Tensor,
                     n_fft: int, hop: int, window: str, T_out: int,
                     normalize: bool = True) -> torch.Tensor:
    """Plain PyTorch featurizer. pcm_padded: (B, N + 2*(n_fft//2))
    host-reflect-padded PCM (f32, or int16 wire format).
    n_valid_frames: (B,) = 1 + n_samples//hop.
    Returns (B, F, T_out) log-spectrograms, zero outside the valid region.
    """
    pcm = pcm_to_f32(pcm_padded)
    cos, sin = dft_matrices(n_fft, window)
    spect = stft_logmag_plain(pcm, torch.from_numpy(cos).to(pcm.device),
                              torch.from_numpy(sin).to(pcm.device),
                              hop, T_out)
    return mask_normalize(spect, n_valid_frames, n_fft // 2 + 1, T_out,
                          normalize)
