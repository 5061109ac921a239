"""Kernel 1: the STFT log-magnitude (csrc/stft.cu) and its plain version.

Replaces ``end2end_asr_tpu/ops/stft_pallas.py::_stft_kernel``: frame →
window → DFT (a product with the windowed cos/sin basis) → magnitude →
log1p, one launch per batch. The masked per-utterance normalization
stays plain PyTorch after it (``ops.features.mask_normalize``), as the
JAX package computes it in XLA outside its kernel.

Bound on the H100 (B=12, T=800, n_fft=320, F=161): the DFT product,
4·B·T·n_fft·F ≈ 2 GFLOP of f32 FMA at 67 TFLOP/s ≈ 30 µs; its ~12.7 MB
of PCM in and spectrogram out take ~4 µs at 3.35 TB/s. The kernel stages
each tile's samples in shared memory once and keeps a register tile of
accumulators per thread (see the source).

`stft_logmag` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel, and raises if it cannot.
"""

from __future__ import annotations

import functools

import torch

from end2end_asr_tpu_torch.ops import cuda_lib
from end2end_asr_tpu_torch.ops.features import (dft_matrices, mask_normalize,
                                                pcm_to_f32,
                                                stft_logmag_plain)

KERNEL = cuda_lib.CudaKernel(
    "stft", "stft_logmag_f32",
    [cuda_lib.P] * 4 + [cuda_lib.I] * 6 + [cuda_lib.P])


def launches() -> int:
    """Launches of the kernel through this module."""
    return KERNEL.launches


def reset_launches() -> None:
    KERNEL.launches = 0


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, window: str, device: str):
    cos, sin = dft_matrices(n_fft, window)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def stft_logmag(pcm: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                hop: int, T_out: int) -> torch.Tensor:
    """log1p(|DFT|) of T_out frames: pcm (B, N) f32, bases (n_fft, F) f32
    → (B, T_out, F) f32."""
    if pcm.device.type == "cpu":
        return stft_logmag_plain(pcm, cos, sin, hop, T_out)
    if pcm.device.type != "cuda":
        raise ValueError(f"stft_logmag: unsupported device {pcm.device}")
    for name, t in (("pcm", pcm), ("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stft_logmag: {name} must be contiguous f32")
        if t.device != pcm.device:
            raise ValueError(f"stft_logmag: {name} on {t.device}, "
                             f"pcm on {pcm.device}")
    if pcm.dim() != 2 or cos.dim() != 2 or cos.shape != sin.shape:
        raise ValueError("stft_logmag: pcm (B, N), cos/sin (n_fft, F)")
    B, N = pcm.shape
    n_fft, F = cos.shape
    out = torch.empty((B, T_out, F), dtype=torch.float32,
                      device=pcm.device)
    if B == 0 or T_out == 0:
        return out
    with torch.cuda.device(pcm.device):
        KERNEL.launch(pcm.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                      out.data_ptr(), B, N, T_out, F, n_fft, hop,
                      torch.cuda.current_stream().cuda_stream)
    return out


def batched_features(pcm_padded: torch.Tensor, n_valid_frames: torch.Tensor,
                     n_fft: int, hop: int, window: str, T_out: int,
                     normalize: bool = True) -> torch.Tensor:
    """Same contract as ops.features.batched_features, through the
    kernel: (B, N + 2·(n_fft//2)) reflect-padded PCM (int16 wire or f32)
    → (B, F, T_out) normalized log-spectrograms."""
    pcm = pcm_to_f32(pcm_padded).contiguous()
    cos, sin = _bases(n_fft, window, str(pcm.device))
    spect = stft_logmag(pcm, cos, sin, hop, T_out)
    return mask_normalize(spect, n_valid_frames, n_fft // 2 + 1, T_out,
                          normalize)
