"""Kernel 1: the STFT log-magnitude (csrc/stft.cu) and its plain version.

Replaces ``end2end_asr_tpu/ops/stft_pallas.py::_stft_kernel``: frame →
window → DFT → magnitude → log1p, one launch per batch. The masked
per-utterance normalization stays plain PyTorch after it
(``ops.features.mask_normalize``), as the JAX package computes it in XLA
outside its kernel.

Two kernels compute it, chosen here by shape, in plain code:
  * ``stft_logmag_fft_f32`` for every even n_fft whose half has no prime
    factor above 5 (320 = 2·5·32, 400, 160, 240, ...): a real-input
    mixed-radix FFT in shared memory. It takes the window vector and two
    twiddle tables built here in float64; `fft_plan` gives its radix
    passes.
  * ``stft_logmag_dft_f32`` for any other n_fft (322, 321, ...): the direct
    sum against windowed cos/sin bases.

Bound on the H100 (B=12, T=800, n_fft=320, F=161): the bytes, PCM in and
spectrogram out, ~12.3 MB → 3.7 µs at 3.35 TB/s; the FFT's
`fft_ops_per_frame` · B·T ≈ 71 MFLOP take 1.1 µs at 67 TFLOP/s (the
direct sum's 4·B·T·n_fft·F ≈ 2 GFLOP, 30 µs). See the source.

`stft_logmag` takes the plain version only for a CPU tensor; for a CUDA
tensor it launches a kernel, and raises if it cannot.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from end2end_asr_tpu_torch.data.features import get_window
from end2end_asr_tpu_torch.ops import cuda_lib
from end2end_asr_tpu_torch.ops.features import (mask_normalize, pcm_to_f32,
                                                stft_logmag_plain,
                                                windowed_bases)

P, I = cuda_lib.P, cuda_lib.I
FFT = cuda_lib.CudaKernel("stft", "stft_logmag_fft_f32",
                          [P] * 5 + [I] * 5 + [cuda_lib.U64, P])
DFT = cuda_lib.CudaKernel("stft", "stft_logmag_dft_f32",
                          [P] * 4 + [I] * 6 + [P])

# real operations of one radix-R butterfly of csrc/stft.cu (an FMA is 2)
BUTTERFLY_OPS = {2: 4, 3: 16, 4: 16, 5: 48, 8: 56}


def launches() -> int:
    """Launches of either STFT kernel through this module."""
    return FFT.launches + DFT.launches


def reset_launches() -> None:
    FFT.launches = DFT.launches = 0


def fft_plan(n_fft: int) -> Optional[Tuple[int, ...]]:
    """The FFT kernel's radix passes for n_fft (5s and 3s first, then 8s,
    a 4, a 2), or None where it does not apply: n_fft odd, under 4, or
    with a prime factor above 5 in n_fft / 2."""
    if n_fft < 4 or n_fft % 2:
        return None
    m, plan = n_fft // 2, []
    for r in (5, 3):
        while m % r == 0:
            plan.append(r)
            m //= r
    while m % 8 == 0:
        plan.append(8)
        m //= 8
    for r in (4, 2):
        if m % r == 0:
            plan.append(r)
            m //= r
    return tuple(plan) if m == 1 else None


def fft_ops_per_frame(n_fft: int) -> int:
    """Real operations the FFT kernel does per frame: the window, each
    pass's butterflies and (after the first) its twiddle products, the
    real-input split per bin pair, |X|², sqrt and log1p per bin."""
    M, ns, ops = n_fft // 2, 1, n_fft
    for r in fft_plan(n_fft):
        ops += (M // r) * (BUTTERFLY_OPS[r] + (6 * (r - 1) if ns > 1 else 0))
        ns *= r
    return ops + 18 * (M // 2 + 1) + 5 * (M + 1)


@functools.lru_cache(maxsize=8)
def window_vector(n_fft: int, window: str, device: str) -> torch.Tensor:
    """(n_fft,) f32 analysis window, as `dft_matrices` folds it in."""
    return torch.from_numpy(get_window(window, n_fft)).to(device)


@functools.lru_cache(maxsize=8)
def twiddles(n_fft: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_M^t for t < M, W_n^k for k ≤ M/2) as (·, 2) f32, M = n_fft/2,
    computed in float64."""
    M = n_fft // 2
    t = np.exp(-2j * np.pi * np.arange(M) / M)
    s = np.exp(-2j * np.pi * np.arange(M // 2 + 1) / n_fft)
    return tuple(torch.from_numpy(np.stack([a.real, a.imag], -1).astype(
        np.float32)).to(device) for a in (t, s))


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, window: str, device: str):
    cos, sin = windowed_bases(get_window(window, n_fft))
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def _check(pcm, tensors):
    if pcm.device.type != "cuda":
        raise ValueError(f"stft_logmag: unsupported device {pcm.device}")
    for name, t in (("pcm", pcm),) + tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stft_logmag: {name} must be contiguous f32")
        if t.device != pcm.device:
            raise ValueError(f"stft_logmag: {name} on {t.device}, "
                             f"pcm on {pcm.device}")
    if pcm.dim() != 2:
        raise ValueError("stft_logmag: pcm must be (B, N)")


def stft_logmag_fft(pcm: torch.Tensor, window: torch.Tensor, hop: int,
                    T_out: int) -> torch.Tensor:
    """log1p(|DFT|) of T_out frames through the FFT kernel: pcm (B, N)
    f32, window (n_fft,) f32 → (B, T_out, n_fft/2 + 1) f32."""
    n_fft = window.shape[0]
    if pcm.device.type == "cpu":
        cos, sin = windowed_bases(window.numpy())
        return stft_logmag_plain(pcm, torch.from_numpy(cos),
                                 torch.from_numpy(sin), hop, T_out)
    _check(pcm, (("window", window),))
    plan = fft_plan(n_fft)
    if window.dim() != 1 or plan is None:
        raise ValueError(f"stft_logmag_fft: no FFT plan for n_fft {n_fft}")
    if pcm.data_ptr() % 16:
        pcm = pcm.clone()                   # the kernel stages 16-byte chunks
    if window.data_ptr() % 8:
        window = window.clone()             # and the window in 8-byte ones
    B, N = pcm.shape
    out = torch.empty((B, T_out, n_fft // 2 + 1), dtype=torch.float32,
                      device=pcm.device)
    if B == 0 or T_out == 0:
        return out
    tw, tws = twiddles(n_fft, str(pcm.device))
    code = sum(r << (4 * i) for i, r in enumerate(plan))
    with torch.cuda.device(pcm.device):
        FFT.launch(pcm.data_ptr(), window.data_ptr(), tw.data_ptr(),
                   tws.data_ptr(), out.data_ptr(), B, N, T_out, n_fft, hop,
                   code, torch.cuda.current_stream().cuda_stream)
    return out


def stft_logmag_dft(pcm: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    hop: int, T_out: int) -> torch.Tensor:
    """log1p(|DFT|) of T_out frames through the direct-sum kernel: pcm
    (B, N) f32, windowed bases (n_fft, F) f32 → (B, T_out, F) f32."""
    if pcm.device.type == "cpu":
        return stft_logmag_plain(pcm, cos, sin, hop, T_out)
    _check(pcm, (("cos", cos), ("sin", sin)))
    if cos.dim() != 2 or cos.shape != sin.shape:
        raise ValueError("stft_logmag: cos/sin must be (n_fft, F)")
    B, N = pcm.shape
    n_fft, F = cos.shape
    out = torch.empty((B, T_out, F), dtype=torch.float32,
                      device=pcm.device)
    if B == 0 or T_out == 0:
        return out
    with torch.cuda.device(pcm.device):
        DFT.launch(pcm.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                   out.data_ptr(), B, N, T_out, F, n_fft, hop,
                   torch.cuda.current_stream().cuda_stream)
    return out


def stft_logmag(pcm: torch.Tensor, n_fft: int, hop: int, T_out: int,
                window: str = "hamming") -> torch.Tensor:
    """log1p(|DFT|) of T_out frames of `pcm` (B, N) f32 under the named
    window → (B, T_out, n_fft/2 + 1) f32: the FFT kernel where `fft_plan`
    has a plan for n_fft, else the direct-sum kernel; the plain version
    on a CPU tensor."""
    dev = str(pcm.device)
    if pcm.device.type == "cpu":
        return stft_logmag_plain(pcm, *_bases(n_fft, window, dev), hop,
                                 T_out)
    if fft_plan(n_fft) is not None:
        return stft_logmag_fft(pcm, window_vector(n_fft, window, dev), hop,
                               T_out)
    return stft_logmag_dft(pcm, *_bases(n_fft, window, dev), hop, T_out)


def batched_features(pcm_padded: torch.Tensor, n_valid_frames: torch.Tensor,
                     n_fft: int, hop: int, window: str, T_out: int,
                     normalize: bool = True,
                     use_kernel: bool = True) -> torch.Tensor:
    """Same contract as ops.features.batched_features, through the
    kernels: (B, N + 2·(n_fft//2)) reflect-padded PCM (int16 wire or f32)
    → (B, F, T_out) normalized log-spectrograms. use_kernel=False
    (``--no-pallas-features``) takes the plain STFT on any device."""
    pcm = pcm_to_f32(pcm_padded).contiguous()
    if use_kernel:
        spect = stft_logmag(pcm, n_fft, hop, T_out, window)
    else:
        spect = stft_logmag_plain(pcm, *_bases(n_fft, window,
                                               str(pcm.device)), hop, T_out)
    return mask_normalize(spect, n_valid_frames, n_fft // 2 + 1, T_out,
                          normalize)
