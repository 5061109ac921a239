"""Host-side feature geometry: the analysis window and the frame count.

A copy of the two functions of the JAX package's host oracle
(``data/features.py``) that the serving path reads. The reference's
per-utterance pipeline (utils/data_loader.py:60-91) uses librosa's STFT
with center=True reflect padding and a symmetric window.
"""

from __future__ import annotations

import numpy as np

_WINDOWS = {
    "hamming": np.hamming,
    "hann": np.hanning,
    "blackman": np.blackman,
    "bartlett": np.bartlett,
}


def get_window(name: str, n: int) -> np.ndarray:
    """Symmetric window, matching scipy.signal.<name>(n) defaults used by
    the reference (utils/data_loader.py:20-21)."""
    fn = _WINDOWS.get(name, np.hamming)
    return fn(n).astype(np.float32)


def num_frames(n_samples: int, n_fft: int, hop_length: int) -> int:
    """librosa center=True frame count: 1 + n_samples//hop."""
    pad = n_fft // 2
    return 1 + (n_samples + 2 * pad - n_fft) // hop_length
