"""WAV I/O for the serving path (pure Python, ``wave`` module).

A copy of the JAX package's pure-Python WAV reader (``data/audio.py``,
``_load_audio_py``) and its WAV writer. Reference behavior
(utils/audio.py:7-15): decode normalized to [-1, 1] with a mean
downmix of multi-channel audio. Augmentation (tempo/gain/noise) belongs
to training and is not part of this module.
"""

from __future__ import annotations

import wave

import numpy as np


def load_audio(path: str) -> np.ndarray:
    """Decode a WAV file → float32 in [-1, 1], mean-downmixed to mono."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)
    if sampwidth == 2:
        sound = np.frombuffer(raw, dtype="<i2").astype(np.float32) / (1 << 15)
    elif sampwidth == 4:
        sound = np.frombuffer(raw, dtype="<i4").astype(np.float32) / (1 << 31)
    elif sampwidth == 1:
        sound = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth} in {path}")
    if n_channels > 1:
        sound = sound.reshape(-1, n_channels).mean(axis=1)
    return sound


def save_wav(path: str, y: np.ndarray, sample_rate: int) -> None:
    """Write mono 16-bit WAV."""
    y16 = np.clip(np.asarray(y) * (1 << 15), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(y16.tobytes())
