"""Audio I/O and augmentation (pure NumPy).

The port's own copy of the JAX package's ``data/audio.py`` along its
pure-Python paths. Reference behavior (utils/audio.py): decode normalized
to [-1, 1] with a mean downmix of multi-channel audio (:7-15), duration
without a `soxi` subprocess (:17-20), random tempo in [0.85, 1.15] and
gain in [-6, 8] dB (:35-61).

Tempo runs the JAX package's default path: the C++ WSOLA of its
``native/`` library, of which the port has its own copy
(``csrc/audio_host.cc``, built with g++ at first use by
``data/audio_host.py``). Its window is built in float and it stretches
input shorter than two windows with its linear resampler, so it differs
from the NumPy ``_wsola_py``; the port takes ``_wsola_py`` only where the
library does not build (or ``ASR_TPU_NO_NATIVE`` stops the build), as the
JAX package does. Each path equals its JAX counterpart bit for bit. The
resampler below is NumPy's ``interp``, whose results equal the native
``resample_linear``'s.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np

from end2end_asr_tpu_torch.data import audio_host


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

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


# Extensions librosa.util.find_files matches by default (the reference
# discovers noise files with it, utils/data_loader.py:153).
AUDIO_EXTENSIONS = ("aac", "au", "flac", "m4a", "mp3", "ogg", "wav")


def find_audio_files(directory: str) -> list:
    """librosa.util.find_files semantics: recursive, case-insensitive
    match on the common audio extensions, sorted."""
    out = []
    for dp, _, fs in os.walk(directory):
        for f in fs:
            ext = f.rsplit(".", 1)[-1].lower() if "." in f else ""
            if ext in AUDIO_EXTENSIONS:
                out.append(os.path.join(dp, f))
    return sorted(out)


def decode_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode any supported audio file → (float32 mono in [-1, 1], sr).

    Dispatch is by container magic, not extension: RIFF → WAV, ``.snd``
    → Sun AU. Anything else tries soundfile / torchaudio if installed,
    then fails with a clear error."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        y = load_audio(path)
        with wave.open(path, "rb") as w:
            return y, w.getframerate()
    if magic == b".snd":
        return _load_au_py(path)
    try:
        import soundfile as sf
        data, sr = sf.read(path, dtype="float32", always_2d=True)
        return data.mean(axis=1).astype(np.float32), int(sr)
    except ImportError:
        pass
    try:
        import torchaudio
        wav, sr = torchaudio.load(path)
        return wav.mean(dim=0).numpy().astype(np.float32), int(sr)
    except ImportError:
        pass
    raise ValueError(
        f"cannot decode {path!r}: not WAV/AU and neither soundfile nor "
        "torchaudio is installed")


_ULAW_BIAS = 0x84


def _ulaw_decode(u: np.ndarray) -> np.ndarray:
    """ITU-T G.711 μ-law byte → float32 in [-1, 1]."""
    u = (~u.astype(np.int32)) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = (((mant << 3) + _ULAW_BIAS) << exp) - _ULAW_BIAS
    return np.where(sign, -mag, mag).astype(np.float32) / 32768.0


def _load_au_py(path: str) -> Tuple[np.ndarray, int]:
    """Sun/NeXT .au: 24+-byte big-endian header, then samples."""
    with open(path, "rb") as f:
        hdr = np.frombuffer(f.read(24), dtype=">u4")
        if len(hdr) < 6 or hdr[0] != 0x2E736E64:
            raise ValueError(f"not an AU file: {path!r}")
        data_offset, encoding, sr, n_ch = (
            int(hdr[1]), int(hdr[3]), int(hdr[4]), int(hdr[5]))
        f.seek(data_offset)
        raw = f.read()
    if encoding == 1:          # 8-bit μ-law
        y = _ulaw_decode(np.frombuffer(raw, np.uint8))
    elif encoding == 2:        # int8
        y = np.frombuffer(raw, np.int8).astype(np.float32) / (1 << 7)
    elif encoding == 3:        # int16 BE
        y = np.frombuffer(raw, ">i2").astype(np.float32) / (1 << 15)
    elif encoding == 5:        # int32 BE
        y = np.frombuffer(raw, ">i4").astype(np.float32) / (1 << 31)
    elif encoding == 6:        # float32 BE
        y = np.frombuffer(raw, ">f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported AU encoding {encoding} in {path!r}")
    if n_ch > 1:
        y = y[: len(y) - len(y) % n_ch].reshape(-1, n_ch).mean(axis=1)
    return y.astype(np.float32), sr


def save_wav(path: str, y: np.ndarray, sample_rate: int) -> None:
    """Write mono 16-bit WAV."""
    y16 = np.clip(np.asarray(y) * (1 << 15), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(y16.tobytes())


def get_num_samples(path: str) -> int:
    """PCM frame count from the WAV header (no decode)."""
    with wave.open(path, "rb") as w:
        return w.getnframes()


def get_audio_length(path: str) -> float:
    """Duration in seconds (replaces the soxi -D subprocess,
    utils/audio.py:17-20); a non-WAV file is decoded."""
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / float(w.getframerate())
    except (wave.Error, EOFError):
        y, sr = decode_audio(path)
        return len(y) / float(sr)


# ---------------------------------------------------------------------------
# resample / crop
# ---------------------------------------------------------------------------

def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler."""
    if sr_in == sr_out:
        return y
    n_out = int(round(len(y) * sr_out / sr_in))
    x_old = np.arange(len(y), dtype=np.float64)
    x_new = np.linspace(0, len(y) - 1, n_out)
    return np.interp(x_new, x_old, y).astype(np.float32)


def audio_with_crop(path: str, sample_rate: int, start_time: float,
                    end_time: float) -> np.ndarray:
    """Load a [start, end] second segment at sample_rate (replaces
    audio_with_sox, utils/audio.py:22-33)."""
    y, sr = decode_audio(path)
    y = resample(y, sr, sample_rate)
    i0 = int(round(start_time * sample_rate))
    i1 = int(round(end_time * sample_rate))
    return y[i0:i1]


# ---------------------------------------------------------------------------
# tempo / gain augmentation
# ---------------------------------------------------------------------------

def apply_gain(y: np.ndarray, gain_db: float) -> np.ndarray:
    return (y * (10.0 ** (gain_db / 20.0))).astype(np.float32)


def apply_tempo(y: np.ndarray, tempo: float, sample_rate: int) -> np.ndarray:
    """Time-stretch by `tempo` (>1 = faster/shorter) preserving pitch:
    the C++ WSOLA (data/audio_host.py) when its library loads, else
    `_wsola_py` (`audio_host.active()` says which)."""
    if abs(tempo - 1.0) < 1e-6:
        return y.astype(np.float32)
    out = audio_host.tempo_wsola(y, tempo, sample_rate)
    if out is not None:
        return out
    return _wsola_py(y, tempo, sample_rate)


def _wsola_py(y: np.ndarray, tempo: float, sample_rate: int) -> np.ndarray:
    """Waveform-similarity overlap-add time stretching. The candidate
    search scores each candidate with its own np.dot, in the JAX
    package's order: a product over all candidates at once sums in
    another order and can flip a near-tied pick, after which every later
    segment differs."""
    y = np.asarray(y, np.float32)
    win = int(0.030 * sample_rate)  # 30 ms analysis window
    win -= win % 2
    hop_out = win // 2
    hop_in = tempo * hop_out
    seek = int(0.010 * sample_rate)  # ±10 ms search
    n_out = int(len(y) / tempo)
    if len(y) < 2 * win:
        # too short for WSOLA; linear resample (pitch shifts, but these
        # are sub-60ms utterances)
        x_new = np.linspace(0, len(y) - 1, max(n_out, 1))
        return np.interp(x_new, np.arange(len(y)), y).astype(np.float32)

    window = np.hanning(win).astype(np.float32)
    out = np.zeros(n_out + win, np.float32)
    norm = np.zeros(n_out + win, np.float32)

    prev = y[:win] * window
    out[:win] += prev
    norm[:win] += window
    t_out = hop_out
    pos = 0.0
    while t_out + win <= n_out:
        pos += hop_in
        center = int(pos)
        lo = max(0, center - seek)
        hi = min(len(y) - win, center + seek)
        if hi <= lo:
            break
        # pick the segment best correlated with the natural continuation
        target = prev[hop_out:]  # second half of the previous overlap
        best, best_score = lo, -np.inf
        tail_len = len(target)
        for c in np.arange(lo, hi, max(1, seek // 16)):
            score = float(np.dot(y[c:c + tail_len], target))
            if score > best_score:
                best_score, best = score, c
        seg = y[best:best + win] * window
        out[t_out:t_out + win] += seg
        norm[t_out:t_out + win] += window
        prev = seg
        t_out += hop_out
    norm = np.maximum(norm, 1e-6)
    return (out[:n_out] / norm[:n_out]).astype(np.float32)


def augment_audio(y: np.ndarray, sample_rate: int, tempo: float,
                  gain_db: float) -> np.ndarray:
    """tempo + gain, replacing augment_audio_with_sox (utils/audio.py:35-47)."""
    return apply_gain(apply_tempo(y, tempo, sample_rate), gain_db)


def load_randomly_augmented_audio(path: str, sample_rate: int = 16000,
                                  tempo_range: Tuple[float, float] = (0.85, 1.15),
                                  gain_range: Tuple[float, float] = (-6, 8),
                                  rng: Optional[np.random.RandomState] = None
                                  ) -> np.ndarray:
    """Random tempo/gain perturbation (utils/audio.py:50-61) with an
    explicit RNG: tempo drawn first, then gain. The audio is resampled to
    sample_rate first, as the reference's `sox -r` does on this path (the
    plain load path does not resample)."""
    rng = rng or np.random
    tempo = rng.uniform(*tempo_range)
    gain = rng.uniform(*gain_range)
    y, sr = decode_audio(path)
    y = resample(y, sr, sample_rate)
    return augment_audio(y, sample_rate, tempo, gain)
