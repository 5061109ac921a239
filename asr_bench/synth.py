"""The one generator of traffic: synthetic utterances from a mix's
parameters and the run's seed.

Every seed gets the same set of durations and transcript lengths
(evenly spread over the mix's ranges), in an order, with tones, noise and
characters, drawn from the seed. An utterance is a tone of its own pitch
plus white noise (16-bit PCM), its transcript characters of the
configuration's vocabulary, as the port's own chip smoke run makes them.
Files go to a directory made under TMPDIR, which the run deletes.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import wave
from typing import List, Sequence, Tuple

import numpy as np

SPECIALS = "¶§¤"      # PAD, SOS, EOS characters


def vocabulary(labels: Sequence[str]) -> Tuple[dict, List[str]]:
    """(label2id, the characters transcripts draw from): ids 0-2 are
    PAD, SOS and EOS, then the labels in order, duplicates skipped."""
    label2id = {}
    for ch in SPECIALS + "".join(labels):
        if ch not in label2id:
            label2id[ch] = len(label2id)
    chars = [c for c in label2id if c not in SPECIALS and c.strip() == c
             and c.lower() == c and len(c) == 1]
    return label2id, chars


def utterances(seed: int, n: int, seconds: Sequence[float],
               chars_range: Sequence[int], chars: List[str],
               sr: int = 16000) -> Tuple[List[np.ndarray], List[str]]:
    """n int16 utterances and their transcripts."""
    rng = np.random.default_rng(seed)
    lo, hi = seconds
    dur = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    n_chars = chars_range[0] + np.arange(n) % (chars_range[1]
                                               - chars_range[0] + 1)
    dur, n_chars = rng.permutation(dur), rng.permutation(n_chars)
    pcm, text = [], []
    for i in range(n):
        m = int(dur[i] * sr)
        t = np.arange(m) / sr
        y = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
             + 0.05 * rng.standard_normal(m))
        pcm.append(np.clip(y * 32768, -32768, 32767).astype(np.int16))
        text.append("".join(rng.choice(chars, int(n_chars[i]))))
    return pcm, text


class Corpus:
    """Utterances written as WAV and transcript files with a manifest,
    in a directory of their own under TMPDIR."""

    def __init__(self, pcm: List[np.ndarray], text: List[str],
                 sr: int = 16000):
        self.dir = tempfile.mkdtemp(prefix="asr_bench-")
        rows = []
        for i, (y, s) in enumerate(zip(pcm, text)):
            wav = os.path.join(self.dir, f"u{i}.wav")
            txt = os.path.join(self.dir, f"u{i}.txt")
            with wave.open(wav, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(y.astype("<i2").tobytes())
            with open(txt, "w", encoding="utf-8") as f:
                f.write(s)
            rows.append(f"{wav},{txt}")
        self.manifest = os.path.join(self.dir, "manifest.csv")
        with open(self.manifest, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class FixedBins:
    """A sampler of given bins of utterance indices, in order, without
    shuffling (the batch loader's sampler interface)."""

    def __init__(self, bins: List[List[int]]):
        self.bins = bins

    def __iter__(self):
        for b in self.bins:
            yield list(b)

    def __len__(self) -> int:
        return len(self.bins)

    def shuffle(self, epoch: int) -> None:
        pass
