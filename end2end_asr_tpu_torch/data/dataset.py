"""Manifest dataset, transcript parsing and noise injection.

A copy of the JAX package's ``data/dataset.py``. Behavioral contract with
utils/data_loader.py:97-179 of the reference:
  * manifests are CSV lines `wav_path,txt_path`;
  * with several manifests (joint training), __getitem__ picks a RANDOM
    manifest and indexes it modulo its length (:126-133);
  * __len__ is the size of the largest manifest;
  * transcripts are lowercased, wrapped SOS_CHAR…EOS_CHAR, chars mapped
    through label2id with unknown chars silently dropped (:135-141);
  * `augment` perturbs tempo and gain, and a NoiseInjector mixes in a
    noise file with probability noise_prob (:147-179).

Every random draw comes from the RandomState the caller passes, in the
JAX package's order: the manifest, tempo, gain, whether to add noise,
then the noise file, its level and its offset.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from end2end_asr_tpu_torch.config import EOS_CHAR, SOS_CHAR
from end2end_asr_tpu_torch.data import audio as A


class ManifestDataset:
    def __init__(self, manifest_filepath_list: Sequence[str],
                 label2id: Dict[str, int], sample_rate: int = 16000,
                 augment: bool = False, noise_injector=None,
                 noise_prob: float = 0.4):
        self.ids_list: List[List[Tuple[str, str]]] = []
        self.max_size = 0
        for path in manifest_filepath_list:
            with open(path, encoding="utf-8") as f:
                rows = [ln.strip().split(",") for ln in f if ln.strip()]
            entries = [(r[0], r[1]) for r in rows]
            if not entries:
                raise ValueError(f"empty manifest: {path!r}")
            self.ids_list.append(entries)
            self.max_size = max(self.max_size, len(entries))
        self.label2id = label2id
        self.sample_rate = sample_rate
        self.augment = augment
        self.noise_injector = noise_injector
        self.noise_prob = noise_prob

    def __len__(self) -> int:
        return self.max_size

    def get_paths(self, index: int, rng: np.random.RandomState
                  ) -> Tuple[str, str]:
        manifest = self.ids_list[rng.randint(0, len(self.ids_list))]
        return manifest[index % len(manifest)]

    def load_pcm(self, audio_path: str, rng: np.random.RandomState
                 ) -> np.ndarray:
        if self.augment:
            y = A.load_randomly_augmented_audio(
                audio_path, self.sample_rate, rng=rng)
        else:
            y = A.load_audio(audio_path)
        if self.noise_injector is not None:
            if rng.binomial(1, self.noise_prob):
                y = self.noise_injector.inject_noise(y, rng)
        return y.astype(np.float32)

    def parse_transcript(self, transcript_path: str) -> List[int]:
        with open(transcript_path, encoding="utf8") as f:
            text = SOS_CHAR + f.read().replace("\n", "").lower() + EOS_CHAR
        return [i for i in (self.label2id.get(ch) for ch in text)
                if i is not None]

    def get_item(self, index: int, rng: np.random.RandomState
                 ) -> Tuple[np.ndarray, List[int]]:
        audio_path, transcript_path = self.get_paths(index, rng)
        return (self.load_pcm(audio_path, rng),
                self.parse_transcript(transcript_path))


class NoiseInjector:
    """Mix a random noise-file segment at a random level
    (utils/data_loader.py:147-179): data + level · noise · E_data /
    E_noise, with RMS energies; a noise file shorter than the utterance
    is zero-padded."""

    def __init__(self, path: str, sample_rate: int = 16000,
                 noise_levels: Tuple[float, float] = (0.0, 0.5)):
        if not os.path.exists(path):
            raise IOError(f"Directory doesn't exist: {path}")
        self.paths = A.find_audio_files(path)
        self.sample_rate = sample_rate
        self.noise_levels = noise_levels

    def inject_noise(self, data: np.ndarray,
                     rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        rng = rng or np.random
        noise_path = self.paths[rng.randint(0, len(self.paths))]
        noise_level = rng.uniform(*self.noise_levels)
        noise_len = A.get_audio_length(noise_path)
        data_len = len(data) / self.sample_rate
        noise_start = rng.rand() * max(noise_len - data_len, 0.0)
        noise = A.audio_with_crop(noise_path, self.sample_rate,
                                  noise_start, noise_start + data_len)
        if len(noise) < len(data):
            noise = np.pad(noise, (0, len(data) - len(noise)))
        noise = noise[:len(data)]
        noise_energy = np.sqrt(noise.dot(noise) / noise.size) + 1e-10
        data_energy = np.sqrt(data.dot(data) / data.size)
        return (data + noise_level * noise * data_energy / noise_energy
                ).astype(np.float32)
