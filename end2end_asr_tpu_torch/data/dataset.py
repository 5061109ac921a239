"""Manifest dataset + transcript parsing (serving path).

A copy of the JAX package's ``data/dataset.py`` without augmentation.
Behavioral contract with utils/data_loader.py:97-144 of the reference:
  * manifests are CSV lines `wav_path,txt_path`;
  * with several manifests, __getitem__ picks a RANDOM manifest and
    indexes it modulo its length (:126-133);
  * __len__ is the size of the largest manifest;
  * transcripts are lowercased, wrapped SOS_CHAR…EOS_CHAR, chars mapped
    through label2id with unknown chars silently dropped (:135-141).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from end2end_asr_tpu_torch.config import EOS_CHAR, SOS_CHAR
from end2end_asr_tpu_torch.data.audio import load_audio


class ManifestDataset:
    def __init__(self, manifest_filepath_list: Sequence[str],
                 label2id: Dict[str, int], sample_rate: int = 16000):
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

    def __len__(self) -> int:
        return self.max_size

    def get_paths(self, index: int, rng: np.random.RandomState
                  ) -> Tuple[str, str]:
        manifest = self.ids_list[rng.randint(0, len(self.ids_list))]
        return manifest[index % len(manifest)]

    def parse_transcript(self, transcript_path: str) -> List[int]:
        with open(transcript_path, encoding="utf8") as f:
            text = SOS_CHAR + f.read().replace("\n", "").lower() + EOS_CHAR
        return [i for i in (self.label2id.get(ch) for ch in text)
                if i is not None]

    def get_item(self, index: int, rng: np.random.RandomState
                 ) -> Tuple[np.ndarray, List[int]]:
        audio_path, transcript_path = self.get_paths(index, rng)
        return (load_audio(audio_path).astype(np.float32),
                self.parse_transcript(transcript_path))
