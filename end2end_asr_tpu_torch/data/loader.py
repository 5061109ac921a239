"""Bucketed batch loader with static shapes (serving path).

A copy of the JAX package's ``data/loader.py`` without the prefetch
thread, the host-feature path and the multi-host slicing. Batches are
padded to a STATIC bucket ladder (Config.src_buckets frames ×
Config.tgt_buckets tokens) and carry reflect-padded raw PCM; the feature
math runs on the device (ops/features.py, ops/stft.py).

BucketingSampler semantics (utils/data_loader.py:223-243 of the
reference): sequential index bins of batch_size over duration-sorted
manifests, shuffle WITHIN a bin every iteration, shuffle bin order on
.shuffle(epoch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from end2end_asr_tpu_torch.config import Config, PAD_TOKEN
from end2end_asr_tpu_torch.data.dataset import ManifestDataset
from end2end_asr_tpu_torch.data.features import num_frames
from end2end_asr_tpu_torch.ops.features import reflect_pad_pcm


class BucketingSampler:
    def __init__(self, n: int, batch_size: int, seed: int = 123456):
        ids = list(range(n))
        self.bins = [ids[i:i + batch_size]
                     for i in range(0, len(ids), batch_size)]
        self.rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[List[int]]:
        for ids in self.bins:
            self.rng.shuffle(ids)
            yield list(ids)

    def __len__(self) -> int:
        return len(self.bins)


@dataclass
class Batch:
    """Host-side batch of reflect-padded PCM."""
    pcm: np.ndarray                    # (B, N + 2*pad) int16 or f32
    n_frames: np.ndarray               # (B,) valid spectrogram frames
    src_bucket: int                    # T (frames after padding)
    targets: np.ndarray                # (B, U_bucket) PAD-padded, SOS…EOS
    # rows [0:real_rows) are real; the tail (if any) is cycled padding
    # (pad_to_full below). -1 = all rows real.
    real_rows: int = -1


def pick_bucket(value: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if value <= b:
            return b
    return ladder[-1]


class AudioBatchLoader:
    """Iterates (possibly sampler-driven) batches of a ManifestDataset."""

    def __init__(self, dataset: ManifestDataset, cfg: Config,
                 sampler: Optional[BucketingSampler] = None,
                 batch_size: Optional[int] = None, seed: int = 123456):
        self.dataset = dataset
        self.cfg = cfg
        self._batch_size = batch_size or cfg.batch_size
        self.sampler = sampler or BucketingSampler(
            len(dataset), self._batch_size, seed=seed)
        self.epoch = 0
        self._seed = seed
        # pad_to_full=True cycles a ragged final bin's rows up to the full
        # batch size, so every batch has one static shape;
        # Batch.real_rows marks the real prefix for scoring
        self.pad_to_full = False

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.RandomState(self._seed + self.epoch)
        self.epoch += 1
        for bin_ids in self.sampler:
            yield self._build_batch(bin_ids, rng)

    def _build_batch(self, bin_ids: List[int],
                     rng: np.random.RandomState) -> Batch:
        cfg = self.cfg
        n_fft, hop = cfg.n_fft, cfg.hop_length

        real_rows = len(bin_ids)
        full = self._batch_size
        if self.pad_to_full and 0 < real_rows < full:
            bin_ids = [bin_ids[k % real_rows] for k in range(full)]

        items = [self.dataset.get_item(i, rng) for i in bin_ids]
        pcms = [it[0] for it in items]
        transcripts = [it[1] for it in items]

        frames = np.array([min(num_frames(len(y), n_fft, hop),
                               cfg.src_max_len) for y in pcms])
        T_b = min(pick_bucket(int(frames.max()), cfg.src_buckets),
                  cfg.src_max_len)
        U_max = max(len(t) for t in transcripts)
        U_b = min(pick_bucket(U_max, cfg.tgt_buckets), cfg.tgt_max_len)
        frames = np.minimum(frames, T_b)

        B = len(items)
        targets = np.full((B, U_b), PAD_TOKEN, np.int32)
        for i, t in enumerate(transcripts):
            t = t[:U_b]
            targets[i, :len(t)] = t

        # reflect-pad PCM rows on the host, heavy math on the device
        n_pcm = (T_b - 1) * hop  # samples that yield exactly T_b frames
        pad = n_fft // 2
        pcm = np.zeros((B, n_pcm + 2 * pad), np.float32)
        for i, y in enumerate(pcms):
            pcm[i] = reflect_pad_pcm(y[:n_pcm], n_fft, n_pcm)
        if cfg.pcm_wire_dtype == "int16":
            # exact for WAV-sourced audio (decode is int16/32768);
            # de-scaled on the device in ops.features.pcm_to_f32
            pcm = np.clip(np.rint(pcm * 32768.0), -32768,
                          32767).astype(np.int16)
        return Batch(pcm=pcm, n_frames=frames, src_bucket=T_b,
                     targets=targets, real_rows=real_rows)
