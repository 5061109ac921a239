"""Bucketed batch loader with static shapes.

A copy of the JAX package's ``data/loader.py`` without the host-feature
path. With
``num_workers`` > 1 each utterance of a batch draws from its own
RandomState, seeded from the epoch's generator as the JAX package's worker
threads are, so the batches (augmented or joint) equal its batches; the
port loads the rows one after another. `Prefetcher` (the JAX package's,
which its trainer uses by default) builds the batches in one producer
thread, up to two ahead, and puts them on the device there. Batches are
padded to a STATIC bucket ladder (Config.src_buckets frames ×
Config.tgt_buckets tokens) and carry reflect-padded raw PCM; the feature
math runs on the device (ops/features.py, ops/stft.py).

BucketingSampler semantics (utils/data_loader.py:223-243 of the
reference): sequential index bins of batch_size over duration-sorted
manifests, shuffle WITHIN a bin every iteration, shuffle bin order on
.shuffle(epoch) (the training loader, with the run's seed).

Data parallelism (``process_index`` / ``process_count``, the JAX
package's multi-host slicing): every rank runs the same sampler and builds
only its 1/process_count slice of each bin, with the buckets taken from
the WAV headers and transcripts of the whole bin (`_global_buckets`), so
every rank's batch has one shape. A ragged bin is cycled up to the full
batch before it is sliced; ``real_rows`` is then -1 (the duplicates land
on any rank, as in the JAX package) and ``bin_rows`` counts the bin's real
rows, which the ranks' slices hold first in rank order.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from end2end_asr_tpu_torch.config import Config, PAD_TOKEN
from end2end_asr_tpu_torch.data.audio import get_num_samples
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

    def shuffle(self, epoch: int) -> None:
        self.rng.shuffle(self.bins)


@dataclass
class Batch:
    """Host-side batch of reflect-padded PCM."""
    pcm: np.ndarray                    # (B, N + 2*pad) int16 or f32
    n_frames: np.ndarray               # (B,) valid spectrogram frames
    src_bucket: int                    # T (frames after padding)
    targets: np.ndarray                # (B, U_bucket) PAD-padded, SOS…EOS
    tgt_lengths: np.ndarray            # (B,)
    # rows [0:real_rows) are real; the tail (if any) is cycled padding
    # (pad_to_full below). -1 = all rows real, or sliced over ranks.
    real_rows: int = -1
    # real rows of the sampler's bin (all ranks' slices together)
    bin_rows: int = -1


def pick_bucket(value: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if value <= b:
            return b
    return ladder[-1]


class AudioBatchLoader:
    """Iterates (possibly sampler-driven) batches of a ManifestDataset."""

    def __init__(self, dataset: ManifestDataset, cfg: Config,
                 sampler: Optional[BucketingSampler] = None,
                 batch_size: Optional[int] = None, seed: int = 123456,
                 num_workers: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.cfg = cfg
        self._batch_size = batch_size or cfg.batch_size
        self.sampler = sampler or BucketingSampler(
            len(dataset), self._batch_size, seed=seed)
        self.epoch = 0
        self._seed = seed
        # --num-workers: > 1 gives each row of a batch its own generator
        self.num_workers = (cfg.num_workers if num_workers is None
                            else num_workers)
        # pad_to_full=True cycles a ragged final bin's rows up to the full
        # batch size, so every batch has one static shape;
        # Batch.real_rows marks the real prefix for scoring
        self.pad_to_full = False
        # data parallelism: this rank's 1/process_count slice of each bin
        self.process_index = process_index
        self.process_count = max(1, process_count)
        # per-index (frame_bound, u_len) memo for _global_buckets
        self._bounds_cache: dict = {}

    def __len__(self) -> int:
        return len(self.sampler)

    def shuffle(self, epoch: int) -> None:
        self.sampler.shuffle(epoch)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.RandomState(self._seed + self.epoch)
        self.epoch += 1
        for bin_ids in self.sampler:
            yield self._build_batch(bin_ids, rng)

    def _get_items(self, bin_ids: List[int], rng: np.random.RandomState):
        if self.num_workers and self.num_workers > 1 and len(bin_ids) > 1:
            # one sub-seed per utterance, drawn up front in row order: the
            # JAX package's stream. Its thread pool is not copied: four
            # threads built an augmented batch ~10x slower than one
            # (PERF.md, host data path)
            rngs = [np.random.RandomState(rng.randint(0, 2 ** 31 - 1))
                    for _ in bin_ids]
            return [self.dataset.get_item(i, r)
                    for i, r in zip(bin_ids, rngs)]
        return [self.dataset.get_item(i, rng) for i in bin_ids]

    def _global_buckets(self, bin_ids: List[int]) -> tuple:
        """(T_b, U_b) for a bin, from WAV headers and transcript files
        only (no audio decode), the same on every rank. Tempo
        augmentation stretches audio by up to 1/0.85, so the frame bound
        is scaled; joint training picks a random manifest per row, so the
        bound covers every manifest's candidate at each index."""
        cfg = self.cfg
        max_frames, max_u = 1, 1
        for i in bin_ids:
            bounds = self._bounds_cache.get(i)
            if bounds is None:
                f_i, u_i = 1, 1
                for entries in self.dataset.ids_list:
                    wav, txt = entries[i % len(entries)]
                    n = get_num_samples(wav)
                    if self.dataset.augment:
                        n = int(n / 0.85) + 1
                    f_i = max(f_i, num_frames(n, cfg.n_fft,
                                              cfg.hop_length))
                    u_i = max(u_i,
                              len(self.dataset.parse_transcript(txt)))
                bounds = self._bounds_cache[i] = (f_i, u_i)
            max_frames = max(max_frames, bounds[0])
            max_u = max(max_u, bounds[1])
        T_b = min(pick_bucket(min(max_frames, cfg.src_max_len),
                              cfg.src_buckets), cfg.src_max_len)
        U_b = min(pick_bucket(max_u, cfg.tgt_buckets), cfg.tgt_max_len)
        return T_b, U_b

    def _build_batch(self, bin_ids: List[int],
                     rng: np.random.RandomState) -> Batch:
        cfg = self.cfg
        n_fft, hop = cfg.n_fft, cfg.hop_length

        real_rows = bin_rows = len(bin_ids)
        full = self._batch_size
        if (self.pad_to_full and self.process_count == 1
                and 0 < real_rows < full):
            bin_ids = [bin_ids[k % real_rows] for k in range(full)]

        forced_buckets = None
        if self.process_count > 1:
            forced_buckets = self._global_buckets(bin_ids)
            # cycle a ragged bin up to the full global batch before
            # slicing, so every rank holds batch_size/process_count rows
            if self.pad_to_full and 0 < len(bin_ids) < full:
                bin_ids = [bin_ids[k % len(bin_ids)] for k in range(full)]
            per = -(-len(bin_ids) // self.process_count)
            padded = [bin_ids[k % len(bin_ids)]
                      for k in range(per * self.process_count)]
            lo = self.process_index * per
            bin_ids = padded[lo:lo + per]
            # the real/cycled split is global here: no local trimming
            real_rows = -1

        items = self._get_items(bin_ids, rng)
        pcms = [it[0] for it in items]
        transcripts = [it[1] for it in items]

        frames = np.array([min(num_frames(len(y), n_fft, hop),
                               cfg.src_max_len) for y in pcms])
        if forced_buckets is None:
            T_b = min(pick_bucket(int(frames.max()), cfg.src_buckets),
                      cfg.src_max_len)
            U_max = max(len(t) for t in transcripts)
            U_b = min(pick_bucket(U_max, cfg.tgt_buckets), cfg.tgt_max_len)
        else:
            T_b, U_b = forced_buckets
        frames = np.minimum(frames, T_b)

        B = len(items)
        targets = np.full((B, U_b), PAD_TOKEN, np.int32)
        tgt_lengths = np.zeros(B, np.int32)
        for i, t in enumerate(transcripts):
            t = t[:U_b]
            targets[i, :len(t)] = t
            tgt_lengths[i] = len(t)

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
                     targets=targets, tgt_lengths=tgt_lengths,
                     real_rows=real_rows, bin_rows=bin_rows)


def batch_tensors(batch: Batch, device, non_blocking: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """(pcm, n_frames, targets, tgt_lengths) of a loader batch on device
    (int64 ids and lengths); `non_blocking` copies from pinned memory."""
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    host = (torch.from_numpy(batch.pcm), as_t(batch.n_frames),
            as_t(batch.targets), as_t(batch.tgt_lengths))
    if non_blocking:
        host = tuple(t.pin_memory() for t in host)
    return tuple(t.to(device, non_blocking=non_blocking) for t in host)


# batches the Prefetcher builds ahead of the consumer (the JAX package's
# default depth)
PREFETCH_DEPTH = 2


class Prefetcher:
    """Threaded batch prefetcher (the JAX package's ``Prefetcher``): ONE
    producer thread builds up to PREFETCH_DEPTH batches ahead into a
    bounded queue, and puts each on `device` there, so that building
    batch n + 1 and its host-to-device copy overlap step n. Iterating yields
    (Batch, its tensors on `device` as `batch_tensors` gives them), the
    loader's batches in the loader's order; an exception in the producer
    is raised in the consumer, never ends the epoch quietly.

    On a CUDA device the producer copies the fields from pinned memory on
    its own copy stream and records an event after the copies; the
    consumer makes its current stream wait on that event and marks the
    tensors as used on that stream (`record_stream`), so the caching
    allocator does not hand their memory out while a step reads them."""

    def __init__(self, loader: AudioBatchLoader, device=None):
        self.loader = loader
        device = torch.device(device or "cpu")
        if device.type == "cuda" and device.index is None:
            # `--device cuda` (train's default) names no card, and the
            # thread sets its card by index: the caller's current one
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def __len__(self) -> int:
        return len(self.loader)

    def _put(self, batch: Batch, stream):
        if stream is None:
            return batch, batch_tensors(batch, self.device), None
        with torch.cuda.stream(stream):
            tensors = batch_tensors(batch, self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return batch, tensors, event

    def __iter__(self) -> Iterator[Tuple[Batch, Tuple[torch.Tensor, ...]]]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        sentinel = object()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for batch in self.loader:
                    q.put(self._put(batch, stream))
                q.put(sentinel)
            except BaseException as e:  # surface in the consumer, don't
                q.put(e)                # silently end the epoch early

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            batch, tensors, event = item
            if event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(event)
                for x in tensors:
                    x.record_stream(cur)
            yield batch, tensors
        t.join()
