"""LM corpus and BPTT batches for the LSTM language model.

A copy of the JAX package's ``data/lm_loader.py`` (plain numpy). It takes
the transcripts of ASR manifests, builds a word-level vocabulary with
code-switched text re-segmented the way the rescorer segments it (each
Chinese character is a word, decoding/lm_rescoring.py), and yields
contiguous (input, target) BPTT batches, the torch LM convention of the
reference (utils/lstm_utils.py:71-80).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from end2end_asr_tpu_torch.utils.helper import (
    get_word_segments_per_language, is_contain_chinese_word)

EOS_WORD = "<eos>"
OOV_WORD = "<oov>"


def words_from_text(text: str) -> List[str]:
    """Lowercased words; each Chinese character is a word of its own."""
    text = " ".join(text.strip().lower().split())
    words: List[str] = []
    for seg in get_word_segments_per_language(text):
        if is_contain_chinese_word(seg):
            words.extend(ch for ch in seg if ch != " ")
        else:
            words.extend(w for w in seg.split(" ") if w)
    return words


def corpus_from_manifests(manifest_paths: Sequence[str]) -> List[List[str]]:
    """One word list per transcript (<eos> appended), in manifest order;
    empty transcripts are dropped."""
    sents = []
    for mp in manifest_paths:
        with open(mp, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",")
                if len(parts) < 2:
                    raise ValueError(
                        f"malformed manifest line in {mp!r} (expected "
                        f"'wav,txt'): {line!r}")
                with open(parts[1], encoding="utf-8") as tf:
                    words = words_from_text(tf.read())
                if words:
                    sents.append(words + [EOS_WORD])
    return sents


def build_word_vocab(sents: Sequence[Sequence[str]],
                     min_count: int = 1) -> Dict[str, int]:
    """<eos> = 0, <oov> = 1, then the words seen at least min_count times
    in sorted order."""
    counts = Counter(w for s in sents for w in s)
    vocab = {EOS_WORD: 0, OOV_WORD: 1}
    for w, c in sorted(counts.items()):
        if c >= min_count and w not in vocab:
            vocab[w] = len(vocab)
    return vocab


def batchify(sents: Sequence[Sequence[str]], word2idx: Dict[str, int],
             batch_size: int) -> np.ndarray:
    """The sentences as one id stream folded into (batch_size, N) columns;
    the tail that does not fill a column is dropped."""
    oov = word2idx[OOV_WORD]
    ids = np.array([word2idx.get(w, oov) for s in sents for w in s],
                   np.int32)
    n = len(ids) // batch_size
    return ids[:n * batch_size].reshape(batch_size, n)


def bptt_batches(stream: np.ndarray, bptt: int
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(inputs (B, L), targets (B, L)) next-word pairs, L <= bptt."""
    N = stream.shape[1]
    for i in range(0, N - 1, bptt):
        L = min(bptt, N - 1 - i)
        yield stream[:, i:i + L], stream[:, i + 1:i + 1 + L]
