"""Error-rate metrics (host side).

A copy of the JAX package's ``utils/metrics.py`` with its pure-Python
edit distance only (the JAX package prefers a ctypes C++ library; the
port keeps no native host code). Behavioral contract with
utils/metrics.py:9-76 of the reference: CER = raw (unnormalized)
Levenshtein distance between hyp and gold strings; WER = distance after
remapping words to single code points; calculate_cer_en_zh splits
code-switched text into en/zh segment groups and scores each separately.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from end2end_asr_tpu_torch.utils.helper import (
    get_word_segments_per_language, is_contain_chinese_word)


def edit_distance(a: str, b: str) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    aa = np.frombuffer(a.encode("utf-32-le"), dtype=np.uint32)
    bb = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    prev = np.arange(len(bb) + 1)
    for i, ca in enumerate(aa, 1):
        cur = np.empty_like(prev)
        cur[0] = i
        cost = (bb != ca).astype(prev.dtype)
        for j in range(1, len(bb) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost[j - 1])
        prev = cur
    return int(prev[-1])


def calculate_cer(s1: str, s2: str) -> int:
    """Unnormalized character edit distance (hyp, gold)."""
    return edit_distance(s1, s2)


def calculate_wer(s1: str, s2: str) -> int:
    """Word-level edit distance: remap each distinct word to one code
    point, then run character edit distance (metrics.py:58-76)."""
    vocab = set(s1.split() + s2.split())
    word2char = dict(zip(vocab, range(len(vocab))))
    w1 = "".join(chr(word2char[w]) for w in s1.split())
    w2 = "".join(chr(word2char[w]) for w in s2.split())
    return edit_distance(w1, w2)


def calculate_cer_en_zh(s1: str, s2: str) -> Tuple[int, int, int, int]:
    """Split hyp/gold into en and zh parts; return
    (en_cer, zh_cer, len(en_gold), len(zh_gold)) as metrics.py:9-46."""
    def split(s: str) -> Tuple[str, str]:
        en, zh = "", ""
        for seg in get_word_segments_per_language(s):
            if is_contain_chinese_word(seg):
                zh = seg if not zh else zh + " " + seg
            else:
                en = seg if not en else en + " " + seg
        return en, zh

    en1, zh1 = split(s1)
    en2, zh2 = split(s2)
    return (calculate_cer(en1, en2), calculate_cer(zh1, zh2),
            len(en2), len(zh2))
