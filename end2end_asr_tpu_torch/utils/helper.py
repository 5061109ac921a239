"""Text / code-switching helpers for the CER_EN / CER_ZH split.

A copy of the JAX package's ``utils/helper.py`` (the functions the
metrics read). Behavioral contract with data/helper.py:33-99 of the
reference: `is_chinese_char` = Unicode category 'Lo', and
`get_word_segments_per_language` groups a space-split sentence into
maximal runs of same-language words (language of a word = contains any
'Lo' char).
"""

from __future__ import annotations

import unicodedata
from typing import List


def is_chinese_char(cc: str) -> bool:
    return unicodedata.category(cc) == "Lo"


def is_contain_chinese_word(seq: str) -> bool:
    return any(is_chinese_char(c) for c in seq)


def get_word_segments_per_language(seq: str) -> List[str]:
    """Split into runs of same-language words. A segment is the
    space-joined run; language switches start a new segment."""
    segments: List[str] = []
    cur_lang = -1  # -1 unset, 0 english, 1 chinese
    cur = ""
    for word in seq.split(" "):
        lang = 1 if is_contain_chinese_word(word) else 0
        if cur_lang == -1 or lang == cur_lang:
            # reference quirk: no separator while the accumulator is empty
            if cur != "" and cur_lang != -1:
                cur += " "
            cur += word
        else:
            segments.append(cur)
            cur = word
        cur_lang = lang
    segments.append(cur)
    return segments
