"""LM score of a finished beam hypothesis.

Port of the JAX package's ``decoding/lm_rescoring.py``. Behavioural
contract with utils/lstm_utils.py:9-44 of the reference
(calculate_lm_score): ids → string (PAD/SOS/EOS characters stripped,
double spaces collapsed), code-switched text re-segmented (each Chinese
character becomes a word), then
  lm_score = −total_ce / num_words + 1,  num_words = len(words) + 1,
and (−999, 0, 0) for an empty sequence.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from end2end_asr_tpu_torch.config import EOS_CHAR, PAD_CHAR, SOS_CHAR
from end2end_asr_tpu_torch.utils.helper import (
    get_word_segments_per_language, is_contain_chinese_word)


def calculate_lm_score(ids: Sequence[int], lm,
                       id2label: Dict[int, str]) -> Tuple[float, int, int]:
    """(lm_score, num_words, oov) of the token ids under `lm`
    (models.lm.LM)."""
    seq_str = "".join(id2label.get(int(x), "") for x in ids)
    seq_str = (seq_str.replace(PAD_CHAR, "").replace(SOS_CHAR, "")
               .replace(EOS_CHAR, "")).replace("  ", " ")

    parts = []
    for seg in get_word_segments_per_language(seq_str):
        if is_contain_chinese_word(seg):
            parts.extend(ch for ch in seg if ch != " ")
        else:
            parts.append(seg)
    joined = " ".join(p for p in parts if p != "")
    joined = joined.replace("  ", " ").replace("  ", " ").strip()

    if joined == "":
        return -999.0, 0, 0

    score, oov = lm.evaluate(joined)
    num_words = len(joined.split())
    return -1.0 * score / num_words + 1.0, num_words + 1, oov
