"""Model FLOPs of the traced steps (work.py: forward and backward at
each utterance's real frames, no recompute) over the traced window's
seconds, as a share of the card's bf16 peak (989 TFLOP/s)."""

from asr_bench.work import PEAK_BF16_FLOPS


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr or not tr["busy_s"]:
        return None
    return 100.0 * rec["trace_flops"] / tr["window_s"] / PEAK_BF16_FLOPS
