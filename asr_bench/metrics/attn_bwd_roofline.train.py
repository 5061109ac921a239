"""The fused attention backward's bound (work.attention_bwd at each
call's shape: 4 encoder, 4 decoder self and 4 cross calls a step) over
its device time, in the traced window (%)."""

from asr_bench.core import kernel_seconds

KERNELS = ("attn_bwd",)


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr:
        return None
    sec, calls = kernel_seconds(tr, KERNELS)
    if not calls:
        return None
    return 100.0 * rec["bounds_per_step"]["attn_bwd"] \
        * rec["trace_steps"] / sec
