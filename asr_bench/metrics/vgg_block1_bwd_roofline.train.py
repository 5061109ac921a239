"""The fused VGG block-1 backward's bound (work.vgg_block1 at the
batch's shape) over its device time, in the traced window (%)."""

from asr_bench.core import kernel_seconds

KERNELS = ("vgg_block1_bwd",)


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr:
        return None
    sec, calls = kernel_seconds(tr, KERNELS)
    if not calls:
        return None
    return 100.0 * rec["bounds_per_step"]["vgg_block1_bwd"] \
        * rec["trace_steps"] / sec
