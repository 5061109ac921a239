"""Device ms a step of the K-step CUDA graph's write-back (each step's new
state copied into the graph's static buffers, GraphedSteps._body): the
program's stamps from after the update to after the copy, summed over
the window ÷ its steps; None as fwd_ms.train.py says."""

from end2end_asr_tpu_torch.utils import profiling


def read(rec):
    tracer = getattr(profiling, "RECORDER", None)
    if rec["kind"] != "train" or not rec["steps"] or tracer is None:
        return None
    s = tracer.card_window(*rec["window"])
    part = s and s["parts"].get("writeback")
    return 1e3 * part["s"] / rec["steps"] if part else None
