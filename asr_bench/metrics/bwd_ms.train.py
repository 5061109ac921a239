"""Device ms a step of the train step's backward (autograd and the
gradients' concatenation): the program's stamps from after the loss to
after the concatenation, summed over the window ÷ its steps; None as
fwd_ms.train.py says."""

from end2end_asr_tpu_torch.utils import profiling


def read(rec):
    tracer = getattr(profiling, "RECORDER", None)
    if rec["kind"] != "train" or not rec["steps"] or tracer is None:
        return None
    s = tracer.card_window(*rec["window"])
    part = s and s["parts"].get("backward")
    return 1e3 * part["s"] / rec["steps"] if part else None
