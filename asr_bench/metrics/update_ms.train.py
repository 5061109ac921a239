"""Device ms a step of the train step's update (the reductions over the
ranks, the clip, Noam Adam, the finite picks): the program's stamps from
after the gradients' concatenation to after the update, summed over the
window ÷ its steps; None as fwd_ms.train.py says."""

from end2end_asr_tpu_torch.utils import profiling


def read(rec):
    tracer = getattr(profiling, "RECORDER", None)
    if rec["kind"] != "train" or not rec["steps"] or tracer is None:
        return None
    s = tracer.card_window(*rec["window"])
    part = s and s["parts"].get("update")
    return 1e3 * part["s"] / rec["steps"] if part else None
