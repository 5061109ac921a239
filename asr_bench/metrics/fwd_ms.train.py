"""Device ms a step of the train step's forward (features, front end,
encoder and decoder, loss): the program's stamps (utils/profiling.py)
from each step's start to after its loss, summed over the window's
steps ÷ their number.

None where the program has no tracer (`profiling.RECORDER`: a checkout
from before it, over which the benchmark runs too), on the CPU, or where
the tracer lost stamps or spans that may lie in the window
(`Recorder.card_window`)."""

from end2end_asr_tpu_torch.utils import profiling


def read(rec):
    tracer = getattr(profiling, "RECORDER", None)
    if rec["kind"] != "train" or not rec["steps"] or tracer is None:
        return None
    s = tracer.card_window(*rec["window"])
    part = s and s["parts"].get("forward")
    return 1e3 * part["s"] / rec["steps"] if part else None
