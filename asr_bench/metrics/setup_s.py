"""Process start to the first timed unit: inputs and weights made,
the kernels built (the first run in a checkout) or loaded, the cell's
shapes warmed, the first two dispatches (the CUDA graph's capture and
a replay) run."""


def read(rec):
    return rec["setup_s"]
