"""Kernel nodes a step of the K-step CUDA graph, counted by the program
at its capture (utils/profiling.Recorder.counting: the graph's kernel
nodes ÷ K, its stamps left out), of the graph replayed most; None where
the program has no tracer (a checkout from before it) or the card
stamped nothing in the window (a CPU run)."""

from end2end_asr_tpu_torch.utils import profiling


def read(rec):
    tracer = getattr(profiling, "RECORDER", None)
    if rec["kind"] != "train" or tracer is None:
        return None
    s = tracer.summary(*rec["window"])
    graphs = [g for g in s["graphs"].values() if "kernel_nodes" in g]
    if not s["device_stamps"] or not graphs:
        return None
    g = max(graphs, key=lambda g: g.get("replays", 0))
    return g["kernel_nodes"] / g["steps"]
