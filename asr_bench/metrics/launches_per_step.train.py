"""Device operations in the traced window (a replayed graph's kernels
included) over the steps traced."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr or not tr["n_kernels"]:
        return None
    return tr["n_kernels"] / rec["trace_steps"]
