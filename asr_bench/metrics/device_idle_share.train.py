"""1 - the union of the device's operation intervals over the traced
window, in the training cells (%)."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "train" or not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
