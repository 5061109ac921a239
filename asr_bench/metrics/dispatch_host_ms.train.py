"""Host milliseconds a step spends inside the program's K-step dispatch
call before it returns, from the benchmark's span around each call in
the window."""


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    lo, hi = rec["window"]
    spans = rec["spans"].durations("dispatch", lo, hi)
    return 1e3 * sum(spans) / rec["steps"]
