"""Utterances trained in the window over the window's seconds, on the
host clock."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["utterances"] / rec["window_s"]
