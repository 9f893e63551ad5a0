"""Tokens trained in the window over the window's seconds (host clock,
the device synchronised at both ends)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["units"] / rec["window_s"]
