"""The share of the traced calls' wall in which no operation ran on the
card (torch.profiler's device timeline)."""


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "prefill" or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
