"""Milliseconds of ``adamw_update`` in the same steps, by CUDA events; the
median of the timed steps."""
import statistics


def read(rec):
    if rec["kind"] != "train" or not rec.get("optimizer_ms"):
        return None
    return statistics.median(rec["optimizer_ms"])
