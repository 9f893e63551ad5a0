"""The prefill call's share of the card's dense bf16 peak: the benchmark's
FLOP count of the window's calls (every position through the stack, the
unembedding of the last position only) over the window's seconds."""
from harness import counts


def read(rec):
    peaks = counts.PEAKS.get(rec["device"])
    if rec["kind"] != "prefill" or peaks is None:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / peaks["bf16_flops"]
