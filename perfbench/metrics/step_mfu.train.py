"""The training step's share of the card's dense bf16 peak: the
benchmark's FLOP count of the window's steps (6 x the weights a token
multiplies through x tokens, plus the causal attention products three
times) over the window's seconds."""
from harness import counts


def read(rec):
    peaks = counts.PEAKS.get(rec["device"])
    if rec["kind"] != "train" or peaks is None:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / peaks["bf16_flops"]
