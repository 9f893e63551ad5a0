"""Milliseconds of the gradient (forward, loss and backward through
``value_and_grad``) in a step composed as ``make_train_step`` composes it,
by CUDA events; the median of the timed steps."""
import statistics


def read(rec):
    if rec["kind"] != "train" or not rec.get("grad_ms"):
        return None
    return statistics.median(rec["grad_ms"])
