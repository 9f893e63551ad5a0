"""Kernels launched a traced train step inside the program's
``optim/adamw`` span (``adamw_update``)."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "train", "optim/adamw", "launches")
