"""Milliseconds a traced train step in which the card idled while the host
was inside the program's ``optim/adamw`` span (``adamw_update``): the
optimizer's host time that no device work covers."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "train", "optim/adamw", "idle_s", 1e3)
