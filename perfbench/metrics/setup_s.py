"""Seconds from the start of the process to the start of the window:
imports, the kernel library's build or load, the weights, warm-up and,
for training, the checked steps."""


def read(rec):
    return rec["setup_s"]
