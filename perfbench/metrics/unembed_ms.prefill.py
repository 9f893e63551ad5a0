"""Device milliseconds a traced prefill call of the kernels launched
inside the program's ``model/unembed`` span (the final norm and the
vocabulary product)."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "prefill", "model/unembed", "device_s", 1e3)
