"""Device milliseconds a traced prefill call of the kernels launched
inside the program's ``moe/experts`` span (``moe_experts``: routing,
slots, the routed and shared experts), every layer's."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "prefill", "moe/experts", "device_s", 1e3)
