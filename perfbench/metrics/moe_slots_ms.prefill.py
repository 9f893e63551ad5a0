"""Device milliseconds a traced prefill call of the kernels launched
inside the program's ``moe/slots`` span (``moe_slots``: each (token,
expert) pair's slot in its expert's buffer), every layer's; a part of
``moe_ms.prefill``."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "prefill", "moe/slots", "device_s", 1e3)
