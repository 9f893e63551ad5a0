"""Device milliseconds a traced prefill call of the kernels launched
inside the program's ``moe/route`` span (``moe_route``: the router's
logits, the scores and the top-k choice), every layer's; a part of
``moe_ms.prefill``."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "prefill", "moe/route", "device_s", 1e3)
