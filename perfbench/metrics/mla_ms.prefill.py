"""Device milliseconds a traced prefill call of the kernels launched
inside the program's ``attention/mla`` span (``mla_apply``: the query and
KV latents, their norms, the rotary embedding, the decompressed keys and
values, B8 and the output projection), every layer's."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "prefill", "attention/mla", "device_s", 1e3)
