"""Device milliseconds a traced train step of the kernels launched inside
the program's ``attention/grad`` span: B8's backward
(``kernels/flash_attention.py::attention_grad``), every layer's."""
from harness import spans


def read(rec):
    return spans.per_call(rec, "train", "attention/grad", "device_s", 1e3)
