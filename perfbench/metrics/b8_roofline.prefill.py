"""B8's (``csrc/flash_attention.cu``) share of its roofline in the traced
calls: the launches' least time (the larger of the causal half's FLOPs at
the bf16 peak and Q, K, V read once and O written once at the HBM
bandwidth, from the call's shape) over their device time, the kernels
found by name in the profiler's timeline."""
KERNEL = "flash_kernel"


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "prefill" or not tr or rec.get("b8_bound_s") is None:
        return None
    secs = sum(v for k, v in tr["kernels"].items() if KERNEL in k)
    n = sum(v for k, v in tr["launches"].items() if KERNEL in k)
    if n == 0 or secs <= 0:
        return None
    return 100.0 * n * rec["b8_bound_s"] / secs
