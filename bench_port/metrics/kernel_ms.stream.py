"""kernel_ms.stream: device milliseconds a traced pair in the kernels of
``csrc/stream.cu``, from the profiler's device events by kernel
name."""
KERNELS = ("ham_kernel", "hamw_kernel", "none_kernel", "desc_kernel",
           "merge_kernel")


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["pairs"]:
        return None
    ns = sum(v for k, v in tr["device_ns_by_op"].items()
             if any(name in k for name in KERNELS))
    return ns / 1e6 / tr["pairs"] if ns else None
