"""Share (%) of the device time inside multiply_relinearize (the
benchmark's "relin" span, which is the whole of a relin request) spent in
PyTorch's own kernels and copies: the int64 glue around the hand-written
kernels.  Any kernel that is not PyTorch's counts as hand-written, so a
new fused kernel of the port lowers the share."""

from fhebench.trace import is_library


def read(trace):
    if not trace.spans_ms.get("relin"):
        return None
    by_name = trace.device_time_by_name()
    total = sum(by_name.values())
    if total <= 0:
        return None
    glue = sum(t for name, t in by_name.items() if is_library(name))
    return 100.0 * glue / total
