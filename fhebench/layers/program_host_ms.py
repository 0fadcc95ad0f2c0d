"""Host ms a traced request spends inside the program's top-level spans
(encode, encrypt, decrypt, decode, the GEMM's tensor and its decrypt and
decode, ...): the cost of launching the work, where the host bounds the
card."""

from fhebench.program import roots


def read(trace):
    top = roots()
    if not top or trace.requests <= 0:
        return None
    return sum(r.host_ms for r in top) / trace.requests
