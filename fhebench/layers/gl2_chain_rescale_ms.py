"""Device ms a traced request spends in the gl2 chain's rescale (the
program's "gl2.rescale" span: Gl2Chain.rescale, the W-CRT inverse of both
components, the exact division by the last prime and the next level's
W-CRT forward)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "gl2.rescale")
