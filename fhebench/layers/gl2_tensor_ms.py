"""Device ms a traced request spends in the gl2 GEMM's tensor (the
program's "gl2.tensor" span: HEMatmul2.tensor_fn, the sigma gathers, the
TW twist and kernel K7's four products)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "gl2.tensor")
