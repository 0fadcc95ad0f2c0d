"""Device ms a traced request spends in the gl2 GEMM's relinearize (the
program's "gl2.relin" span: Gl2GemmRelin.relinearize, both components'
basis extensions, 2D transforms, key products and ModDown, and the
repack)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "gl2.relin")
