"""Device-clock ms a traced request spends in the Delta^2 decode's exact
big-int compose (the program's "decode.compose_exact" span,
Encoder.dequantize_exact_delta, under its "gemm.decrypt_decode" root:
HEMatmul.decrypt_and_decode)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "decode.compose_exact",
                                 root="gemm.decrypt_decode")
