"""Device ms a traced request spends in the rescale (the program's
"ks.rescale" span: rescale_ciphertext, the W-CRT inverse of both
components, the exact division by the last prime and the reduced chain's
W-CRT forward)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "ks.rescale")
