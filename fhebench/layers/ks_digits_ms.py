"""Device ms a traced request spends in key switching's digit steps, summed
over the digits (the program's "ks.digit" spans: RelinContext._digit_step,
each a basis extension to QP, a W-CRT and the X-NTT fused with both key
products)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "ks.digit")
