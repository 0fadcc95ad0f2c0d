"""Device ms a traced request spends in key switching's front, the tensor
product of the two ciphertexts (the program's "ks.front" span:
RelinContext._mr_front)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "ks.front")
