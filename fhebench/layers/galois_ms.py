"""Device ms a traced request spends in the Galois key switches, summed
over a rotation's hops (the program's "ks.galois" spans:
GaloisKeys.apply, each the lane gather, key_switch_d2 and the add)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "ks.galois")
