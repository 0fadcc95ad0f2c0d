"""Device ms a traced request spends in the gl2 relinearize's key products,
summed (the program's "gl2.key_products" spans: each digit's two products
with the switch keys and their sums, and the 2^-64 factor, a component
and QP chunk)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "gl2.key_products")
