"""Device ms a traced request spends in key switching's finish: the QP
inverse transforms, ModDown and the W-CRT forward of both accumulators
(the program's "ks.finish" span: RelinContext._switch_finish)."""

from fhebench.program import device_ms_per_request


def read(trace):
    return device_ms_per_request(trace, "ks.finish")
