"""Share (%) of its roofline that the stage kernel (K1, K10a: csrc/stage.cu,
its split pass included) reaches over the traced stretch: the sum of the
recorded calls' bounds (fhebench/roofline/stage.py, the H100 SXM's
published peaks at 700 W) over the device time of every stage_kernel and
stage_split_kernel event."""

from fhebench.roofline import stage


def read(trace):
    device = sum(t for name, t in trace.device_time_by_name().items()
                 if "stage_kernel" in name or "stage_split_kernel" in name)
    if not trace.stage_calls or device <= 0:
        return None
    return 100.0 * sum(stage.bound_s(c) for c in trace.stage_calls) / device
