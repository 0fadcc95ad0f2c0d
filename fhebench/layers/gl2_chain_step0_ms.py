"""Device ms a traced request spends in the gl2 chain's first GEMM (the
program's "gl2.step" spans of index 0: Gl2Chain.matmul at level 0, its
tensor and its relinearize with the level's switch keys)."""

from fhebench.program import named


def step_ms(trace, level: int):
    """Device ms a request in the "gl2.step" spans of index `level`."""
    recs = [r for r in named("gl2.step") if r.index == level]
    if not recs or trace.requests <= 0:
        return None
    return sum(r.device_ms for r in recs) / trace.requests


def read(trace):
    return step_ms(trace, 0)
