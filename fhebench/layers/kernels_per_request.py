"""Device kernels (copies and fills left out) the profiler saw in the
traced stretch, divided by its requests."""


def read(trace):
    n = len(trace.kernels())
    return n / trace.requests if n and trace.requests else None
