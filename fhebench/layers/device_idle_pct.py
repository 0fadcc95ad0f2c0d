"""Share (%) of the traced stretch in which no operation ran on the device:
1 - (union of the device intervals) / the stretch's host-clock length."""


def read(trace):
    busy = trace.busy_s()
    if busy <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.window_s)
