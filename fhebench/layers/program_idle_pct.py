"""Share (%) of the traced stretch that is device idle inside the program:
the gaps between consecutive operations of the union of the device
intervals (as device_idle_pct reads them) whose middle, in kineto ns, falls
inside the host interval of one of the program's top-level spans, in
time.time_ns() (the same clock).  At most device_idle_pct; the rest is idle
caused by the caller (uploads, downloads, Python between calls)."""

from fhebench.program import idle_gaps_ns, inside, roots


def read(trace):
    top = roots()
    if not top or trace.window_s <= 0 or not trace.device_ops:
        return None
    spans = sorted((r.host_start_ns, r.host_end_ns) for r in top)
    idle = sum(e - s for s, e in idle_gaps_ns(trace.device_ops)
               if inside(spans, (s + e) // 2))
    return 100.0 * idle / 1e9 / trace.window_s
