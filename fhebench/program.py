"""The program's own spans, for the per-layer metrics that read them.

The port marks its steps with matrix_fhe_tpu_torch.utils.profiler.span;
while the traced stretch's profiler records, each span keeps a record (its
name, parent and root, host interval in time.time_ns(), which is kineto's
clock, and device interval from CUDA events), and the records stay
readable after the profiler stops.  A program without spans gives None
here, and so does every reader built on it.
"""

from __future__ import annotations

import bisect
from typing import List, Optional


def records() -> Optional[list]:
    """The records of the traced stretch, or None where the program keeps
    none."""
    from matrix_fhe_tpu_torch.utils import profiler
    read = getattr(profiler, "records", None)
    return None if read is None else read()


def named(name: str, root: Optional[str] = None) -> List:
    """The records called `name` (under a root span called `root`, where
    one is given)."""
    recs = records() or []
    if root is not None:
        roots = {r.id: r.name for r in recs if r.parent is None}
        recs = [r for r in recs if roots.get(r.root) == root]
    return [r for r in recs if r.name == name]


def device_ms_per_request(trace, name: str,
                          root: Optional[str] = None) -> Optional[float]:
    """Device ms summed over the spans called `name`, a traced request."""
    recs = named(name, root)
    if not recs or trace.requests <= 0:
        return None
    return sum(r.device_ms for r in recs) / trace.requests


def roots() -> List:
    return [r for r in records() or [] if r.parent is None]


def idle_gaps_ns(device_ops):
    """(start, end) of each gap between consecutive operations of the union
    of the device intervals, kineto ns (fhebench.trace.Trace.busy_s's
    union)."""
    gaps, end = [], None
    for _, s, e in sorted(device_ops, key=lambda o: o[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def inside(intervals, t: int) -> bool:
    """Whether t lies in one of `intervals` [(start, end)], sorted by start
    and disjoint."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]
