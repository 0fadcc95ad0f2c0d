"""torch.profiler convenience wrappers (Chrome traces) and the port's spans.

Counterpart of matrix_fhe_tpu/utils/profiler.py.

`span(name, index=None)` marks one step of the port (the encode's W-IDFT,
a key switch's digit step, ...).  It costs one check of torch's profiler
state while no profiler records, and returns one shared no-op context.
While a `torch.profiler.profile` records, a span opens
`record_function("mfhe." + name)`, so every trace of the port names its
steps, and keeps a record of the step in memory:

  * its name, its index (a digit's number, where given), its id, its
    parent's and its root's ids (spans of one top-level call share the
    root's id);
  * host start and end from `time.time_ns()`, taken just inside the
    `record_function` range: the Unix-epoch nanoseconds in which kineto
    stamps its host and device events, so a device gap of the trace can
    be put down to the step the host was in;
  * CUDA events around it on the current stream where CUDA is
    initialised (on the CPU the device interval is the host interval);
  * the hand-written kernel launches it made (`ops._backend.LAUNCHES`).

The records are cleared when a profile starts and stay readable after it
ends: `records()` lists them, `summary()` sums them by
name.  The profiler's own state is the switch; there is no other.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from ..ops._backend import LAUNCHES

PREFIX = "mfhe."

_recording = torch._C._autograd._profiler_enabled
# a profiler range: torch's C++ RecordFunction context, about 1 us from its
# edges to the span's clock readings (record_function's operator calls put
# 15-90 us there)
_range = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(),
                                     "matrix_fhe_trace")):
    """Capture a host and device trace around a block:

        with profiler.trace(logdir):
            with profiler.annotate("roundtrip"):
                ctx.roundtrip(...)

    and write it into `logdir` as a Chrome trace (a file of its own for
    each block, trace_<pid>_*.json); view it in ui.perfetto.dev or
    chrome://tracing.  CUDA activity is recorded where a card exists.
    The port's spans appear in it as `mfhe.*` ranges.
    """
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix=f"trace_{os.getpid()}_",
                                suffix=".json", dir=logdir)
    os.close(fd)
    prof.export_chrome_trace(path)


annotate = torch.profiler.record_function


class SpanRecord:
    """One finished span.  `device_ms` reads its CUDA events, so read it
    after a synchronize."""

    __slots__ = ("name", "index", "id", "parent", "root", "host_start_ns",
                 "host_end_ns", "launches", "_events")

    def __init__(self, name: str, index: Optional[int], id: int,
                 parent: Optional[int], root: int):
        self.name, self.index = name, index
        self.id, self.parent, self.root = id, parent, root
        self.host_start_ns = self.host_end_ns = 0
        self.launches: Dict[str, int] = {}
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float:
        if self._events is None:
            return self.host_ms
        start, end = self._events
        return start.elapsed_time(end)

    def __repr__(self) -> str:
        idx = "" if self.index is None else f"[{self.index}]"
        return (f"SpanRecord({self.name}{idx} id={self.id} "
                f"parent={self.parent} root={self.root} "
                f"host_ms={self.host_ms:.3f})")


class _Recorder:
    """The records of the current (or last) profile, and each thread's
    stack of open spans."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_REC = _Recorder()
_start_profiler = _autograd_profiler._run_on_profiler_start


def _clear_on_profiler_start():
    """torch's profilers announce their start through
    torch.autograd.profiler._run_on_profiler_start: a new profile starts
    with no records."""
    _REC.records = []
    _start_profiler()


_autograd_profiler._run_on_profiler_start = _clear_on_profiler_start


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "rf", "before")

    def __init__(self, name: str, index: Optional[int]):
        stack = _REC.stack()
        sid = next(_REC.ids)
        parent = stack[-1] if stack else None
        self.rec = SpanRecord(name, index, sid,
                              None if parent is None else parent.id,
                              sid if parent is None else parent.root)
        self.rf = _range(PREFIX + name)

    def __enter__(self):
        rec = self.rec
        self.rf.__enter__()
        rec.host_start_ns = time.time_ns()
        _REC.stack().append(rec)
        self.before = collections.Counter(LAUNCHES)
        if torch.cuda.is_initialized():
            rec._events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            rec._events[0].record()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec._events is not None:
            rec._events[1].record()
        rec.launches = dict(LAUNCHES - self.before)
        _REC.stack().pop()
        _REC.records.append(rec)
        rec.host_end_ns = time.time_ns()
        self.rf.__exit__(*exc)
        return False


def span(name: str, index: Optional[int] = None):
    """A context that marks one step of the port (see the module's
    docstring); the shared no-op context while no profiler records."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, index)


def records() -> List[SpanRecord]:
    """The finished spans of the current (or last) profile, in the order
    they closed (children before their parent)."""
    return list(_REC.records)


def summary() -> Dict[str, dict]:
    """{span name: {calls, host_ms, host_self_ms, device_ms, launches}}
    summed over records() (after a synchronize): host_self_ms leaves out
    the host time its child spans cover, launches is {kernel: launches}."""
    recs = records()
    child_ms: Dict[int, float] = collections.defaultdict(float)
    for r in recs:
        if r.parent is not None:
            child_ms[r.parent] += r.host_ms
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                    "host_self_ms": 0.0, "device_ms": 0.0,
                                    "launches": collections.Counter()})
        s["calls"] += 1
        s["host_ms"] += r.host_ms
        s["host_self_ms"] += r.host_ms - child_ms[r.id]
        s["device_ms"] += r.device_ms
        s["launches"].update(r.launches)
    for s in out.values():
        s["launches"] = dict(sorted(s["launches"].items()))
    return out
