"""The traced stretch of a run: the benchmark's spans, the program's stage
calls, and what torch.profiler saw the device do.

Spans are CUDA events that the benchmark records around its own calls into
each layer of the program, on the one stream (host clock on a CPU test),
each wrapped in a torch.profiler record_function named "fhebench.<span>"
so that the trace can say what the host was doing in a device gap.  The
stage recorder wraps the program's K1 / K10a entry (ops/cuda_ntt.Stage's
kernel method) while the stretch runs and notes each call's shapes; the
roofline reader turns them into bounds with fhebench/roofline/stage.py.
Nothing here is active in an untraced run.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "fhebench."


class Spans:
    """Per-request spans; a no-op until enabled."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.enabled = False
        self.request = -1
        self._open: List[Tuple[int, str, object, object]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(SPAN_PREFIX + name):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
            else:
                start = time.perf_counter()
                yield
                end = time.perf_counter()
        self._open.append((self.request, name, start, end))

    def per_request_ms(self) -> Dict[str, List[float]]:
        """{span: [ms summed within each traced request]} (call after a
        synchronize)."""
        sums: Dict[str, Dict[int, float]] = collections.defaultdict(
            lambda: collections.defaultdict(float))
        for req, name, start, end in self._open:
            ms = (start.elapsed_time(end) if self.cuda
                  else 1e3 * (end - start))
            sums[name][req] += ms
        return {name: list(v.values()) for name, v in sums.items()}


class StageRecorder:
    """Notes every call of the program's stage kernel entry while active:
    (side, moduli, table shape, data shape, output elements, twiddle
    elements)."""

    def __init__(self):
        self.calls: List[dict] = []
        self._orig = None
        self._cls = None

    def __enter__(self):
        from matrix_fhe_tpu_torch.ops.cuda_ntt import Stage
        self._cls, self._orig = Stage, Stage.kernel
        orig, calls = self._orig, self.calls

        def kernel(stage, data, twiddle_mont=None):
            out = orig(stage, data, twiddle_mont)
            calls.append({
                "side": stage.side, "moduli": tuple(stage.moduli),
                "table": tuple(stage.table.shape),
                "data_elems": data.numel(), "out_elems": out.numel(),
                "twiddle_elems": 0 if twiddle_mont is None
                else twiddle_mont.numel()})
            return out

        Stage.kernel = kernel
        return self

    def __exit__(self, *exc):
        self._cls.kernel = self._orig


class Trace:
    """What a reader of a per-layer metric sees."""

    def __init__(self, spans_ms: Dict[str, List[float]], requests: int,
                 window_s: float, device_ops, host_ranges, stage_calls):
        self.spans_ms = spans_ms
        self.requests = requests
        self.window_s = window_s
        self.device_ops = device_ops      # [(name, start_ns, end_ns)]
        self.host_ranges = host_ranges    # [(span, start_ns, end_ns)]
        self.stage_calls = stage_calls

    def span_mean_ms(self, name: str) -> Optional[float]:
        v = self.spans_ms.get(name)
        return sum(v) / len(v) if v else None

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union
        of the device intervals)."""
        busy, cur_s, cur_e = 0, None, None
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def kernels(self):
        return [o for o in self.device_ops if not is_copy(o[0])]

    def device_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.device_ops:
            out[name] += (e - s) / 1e9
        return out

    def idle_gaps_by_span(self) -> Dict[str, float]:
        """Device idle time between consecutive device operations, summed
        by the innermost benchmark span the host was in at the gap's
        middle ("between requests" outside every span)."""
        ops = sorted(self.device_ops, key=lambda o: o[1])
        ranges = sorted(self.host_ranges, key=lambda r: r[1])
        out: Dict[str, float] = collections.defaultdict(float)
        end = None
        for _, s, e in ops:
            if end is not None and s > end:
                mid = (s + end) // 2
                name = "between requests"
                for span, rs, re_ in ranges:
                    if rs > mid:
                        break
                    if re_ >= mid:
                        name = span          # later starts are inner
                out[name] += (s - end) / 1e9
            end = e if end is None else max(end, e)
        return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_library(name: str) -> bool:
    """A kernel of PyTorch itself (the glue around the hand-written
    kernels), or a copy."""
    return is_copy(name) or "at::" in name or "at_cuda_detail" in name


def read_profile(prof) -> Tuple[list, list]:
    """(device ops, benchmark span ranges) of a finished profile, with
    kineto's timestamps (ns, one clock for host and device)."""
    device_ops, host_ranges = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == torch.autograd.DeviceType.CPU:
                host_ranges.append((name[len(SPAN_PREFIX):], e.start_ns(),
                                    e.end_ns()))
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation():
            device_ops.append((name, e.start_ns(), e.end_ns()))
    return device_ops, host_ranges


def breakdown(trace: Trace) -> dict:
    top = sorted(trace.device_time_by_name().items(), key=lambda kv: -kv[1])
    gaps = sorted(trace.idle_gaps_by_span().items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in top[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
