"""Timing harness.

Counterpart of matrix_fhe_tpu/utils/timer.py.  The clock follows the
device of the tensors: on CUDA tensors, CUDA events on the current stream
(utils/timing.cuda_ms) with one synchronize after the last call; otherwise
time.perf_counter, fenced by a synchronize before and after wherever CUDA
is in use (an output that is no tensor, a Gl2Conj or None, may still stand
for work queued on the card).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch

from .timing import cuda_ms


def _first_tensor(x):
    """The first tensor in a (nested) tuple or list, or None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _on_cuda(x) -> bool:
    t = _first_tensor(x)
    return t is not None and t.is_cuda


def _sync() -> None:
    """Wait for the card, where this process has used it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulating named timer.  A section fenced by a CUDA tensor is
    timed by CUDA events on the current stream, waited for at its end;
    any other section by the host clock between two synchronizes."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, fence=None):
        if _on_cuda(fence):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            _sync()
            t0 = time.perf_counter()
            yield
            _sync()
            dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            lines.append(f"{k}: {self.totals[k] * 1e3:.2f} ms "
                         f"({self.counts[k]} calls)")
        return "\n".join(lines)


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call of fn(*args).  When the warm-up's
    output (or, without a warm-up, the arguments) is on the card, the
    `iters` calls run between two CUDA events with one synchronize after
    the last (cuda_ms); otherwise they are timed by the host clock between
    two synchronizes."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_cuda(out if warmup else args):
        torch.cuda.synchronize()
        return cuda_ms(lambda: fn(*args), iters, warmup=False) / 1e3
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters
