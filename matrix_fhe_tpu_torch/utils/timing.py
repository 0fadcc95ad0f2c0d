"""Timers of the port's programs, measurement scripts and chip_smoke.py:
the host clock after a sync, and CUDA events."""

from __future__ import annotations

import time

import torch


def sync(device: torch.device) -> None:
    """Wait for the card to finish what it was given (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock(device: torch.device) -> float:
    """Host seconds, after the card has finished what it was given."""
    sync(device)
    return time.perf_counter()


def cuda_ms(fn, iters: int = 1, *, warmup: bool = True, chain=None) -> float:
    """Mean milliseconds per call of `fn` over `iters` calls between two
    CUDA events, after one warm-up call unless `warmup` is False.  With
    `chain`, the calls are chained, y = fn(y), starting from y = chain."""
    if warmup:
        fn() if chain is None else fn(chain)
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    y = chain
    start.record()
    for _ in range(iters):
        if chain is None:
            fn()
        else:
            y = fn(y)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
