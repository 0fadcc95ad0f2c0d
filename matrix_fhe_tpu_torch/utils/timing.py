"""CUDA-event timer of the port's measurement scripts and chip_smoke.py."""

from __future__ import annotations

import torch


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
