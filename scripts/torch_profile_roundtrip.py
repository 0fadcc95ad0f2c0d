#!/usr/bin/env python3
"""Where the time of the port's ref roundtrip goes, on one GPU.

    python3 scripts/torch_profile_roundtrip.py [preset] [runs]

Runs matrix_fhe_tpu_torch's HEContext.roundtrip (default: the ref preset,
3 profiled runs after 2 warm-ups) under torch.profiler and prints the
device time of the 15 largest kernel names (summed, per roundtrip), the
wall time per roundtrip, and the device's idle share (1 - device busy /
wall).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    preset = sys.argv[1] if len(sys.argv) > 1 else "ref"
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    from torch.profiler import ProfilerActivity, profile

    from matrix_fhe_tpu_torch import init_he_backend

    ctx = init_he_backend(preset, device="cuda")
    p = ctx.params
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(7)
    re, im = (torch.from_numpy(rng.uniform(-4, 4, (p.phi, p.n, p.n))).cuda()
              for _ in range(2))
    for _ in range(2):
        ctx.roundtrip(re, im, sk)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            ctx.roundtrip(re, im, sk)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / runs

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events) / runs
    print(f"[profile] {preset} roundtrip: wall {wall_us / 1e3:.3f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.4f}")
    for e in events[:15]:
        print(f"[profile] {e.self_device_time_total / runs / 1e3:9.3f} ms "
              f"x{e.count // runs:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
