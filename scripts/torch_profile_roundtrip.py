#!/usr/bin/env python3
"""Where the time of the port's ref roundtrip (or trace matmul) goes, on one GPU.

    python3 scripts/torch_profile_roundtrip.py [preset] [runs] [path]

Runs one path of matrix_fhe_tpu_torch (default: the ref preset, 3
profiled runs after 2 warm-ups) under torch.profiler and prints the device
time of the 15 largest kernel names (summed, per run), the wall time per
run, and the device's idle share (1 - device busy / wall).  path is
"roundtrip" (HEContext.roundtrip, the default), "matmul" (HEMatmul.matmul
on two encrypted pairs, ring "gl") or "decode" (HEMatmul.decrypt_and_decode
of that tensor).
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
    path = sys.argv[3] if len(sys.argv) > 3 else "roundtrip"

    from torch.profiler import ProfilerActivity, profile

    from matrix_fhe_tpu_torch import HEMatmul, init_he_backend

    ctx = init_he_backend(preset, ring="gl" if path != "roundtrip" else "nega",
                          device="cuda")
    p = ctx.params
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(7)
    re, im = (torch.from_numpy(rng.uniform(-4, 4, (p.phi, p.n, p.n))).cuda()
              for _ in range(2))
    if path == "roundtrip":
        def step():
            return ctx.roundtrip(re, im, sk)
    elif path in ("matmul", "decode"):
        hm = HEMatmul(ctx)
        gen = torch.Generator(device="cuda").manual_seed(3)
        ct = ctx.encrypt_pair(*ctx.batched_encoder.encode_to_wntt_eval(
            re / 4, im / 4), sk, generator=gen)
        tt = hm.matmul(ct, ct)

        def step():
            if path == "matmul":
                return hm.matmul(ct, ct)
            return hm.decrypt_and_decode(tt, sk)
    else:
        raise SystemExit(f"unknown path {path!r}")
    for _ in range(2):
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / runs

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events) / runs
    print(f"[profile] {preset} {path}: wall {wall_us / 1e3:.3f} ms "
          f"(profiler on), device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.4f}")
    for e in events[:15]:
        print(f"[profile] {e.self_device_time_total / runs / 1e3:9.3f} ms "
              f"x{e.count // runs:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
