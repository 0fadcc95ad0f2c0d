"""Where the time of the gl2 GEMM's keygen and relinearize goes, on one GPU.

    python3 -m matrix_fhe_tpu_torch.profile_gl2 [preset] [runs]

Builds the gl2 GEMM of a preset (default "ref": the preset's P basis,
dnum = 4) on the card, with keys from a seeded torch.Generator and
examples/matmul_gl2.py's inputs, and profiles `Gl2GemmRelin.gen_keys` and
`Gl2GemmRelin.relinearize` (default 1 run each after a warm-up).  For each
phase it prints:

  * from torch.profiler, the wall time, the device busy time and the
    device's idle share (1 - busy / wall), and the 10 largest kernel names;
  * the hand-written kernel launches of the phase, per kernel;
  * the port's own spans in the phase (utils.profiler.summary()): calls,
    device ms (inclusive: the basis extension inside ModDown counts under
    both) and hand-written launches of each, for the relinearize the
    whole call (gl2.relin), the chunks of all digits' key products
    (gl2.relin_chunk), the key products themselves (gl2.key_products,
    each digit's pair: one gl2_key_products launch), each digit's
    extension to a chunk's limbs (rns.extend, one base_conv launch) and
    ModDown (ks.mod_down, with its conversion and division rns.extend).

Needs a CUDA device and, at ref, about 35 GB of device memory.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _profile(name: str, fn, runs: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    from .ops._backend import Launches
    from .utils import profiler

    fn()                                        # warm-up
    torch.cuda.synchronize()
    launches = Launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with launches:
            for _ in range(runs):
                fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / runs / 1e3
    print(f"[profile] {name}: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    print(f"[profile] {name} launches "
          + ", ".join(f"{k} {v // runs}" for k, v in launches.counts().items()),
          flush=True)
    steps = sorted(profiler.summary().items(), key=lambda kv: -kv[1]["device_ms"])
    for label, s in steps:
        hand = sum(s["launches"].values())
        print(f"[profile] {name} span {s['device_ms'] / runs:10.3f} ms "
              f"x{s['calls'] // runs:<4d} {hand // runs:>4d} launches  {label}",
              flush=True)
    for e in kernels[:10]:
        print(f"[profile] {name} kernel {e.self_device_time_total / runs / 1e3:9.3f} ms "
              f"x{e.count // runs:<5d} {e.key[:80]}", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_gl2: needs a CUDA device")
        return 2
    preset = argv[0] if argv else "ref"
    runs = int(argv[1]) if len(argv) > 1 else 1

    from . import Gl2Context, Gl2GemmRelin, HEMatmul2
    from .config import get_params

    p = get_params(preset)
    ctx = Gl2Context(p, device="cuda")
    hm = HEMatmul2(ctx)
    gr = Gl2GemmRelin(hm)
    rc = gr.rc
    print(f"[profile] {preset} gl2: P of {[q.bit_length() for q in rc.p_moduli]} "
          f"bits, dnum {rc.dnum}, Lqp {len(rc.qp_moduli)}, QP chunks "
          f"{gr._qp_chunks()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(7)
    W, n = p.phi, p.n
    sk = ctx.generate_secret_key(gen)
    cts = [ctx.encrypt(ctx.encode(
        torch.from_numpy(rng.uniform(-1, 1, (W, n, n))).cuda(),
        torch.from_numpy(rng.uniform(-1, 1, (W, n, n))).cuda()), sk, gen)
        for _ in range(2)]
    ks = gr.gen_keys(sk, gen)
    tt = hm.matmul_tensor(*cts)
    torch.cuda.synchronize()

    _profile("keygen", lambda: gr.gen_keys(sk, gen), runs)
    _profile("relinearize", lambda: gr.relinearize(tt, ks), runs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
