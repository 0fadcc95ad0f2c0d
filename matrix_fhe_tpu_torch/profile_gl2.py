"""Where the time of the gl2 GEMM's keygen and relinearize goes, on one GPU.

    python3 -m matrix_fhe_tpu_torch.profile_gl2 [preset] [runs]

Builds the gl2 GEMM of a preset (default "ref": the preset's P basis,
dnum = 4) on the card, with keys from a seeded torch.Generator and
examples/matmul_gl2.py's inputs, and times `Gl2GemmRelin.gen_keys` and
`Gl2GemmRelin.relinearize` (default 1 run each after a warm-up).  For each
phase it prints:

  * the device time of each sub-step range: CUDA events recorded on the
    stream around every call of the sub-step and summed (inclusive: the
    basis extension's own modular products count under `extend_from`, not
    under `mul_mod`, which is the key products and the 2^-64 and P^-1
    folds), with the number of calls;
  * from torch.profiler, the wall time, the device busy time and the
    device's idle share (1 - busy / wall), and the 10 largest kernel names.

Needs a CUDA device and, at ref, about 35 GB of device memory.
"""

from __future__ import annotations

import collections
import functools
import sys
import time

import numpy as np
import torch


class RangeTimer:
    """Device time of named sub-steps, from CUDA events around each call."""

    def __init__(self):
        self.events = collections.defaultdict(list)
        self._undo = []

    def wrap(self, owner, attr: str, label) -> None:
        """Replace owner.attr by a wrapper that records a start and an end
        event around each call; `label` is a name or a function of the
        call's arguments that gives one."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            name = label(*args) if callable(label) else label
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out

        self._undo.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def reset(self) -> None:
        self.events.clear()

    def totals(self):
        """{name: (ms, calls)}, after a synchronize."""
        torch.cuda.synchronize()
        return {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
                for k, v in self.events.items()}


def _instrument(timer: RangeTimer) -> None:
    from .models import keyswitch, rng
    from .models.he_matmul2 import Gl2GemmRelin
    from .ops import cgemm, cuda_ntt, fpmatmul, modmath, rns_ext

    def stage_label(stage, data):
        what = "W-CRT" if stage.side == "left" else "X-NTT"
        return f"K1 {what} ({stage.table.shape[0]} limbs, K = {stage.table.shape[-1]})"

    timer.wrap(rns_ext.BasisExtender, "scaled_residues", "scaled_residues")
    timer.wrap(rns_ext.BasisExtender, "extend_from", "extend_from")
    timer.wrap(keyswitch.RelinContext, "_mod_down", "ModDown")
    timer.wrap(keyswitch.RelinContext, "_lift_ternary", "lift_ternary")
    timer.wrap(Gl2GemmRelin, "_relin_chunk", "relin chunk (all digits)")
    timer.wrap(modmath, "mul_mod", "mul_mod")
    timer.wrap(rng, "fresh_uniform_a", "uniform draws")
    timer.wrap(rng, "fresh_gaussian_noise", "Gaussian draws")
    timer.wrap(cuda_ntt.Stage, "kernel", stage_label)
    timer.wrap(cuda_ntt.NttMulNtt, "kernel", "K2")
    timer.wrap(fpmatmul, "fp_cmatmul_kernel", "K4")
    timer.wrap(cgemm.Gemm2x2, "kernel", "K7")


def _profile(name: str, fn, runs: int, timer: RangeTimer) -> None:
    from torch.profiler import ProfilerActivity, profile

    fn()                                        # warm-up
    torch.cuda.synchronize()
    timer.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    ranges = timer.totals()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / runs / 1e3
    print(f"[profile] {name}: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    for label, (ms, calls) in sorted(ranges.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {name} range {ms / runs:10.3f} ms x{calls // runs:<4d} "
              f"{label}", flush=True)
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

    timer = RangeTimer()
    _instrument(timer)
    try:
        _profile("keygen", lambda: gr.gen_keys(sk, gen), runs, timer)
        _profile("relinearize", lambda: gr.relinearize(tt, ks), runs, timer)
    finally:
        timer.restore()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
