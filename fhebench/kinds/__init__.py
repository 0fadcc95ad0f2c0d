"""Request kinds: the code that a traffic mix's data file names ("kind").

Each module defines
  setup(cfg, traffic, seed, device) -> state: contexts, keys and the pool,
      all drawn from the seed on the device, with mark() at the end of each
      phase;
  request(state, i, spans) -> payload: the i-th request of the closed loop
      (the harness synchronises after it and keeps a sample of payloads);
  release(state): frees what only the program needed, before the check;
  check(state, samples, cfg, traffic) -> [Check]: the comparison with the
      plain reference (fhebench/reference), run once the window has closed.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

MASK63 = (1 << 63) - 1
PHASES: list = []       # (phase, perf_counter at its end), in set-up order


def mark(phase: str) -> None:
    """Note the end of a set-up phase; the harness prints their seconds."""
    PHASES.append((phase, time.perf_counter()))


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit     # NaN fails


def params(cfg: dict):
    """The program's parameter set, built from the configuration file."""
    from matrix_fhe_tpu_torch import GLParams
    return GLParams(name=cfg["name"], n=cfg["n"], p=cfg["p"],
                    moduli=tuple(cfg["moduli"]),
                    delta=float(2 ** cfg["delta_bits"]),
                    p_moduli=tuple(cfg.get("p_moduli") or ()),
                    sigma=cfg["sigma"])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed & MASK63)


def ternary(gen: torch.Generator, phi: int, n: int, device) -> torch.Tensor:
    """A uniform ternary secret [W, n] in {-1, 0, 1} (W-coeff, X-coeff)."""
    r = torch.randint(0, 3, (phi, n), generator=gen, dtype=torch.int64,
                      device=device)
    return r - 1


def residues(small: torch.Tensor, moduli) -> torch.Tensor:
    q = torch.tensor([int(v) for v in moduli], dtype=torch.int64,
                     device=small.device).reshape((-1,) + (1,) * small.dim())
    return torch.remainder(small[None], q)


def secret_key(ctx, s: torch.Tensor):
    """The program's SecretKey of the benchmark's secret s [W, n]: the
    W-CRT and X-NTT of s in the storage form s 2^64 mod q, as
    HEContext.generate_secret_key makes it from its own draw."""
    from matrix_fhe_tpu_torch import SecretKey
    from matrix_fhe_tpu_torch.ops import modmath as mm
    moduli = ctx.params.moduli
    s_ntt = ctx.xntt.forward(ctx.wt.forward(residues(s, moduli)))
    return SecretKey(mm.to_mont(s_ntt, moduli))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
