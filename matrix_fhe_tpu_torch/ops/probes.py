"""Kernels K11 and K12: the measurement probes.

Counterparts of the TPU probe kernels scripts/micro_vpu.py:kern (K11, the
u32 op-chain and copy probe) and scripts/micro_coissue.py:_kern (K12, int8
dots interleaved with u32 chains, the co-issue probe).  u32 values live in
int32 tensors with the same bits.  As everywhere in the port, a CPU tensor
runs the plain PyTorch version, which computes in int64 with 32-bit masks
(and K12's dots as float64 matmuls of the int8 values, exact since
|sum| <= reps * K * 100^2 < 2^31), and a CUDA tensor launches the kernel
in csrc/micro_vpu.cu or csrc/micro_coissue.cu (K12: s8 wgmma products with
the u32 rounds between their commit and wait).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _backend as be

M32 = 0xFFFFFFFF
I32 = torch.int32
I64 = torch.int64

VPU_KINDS = {"copy": 0, "addmul": 1, "shift": 2, "cmpadd": 3}
# "dma+mxu" runs the kernel body of "mxu", as it does in the TPU probe
COISSUE_MODES = {"dma": 0, "mxu": 1, "vpu": 2, "both": 3, "dep": 4,
                 "dma+mxu": 1}


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values in int64."""
    return x.to(I64) & M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


# -- K11 ---------------------------------------------------------------------------

def u32_chain(x: torch.Tensor, kind: str, k: int) -> torch.Tensor:
    """Every element of x (int32 holding u32) through `kind`'s chain of k
    steps (scripts/micro_vpu.py:28-48)."""
    if kind not in VPU_KINDS:
        raise ValueError(f"kind must be one of {sorted(VPU_KINDS)}")
    if be.on_device(x):
        return u32_chain_kernel(x, kind, k)
    return u32_chain_plain(x, kind, k)


def u32_chain_plain(x: torch.Tensor, kind: str, k: int) -> torch.Tensor:
    v = _u32(x)
    acc = v
    if kind == "addmul":
        for i in range(k):
            acc = (acc * 2654435761 + (i | 1)) & M32
    elif kind == "shift":
        for i in range(k):
            acc = ((acc >> (1 + i % 5)) | ((acc << 3) & M32)) & 0x7FFFFFFF
    elif kind == "cmpadd":
        c = v
        for i in range(k):
            s = (acc + c) & M32
            c = (s < c).to(I64) + i
            acc = s
    return _as_i32(acc)


def u32_chain_kernel(x: torch.Tensor, kind: str, k: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """K11 on a CUDA tensor: a chain on 4n elements, the copy on any count
    and into `out` if given (a tensor like x, so that a timing can reuse
    its buffers)."""
    be.check(x, "x", I32, tuple(x.shape))
    if kind != "copy" and (x.numel() % 4 or out is not None):
        raise ValueError("K11's chains take 4n elements and no out=")
    if out is None:
        out = torch.empty_like(x)
    be.check(out, "out", I32, tuple(x.shape))
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("K11 takes 16-byte aligned tensors")
    be.launch("micro_vpu", "mf_u32_chain", x.device, x, out, x.numel(),
              VPU_KINDS[kind], int(k))
    return out


# -- K12 ---------------------------------------------------------------------------

def _vpu_round(a: torch.Tensor, b: torch.Tensor):
    """scripts/micro_coissue.py:44-52 on u32 values held in int64."""
    m = ((a & 0x0FFFFFFF) * 0x9E3779B1) & M32
    u = (m + (b >> 7)) & M32
    c = (u < m).to(I64)
    v = ((u << 4) & M32) | (a >> 28)
    w = (v + c + (m >> 28)) & M32
    return torch.where(w > 0x7FFFFFFF, w - 0x7FFFFFFF, w), u


def coissue(d8: torch.Tensor, t8: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, mode: str, reps: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The co-issue probe (scripts/micro_coissue.py:55-81) over a grid of
    cells: d8 [G, P, N, K] and t8 [1, Pt, K, N] int8, a and b [G, N, N]
    int32 holding u32.  Returns (o32, ou): the int32 sum of the reps dots
    d8[g, r % P] @ t8[0, r % Pt] (zero for "dma" and "vpu") and a after
    the rounds, as int32 [G, N, N]."""
    if mode not in COISSUE_MODES:
        raise ValueError(f"mode must be one of {sorted(COISSUE_MODES)}")
    if be.on_device(d8, t8, a, b):
        return coissue_kernel(d8, t8, a, b, mode, reps)
    return coissue_plain(d8, t8, a, b, mode, reps)


def coissue_plain(d8, t8, a, b, mode: str, reps: int):
    G, P, N, _ = d8.shape
    Pt = t8.shape[1]
    av, bv = _u32(a), _u32(b)
    acc = torch.zeros((G, N, N), dtype=I64, device=a.device)
    if mode == "vpu":
        for _ in range(reps):
            av, bv = _vpu_round(av, bv)
    elif mode != "dma":
        for r in range(reps):
            dot = d8[:, r % P].to(torch.float64) @ t8[0, r % Pt].to(
                torch.float64)
            acc = acc + dot.to(I64)
            if mode == "both":
                av, bv = _vpu_round(av, bv)
            elif mode == "dep":
                av, bv = _vpu_round(av ^ (acc & M32), bv)
    return acc.to(I32), _as_i32(av)


def coissue_kernel(d8, t8, a, b, mode: str, reps: int):
    """K12 on CUDA tensors: one launch is a transpose of t8 to K-major
    (scratch [Pt, N, K], not for "vpu") and the probe kernel."""
    if d8.dim() != 4 or t8.dim() != 4:
        raise ValueError("d8 must be [G, P, N, K] and t8 [1, Pt, K, N]")
    G, P, N, K = d8.shape
    Pt = t8.shape[1]
    if N % 128 or K % 32 or K == 0:
        raise ValueError(f"K12 takes N % 128 == 0 and K % 32 == 0, "
                         f"not N = {N}, K = {K}")
    be.check(d8, "d8", torch.int8, (G, P, N, K))
    be.check(t8, "t8", torch.int8, (1, Pt, K, N))
    be.check(a, "a", I32, (G, N, N))
    be.check(b, "b", I32, (G, N, N))
    if any(t.data_ptr() % 16 for t in (d8, t8, a, b)):
        raise ValueError("K12 takes 16-byte aligned tensors")
    t8t = torch.empty((Pt, N, K), dtype=torch.int8, device=a.device)
    o32 = torch.empty((G, N, N), dtype=I32, device=a.device)
    ou = torch.empty((G, N, N), dtype=I32, device=a.device)
    be.launch("micro_coissue", "mf_coissue", a.device, d8, t8, t8t, a, b,
              o32, ou, G, N, K, P, Pt, int(reps), COISSUE_MODES[mode])
    return o32, ou
