"""Coefficient-sharded four-step NTT over a mesh axis.

Counterpart of matrix_fhe_tpu/parallel/dist_ntt.py.  With N = n1 n2 and
the [n1, n2] view x[i1, i2] = x[i1 n2 + i2] of each polynomial, a rank of
the `axis` group (d ranks, coordinate r) holds the columns
i2 in [r n2/d, (r + 1) n2/d):

  forward, on the rank's [L, B, n1, n2/d] block:
    twist     x *= psi^(i1 n2 + i2)                (negacyclic only)
    stage 1   y[i2, k1] = sum_i1 x[i1, i2] w1^(i1 k1), times the twiddle
              w_N^(i2 k1): one launch of K10a's twiddle form (Stage side
              'right' on the [L, B n2/d, n1] rows, twiddle [L, n2/d, n1])
    exchange  one all_to_all_single: k1 blocks out, i2 blocks in
    stage 2   z[k1, k2] = sum_i2 y[i2, k1] w2^(i2 k2): K1 on the
              [L, B n1/d, n2] rows
  giving the k1-sharded [L, B, n1/d, n2] block of the four-step-order
  spectrum (rank r holds out[k1 n2 + k2] for k1 in its block);

  inverse, on that block: K1 (stage 2's inverse), the twiddle w_N^-(i2 k1)
  elementwise, one all_to_all_single (i2 blocks out, k1 blocks in), K1
  (stage 1's inverse) and n^-1 psi^-i elementwise, back to the
  i2-sharded [L, B, n1, n2/d] block of natural-order coefficients.

The exchange is the only communication.  The stages are the port's K1 /
K10a (ops/cuda_ntt.Stage), so a CPU tensor takes Stage.plain and a CUDA
tensor the kernel; the tables are FourStepNTT's, so the spectrum is the
same integers as the single-device transform's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import _backend as be
from ..ops.cuda_ntt import Stage
from ..ops.modmath import mul_mod, to_mont
from ..ops.ntt_large import FourStepNTT, FourStepPlan


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


class DistFourStepNTT:
    """Forward / inverse NTT of [L, B, N] residues, N sharded over `axis`
    of `mesh` (each rank calls it on its own block)."""

    def __init__(self, plan: FourStepPlan, mesh: DeviceMesh,
                 axis: str = "coeff", device="cuda"):
        self.device = be.resolve_device(device)      # before the mesh
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.d = mesh.size(mesh.mesh_dim_names.index(axis))
        if plan.n2 % self.d or plan.n1 % self.d:
            raise ValueError("n1 and n2 must be divisible by the mesh axis")
        self.group = mesh.get_group(axis)
        r = mesh.get_local_rank(axis)
        n1, n2, d = plan.n1, plan.n2, self.d
        c, r1 = n2 // d, n1 // d
        cols, krows = slice(r * c, (r + 1) * c), slice(r * r1, (r + 1) * r1)
        t = FourStepNTT(plan, device="cpu")._t       # [L, ...] canonical
        L, q = len(plan.moduli), plan.moduli
        self._st = {k: Stage(_u64(t[k]), q, "right", self.device)
                    for k in ("t1f", "t2f", "t1i", "t2i")}
        # stage 1's twiddle at [i2 local, k1], in storage form tw * 2^64
        tw_f = t["tw_f"][:, :, cols].transpose(1, 2).contiguous()
        self._tw_f = to_mont(tw_f, q).to(self.device)
        self._tw_i = t["tw_i"][:, krows, :].reshape(L, 1, r1, n2).to(
            self.device)
        def local_cols(v):          # [L, N] -> [L, 1, n1, n2/d] on the device
            return v.reshape(L, 1, n1, n2)[..., cols].contiguous().to(
                self.device)

        self._twist = local_cols(t["twist_f"]) if plan.negacyclic else None
        self._post = local_cols(t["post_i"])
        self._q4 = torch.tensor(q, dtype=torch.int64,
                                device=self.device).reshape(L, 1, 1, 1)

    def _exchange(self, y: torch.Tensor) -> torch.Tensor:
        """[L, B, a, d, b] with the d blocks going out -> [d, L, B, a, b]
        with block j from rank j (one all_to_all_single)."""
        send = y.permute(3, 0, 1, 2, 4).contiguous()
        if self.d == 1:
            return send
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """i2-sharded [L, B, n1, n2/d] block -> k1-sharded [L, B, n1/d, n2]
        block of the four-step-order spectrum."""
        p, d = self.plan, self.d
        L, B = x.shape[0], x.shape[1]
        c, r1 = p.n2 // d, p.n1 // d
        if tuple(x.shape) != (L, B, p.n1, c):
            raise ValueError(f"block {tuple(x.shape)} is not [L, B, "
                             f"{p.n1}, {c}]")
        if self._twist is not None:
            x = mul_mod(x, self._twist, self._q4)
        rows = x.transpose(2, 3).reshape(L, B * c, p.n1).contiguous()
        y = self._st["t1f"](rows, twiddle_mont=self._tw_f)  # [L, (B, i2), k1]
        y = self._exchange(y.reshape(L, B, c, d, r1))       # [j, L, B, i2, k1]
        y = y.permute(1, 2, 4, 0, 3).reshape(L, B * r1, p.n2)
        return self._st["t2f"](y.contiguous()).reshape(L, B, r1, p.n2)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """k1-sharded [L, B, n1/d, n2] spectrum block -> i2-sharded
        [L, B, n1, n2/d] block of natural-order coefficients."""
        p, d = self.plan, self.d
        L, B = z.shape[0], z.shape[1]
        c, r1 = p.n2 // d, p.n1 // d
        if tuple(z.shape) != (L, B, r1, p.n2):
            raise ValueError(f"block {tuple(z.shape)} is not [L, B, "
                             f"{r1}, {p.n2}]")
        y = self._st["t2i"](z.reshape(L, B * r1, p.n2).contiguous())
        y = mul_mod(y.reshape(L, B, r1, p.n2), self._tw_i, self._q4)
        y = self._exchange(y.reshape(L, B, r1, d, c))       # [j, L, B, k1, i2]
        y = y.permute(1, 2, 4, 0, 3).reshape(L, B * c, p.n1)
        w = self._st["t1i"](y.contiguous())                 # [L, (B, i2), i1]
        w = w.reshape(L, B, c, p.n1).transpose(2, 3)
        return mul_mod(w, self._post, self._q4)
