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

The exchange is the only communication.  The stages are the
single-device stage route, ops/ntt_large.FourStepStages, at this rank's
columns and rows (K1 / K10a: a CPU tensor takes Stage.plain, a CUDA tensor
the kernel); the tables are FourStepNTT's, so the spectrum is the same
integers as the single-device transform's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import _backend as be
from ..ops.ntt_large import FourStepNTT, FourStepPlan, FourStepStages


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
        tables = FourStepNTT(plan, device="cpu")._t  # [L, ...] canonical
        self.stages = FourStepStages(plan, tables, self.device, self.d,
                                     mesh.get_local_rank(axis),
                                     self._exchange)

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
        return self.stages.forward(x)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """k1-sharded [L, B, n1/d, n2] spectrum block -> i2-sharded
        [L, B, n1, n2/d] block of natural-order coefficients."""
        return self.stages.inverse(z)
