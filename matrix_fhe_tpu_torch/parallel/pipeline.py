"""Sharded end-to-end HE roundtrip: dp over messages, tp over matrix rows.

Counterpart of matrix_fhe_tpu/parallel/pipeline.py (ShardedPipeline):
message batches [B, W, n, n] f64 pairs are sharded as mesh.msg_spec, the
batch B over 'dp' (no communication) and the matrix-row axis y over 'tp';
the secret key is replicated.  JAX jits vmap(roundtrip_fn) with those
shardings and lets GSPMD place the collectives; here each rank runs the
roundtrip of its messages with them written out.

The y axis is contracted only by the encode's XY-IDFT and the decode's
XY-DFT, and the fixed-point exponents of the encode's and decode's K4
steps are maxima over the whole message.  So those steps run on the whole
message on every tp rank, and the rest on the rank's rows alone:

  all_gather the message's rows over tp
  encode_to_wcoeff (K4: XY-IDFT sandwich, W-IDFT; quantize) on the whole
  slice the rank's rows; W-CRT forward (K1)
  encrypt / decrypt: t = a*s (K2) on the rows of the parity a, b = m - t
      + e, ev = b + t with e sliced by rows (s has no y axis)
  compose_pair (K3: W-CRT inverse + CRT compose) on the rows
  all_gather the composed f64 rows over tp
  decode_composed (K4: W-DFT, XY-DFT) on the whole, slice the rank's rows

Every sharded result is the unsharded one bit for bit: the row-local steps
compute each row alone, the others run on the whole message.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.he import HEContext, SecretKey
from . import mesh as meshlib


class ShardedPipeline:
    """Batched, mesh-sharded roundtrip for one HEContext; `mesh` has axes
    'dp' and 'tp'."""

    def __init__(self, ctx: HEContext, mesh: DeviceMesh):
        self.ctx = ctx
        self.mesh = mesh
        self.spec = meshlib.msg_spec
        n = ctx.params.n
        tp = mesh.size(mesh.mesh_dim_names.index("tp"))
        if n % tp:
            raise ValueError(f"tp = {tp} does not divide the {n} matrix rows")
        r = mesh.get_local_rank("tp")
        self.rows = slice(r * (n // tp), (r + 1) * (n // tp))
        self._a_rows = ctx._parity_a_eval[:, :, self.rows].contiguous()

    def shard(self, m: torch.Tensor) -> torch.Tensor:
        """This rank's block of a message batch every rank holds."""
        return meshlib.shard(m, self.mesh, self.spec)

    def gather(self, m_local: torch.Tensor) -> torch.Tensor:
        """The whole batch from each rank's block."""
        return meshlib.gather(m_local, self.mesh, self.spec)

    def roundtrip(self, m_re: torch.Tensor, m_im: torch.Tensor, sk: SecretKey
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's [B/dp, W, n/tp, n] blocks of a message pair ->
        its blocks of the decoded pair."""
        ctx, be, rows = self.ctx, self.ctx.batched_encoder, self.rows
        t = ctx.xntt.mul_s(self._a_rows, sk.s_mont)
        out_re, out_im = [], []
        for b in range(m_re.shape[0]):
            whole = meshlib.all_gather_dim(
                torch.stack([m_re[b], m_im[b]]), self.mesh, "tp", 2)
            rr, ri = be.encode_to_wcoeff(whole[0], whole[1])
            pr, pi = (ctx.wt.forward(x[:, :, rows].contiguous())
                      for x in (rr, ri))
            f2 = be.compose_pair(*ctx._roundtrip_combine(pr, pi, t, rows))
            dr, di = be.decode_composed(
                meshlib.all_gather_dim(f2, self.mesh, "tp", 2))
            out_re.append(dr[:, rows])
            out_im.append(di[:, rows])
        return torch.stack(out_re), torch.stack(out_im)
