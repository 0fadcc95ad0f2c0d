"""The W-sharded relinearized multiply: ciphertexts and keys split on W.

Counterpart of tests/test_distributed.py's sharded key switch, where JAX
jits RelinContext._multiply_relinearize_fn with the ciphertexts sharded on
the W lane axis and the relinearization key replicated, and GSPMD places
the collectives of the W contractions.  In the key switch only the W-CRT
contracts W (the context's wt.forward / inverse and the QP basis' wt_qp);
the X-NTT, the key products (K10a's twiddle form) and the base extension
and ModDown are W-local.  So:

  * ShardedWTransform: all_gather the input's W rows over the axis, then
    K1 (Stage side 'left') on the table's rows of this rank's output lanes,
    T[:, w_local, :] -- bit-exact by construction, 1/d of the products;
  * ShardedKeySwitch: a view of a RelinContext whose W-CRTs are the
    sharded ones, with the relinearization key sliced on W; its
    multiply_relinearize is RelinContext's own code on the local blocks.

Key generation runs unsharded (models/keyswitch.py builds its keys over
the whole frame).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.he import Ciphertext
from ..models.keyswitch import RelinContext, RelinKey
from ..ops.cuda_ntt import Stage
from ..ops.wcrt import WTransform
from . import mesh as meshlib


def lane_block(phi: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's block of the phi W lanes over `axis` of `mesh`."""
    d = mesh.size(mesh.mesh_dim_names.index(axis))
    if phi % d:
        raise ValueError(f"{axis} = {d} does not divide W = {phi}")
    r = mesh.get_local_rank(axis)
    return slice(r * (phi // d), (r + 1) * (phi // d))


class ShardedWTransform:
    """WTransform.forward / inverse on the W-sharded [L, W/d, ...] blocks
    of `axis`."""

    def __init__(self, wt: WTransform, mesh: DeviceMesh, axis: str = "tp"):
        self.params = wt.params
        self.mesh, self.axis = mesh, axis
        self.lanes = lanes = lane_block(wt.params.phi, mesh, axis)

        def local(stage: Stage) -> Stage:
            t = stage.table.cpu().numpy().view(np.uint64)[:, lanes]
            return Stage(t, stage.moduli, "left", stage.table.device)

        self._fwd, self._inv = local(wt._fwd), local(wt._inv)

    def _apply(self, stage: Stage, x: torch.Tensor) -> torch.Tensor:
        whole = meshlib.all_gather_dim(x, self.mesh, self.axis, 1)
        L, W = whole.shape[0], whole.shape[1]
        return stage(whole.reshape(L, W, -1).contiguous()).reshape(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[L, W/d, ...] coeff block -> this rank's [L, W/d, ...] eval."""
        return self._apply(self._fwd, x)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """[L, W/d, ...] eval block -> this rank's [L, W/d, ...] coeff."""
        return self._apply(self._inv, x)


class ShardedKeySwitch:
    """RelinContext `rc` with its ciphertexts and keys sharded on W over
    `axis` of `mesh` (every rank holds its lanes)."""

    def __init__(self, rc: RelinContext, mesh: DeviceMesh, axis: str = "tp"):
        self.mesh, self.axis = mesh, axis
        self.spec = (None, axis)            # [L, W, y, x]: W over the axis
        ctx = copy.copy(rc.ctx)
        ctx.wt = ShardedWTransform(rc.ctx.wt, mesh, axis)
        self.rc = copy.copy(rc)
        self.rc.ctx = ctx
        self.rc.wt_qp = ShardedWTransform(rc.wt_qp, mesh, axis)
        self.lanes = ctx.wt.lanes

    def shard_key(self, rlk: RelinKey) -> RelinKey:
        """This rank's lanes of a replicated key."""
        return RelinKey(b=tuple(k[:, self.lanes].contiguous() for k in rlk.b),
                        a=tuple(k[:, self.lanes].contiguous() for k in rlk.a))

    def shard(self, ct: Ciphertext) -> Ciphertext:
        return Ciphertext(*(meshlib.shard(c, self.mesh, self.spec)
                            for c in ct))

    def gather(self, ct: Ciphertext) -> Ciphertext:
        return Ciphertext(*(meshlib.gather(c, self.mesh, self.spec)
                            for c in ct))

    def multiply_relinearize(self, ct1: Ciphertext, ct2: Ciphertext,
                             rlk_local: RelinKey) -> Ciphertext:
        """RelinContext.multiply_relinearize on this rank's lanes of both
        ciphertexts and of the key (shard_key)."""
        return self.rc.multiply_relinearize(ct1, ct2, rlk_local)
