"""The W-sharded gl2 ciphertext GEMM with its relinearization.

Counterpart of the last program of __graft_entry__.dryrun_multichip in the
JAX package, where Gl2GemmRelin.matmul runs on ciphertexts sharded on the
W lane axis and GSPMD places the collectives.  Here every rank holds its
block of W lanes of both ciphertexts and of the switch keys, and:

  * the tensor (HEMatmul2.tensor_fn, kernel K7) is lane-local but for
    sigma's lane flip W -> W^-1, which reads Y's lanes flip[w] from other
    ranks: one all_gather of Y's two components, then the rank's flipped
    lanes (HEMatmul2.on_lanes); X's twist and the four products run on the
    rank's lanes;
  * the relinearization is Gl2GemmRelin.relinearize on the local blocks,
    with every W-CRT (the Q basis' and each QP chunk's) mapped by its
    wt_map to a ShardedWTransform: an all_gather of its input's W rows,
    then K1 on the
    table rows of this rank's lanes (parallel/keyswitch.py); the basis
    extension, the X-NTTs (K1), the key products and ModDown are W-local.

So the gathered output is the unsharded Gl2GemmRelin.matmul's bit for
bit.  Key generation runs unsharded (shard_key cuts a rank's lanes).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..models.he2 import Ciphertext2
from ..models.he_matmul2 import GemmRelinKey, Gl2GemmRelin
from . import mesh as meshlib
from .keyswitch import ShardedWTransform, lane_block


class ShardedGl2Gemm:
    """Gl2GemmRelin `gr` with its ciphertexts and keys sharded on W over
    `axis` of `mesh` (every rank holds its lanes)."""

    def __init__(self, gr: Gl2GemmRelin, mesh: DeviceMesh, axis: str = "tp"):
        self.mesh, self.axis = mesh, axis
        self.spec = (None, axis)            # [L, W, y, x]: W over the axis
        self.lanes = lane_block(gr.ctx.params.phi, mesh, axis)
        self.gr = Gl2GemmRelin(
            gr.hm.on_lanes(self.lanes), gr.rc, gr.chunk_limbs,
            wt_map=lambda wt: ShardedWTransform(wt, mesh, axis))

    def shard_key(self, ks: GemmRelinKey) -> GemmRelinKey:
        """This rank's lanes of replicated switch keys."""
        return GemmRelinKey(*(tuple(k[:, self.lanes].contiguous()
                                    for k in part) for part in ks))

    def shard(self, ct: Ciphertext2) -> Ciphertext2:
        return Ciphertext2(*(meshlib.shard(c, self.mesh, self.spec)
                             for c in ct))

    def gather(self, ct: Ciphertext2) -> Ciphertext2:
        return Ciphertext2(*(meshlib.gather(c, self.mesh, self.spec)
                             for c in ct))

    def matmul(self, ctX: Ciphertext2, ctY: Ciphertext2,
               ks_local: GemmRelinKey) -> Ciphertext2:
        """Gl2GemmRelin.matmul on this rank's lanes of both ciphertexts
        and of the keys (shard_key): this rank's lanes of the standard
        ciphertext of Y^H X, Delta^2-scaled."""
        whole_y = Ciphertext2(*(meshlib.all_gather_dim(c, self.mesh,
                                                       self.axis, 1)
                                for c in ctY))
        return self.gr.matmul(ctX, whole_y, ks_local)
