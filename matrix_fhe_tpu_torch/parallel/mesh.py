"""Device-mesh helpers: named mesh axes over the ranks of a world.

Counterpart of matrix_fhe_tpu/parallel/mesh.py.  The axes keep their
meaning there:

  dp    -- data parallel over independent messages / ciphertexts
  tp    -- tensor parallel: the matrix-row axis y of a message batch
           (the sharded roundtrip) or the W lane axis (the sharded key
           switch)
  coeff -- the coefficient-sharded large-N NTT (dist_ntt.py)

A mesh is a torch DeviceMesh over the ranks of the default process group
(one rank a process, one device a rank), used for its named sub-groups.
A sharding spec is a tuple naming the mesh axis of each tensor dimension,
None for a replicated one (JAX's PartitionSpec); dimensions past its end
are replicated.  ``shard`` cuts a rank's block out of a tensor every rank
holds, ``gather`` rebuilds the whole from the blocks with all_gather over
each named axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

Spec = Tuple[Optional[str], ...]


def make_mesh(shape: Dict[str, int], device_type: str = "cuda") -> DeviceMesh:
    """A mesh from a {'dp': 2, 'tp': 4}-style shape over ranks 0..n-1 of
    the world, row-major (the last axis varies fastest).  Raises when the
    world has fewer ranks than the mesh needs."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(multihost.init_distributed or launch.run_world)")
    total = int(np.prod(list(shape.values())))
    world = dist.get_world_size()
    if total > world:
        raise ValueError(f"mesh {shape} needs {total} ranks, have {world}")
    ranks = torch.arange(total).reshape(tuple(shape.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(shape))


def factor_mesh(n_devices: int, want_dp: int = 2) -> Dict[str, int]:
    """Split n_devices into (dp, tp) with dp | n_devices."""
    dp = want_dp if n_devices % want_dp == 0 and n_devices >= want_dp else 1
    return {"dp": dp, "tp": n_devices // dp}


# message batch [B, W, n, n]: batch over dp, matrix rows (y) over tp (the
# JAX msg_sharding: tp over y keeps the W-CRT contractions local)
msg_spec: Spec = ("dp", None, "tp", None)
# packed plaintext / ciphertext component batch [B, L, W, n, n]
packed_spec: Spec = ("dp", None, None, "tp", None)
replicated: Spec = ()


def block_index(shape: Sequence[int], mesh: DeviceMesh,
                spec: Spec) -> Tuple[slice, ...]:
    """This rank's block of a global array of `shape` under `spec`."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more axes than shape {tuple(shape)}")
    index = []
    for dim, size in enumerate(shape):
        name = spec[dim] if dim < len(spec) else None
        if name is None:
            index.append(slice(None))
            continue
        d = mesh.size(mesh.mesh_dim_names.index(name))
        if size % d:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over mesh axis {name!r} of {d}")
        r = mesh.get_local_rank(name)
        index.append(slice(r * (size // d), (r + 1) * (size // d)))
    return tuple(index)


def shard(full: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """This rank's block (contiguous) of a tensor every rank holds."""
    return full[block_index(full.shape, mesh, spec)].contiguous()


def all_gather_dim(local: torch.Tensor, mesh: DeviceMesh, axis: str,
                   dim: int) -> torch.Tensor:
    """The blocks of mesh axis `axis` concatenated along tensor dimension
    `dim`, in the axis' rank order (one all_gather over its group)."""
    d = mesh.size(mesh.mesh_dim_names.index(axis))
    if d == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(d)]
    dist.all_gather(parts, local, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def gather(local: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """The whole tensor, on every rank, from each rank's block."""
    for dim, name in enumerate(spec):
        if name is not None:
            local = all_gather_dim(local, mesh, name, dim)
    return local
