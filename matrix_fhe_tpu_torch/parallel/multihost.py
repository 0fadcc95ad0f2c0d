"""Multi-process (multi-host) execution support.

Counterpart of matrix_fhe_tpu/parallel/multihost.py on torch.distributed:

  * ``init_distributed`` joins the default process group once per
    process, from its arguments or the MFHE_COORDINATOR / MFHE_NUM_PROCS /
    MFHE_PROC_ID environment, on the backend the caller names ("gloo" or
    "nccl": the port never picks one for it);
  * ``hybrid_mesh``: the dcn axes vary slowest and map across hosts, the
    ici axes within a host, so the collectives of the W contractions and
    the dist-NTT all_to_all stay inside a host and only dp crosses hosts;
  * host data <-> rank blocks: ``global_from_host_data`` cuts this rank's
    block from an array every rank can build, ``local_shards`` lists the
    (global index, data) pairs a rank holds (one: a rank is a device).

``launch.run_world`` starts a world of such processes on one machine,
which is the same program a fleet of hosts runs.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import Spec, block_index, make_mesh

BACKENDS = ("gloo", "nccl")


def local_layout(process_id: int, num_processes: int) -> Tuple[int, int]:
    """(this rank's index on its host, the ranks on its host): LOCAL_RANK
    and LOCAL_WORLD_SIZE where the launcher sets them (torchrun does),
    else one host holding every rank, numbered as the world is."""
    count = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return int(os.environ.get("LOCAL_RANK", process_id % count)), count


def check_backend(backend: str, num_processes: int,
                  local_ranks: Optional[int] = None) -> None:
    """Refuse a backend the world cannot use: NCCL takes one card a rank
    (it refuses two ranks on one card), so more NCCL ranks on this host
    than cards raises.  The ranks on this host are `local_ranks`, else
    local_layout's: ranks that span hosts must say so through
    LOCAL_WORLD_SIZE, for unset every rank counts as this host's."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl":
        guessed = local_ranks is None and "LOCAL_WORLD_SIZE" not in os.environ
        if local_ranks is None:
            local_ranks = local_layout(0, num_processes)[1]
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_ranks > cards:
            unset = (" (LOCAL_WORLD_SIZE unset, so every rank counts as "
                     "this host's: set it and LOCAL_RANK when the ranks "
                     "span hosts)") if guessed else ""
            raise ValueError(
                f"nccl needs one card a rank: {local_ranks} ranks on this "
                f"host{unset}, {cards} CUDA devices; two ranks cannot share "
                "a card under nccl (use backend='gloo' for that)")


def rank_device(device, backend: str, process_id: int,
                num_processes: int) -> torch.device:
    """The device of rank `process_id`: under nccl cuda:<local rank>;
    under gloo a bare "cuda" is cuda:<local rank mod cards> (ranks of a
    one-card host share cuda:0), any other `device` is itself."""
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl moves CUDA tensors only, not {dev}")
    if dev.type != "cuda" or (backend != "nccl" and dev.index is not None):
        return dev
    local, _ = local_layout(process_id, num_processes)
    if backend == "nccl":
        return torch.device("cuda", local)
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: str,
                     timeout_s: float = 1800.0) -> bool:
    """Join the default process group from the arguments or the MFHE_*
    environment.  Returns True when more than one process takes part.

    Without a coordinator (single-process) it does nothing and returns
    False.  The coordinator is an init-method URL (file://... or
    tcp://host:port; a bare host:port means tcp).  A world of one process
    is still initialized, so that its collectives run."""
    coordinator_address = coordinator_address or os.environ.get(
        "MFHE_COORDINATOR")
    if num_processes is None and "MFHE_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["MFHE_NUM_PROCS"])
    if process_id is None and "MFHE_PROC_ID" in os.environ:
        process_id = int(os.environ["MFHE_PROC_ID"])
    if coordinator_address is None or not num_processes:
        return False
    if process_id is None:
        raise ValueError("a coordinator and a process count need a process "
                         "id (MFHE_PROC_ID)")
    check_backend(backend, num_processes)
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return num_processes > 1


def hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                device_type: str = "cuda") -> DeviceMesh:
    """Mesh with `dcn_axes` across hosts (slowest-varying) and `ici_axes`
    within each host, over the ranks in process-major order (a host's
    ranks are consecutive, as launchers number them)."""
    return make_mesh(dict(**dcn_axes, **ici_axes), device_type)


def global_from_host_data(full, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """This rank's block of an array every rank can build (deterministic
    inputs), on the mesh's device type: each rank uploads only its block.
    uint64 arrays arrive as their int64 bit patterns."""
    arr = full
    if isinstance(full, np.ndarray):
        if full.dtype == np.uint64:
            full = full.view(np.int64)
        arr = torch.from_numpy(np.ascontiguousarray(full))
    blk = arr[block_index(arr.shape, mesh, spec)].contiguous()
    return blk.to(mesh.device_type)


def local_shards(local: torch.Tensor, mesh: DeviceMesh, spec: Spec,
                 global_shape) -> Tuple[Tuple[tuple, torch.Tensor], ...]:
    """(global index, data) for each block this rank holds: one."""
    return ((block_index(global_shape, mesh, spec), local),)
