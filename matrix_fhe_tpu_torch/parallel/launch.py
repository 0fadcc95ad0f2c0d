"""A world of ranks on one machine: spawn, rendezvous, results, failures.

The counterpart of the JAX package's virtual 8-device CPU mesh
(tests/conftest.py) and of bench_dist.py's mp_parent / mp_worker: JAX
runs one program over many devices of one process, the port runs one
process a rank.  ``run_world(fn, world_size, backend, device, timeout_s,
*args)`` starts `world_size` processes by the ``spawn`` method, each of
which

  * joins the process group through a file:// rendezvous in a temporary
    directory of its own (so concurrent worlds never race for a port),
    by ``multihost.init_distributed`` reading MFHE_COORDINATOR,
    MFHE_NUM_PROCS and MFHE_PROC_ID as a multi-host launcher would set
    them (and LOCAL_RANK / LOCAL_WORLD_SIZE: the world is one host's);
  * runs ``fn(device, *args)`` on its device (a CPU rank with one thread)
    and sends the return value back, pickled by value (tensors as CPU
    tensors).

The parent returns the values in rank order.  A rank that raises fails
the world: the others are killed and the parent raises with that rank's
traceback.  A world still running at `timeout_s` is killed and the parent
raises TimeoutError, so a rank that hangs in a collective can never hold
its caller past the limit.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.multiprocessing as mp


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, tuple):                      # a NamedTuple
        return type(obj)(*(_to_cpu(v) for v in obj))
    return obj


def _rank_main(rank: int, world_size: int, backend: str, device: str,
               coordinator: str, timeout_s: float, fn: Callable, args: tuple,
               results) -> None:
    import torch.distributed as dist

    from . import multihost

    os.environ["MFHE_COORDINATOR"] = coordinator
    os.environ["MFHE_NUM_PROCS"] = str(world_size)
    os.environ["MFHE_PROC_ID"] = str(rank)
    os.environ["LOCAL_RANK"] = str(rank)            # one host holds the world
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    try:
        multihost.check_backend(backend, world_size)
        dev = multihost.rank_device(device, backend, rank, world_size)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        multihost.init_distributed(backend=backend, timeout_s=timeout_s)
        out = _to_cpu(fn(dev, *args))
        results.put((rank, True, pickle.dumps(out)))
    except Exception:         # the parent raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    """Kill the ranks still running and reap them."""
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_world(fn: Callable, world_size: int, backend: str, device,
              timeout_s: float, *args) -> List[Any]:
    """Run ``fn(device, *args)`` on every rank of a new world; returns the
    ranks' return values in rank order.  `fn` must be a module-level
    function (spawned ranks import it by name), `backend` is "gloo" or
    "nccl" as the caller names it, `device` "cpu" or "cuda" (each rank's
    card is multihost.rank_device's: under nccl rank r takes cuda:r, under
    gloo a bare "cuda" spreads the ranks over the cards)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, not {world_size}")
    from . import multihost
    multihost.check_backend(backend, world_size, local_ranks=world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="mfhe_world_") as tmp:
        coordinator = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, backend, str(device),
                                   coordinator, timeout_s, fn, args, results))
                 for r in range(world_size)]
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.start()
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(out))
                    raise TimeoutError(
                        f"world of {world_size} ranks ({backend}) did not "
                        f"finish within {timeout_s} s; ranks {missing} sent "
                        "no result and were killed")
                try:
                    rank, ok, payload = results.get(timeout=min(1.0, left))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        # a rank that exited may still have its result in
                        # the pipe: wait a moment before calling it dead
                        try:
                            rank, ok, payload = results.get(timeout=2.0)
                        except queue_mod.Empty:
                            r = dead[0]
                            raise RuntimeError(
                                f"rank {r} of {world_size} exited with code "
                                f"{procs[r].exitcode} and sent no result")
                    else:
                        continue
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} of {world_size} ({backend}, {device}) "
                        f"failed:\n{payload}")
                out[rank] = pickle.loads(payload)
        except BaseException:
            _stop(procs)            # ranks may wait in a collective forever
            raise
        for p in procs:
            p.join(max(0.0, min(30.0, deadline - time.monotonic())))
        _stop(procs)
    return [out[r] for r in range(world_size)]
