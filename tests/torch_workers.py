"""One torch CPU thread per pytest-xdist worker.

Torch starts one OpenMP thread per core in every process.  Under
`pytest -n N` that is N times as many threads as cores, and the port's
many small int64 ops spend most of their time waiting on the other
workers' spinning threads.  A worker (PYTEST_XDIST_WORKER is set) runs
torch on one thread.  The processes its tests spawn (the gloo ranks of
parallel/launch.run_world, the entry-point subprocesses) inherit
OMP_NUM_THREADS and MKL_NUM_THREADS of 1, unless the caller set them.  A
run without xdist keeps torch's default.

Every tests/test_torch_*.py imports this module (`import torch_workers`),
so a single file run under -n behaves like the whole suite.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    torch.set_num_threads(1)
