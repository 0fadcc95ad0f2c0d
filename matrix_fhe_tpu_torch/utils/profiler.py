"""torch.profiler convenience wrappers (Chrome traces).

Counterpart of matrix_fhe_tpu/utils/profiler.py.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(),
                                     "matrix_fhe_trace")):
    """Capture a host and device trace around a block:

        with profiler.trace(logdir):
            with profiler.annotate("roundtrip"):
                ctx.roundtrip(...)

    and write it into `logdir` as a Chrome trace (a file of its own for
    each block, trace_<pid>_*.json); view it in ui.perfetto.dev or
    chrome://tracing.  CUDA activity is recorded where a card exists.
    """
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix=f"trace_{os.getpid()}_",
                                suffix=".json", dir=logdir)
    os.close(fd)
    prof.export_chrome_trace(path)


annotate = torch.profiler.record_function
