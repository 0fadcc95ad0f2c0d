"""The port's tests run torch on one CPU thread in each xdist worker.

tests/torch_workers.py sets this up on import; every tests/test_torch_*.py
must import it (read with `ast`, never imported), and a fresh interpreter
shows what the import does with and without PYTEST_XDIST_WORKER.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

import torch_workers  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
PORT_TESTS = sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py")))


def _imports(path):
    tree = ast.parse(open(path).read())
    return {alias.name for node in tree.body if isinstance(node, ast.Import)
            for alias in node.names}


@pytest.mark.parametrize("path", PORT_TESTS, ids=os.path.basename)
def test_port_test_imports_torch_workers(path):
    assert "torch_workers" in _imports(path), (
        f"{os.path.basename(path)} must `import torch_workers  # noqa: F401` "
        "at module level, before its first torch work")


PROBE = (
    "import json, os, sys, torch\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "before = torch.get_num_threads()\n"
    "import torch_workers\n"
    "print(json.dumps([before, torch.get_num_threads(),\n"
    "                  os.environ.get('OMP_NUM_THREADS'),\n"
    "                  os.environ.get('MKL_NUM_THREADS')]))\n")


def _probe(**env):
    clean = {k: v for k, v in os.environ.items()
             if k not in ("PYTEST_XDIST_WORKER", "OMP_NUM_THREADS",
                          "MKL_NUM_THREADS")}
    proc = subprocess.run([sys.executable, "-c", PROBE, TESTS],
                          env=dict(clean, **env), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


def test_xdist_worker_runs_torch_on_one_thread():
    _, threads, omp, mkl = _probe(PYTEST_XDIST_WORKER="gw0")
    assert (threads, omp, mkl) == (1, "1", "1")


def test_xdist_worker_keeps_the_callers_thread_settings():
    _, threads, omp, mkl = _probe(PYTEST_XDIST_WORKER="gw0",
                                  OMP_NUM_THREADS="2", MKL_NUM_THREADS="3")
    assert (threads, omp, mkl) == (1, "2", "3")


def test_without_xdist_torch_keeps_its_default():
    before, threads, omp, mkl = _probe()
    assert (threads, omp, mkl) == (before, None, None)
