"""What a run loads, and what a run without a card does."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "matrix_fhe_tpu"}

RUN_TINY = """
import sys, json
from fhebench.tests.tiny import TINY, traffic
from fhebench.run import run_cell
from fhebench import control
import fhebench.layers, fhebench.kinds.relin, fhebench.kinds.roundtrip
import fhebench.kinds.matmul
for kind, cell in (("relin", "ref.relin"), ("roundtrip", "ref.roundtrip"),
                   ("matmul", "ref.matmul")):
    for trace in (False, True):
        run_cell(cell, 1, 0.05, trace, device="cpu", cfg=TINY,
                 traffic=traffic(kind))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import sys, json, torch
from fhebench.reference import modq, scheme
r = scheme.Ring([1073742721], 8, 15, "gl", "cpu")
c = scheme.Codec(8, 15, 4096.0, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_modules(RUN_TINY)
    assert "matrix_fhe_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_modules(REFERENCE)
    assert not mods & (FORBIDDEN | {"matrix_fhe_tpu_torch"})


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{")
                   for line in out.stdout.splitlines())


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "fhebench", "--workload",
                          "mid.relin", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    _no_result(out)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "fhebench"), tmp_path / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "fhebench", "--workload",
                          "mid.relin", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    _no_result(out)
