"""A short run of a cell on the card (run there with -m cuda)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_mid_relin_runs_and_is_correct(card, trace):
    out = subprocess.run([sys.executable, "-m", "fhebench", "--workload",
                          "mid.relin", "--seed", str(2 ** 31 + 7),
                          "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
