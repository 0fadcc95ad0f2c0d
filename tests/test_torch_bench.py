"""The port's headline bench (matrix_fhe_tpu_torch.scripts.bench) on the
CPU, at a small plan through the same code as the card's run (its
NTT_N, NTT_L and GATE_PRESET set to 4096, 2 and tiny).

Its JSON line carries the JAX bench.py's keys and the device; the NTT
rows are fenced by an exact roundtrip and the ref gate by its error
limit, and a failure of either exits nonzero with no JSON line.  The
bench runs on the CPU only when asked (--device cpu).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.ops.ntt_large import generate_primes_1mod as jax_primes
from matrix_fhe_tpu_torch.config import generate_primes_1mod
from matrix_fhe_tpu_torch.ops.ntt_large import FourStepNTT
from matrix_fhe_tpu_torch.scripts import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--batch", "2", "--iters", "2"]
SHRINK = ("from matrix_fhe_tpu_torch.scripts import bench\n"
          "bench.NTT_N, bench.NTT_L, bench.GATE_PRESET = 4096, 2, 'tiny'\n")
KEYS = {"metric", "value", "unit", "vs_baseline", "ntt_28bit_per_sec",
        "ref_roundtrip_ms", "ref_roundtrip_err", "device"}


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bench, "NTT_N", 4096)
    monkeypatch.setattr(bench, "NTT_L", 2)
    monkeypatch.setattr(bench, "GATE_PRESET", "tiny")


def _run(args, code=""):
    """The shrunk bench as a process from the repository root (after
    `code`)."""
    prog = (SHRINK + code + "import sys\n"
            "sys.exit(bench.main(sys.argv[1:]))\n")
    return subprocess.run([sys.executable, "-c", prog, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))


def test_bench_line_on_the_cpu(small, capsys):
    """--batch 2 at N = 4096 on 2 limbs with the tiny gate: exit 0, one
    launches line (empty on the CPU), then the JSON line with the JAX
    bench's keys and the device."""
    assert bench.main(SMALL) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[0]) == {"launches": {}}
    res = json.loads(out[-1])
    assert KEYS <= set(res)
    assert res["metric"] == bench.METRIC and res["unit"] == "NTT/s"
    assert res["value"] > 0 and res["ntt_28bit_per_sec"] > 0
    assert res["vs_baseline"] == pytest.approx(res["value"] / 1e6)
    assert res["ref_roundtrip_ms"] > 0 and res["ref_roundtrip_err"] < 0.5
    assert res["device"].startswith("cpu")


def test_bench_primes_are_the_jax_benchs():
    """The headline's 16 35-bit primes and the 28-bit row's are the JAX
    bench's (generate_primes_1mod(16, bits, 2^17))."""
    for bits in (35, 28):
        assert generate_primes_1mod(16, bits, 1 << 17) == \
            jax_primes(16, bits, 1 << 17)


def test_a_broken_fence_raises(small, monkeypatch):
    """An inverse that does not give x back fails the NTT row."""
    monkeypatch.setattr(FourStepNTT, "inverse", lambda self, xf: xf)
    with pytest.raises(RuntimeError, match="NTT roundtrip mismatch"):
        bench.main(SMALL)


def test_a_failed_gate_raises(small, monkeypatch):
    monkeypatch.setattr(bench, "tolerance", lambda delta: 0.0)
    with pytest.raises(RuntimeError, match="pipeline err"):
        bench.main(SMALL)


def test_a_failed_gate_exits_nonzero_with_no_json_line():
    proc = _run(SMALL, "bench.tolerance = lambda delta: 0.0\n")
    assert proc.returncode != 0
    assert "pipeline err" in proc.stderr
    assert '"metric"' not in proc.stdout


def test_bench_runs_on_the_card_unless_asked():
    """Without --device cpu the bench needs CUDA: on a host without it, it
    exits nonzero and prints no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = _run([a for a in SMALL if a not in ("--device", "cpu")])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert '"metric"' not in proc.stdout
