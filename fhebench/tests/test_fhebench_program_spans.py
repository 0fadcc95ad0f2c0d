"""The readers of the program's spans through the whole harness, traced, at
the tiny parameter set on the CPU: each returns a finite number in every
cell its entry lists, and program_idle_pct stays within device_idle_pct.

On the CPU the profiler sees no device, so here the host's aten operations
stand in for the device's (their union is what the idle readers read)."""

import math

import pytest
import torch

from fhebench import trace as fhetrace
from fhebench.run import cell, run_cell
from fhebench.tests.tiny import TINY, traffic

SEED = 2 ** 31 + 29
SPEC = cell("ref.relin")[0]
PROGRAM = [m for m in SPEC["per_layer"] if m["source"] == "program_span"
           and m["name"] not in ("encode_ms", "decode_ms", "scheme_ms",
                                 "gemm_ms", "decode_d2_ms")]
CELLS = {"ref.relin": "relin", "mid.relin": "relin",
         "ref.roundtrip": "roundtrip", "ref.matmul": "matmul"}


def _with_host_ops(read_profile):
    def read(prof):
        device_ops, host_ranges = read_profile(prof)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CPU and \
                    e.name().startswith("aten::"):
                device_ops.append((e.name(), e.start_ns(), e.end_ns()))
        return device_ops, host_ranges
    return read


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_program_readers_in_their_cells(workload, monkeypatch):
    monkeypatch.setattr(fhetrace, "read_profile",
                        _with_host_ops(fhetrace.read_profile))
    res = run_cell(workload, SEED, 0.1, True, device="cpu", cfg=TINY,
                   traffic=traffic(CELLS[workload]))
    assert res["correct"], res["checks"]
    got = res["metrics"]
    want = {m["name"] for m in PROGRAM if workload in m["workloads"]}
    assert want and want <= set(got), (want, set(got))
    for name in want:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    assert got["program_idle_pct"]["value"] <= \
        got["device_idle_pct"]["value"]


def test_six_program_metrics():
    assert sorted(m["name"] for m in PROGRAM) == sorted(
        ["ks_front_ms", "ks_digits_ms", "ks_finish_ms",
         "decode_d2_compose_ms", "program_host_ms", "program_idle_pct"])
    assert all(m["moves"] == "matrices_per_s" for m in PROGRAM)


def test_readers_give_none_without_records(monkeypatch):
    """A program without spans (the tree before them): every reader
    returns None."""
    import importlib

    from matrix_fhe_tpu_torch.utils import profiler
    monkeypatch.delattr(profiler, "records")
    tr = fhetrace.Trace({}, 2, 1.0, [("k", 0, 10), ("k", 20, 30)], [], [])
    for m in PROGRAM:
        reader = importlib.import_module(f"fhebench.layers.{m['name']}")
        assert reader.read(tr) is None, m["name"]
