"""The gl2gemm kind through the whole harness at the tiny parameter set on
the CPU, against fhebench/reference/gl2.py; its lower-precision control
and each planted fault must come out not correct.  With -m cuda on a
card, the cell runs at ref, and so do the control and a fault.

The control and the faults are patched here, each the program's own
steps with one thing wrong.  Control: the key products of the
relinearize (Gl2GemmRelin._relin_chunk's modmath.mul_mod: each digit's
products with the switch keys and the 2^-64 factor) in float64, the
precision below the configuration's exact 64-bit words.  Faults: the
tensor repacked without the relinearize ("unchanged"), half of the lanes
left out ("half"), one residue of one limb changed ("altered")."""

import contextlib
import json
import os
import subprocess
import sys
import types
from unittest import mock

import pytest

from fhebench import control
from fhebench.run import cell, run_cell
from fhebench.tests.tiny import TINY, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 11
CELL = "ref_gl2.gemm"
SPEC, _, _, TRAFFIC = cell(CELL)
METRICS = {"gl2_tensor_ms", "gl2_relin_ms", "gl2_key_products_ms"}
# at Delta 2^12 the key switch's noise (tens of units) is ~1e-6 of Delta^2,
# ~5e-5 of a decoded entry: the cell's 1e-6 is for Delta 2^35
TINY_LIMITS = {"gl2_gap": 1e-3}


@contextlib.contextmanager
def gl2_control():
    from matrix_fhe_tpu_torch.models import he_matmul2
    from matrix_fhe_tpu_torch.ops import modmath
    chunk = he_matmul2.Gl2GemmRelin._relin_chunk
    mm = types.SimpleNamespace(**vars(modmath))
    mm.mul_mod = control._fmul

    def relin_chunk(gr, *args):
        with mock.patch.object(he_matmul2, "mm", mm):
            return chunk(gr, *args)

    with mock.patch.object(he_matmul2.Gl2GemmRelin, "_relin_chunk",
                           relin_chunk):
        yield


def _unrelinearized():
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2
    from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin

    def relinearize(gr, tt, ks):
        return Ciphertext2(b=gr.hm.repack_fn(tt.e00),
                           a=gr.hm.repack_fn(tt.e01))

    return mock.patch.object(Gl2GemmRelin, "relinearize", relinearize)


def _output_fault(fault: str):
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2
    from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin
    matmul = Gl2GemmRelin.matmul

    def mm(gr, ct_x, ct_y, ks):
        ct = matmul(gr, ct_x, ct_y, ks)
        if fault == "half":
            return Ciphertext2(control._half(ct.b, control.W_AXIS),
                               control._half(ct.a, control.W_AXIS))
        b = control._bump(ct.b, 1)
        b.view(-1)[0] %= int(gr.ctx.params.moduli[0])
        return Ciphertext2(b, ct.a)

    return mock.patch.object(Gl2GemmRelin, "matmul", mm)


def patch(mode: str):
    if mode == "sound":
        return contextlib.nullcontext()
    if mode == "control":
        return gl2_control()
    if mode == "unchanged":
        return _unrelinearized()
    return _output_fault(mode)


def run(mode="sound", trace=False, seed=SEED, seconds=0.0):
    """seconds 0: one request in the window, the one the check samples."""
    t = traffic("gl2gemm", limits=TINY_LIMITS)
    with patch(mode):
        return run_cell(CELL, seed, seconds, trace, device="cpu", cfg=TINY,
                        traffic=t)


@pytest.mark.parametrize("trace", [False, True])
def test_kind_passes_the_reference(trace):
    res = run(trace=trace)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"gl2_noise", "gl2_err", "gl2_gap"}
    assert res["checks"]["gl2_noise"]["value"] > 0
    assert res["attempted"] >= (4 if trace else 1) and res["failed"] == 0
    got = set(res["metrics"])
    if trace:
        want = {m["name"] for m in SPEC["per_layer"]
                if CELL in m.get("workloads", [CELL])}
        assert want == METRICS and want <= got
        assert all(res["metrics"][m]["value"] > 0 for m in want)
        assert res["metrics"]["gl2_key_products_ms"]["value"] <= \
            res["metrics"]["gl2_relin_ms"]["value"]
    else:
        assert got == {"matrices_per_s", "peak_device_gib", "setup_s"}


def test_cell_traffic_and_configuration():
    assert TRAFFIC["kind"] == "gl2gemm" and TRAFFIC["pool"] == 8
    assert (TRAFFIC["warmup"], TRAFFIC["sample"],
            TRAFFIC["trace_requests"]) == (2, 2, 3)
    assert TRAFFIC["limits"] == {"gl2_gap": 1e-6}
    cfg = cell(CELL)[2]
    assert cfg["ring"] == "gl2" and cfg["reduced"] == []
    assert cfg["precision"] == {"relin_noise": 2 ** 25,
                                "matmul_max_abs_err": 1e-4}


def test_same_seed_same_readings():
    a, b = run(seed=5), run(seed=5)
    assert a["checks"] == b["checks"]
    assert a["checks"] != run(seed=6)["checks"]


@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
def test_degraded_output_fails(mode):
    res = run(mode)
    assert not res["correct"], res["checks"]
    assert res["checks"]["gl2_noise"]["value"] > \
        res["checks"]["gl2_noise"]["limit"]


# -- on the card, at ref ------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_ref_gl2_runs_and_is_correct(card, trace):
    out = subprocess.run([sys.executable, "-m", "fhebench", "--workload",
                          CELL, "--seed", str(2 ** 31 + 7), "--seconds", "2",
                          "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps({"trace": trace, "checks": res["checks"],
                      "metrics": res["metrics"]}))
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if trace:
        m = res["metrics"]
        assert METRICS <= set(m)
        assert m["gl2_key_products_ms"]["value"] <= \
            m["gl2_relin_ms"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "unchanged"])
def test_degraded_output_fails_on_the_card(card, mode):
    with patch(mode):
        res = run_cell(CELL, 2 ** 31 + 13, 2.0, False, device="cuda")
    print(json.dumps({"mode": mode, "correct": res["correct"],
                      "checks": res["checks"]}))
    assert not res["correct"], res["checks"]
