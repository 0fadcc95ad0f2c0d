"""The gl2chain kind through the whole harness on the CPU, on a small
geometry whose Delta sits near its limbs as at ref (small's n 16, p 51
and four 35-bit limbs, Delta 2^35, P of two 40-bit limbs: level 1's last
digit is one limb, as at ref), against fhebench/reference/gl2_chain.py;
its lower-precision control and each planted fault must come out not
correct.  With -m cuda on a card, the cell runs at ref, and so do the
control and a fault.

The control and the faults are patched here, each the program's own
steps with one thing wrong.  Controls, the precision below the
configuration's: one GEMM's key products in float64 (the plain twin
Gl2GemmRelin._key_products_plain on the CPU, KeyProducts.__call__ on the
card), at level 1 ("control") or at level 0 ("control0"), the rescale's
division in float64 ("rescale_f64"), and
the reference's decodes in complex64 ("complex64").  Faults: a rescale that drops the
last limb without dividing (a mod-switch, "modswitch"); the second GEMM
with half of its lanes left out ("half")."""

import contextlib
import json
import os
import subprocess
import sys
from unittest import mock

import pytest
import torch

from fhebench import control
from fhebench.run import cell, run_cell
from fhebench.tests.tiny import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 11
CELL = "ref_gl2_chain.gram"
SPEC, _, REF_CFG, TRAFFIC = cell(CELL)
METRICS = {"gl2_chain_step0_ms", "gl2_chain_rescale_ms",
           "gl2_chain_step1_ms"}
SMALL = {
    "name": "small_d35", "n": 16, "p": 51,
    "moduli": [34359752641, 34359785281, 34359847297, 34359912577],
    "delta_bits": 35, "sigma": 3.2,
    "p_moduli": [1099511585089, 1099511575297],
    "gemm_key_levels": [0, 1],
    "precision": {"relin_noise": 2 ** 25, "rescale_noise": 2 ** 25,
                  "matmul_max_abs_err": 1e-4},
}


def _f64_products(q, hat, kb, ka, u0, u1):
    """One digit's key products summed into (u0, u1) (None on the first
    digit), each hat k 2^-64 mod q through two float64 products: wrong in
    the low bits."""
    from matrix_fhe_tpu_torch.ops import modmath as mm
    r_inv = mm.moduli_col([pow(1 << 64, -1, int(x)) for x in q.flatten()],
                          3, hat.device)
    out = []
    for acc, key in ((u0, kb), (u1, ka)):
        t = control._fmul(control._fmul(hat, key, q), r_inv, q)
        out.append(t if acc is None else mm.add_mod(acc, t, q))
    return tuple(out)


@contextlib.contextmanager
def chain_control(at: int = 1):
    """The key products of the GEMM at level `at` in float64, on either
    route (the plain twin's sums then hold no storage factor, so its
    2^-64 step goes)."""
    from matrix_fhe_tpu_torch import Gl2Chain
    from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin
    from matrix_fhe_tpu_torch.ops import modmath as mm
    from matrix_fhe_tpu_torch.ops.key_products import KeyProducts
    matmul = Gl2Chain.matmul

    def card(kp, hat, kb, ka, u0=None, u1=None):
        q = mm.moduli_col(kp.moduli, 3, hat.device)
        return _f64_products(q, hat, kb, ka, u0, u1)

    def plain(hat, kb, ka, u0, u1, q):
        return _f64_products(q, hat, kb, ka, u0, u1)

    def at_level(chain, x, y):
        if x.level != at:
            return matmul(chain, x, y)
        with mock.patch.object(KeyProducts, "__call__", card), \
                mock.patch.object(Gl2GemmRelin, "_key_products_plain",
                                  staticmethod(plain)), \
                mock.patch.object(Gl2GemmRelin, "_from_storage",
                                  staticmethod(lambda u0, u1, q, r: (u0, u1))):
            return matmul(chain, x, y)

    with mock.patch.object(Gl2Chain, "matmul", at_level):
        yield


@contextlib.contextmanager
def rescale_control():
    """The rescale's division (the base conversion of the last limb,
    BasisExtender's kernel and its plain version) with its modular
    products in float64."""
    from matrix_fhe_tpu_torch import Gl2Chain
    from matrix_fhe_tpu_torch.ops import rns_ext
    plain, rescale = rns_ext.BasisExtender.plain, Gl2Chain.rescale

    def conv(ext, x, dst_slice=None, dividend=None):
        with mock.patch.object(rns_ext, "mul_mod", control._fmul):
            return plain(ext, x, dst_slice, dividend)

    def f64(chain, a):
        with mock.patch.object(rns_ext.BasisExtender, "plain", conv), \
                mock.patch.object(rns_ext.BasisExtender, "kernel", conv):
            return rescale(chain, a)

    with mock.patch.object(Gl2Chain, "rescale", f64):
        yield


@contextlib.contextmanager
def decode_control():
    """The reference's decodes in complex64, below the stated float64:
    what chain_gap and chain_err read at the precision below."""
    from fhebench.reference import gl2_chain
    codec = gl2_chain.Codec

    def codec64(n, p, delta, device, dtype=None):
        return codec(n, p, delta, device, torch.complex64)

    with mock.patch.object(gl2_chain, "Codec", codec64):
        yield


def _modswitch():
    from matrix_fhe_tpu_torch.models.keyswitch import Rescaler
    return mock.patch.object(Rescaler, "rescale_component",
                             lambda rs, y: y[:-1])


def _half_second_gemm():
    from matrix_fhe_tpu_torch import Gl2Chain
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2
    matmul = Gl2Chain.matmul

    def mm(chain, x, y):
        out = matmul(chain, x, y)
        if x.level != 1:
            return out
        ct = Ciphertext2(*(control._half(t, control.W_AXIS) for t in out.ct))
        return out._replace(ct=ct)

    return mock.patch.object(Gl2Chain, "matmul", mm)


def patch(mode: str):
    return {"sound": contextlib.nullcontext, "control": chain_control,
            "control0": lambda: chain_control(0),
            "rescale_f64": rescale_control, "complex64": decode_control,
            "modswitch": _modswitch, "half": _half_second_gemm}[mode]()


def run(mode="sound", trace=False, seed=SEED, seconds=0.0):
    """seconds 0: one request in the window, the one the check samples."""
    t = traffic("gl2chain", limits=TRAFFIC["limits"])
    with patch(mode):
        return run_cell(CELL, seed, seconds, trace, device="cpu", cfg=SMALL,
                        traffic=t)


@pytest.mark.parametrize("trace", [False, True])
def test_kind_passes_the_reference(trace):
    res = run(trace=trace)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"chain_noise0", "rescale_noise",
                                  "chain_noise1", "chain_gap", "chain_err"}
    assert all(c["value"] > 0 for c in res["checks"].values())
    assert res["attempted"] >= (4 if trace else 1) and res["failed"] == 0
    got = set(res["metrics"])
    if trace:
        want = {m["name"] for m in SPEC["per_layer"]
                if CELL in m.get("workloads", [CELL])}
        assert want == METRICS and want <= got
        assert all(res["metrics"][m]["value"] > 0 for m in want)
    else:
        assert got == {"matrices_per_s", "peak_device_gib", "setup_s"}


def test_cell_traffic_and_configuration():
    assert TRAFFIC["kind"] == "gl2chain" and TRAFFIC["pool"] == 8
    assert (TRAFFIC["warmup"], TRAFFIC["sample"],
            TRAFFIC["trace_requests"]) == (2, 2, 3)
    assert TRAFFIC["limits"] == {"chain_gap": 1e-6, "chain_err": 0.009}
    assert REF_CFG["ring"] == "gl2" and REF_CFG["reduced"] == []
    assert (REF_CFG["levels"], REF_CFG["gemm_key_levels"]) == (2, [0, 1])
    assert REF_CFG["precision"] == {"relin_noise": 2 ** 25,
                                    "rescale_noise": 2 ** 25,
                                    "matmul_max_abs_err": 1e-4}
    ref_gl2 = cell("ref_gl2.gemm")[2]
    for key in ("n", "p", "moduli", "p_moduli", "delta_bits", "sigma"):
        assert REF_CFG[key] == ref_gl2[key], key


def test_same_seed_same_readings():
    a, b = run(seed=5), run(seed=5)
    assert a["checks"] == b["checks"]
    assert a["checks"] != run(seed=6)["checks"]


@pytest.mark.parametrize("mode,fails", [
    ("control", "chain_noise1"), ("control0", "chain_noise0"),
    ("rescale_f64", "rescale_noise"),
    ("complex64", "chain_gap"), ("modswitch", "rescale_noise"),
    ("half", "chain_noise1")])
def test_degraded_output_fails(mode, fails):
    res = run(mode)
    assert not res["correct"], res["checks"]
    assert res["checks"][fails]["value"] > res["checks"][fails]["limit"]
    if mode == "control":       # level 0 keeps its exact products
        c = res["checks"]["chain_noise0"]
        assert c["value"] <= c["limit"]


# -- on the card, at ref ------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_ref_chain_runs_and_is_correct(card, trace):
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
        assert METRICS <= set(res["metrics"])


@pytest.mark.cuda
def test_ref_chain_launches_sixteen_key_products_a_request(card):
    """A traced run in process: the "gl2.step" spans of the traced
    requests launched gl2_key_products 16 times a request (2 components x
    4 digits x 1 QP chunk, at each of the two levels), and the
    "gl2.rescale" spans base_conv twice."""
    from matrix_fhe_tpu_torch.utils import profiler
    res = run_cell(CELL, 2 ** 31 + 17, 2.0, True, device="cuda")
    assert res["correct"], res["checks"]
    n = TRAFFIC["trace_requests"]
    recs = profiler.records()
    steps = [r for r in recs if r.name == "gl2.step"]
    rescales = [r for r in recs if r.name == "gl2.rescale"]
    assert len(steps) == 2 * n and len(rescales) == n
    assert sum(r.launches.get("gl2_key_products", 0)
               for r in steps) == 16 * n
    assert all(r.launches.get("base_conv") == 2 for r in rescales)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "control0", "rescale_f64",
                                  "complex64", "modswitch"])
def test_degraded_output_fails_on_the_card(card, mode):
    with patch(mode):
        res = run_cell(CELL, 2 ** 31 + 13, 2.0, False, device="cuda")
    print(json.dumps({"mode": mode, "correct": res["correct"],
                      "checks": res["checks"]}))
    assert not res["correct"], res["checks"]
    torch.cuda.empty_cache()
