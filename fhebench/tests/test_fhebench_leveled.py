"""The leveled kind through the whole harness at the tiny parameter set on
the CPU, against fhebench/reference/leveled.py; its lower-precision
control and each planted fault must come out not correct.  With -m cuda
on a card, the cell runs at ref, and so do the control and a fault.

The control and the faults are patched here, each the program's own
steps with one thing wrong.  Control: the exact base conversion
(BasisExtender's kernel and its plain version, which every key switch
and the rescale run) with its modular products in float64, the
precision below the configuration's exact 64-bit words.  Faults: the
rotation's last hop left out ("hop"), a rotation by the next unit after
the drawn one ("wrong_j"), half of the lanes left out ("half"), one
residue of one limb changed ("altered")."""

import contextlib
import json
import os
import random
import subprocess
import sys
from unittest import mock

import pytest

from fhebench import control
from fhebench.reference.leveled import units
from fhebench.run import cell, run_cell
from fhebench.tests.tiny import TINY, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 11
CELL = "ref.leveled"
SPEC, _, _, TRAFFIC = cell(CELL)
FAULTS = ("hop", "wrong_j", "half", "altered")


@contextlib.contextmanager
def leveled_control():
    from matrix_fhe_tpu_torch.ops import rns_ext
    plain = rns_ext.BasisExtender.plain

    def conv(ext, x, dst_slice=None, dividend=None):
        with mock.patch.object(rns_ext, "mul_mod", control._fmul):
            return plain(ext, x, dst_slice, dividend)

    with mock.patch.object(rns_ext.BasisExtender, "plain", conv), \
            mock.patch.object(rns_ext.BasisExtender, "kernel", conv):
        yield


def _hop_left_out():
    from matrix_fhe_tpu_torch.models.keyswitch import FullGaloisKeys

    def apply(fk, ct, j):
        t, e = fk.decompose(j)
        keys = [fk._t_idx] * t + [g for k, g in enumerate(fk._g_idx)
                                  if (e >> k) & 1]
        for g in keys[:-1]:
            ct = fk._gk.apply(ct, g)
        return ct

    return mock.patch.object(FullGaloisKeys, "apply", apply)


def _rotate_fault(fault: str):
    from matrix_fhe_tpu_torch import Ciphertext
    from matrix_fhe_tpu_torch.models.leveled import LeveledChain, LeveledCt
    rotate = LeveledChain.rotate

    def rot(chain, a, j, full=False):
        if fault == "wrong_j":
            js = units(chain.base.p)
            j = js[(js.index(j) + 1) % len(js)]
        out = rotate(chain, a, j, full)
        ct = out.ct
        if fault == "half":
            ct = Ciphertext(control._half(ct.b, control.W_AXIS),
                            control._half(ct.a, control.W_AXIS))
        elif fault == "altered":
            b = control._bump(ct.b, 1)
            b.view(-1)[0] %= int(chain.params_at(out.level).moduli[0])
            ct = Ciphertext(b, ct.a)
        return LeveledCt(ct, out.level, out.scale)

    return mock.patch.object(LeveledChain, "rotate", rot)


def patch(mode: str):
    if mode == "sound":
        return contextlib.nullcontext()
    if mode == "control":
        return leveled_control()
    if mode == "hop":
        return _hop_left_out()
    return _rotate_fault(mode)


def run(mode="sound", trace=False, seed=SEED, seconds=0.0):
    """seconds 0: one request in the window, the one the check samples."""
    t = traffic("leveled", message_bits=TRAFFIC["message_bits"],
                limits=TRAFFIC["limits"])
    with patch(mode):
        return run_cell(CELL, seed, seconds, trace, device="cpu", cfg=TINY,
                        traffic=t)


@pytest.mark.parametrize("trace", [False, True])
def test_kind_passes_the_reference(trace):
    res = run(trace=trace, seconds=0.2)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"leveled_noise", "leveled_step_noise"}
    assert res["checks"]["leveled_noise"]["limit"] == 2 ** 40
    assert res["attempted"] >= (4 if trace else 1) and res["failed"] == 0
    got = set(res["metrics"])
    if trace:
        want = {m["name"] for m in SPEC["per_layer"]
                if CELL in m.get("workloads", [CELL])}
        assert want == {"galois_ms", "galois_hop_ms", "rescale_ms"}
        assert want <= got
        assert all(res["metrics"][m]["value"] > 0 for m in want)
    else:
        assert got == {"matrices_per_s", "peak_device_gib", "setup_s"}


def test_same_seed_same_readings():
    a, b = run(seed=5), run(seed=5)
    assert a["checks"] == b["checks"]
    assert a["checks"] != run(seed=6)["checks"]


def test_first_request_rotates():
    """The hop fault needs a hop: the first window request's j at SEED
    (the kind's draw) is not 1, the one unit that takes none."""
    js = units(TINY["p"])
    assert js[random.Random(SEED).randrange(len(js))] != 1


@pytest.mark.parametrize("mode", ("control",) + FAULTS)
def test_degraded_output_fails(mode):
    res = run(mode)
    assert not res["correct"], res["checks"]


# -- on the card, at ref ------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_ref_leveled_runs_and_is_correct(card, trace):
    out = subprocess.run([sys.executable, "-m", "fhebench", "--workload",
                          CELL, "--seed", str(2 ** 31 + 7), "--seconds", "2",
                          "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    if trace:
        assert {"galois_ms", "galois_hop_ms", "rescale_ms"} <= \
            set(res["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "hop", "wrong_j"])
def test_degraded_output_fails_on_the_card(card, mode):
    with patch(mode):
        res = run_cell(CELL, 2 ** 31 + 13, 2.0, False, device="cuda")
    print(json.dumps({"mode": mode, "correct": res["correct"],
                      "checks": res["checks"]}))
    assert not res["correct"], res["checks"]
