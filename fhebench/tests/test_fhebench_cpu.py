"""Each traffic kind through the whole harness at the tiny parameter set on
the CPU (the program's plain versions), against the plain reference; the
controls and every planted fault must come out not correct."""

import numpy as np
import pytest
import torch

from fhebench import control
from fhebench.reference import modq, scheme
from fhebench.run import cell, run_cell
from fhebench.tests.tiny import TINY, traffic

CELLS = {"relin": "ref.relin", "roundtrip": "ref.roundtrip",
         "matmul": "ref.matmul"}
SEED = 2 ** 31 + 11
SPEC = cell("ref.relin")[0]


def run(kind, trace=False, mode="sound", seed=SEED):
    with control.patch(kind, mode, TINY):
        return run_cell(CELLS[kind], seed, 0.2, trace, device="cpu",
                        cfg=TINY, traffic=traffic(kind))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_kind_passes_the_reference(kind, trace):
    res = run(kind, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= (3 if trace else 1) and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in SPEC["end_to_end"]
                if CELLS[kind] in m.get("workloads", [CELLS[kind]])}
        assert set(res["metrics"]) == want
        assert {"matrices_per_s", "setup_s"} <= want


def test_same_seed_same_readings():
    a, b = run("relin", seed=5), run("relin", seed=5)
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("mode", ["control"] + list(control.FAULTS))
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_degraded_output_fails(kind, mode):
    res = run(kind, mode=mode)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("preset", ["tiny", "small"])
@pytest.mark.parametrize("ring", ["nega", "gl"])
def test_reference_ring_reads_the_programs_layout(preset, ring):
    """The reference's W-CRT and X products, built from the conventions
    alone, are the program's, bit for bit."""
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models.he import HEContext
    from matrix_fhe_tpu_torch.tables import build_tables
    p = get_params(preset)
    t = build_tables(p)
    r = scheme.Ring(p.moduli, p.n, p.p, ring, "cpu")
    assert (r.v.numpy() == t.w_fwd.view(np.int64)).all()
    assert (r.vinv.numpy() == t.w_inv.view(np.int64)).all()
    ctx = HEContext(p, ring=ring, device="cpu")
    g = torch.Generator().manual_seed(1)
    u, v = (torch.stack([torch.randint(0, q, (p.phi, p.n, p.n), generator=g)
                         for q in p.moduli]) for _ in range(2))
    xn = ctx.xntt
    want = xn.inverse(xn.forward_mul(v, xn.forward_mul(u, ctx._r2_tw)))
    assert (r.x_product(u, r.x_hat(v)) == want).all()


def test_modmatmul_exact_at_57_bits():
    q = (1 << 57) - 13
    g = torch.Generator().manual_seed(3)
    a = torch.randint(0, q, (2, 5, 512), generator=g)
    b = torch.full((2, 512, 3), q - 1)
    got = modq.modmatmul(a, b, torch.tensor(q), 57)
    want = [[[sum(int(x) * (q - 1) for x in a[i, j]) % q] * 3
             for j in range(5)] for i in range(2)]
    assert got.tolist() == want


def test_codec_inverts():
    c = scheme.Codec(8, 15, 2.0 ** 12, "cpu")
    g = torch.Generator().manual_seed(4)
    m = torch.rand((8, 8, 8), generator=g, dtype=torch.float64), \
        torch.rand((8, 8, 8), generator=g, dtype=torch.float64)
    out = c.decode(*c.encode(*m))
    assert max(float((o - x).abs().max()) for o, x in zip(out, m)) < 1e-12
