"""The port's golden-model C++ oracle (native/golden) against the port.

The port's own copy of the independent oracle cross-checks its transforms,
RNG streams and exact CRT compose, mirroring the golden cases of
tests/test_native.py (the JAX package's oracle against the JAX package):
schoolbook polymul against the X-NTT product on every ring, the W-CRT
matvec, the reference RNG streams, the centered compose and the Box-Muller
noise, all bit for bit.  The native root searches of native/tablegen
(find_eta, find_psi4n) are held to the port's Python searches and to the
JAX package's binding at every Q and P limb of tiny, small, mid and ref.
"""

import numpy as np
import pytest
import torch

from matrix_fhe_tpu.native import tablegen as jax_tablegen
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import rng as refrng
from matrix_fhe_tpu_torch.models.keyswitch import _default_p_moduli
from matrix_fhe_tpu_torch.native import golden, tablegen
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops.crt import CRTComposer
from matrix_fhe_tpu_torch.ops.ntt import XNTT
from matrix_fhe_tpu_torch.ops.wcrt import WTransform
from matrix_fhe_tpu_torch.tables import build_gl2_x_tables, build_tables

pytestmark = pytest.mark.skipif(not golden.available(),
                                reason="no C++ toolchain")


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _rand(moduli, shape, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, int(q), size=shape, dtype=np.uint64)
                     for q in moduli])


@pytest.mark.parametrize("ring", ["nega", "gl", "gl2"])
def test_golden_polymul_vs_xntt(ring):
    """NTT(a) * NTT(b) -> inverse == schoolbook a * b mod (X^m - wrap) for
    every limb, m = n (nega, gl) or 2n (gl2)."""
    p = get_params("small")
    xn = XNTT(p, ring=ring, device="cpu")
    m = 2 * p.n if ring == "gl2" else p.n
    a, b = _rand(p.moduli, (1, m), 1), _rand(p.moduli, (1, m), 2)
    q = mm.moduli_col(p.moduli, 2, "cpu")
    fa = xn.forward(torch.from_numpy(a.view(np.int64)))
    fb = xn.forward(torch.from_numpy(b.view(np.int64)))
    got = _u64(xn.inverse(mm.mul_mod(fa, fb, q)))
    for l, ql in enumerate(p.moduli):
        want = golden.polymul_wrap(int(ql), xn.wrap_constant(l), a[l, 0],
                                   b[l, 0])
        assert (got[l, 0] == want).all(), (ring, l)


def test_golden_ntt_polymul_through_the_tables():
    """golden.ntt_polymul on the port's gl2 tables == the schoolbook
    product: the 2n-point tables transform the double ring."""
    p = get_params("tiny")
    fwd, inv = build_gl2_x_tables(build_tables(p))
    a, b = _rand(p.moduli, (2 * p.n,), 3), _rand(p.moduli, (2 * p.n,), 4)
    for l, q in enumerate(p.moduli):
        got = golden.ntt_polymul(int(q), fwd[l], inv[l], a[l], b[l])
        assert (got == golden.polymul_wrap(int(q), int(q) - 1, a[l], b[l])
                ).all(), l


def test_golden_wcrt_matvec():
    p = get_params("small")
    t = build_tables(p)
    wt = WTransform(p, t, device="cpu")
    x = _rand(p.moduli, (p.phi,), 5)
    got = _u64(wt.forward(torch.from_numpy(x.view(np.int64))[:, :, None, None])
               )[..., 0, 0]
    for l, q in enumerate(p.moduli):
        assert (got[l] == golden.mod_matvec(int(q), t.w_fwd[l], x[l])).all(), l


def test_golden_rng_streams():
    p = get_params("small")
    got_u = _u64(refrng.uniform_a(p, "cpu"))
    assert (got_u == golden.uniform_a(p.num_limbs, p.phi, p.n, p.moduli)).all()
    got_t = _u64(refrng.ternary_secret(p, "cpu"))
    assert (got_t == golden.ternary_secret(p.num_limbs, p.phi, p.n,
                                           p.moduli)).all()


def test_golden_crt_compose():
    """Centered compose of signed 60-bit integers: the oracle gives them
    back, and so does the port's CRTComposer.compose_magnitude."""
    p = get_params("small")
    t = build_tables(p)
    comp = CRTComposer(t)
    moduli = np.asarray(p.moduli, dtype=np.uint64)
    xs = [int(v) - (1 << 59)
          for v in np.random.default_rng(6).integers(0, 1 << 60, size=8)]
    for x in xs:
        res = np.array([x % int(q) for q in moduli], dtype=np.uint64)
        mag, neg = golden.crt_compose_centered(
            res, t.crt_m, t.crt_inv, moduli, t.crt_q_big, t.crt_q_half)
        val = sum(int(w) << (64 * i) for i, w in enumerate(mag))
        assert (-val if neg else val) == x
        mag_t, neg_t = comp.compose_magnitude(
            torch.from_numpy(res.view(np.int64).reshape(-1, 1)))
        val_t = sum(int(d[0]) << (32 * i) for i, d in enumerate(mag_t))
        assert (-val_t if bool(neg_t[0]) else val_t) == x


@pytest.mark.parametrize("preset", ["tiny", "ref"])
def test_golden_gaussian_noise_bit_exact(preset):
    """Box-Muller noise: native libm (golden.cpp) vs the port's torch f64
    stream (models/rng.gaussian_noise), bit-compared as residues at the tiny
    and the ref moduli (HE.cu:581-627)."""
    p = get_params(preset)
    want = _u64(refrng.gaussian_noise(p, "cpu"))
    got = golden.gaussian_noise(p.num_limbs, p.phi, p.n, p.sigma, p.moduli)
    np.testing.assert_array_equal(want, got)


# -- native/tablegen's root searches ---------------------------------------------

def _need_tablegen():
    if not tablegen.available():
        pytest.skip("no native toolchain")


@pytest.mark.parametrize("limbs", ["Q", "P"])
@pytest.mark.parametrize("preset", ["tiny", "small", "mid", "ref"])
def test_native_root_searches(preset, limbs):
    """find_eta / find_psi4n == the Python searches (ops/modmath) == the
    JAX package's binding, at every Q limb and every limb of the key-switch
    P basis (ref's preset P, the generated P of the others)."""
    _need_tablegen()
    p = get_params(preset)
    f1, f2 = p.p_factors
    moduli = p.moduli if limbs == "Q" else _default_p_moduli(p)
    assert jax_tablegen.available()
    for q in moduli:
        eta = tablegen.find_eta(q, p.p, f1, f2)
        psi = tablegen.find_psi4n(q, p.n)
        assert eta == mm.find_eta(q, p.p, f1, f2), q
        assert psi == mm.find_psi_4n(q, p.n), q
        assert eta == jax_tablegen.find_eta(q, p.p, f1, f2), q
        assert psi == jax_tablegen.find_psi4n(q, p.n), q


def test_native_root_searches_raise_where_none_exists():
    """(q - 1) mod 4n != 0: the C++ returns 0 and the binding raises, as the
    Python search does; a q with no order-p root raises from find_eta."""
    _need_tablegen()
    p = get_params("small")
    q = p.moduli[0]
    n = 1 << 20                                   # 4n does not divide q - 1
    assert (q - 1) % (4 * n) != 0
    with pytest.raises(ValueError, match="native find_psi4n failed"):
        tablegen.find_psi4n(q, n)
    with pytest.raises(ValueError):
        mm.find_psi_4n(q, n)
    with pytest.raises(ValueError, match="native find_eta failed"):
        tablegen.find_eta(7, p.p, *p.p_factors)   # 51 does not divide 6


def test_native_root_searches_raise_without_the_library(monkeypatch):
    """Where the library cannot be built, the bindings raise: they never
    fall back to the Python search."""
    monkeypatch.setattr(tablegen, "_lib", lambda: None)
    assert not tablegen.available()
    p = get_params("tiny")
    with pytest.raises(RuntimeError, match="could not be built"):
        tablegen.find_eta(p.moduli[0], p.p, *p.p_factors)
    with pytest.raises(RuntimeError, match="could not be built"):
        tablegen.find_psi4n(p.moduli[0], p.n)
