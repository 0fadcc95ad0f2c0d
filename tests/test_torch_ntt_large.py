"""Port four-step NTT (matrix_fhe_tpu_torch.ops.ntt_large) against the JAX
package's FourStepNTT.

On the CPU the port runs its plain version (kernel K5's twin); the same
numpy residues go through both packages and the spectra, the inverse and
the convolution must match bit for bit.  Mirrors tests/test_ntt_large.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.ops import ntt_large as jnl
from matrix_fhe_tpu_torch.ops import ntt_large as tnl

WIDTHS = {35: 1 << 12, 28: 1 << 12, 23: 1 << 11}


@pytest.fixture(scope="module")
def primes():
    return {bits: tnl.generate_primes_1mod(2, bits, m)
            for bits, m in WIDTHS.items()}


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=shape, dtype=np.uint64)
                     for q in moduli])


def _i64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64).copy())


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_primes_match_jax():
    for bits, m in WIDTHS.items():
        assert tnl.generate_primes_1mod(4, bits, m) == \
            jnl.generate_primes_1mod(4, bits, m)


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_tables_match_jax(primes, n):
    """Stage tables, twiddles and the negacyclic twist equal the JAX
    FourStepNTT's (the JAX twiddle/twist arrays are in Montgomery form and
    [i2, k1]; the port keeps canonical [k1, i2] and folds n^-1 into the
    untwist instead of the inverse stage-1 table)."""
    moduli = primes[35]
    plan = tnl.FourStepPlan.make(n, moduli)
    jntt = jnl.FourStepNTT(jnl.FourStepPlan.make(n, moduli))
    ntt = tnl.FourStepNTT(plan, "cpu")
    for name in ("t1f", "t2f", "t2i"):
        np.testing.assert_array_equal(_u64(ntt._t[name]),
                                      getattr(jntt, "_" + name))
    for l, q in enumerate(moduli):
        r_inv, n_inv = pow(1 << 64, -1, q), pow(n, -1, q)
        assert _u64(ntt._t["t1i"][l]).astype(object).tolist() == (
            jntt._t1i[l].astype(object) * n % q).tolist()
        twf = np.asarray(jntt._twf)[l, 0].astype(object) * r_inv % q
        assert _u64(ntt._t["tw_f"][l]).astype(object).tolist() == twf.T.tolist()
        twist = np.asarray(jntt._twist_f)[l, 0].astype(object) * r_inv % q
        assert _u64(ntt._t["twist_f"][l]).astype(object).tolist() == \
            twist.tolist()
        untwist = np.asarray(jntt._twist_i)[l, 0].astype(object) * r_inv % q
        assert _u64(ntt._t["post_i"][l]).astype(object).tolist() == \
            (untwist * n_inv % q).tolist()


@pytest.mark.parametrize("bits", [35, 28, 23])
@pytest.mark.parametrize("n,nega", [(64, True), (256, True), (1024, True),
                                    (64, False), (256, False), (1024, False)])
def test_forward_inverse_match_jax(primes, bits, n, nega):
    moduli = primes[bits]
    jntt = jnl.FourStepNTT(jnl.FourStepPlan.make(n, moduli, negacyclic=nega))
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(n, moduli, negacyclic=nega), "cpu")
    x = _residues(moduli, (3, n), seed=n + bits)
    want = np.asarray(jntt.forward(jnp.asarray(x)))
    got = ntt.forward(_i64(x))
    np.testing.assert_array_equal(_u64(got), want)
    np.testing.assert_array_equal(_u64(ntt.inverse(got)),
                                  np.asarray(jntt.inverse(jnp.asarray(want))))
    np.testing.assert_array_equal(_u64(ntt.inverse(got)), x)


def test_unequal_split_matches_jax(primes):
    """N = 128 splits 8 x 16: the plain version takes every plan."""
    moduli = primes[35]
    plan = tnl.FourStepPlan.make(128, moduli)
    assert (plan.n1, plan.n2) == (8, 16)
    jntt = jnl.FourStepNTT(jnl.FourStepPlan.make(128, moduli))
    x = _residues(moduli, (2, 128), seed=5)
    got = tnl.FourStepNTT(plan, "cpu").forward(_i64(x))
    np.testing.assert_array_equal(_u64(got),
                                  np.asarray(jntt.forward(jnp.asarray(x))))


def test_matches_sliced_kernel_interpret(primes):
    """Against the TPU kernel itself (SlicedFourStepNTT in interpret mode),
    N = 1024, two 35-bit primes, both directions."""
    from matrix_fhe_tpu.ops import pallas_ntt as pn

    moduli = primes[35]
    sliced = pn.SlicedFourStepNTT(jnl.FourStepPlan.make(1024, moduli))
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(1024, moduli), "cpu")
    x = _residues(moduli, (2, 1024), seed=7)
    want = np.asarray(sliced.forward(jnp.asarray(x)))
    got = ntt.forward(_i64(x))
    np.testing.assert_array_equal(_u64(got), want)
    np.testing.assert_array_equal(
        _u64(ntt.inverse(got)),
        np.asarray(sliced.inverse(jnp.asarray(want))))


def test_pointwise_mul_and_negacyclic_convolution(primes):
    moduli, n = primes[35], 128
    plan = tnl.FourStepPlan.make(n, moduli)
    ntt = tnl.FourStepNTT(plan, "cpu")
    jntt = jnl.FourStepNTT(jnl.FourStepPlan.make(n, moduli))
    a = _residues(moduli, (1, n), seed=8)
    b = _residues(moduli, (1, n), seed=9)
    fa, fb = ntt.forward(_i64(a)), ntt.forward(_i64(b))
    fc = ntt.pointwise_mul(fa, fb)
    np.testing.assert_array_equal(
        _u64(fc), np.asarray(jntt.pointwise_mul(jnp.asarray(_u64(fa)),
                                                jnp.asarray(_u64(fb)))))
    got = _u64(ntt.inverse(fc))
    for l, q in enumerate(moduli):
        ref = [0] * n
        for i in range(n):
            for j in range(n):
                p = int(a[l, 0, i]) * int(b[l, 0, j]) % q
                if i + j < n:
                    ref[i + j] = (ref[i + j] + p) % q
                else:
                    ref[i + j - n] = (ref[i + j - n] - p) % q
        assert got[l, 0].tolist() == ref, f"limb {l}"


def test_generator_is_the_smallest_primitive_root(primes):
    for q in primes[35] + primes[23]:
        assert tnl._find_generator(q) == jnl._find_generator(q)
        assert tnl._factorize(q - 1) == jnl._factorize(q - 1)


def test_kernel_refuses_unequal_split(primes):
    """K5 takes n1 == n2 only (as the TPU kernel, pallas_ntt.py:2052)."""
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(128, primes[35]), "cpu")
    with pytest.raises(ValueError, match="n1 == n2"):
        ntt.forward_kernel(torch.zeros((2, 1, 128), dtype=torch.int64))


def test_bench_plan_tables_build_fast(primes):
    """The N = 2^16 tables are built from cumulative products, not per-entry
    pow calls (ntt_large.py:115-143 there): one limb in a few seconds."""
    import time

    q = tnl.generate_primes_1mod(1, 35, 1 << 17)
    t0 = time.perf_counter()
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(1 << 16, q), "cpu")
    assert time.perf_counter() - t0 < 20
    psi = pow(tnl._find_generator(q[0]), (q[0] - 1) // (1 << 17), q[0])
    tw = ntt._t["twist_f"][0]
    for i in (0, 1, 12345, (1 << 16) - 1):
        assert int(tw[i]) == pow(psi, i, q[0])
    w = psi * psi % q[0]
    assert int(ntt._t["tw_f"][0, 255, 77]) == pow(w, 255 * 77, q[0])
