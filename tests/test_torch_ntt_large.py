"""Port four-step NTT (matrix_fhe_tpu_torch.ops.ntt_large) against the JAX
package's FourStepNTT.

On the CPU the port runs its plain version (kernel K5's twin); the same
numpy residues go through both packages and the spectra, the inverse and
the convolution must match bit for bit.  Mirrors tests/test_ntt_large.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
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


# -- kernel K5's method, transcribed ------------------------------------------
#
# csrc/four_step_ntt.cu on the CPU, step by step: Shoup products with the
# (w, w') tables of FourStepNTT._kernel_tables, umulhi emulated exactly,
# values lazy in [0, 2q) with differences in (0, 4q) before their product
# (in the 64-bit register DFT the sums grow unreduced, below 32q), one
# correction to canonical at the store; m = R * R (R <= 16) through the
# register split (an R-point DIF DFT "in registers", the inner twiddles
# w_m^(j k1), one transpose, a second R-point DFT), every other m through
# the radix-2 loop on bit-reversed input.  Both word widths.

M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


class _Words:
    """b-bit unsigned words held in uint64 arrays, as the kernel's W."""

    def __init__(self, bits):
        self.bits = bits

    def wrap(self, a):
        return a if self.bits == 64 else a & M32

    def mulhi(self, a, b):
        if self.bits == 32:
            return (a * b) >> S32
        a0, a1, b0, b1 = a & M32, a >> S32, b & M32, b >> S32
        p01, p10 = a0 * b1, a1 * b0
        mid = ((a0 * b0) >> S32) + (p01 & M32) + (p10 & M32)
        return a1 * b1 + (p01 >> S32) + (p10 >> S32) + (mid >> S32)

    def shoup(self, a, pair, q):
        w, wp = pair
        assert (a >> np.uint64(self.bits - 1) >> np.uint64(1) == 0).all()
        r = self.wrap(self.wrap(a * w) - self.wrap(self.mulhi(a, wp) * q))
        assert (r < 2 * q).all()
        return r

    def csub(self, a, bound):
        return np.where(a >= bound, a - bound, a)

    def unpack(self, table):
        """A kernel table (int64 tensor) -> (w, w') uint64 arrays."""
        t = table.numpy().view(np.uint64)
        if self.bits == 64:
            return t[..., 0], t[..., 1]
        return t & M32, t >> S32


def _dif(words, regs, root, q):
    """The kernel's dif(): R registers in natural order -> bit-reversed;
    root(e) is the (w, w') pair of w_m^e.  Inputs below 2q; on 64-bit words
    the sums grow unreduced, stage s's inputs below 2^(s+1) q."""
    R = len(regs)
    grow = words.bits == 64
    length, stage = R // 2, 0
    while length >= 1:
        bound = q << np.uint64(stage + 1) if grow else 2 * q
        for s0 in range(0, R, 2 * length):
            for j in range(length):
                a, c = regs[s0 + j], regs[s0 + j + length]
                assert (a < bound).all() and (c < bound).all()
                d = words.wrap(a - c + bound)
                assert (d < 2 * bound).all() and (d > 0).all()
                regs[s0 + j] = a + c if grow else words.csub(a + c, bound)
                regs[s0 + j + length] = (
                    words.shoup(d, root(j * (R * R // (2 * length))), q)
                    if j else d if grow else words.csub(d, bound))
        length //= 2
        stage += 1
    assert all((r < (32 * q if grow else 2 * q)).all() for r in regs)


def _brev(p, bits):
    return int(format(p, f"0{bits}b")[::-1], 2) if bits else 0


def _k5_pass(words, x, q, roots, pre, post, col):
    """One pass on x [L, B, m, m] (uint64, canonical): the DFT of every
    column (col) or row, with the pre- and post-products; tables as
    (w, w') pairs, pre / post [L, m * m] or None."""
    L, B, m, _ = x.shape
    qv = q.reshape(L, 1, 1, 1)

    def as_vectors(a):               # matrix [.., row, col] -> [.., vec, elem]
        return np.swapaxes(a, -1, -2) if col else a

    def table(t):                    # [L, m*m] pair -> [L, 1, vec, elem] pair
        return tuple(as_vectors(u.reshape(L, 1, m, m)) for u in t)

    vec = as_vectors(x)
    if pre is not None:
        vec = words.shoup(vec, table(pre), qv)
    R = int(round(m ** 0.5))
    if R * R == m and R <= 16:
        log_r = R.bit_length() - 1
        rw, rp = (u.reshape(L, 1, 1, m) for u in roots)

        def root(e):                 # the same power for every lane
            return rw[..., e:e + 1], rp[..., e:e + 1]

        # thread j of a vector holds elements i1 R + j, i1 < R
        el = vec.reshape(L, B, m, R, R)
        regs = [el[..., i1, :] for i1 in range(R)]          # [L, B, vec, j]
        _dif(words, regs, root, qv)
        lanes = np.arange(R)
        ex = np.empty((L, B, m, R, R), dtype=np.uint64)    # [.., k1, j]
        grow = words.bits == 64     # k1 = 0 too, by w_m^0 = 1
        for p in range(R):
            k1 = _brev(p, log_r)
            ex[..., k1, :] = regs[p] if k1 == 0 and not grow else words.shoup(
                regs[p], (rw[..., lanes * k1], rp[..., lanes * k1]), qv)
        # thread k1 of a vector now holds j = i2 < R
        regs = [ex[..., i2] for i2 in range(R)]            # [L, B, vec, k1]
        _dif(words, regs, root, qv)
        out = np.empty((L, B, m, R, R), dtype=np.uint64)   # [.., k2, k1]
        for p in range(R):
            out[..., _brev(p, log_r), :] = (
                words.shoup(regs[p], root(0), qv) if grow and post is None
                else regs[p])
        vec = out.reshape(L, B, m, m)
    else:
        log_m = m.bit_length() - 1
        rev = [_brev(i, log_m) for i in range(m)]
        s = vec[..., np.argsort(rev)].copy()     # s[rev(i)] = element i
        half = 1
        while half < m:
            for start in range(0, m, 2 * half):
                for k in range(half):
                    i0, i1 = start + k, start + k + half
                    e = k * (m // (2 * half))
                    t = words.shoup(s[..., i1], (roots[0][:, e].reshape(
                        L, 1, 1), roots[1][:, e].reshape(L, 1, 1)),
                        q.reshape(L, 1, 1))
                    a = s[..., i0].copy()
                    q2 = 2 * q.reshape(L, 1, 1)
                    s[..., i0] = words.csub(a + t, q2)
                    s[..., i1] = words.csub(words.wrap(a - t + q2), q2)
            half *= 2
        vec = s
    if post is not None:
        vec = words.shoup(vec, table(post), qv)
    vec = words.csub(vec, qv)
    return np.ascontiguousarray(as_vectors(vec))


def k5_transcript(ntt, x, inverse=False):
    """FourStepNTT.forward_kernel / inverse_kernel as csrc/four_step_ntt.cu
    computes them, on uint64 arrays [L, B, N]."""
    words = _Words(ntt.word_bits)
    k = {n: words.unpack(t) for n, t in ntt._kernel_tables.items()
         if n != "moduli"}
    q = np.asarray(ntt.plan.moduli, dtype=np.uint64)
    L, B, n = x.shape
    m = ntt.plan.n1
    a = x.reshape(L, B, m, m)
    if not inverse:
        a = _k5_pass(words, a, q, k["roots_f"], k.get("twist_f"), k["tw_f"],
                     col=True)
        a = _k5_pass(words, a, q, k["roots_f"], None, None, col=False)
    else:
        a = _k5_pass(words, a, q, k["roots_i"], None, k["tw_i"], col=False)
        a = _k5_pass(words, a, q, k["roots_i"], None, k["post_i"], col=True)
    return a.reshape(L, B, n)


# every width in one plan: the 32-bit route's 23/28/30-bit and the 64-bit
# route's 35/55-bit limbs
ROUTE_BITS = {32: (23, 28, 30), 64: (35, 55)}


@functools.lru_cache(maxsize=None)
def _route_ntt(route, m, nega):
    n = m * m
    moduli = [tnl.generate_primes_1mod(1, b, 2 * n)[0]
              for b in ROUTE_BITS[route]]
    return tnl.FourStepNTT(tnl.FourStepPlan.make(n, moduli, negacyclic=nega),
                           "cpu")


@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("nega", [True, False])
@pytest.mark.parametrize("route", [32, 64])
@pytest.mark.parametrize("m", [2, 8, 64, 256])
def test_k5_method_matches_plain(m, route, nega, fill):
    """The transcription equals forward_plain / inverse_plain bit for bit
    (and so the JAX FourStepNTT), on random and all-(q - 1) inputs."""
    ntt = _route_ntt(route, m, nega)
    assert ntt.word_bits == route
    moduli, n = ntt.plan.moduli, ntt.plan.n
    if fill == "max":
        x = np.stack([np.full((2, n), q - 1, dtype=np.uint64) for q in moduli])
    else:
        x = _residues(moduli, (2, n), seed=m + route + nega)
    want = _u64(ntt.forward_plain(_i64(x)))
    got = k5_transcript(ntt, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(k5_transcript(ntt, want, inverse=True),
                                  _u64(ntt.inverse_plain(_i64(want))))
    np.testing.assert_array_equal(k5_transcript(ntt, want, inverse=True), x)


@pytest.mark.parametrize("route", [32, 64])
def test_k5_shoup_companions_exact(route):
    """Every entry's w' is floor(w 2^b / q) in Python integers, on the
    route the moduli call for (b = 32 below 2^30, else 64)."""
    ntt = _route_ntt(route, 8, True)
    words = _Words(route)
    for name, t in ntt._kernel_tables.items():
        if name == "moduli":
            assert t.tolist() == list(ntt.plan.moduli)
            continue
        w, wp = words.unpack(t)
        for l, q in enumerate(ntt.plan.moduli):
            ws, wps = w[l].ravel().tolist(), wp[l].ravel().tolist()
            assert all(0 < a < q for a in ws), name
            assert wps == [(a << route) // q for a in ws], name


def test_k5_route_from_the_moduli():
    """32-bit words exactly when every modulus is below 2^30."""
    q30 = tnl.generate_primes_1mod(1, 30, 128)
    q31 = tnl.generate_primes_1mod(1, 31, 128)
    assert tnl.word_bits(q30) == 32
    assert tnl.word_bits(q31) == 64
    assert tnl.word_bits(q30 + q31) == 64
    assert tnl.word_bits([(1 << 30) - 1]) == 32
    assert tnl.word_bits([1 << 30]) == 64


def test_k5_route_fixed_with_its_tables():
    """`words=64` puts narrow moduli on the wide route, with 64-bit pairs
    that the transcription takes to the same spectra; no plan takes a route
    its moduli do not fit, and the route cannot change after the tables."""
    narrow = _route_ntt(32, 8, True)
    wide = tnl.FourStepNTT(narrow.plan, "cpu", words=64)
    assert wide.word_bits == 64
    w, wp = _Words(64).unpack(wide._kernel_tables["tw_f"])
    assert [int(b) for b in wp[0].ravel()] == [
        (int(a) << 64) // narrow.plan.moduli[0] for a in w[0].ravel()]
    x = _residues(narrow.plan.moduli, (2, narrow.plan.n), seed=5)
    np.testing.assert_array_equal(k5_transcript(wide, x),
                                  k5_transcript(narrow, x))
    with pytest.raises(ValueError, match="32-bit words"):
        tnl.FourStepNTT(_route_ntt(64, 8, True).plan, "cpu", words=32)
    with pytest.raises(AttributeError):
        wide.word_bits = 32


def test_k5_bench_companions_build_fast():
    """The bench plan's Shoup tables (N = 2^16, one limb) build in well
    under a second a limb, exactly (sampled against Python integers)."""
    import time

    q = tnl.generate_primes_1mod(1, 35, 1 << 17)
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(1 << 16, q), "cpu")
    t0 = time.perf_counter()
    k = ntt._kernel_tables
    assert time.perf_counter() - t0 < 10
    tw = k["tw_f"][0].numpy().view(np.uint64)
    for k1, i2 in ((0, 0), (255, 77), (128, 255), (3, 200)):
        w, wp = (int(v) for v in tw[k1, i2])
        assert w == int(ntt._t["tw_f"][0, k1, i2])
        assert wp == (w << 64) // q[0]


# -- the stage route: n1 != n2 on the card ---------------------------------------

STAGE_ROUTE_LOGS = (13, 15, 17)


@pytest.mark.parametrize("lg", STAGE_ROUTE_LOGS)
def test_stage_route_matches_plain(lg):
    """The stage route a CUDA tensor takes where n1 != n2 (K10a's twiddle
    form, then K1; on the CPU the stages' plain versions) gives
    forward_plain's and inverse_plain's integers at N = 2^13, 2^15, 2^17,
    L = 4 x 35 bits, B = 2 (chip_smoke.py holds the card to the same)."""
    n = 1 << lg
    moduli = tnl.generate_primes_1mod(4, 35, 2 * n)
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(n, moduli), "cpu")
    assert ntt.plan.n1 != ntt.plan.n2
    x = _i64(_residues(moduli, (2, n), seed=lg))
    spec = ntt.forward_stages(x)
    assert torch.equal(spec, ntt.forward_plain(x))
    back = ntt.inverse_stages(spec)
    assert torch.equal(back, ntt.inverse_plain(spec))
    assert torch.equal(back, x)


@pytest.mark.parametrize("nega", [True, False])
def test_stage_route_matches_jax(nega):
    """The stage route at N = 2^13 (64 x 128) against the JAX
    FourStepNTT, which computes every power-of-two N on the device."""
    n = 1 << 13
    moduli = tnl.generate_primes_1mod(2, 35, 2 * n)
    jntt = jnl.FourStepNTT(jnl.FourStepPlan.make(n, moduli, negacyclic=nega))
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(n, moduli, negacyclic=nega),
                          "cpu")
    x = _residues(moduli, (2, n), seed=21)
    want = np.asarray(jntt.forward(jnp.asarray(x)))
    got = ntt.forward_stages(_i64(x))
    np.testing.assert_array_equal(_u64(got), want)
    np.testing.assert_array_equal(
        _u64(ntt.inverse_stages(got)),
        np.asarray(jntt.inverse(jnp.asarray(want))))


def test_stage_route_refuses_a_foreign_block():
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(128, tnl.generate_primes_1mod(
        1, 35, 256)), "cpu")
    with pytest.raises(ValueError, match="is not"):
        ntt.stages.forward(torch.zeros((1, 1, 16, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="needs an exchange"):
        tnl.FourStepStages(ntt.plan, ntt._t, "cpu", d=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lg", STAGE_ROUTE_LOGS)
def test_cuda_unequal_split_takes_the_stage_route(cuda, lg):
    """On the card a plan with n1 != n2 runs K10a-tw once and K1 once
    forward, K1 twice inverse, never K5, and equals forward_plain /
    inverse_plain bit for bit; a stage of at most 128 terms (n1 = 64 at
    2^13, 128 at 2^15; n2 = 128 at 2^13) under the X-NTT route's keys."""
    import collections

    from matrix_fhe_tpu_torch.ops import _backend as be

    n = 1 << lg
    moduli = tnl.generate_primes_1mod(4, 35, 2 * n)
    ntt = tnl.FourStepNTT(tnl.FourStepPlan.make(n, moduli), cuda)
    x = _i64(_residues(moduli, (2, n), seed=lg)).to(cuda)
    before = collections.Counter(be.LAUNCHES)
    spec = ntt.forward(x)
    back = ntt.inverse(spec)
    torch.cuda.synchronize()
    launched = collections.Counter(be.LAUNCHES) - before
    st = ntt.stages.st
    want = collections.Counter([st["t1f"].launch_key(True)] + [
        st[k].launch_key(False) for k in ("t2f", "t2i", "t1i")])
    assert launched == want
    assert want["stage_tw" if lg == 17 else "stage_tw_x"] == 1
    assert torch.equal(spec, ntt.forward_plain(x))
    assert torch.equal(back, ntt.inverse_plain(spec))
    assert torch.equal(back, x)
