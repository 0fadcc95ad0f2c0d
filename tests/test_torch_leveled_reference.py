"""The port's LeveledChain keyed from a caller's secret, held to the
benchmark's plain reference of the leveled circuit
(fhebench/reference/leveled.py, plain torch) at tiny on the CPU; the
reference's own exact steps; and the chain's rotation and rescale spans.
"""

import functools
import math

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from fhebench import kinds
from fhebench.reference import leveled as ref
from fhebench.reference.scheme import Ring
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import rng as refrng
from matrix_fhe_tpu_torch.models.keyswitch import w_automorphism_perm
from matrix_fhe_tpu_torch.models.leveled import LeveledChain, LeveledCt
from matrix_fhe_tpu_torch.utils import profiler

LIMIT = 1 << 40     # leveled_noise's limit (fhebench/traffic/leveled.json)
# units mod 15 taking 0, 1, 2 and 3 (every key) switches at tiny
J_BY_HOPS = {0: 1, 1: 7, 2: 13, 3: 8}


@functools.lru_cache(maxsize=None)
def _setup():
    """A tiny chain keyed from a seeded ternary secret, its level-1 keys,
    two ciphertexts encrypted with fresh randomness, and the reference's
    rings."""
    p = get_params("tiny")
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    s = kinds.ternary(gen, p.phi, p.n, "cpu")
    chain = LeveledChain(p, seed=7, device="cpu", secret=s)
    chain.full_galois(1)
    msgs = [chain.ctx(0).wt.forward(kinds.residues(
        torch.randint(0, 1 << 16, (p.phi, p.n, p.n), generator=gen),
        p.moduli)) for _ in range(2)]
    x, y = (LeveledCt(ct, 0, p.delta) for ct in chain.ctx(0).encrypt_pair(
        *msgs, chain.sk(0), generator=gen))
    ring = Ring(p.moduli, p.n, p.p, "nega", "cpu")
    return chain, s, x, y, ring


def _hops(chain, j):
    t, e = chain.full_galois(1).decompose(j)
    return t + bin(e).count("1")


@pytest.mark.parametrize("hops", sorted(J_BY_HOPS))
def test_chain_with_a_secret_meets_the_reference(hops):
    chain, s, x, y, ring = _setup()
    j = J_BY_HOPS[hops]
    assert _hops(chain, j) == hops
    zr = chain.rescale(chain.multiply(x, y))
    w = chain.rotate(chain.multiply(zr, chain.mod_switch(x, 1)), j,
                     full=True)
    s_hat = ring.secret_hat(s)
    m_x, m_y = (ring.decrypt(c.ct.b, c.ct.a, s_hat) for c in (x, y))
    ring1 = ref.prefix(ring, len(ring.moduli) - 1)
    want = ref.rotated_product(ring1, ref.rescaled(ring, m_x, m_y),
                               m_x[:-1], j)
    got = ring1.decrypt(w.ct.b, w.ct.a, s_hat[:-1])
    noise = ref.noise(ring1, got, want)
    assert 0 < noise < LIMIT
    # one residue changed in one limb reads near half the level's modulus
    bad = got.clone()
    bad[1, 0, 0, 0] = (bad[1, 0, 0, 0] + 1) % ring1.moduli[1]
    assert ref.noise(ring1, bad, want) > 2.0 ** 50


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_reference_perm_is_the_programs(preset):
    p = get_params(preset)
    for j in ref.units(p.p):
        assert ref.w_perm(p.p, j).tolist() == \
            w_automorphism_perm(p, j).tolist(), j
    assert len(ref.units(p.p)) == p.phi


def test_reference_rescale_and_compose_are_exact():
    """On limb-consistent W-coefficients past one limb (|c| < 2^70): the
    reference's rescale is round(c / q_last) in every remaining limb, and
    its composed magnitude is max |c|, both against Python's integers."""
    p = get_params("tiny")
    ring = Ring(p.moduli, p.n, p.p, "nega", "cpu")
    rng = np.random.default_rng(11)
    shape = (p.phi, p.n, p.n)
    c = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, math.prod(shape))]
    c = [v * int(k) for v, k in zip(c, rng.integers(1, 1 << 8, len(c)))]
    c[5] = -(1 << 69) - 12345

    def limbs(vals, moduli):
        return torch.tensor([[v % q for v in vals] for q in moduli],
                            dtype=torch.int64).reshape((len(moduli),) + shape)

    y = ring.w_forward(limbs(c, p.moduli))
    q_last = p.moduli[-1]
    want = [(2 * v + q_last) // (2 * q_last) for v in c]   # round half up
    ring1 = ref.prefix(ring, len(p.moduli) - 1)
    got = ring1.w_inverse(ref.rescale(ring, y))
    assert torch.equal(got, limbs(want, p.moduli[:-1]))
    assert ref.composed_max_abs(ring, y) == pytest.approx(
        float(max(abs(v) for v in c)), rel=1e-12)


def test_chain_keys_come_from_the_given_secret():
    """With a secret, sk(0) is the benchmark's SecretKey of it
    (fhebench.kinds.secret_key); without one, the chain's secret and key
    are the hashed secret's, as before; a secret that is not ternary
    [W, n] is refused."""
    chain, s, _, _, _ = _setup()
    assert torch.equal(chain.sk(0).s_mont,
                       kinds.secret_key(chain.ctx(0), s).s_mont)
    assert torch.equal(chain._s_coeff0, kinds.residues(s, chain.base.moduli))
    p = chain.base
    plain = LeveledChain(p, device="cpu")
    assert torch.equal(plain._s_coeff0, refrng.ternary_secret(p, "cpu"))
    assert torch.equal(plain.sk(1).s_mont,
                       plain.ctx(0).generate_secret_key().s_mont[:2])
    for bad in (2 * s, s[:, :-1]):
        with pytest.raises(ValueError, match="ternary"):
            LeveledChain(p, device="cpu", secret=bad)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiler.records()


@pytest.mark.parametrize("hops", sorted(J_BY_HOPS))
def test_rotate_and_rescale_spans(hops):
    chain, _, x, y, _ = _setup()
    j = J_BY_HOPS[hops]
    z = chain.multiply(x, y)
    want = chain.rescale(z)
    got, recs = _profiled(lambda: chain.rescale(z))
    assert torch.equal(got.ct.b, want.ct.b)
    assert [r.name for r in recs if r.parent is None] == ["ks.rescale"]
    w = chain.multiply(want, chain.mod_switch(x, 1))
    _, recs = _profiled(lambda: chain.rotate(w, j, full=True))
    rot = [r for r in recs if r.name == "ks.rotate"]
    gal = [r for r in recs if r.name == "ks.galois"]
    assert len(rot) == 1 and rot[0].parent is None and rot[0].index == j
    assert len(gal) == hops
    assert all(r.parent == rot[0].id for r in gal)
    assert {r.index for r in gal} <= set(chain.full_galois(1).indices)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name in ("ks.digit", "ks.finish"):
            assert by_id[r.parent].name == "ks.galois"
    assert sum(r.name == "ks.finish" for r in recs) == hops
