"""The gl2 leveled tower (models/leveled2.Gl2Chain): two chained encrypted
GEMMs, B = Q^H A, the gl2 rescale, G = B'^H B', against the plain
reference fhebench/reference/gl2_chain.py.

On the CPU: the three noise readings at tiny; the decode gap and the
carried contract on a small geometry whose Delta sits near its limbs as
at ref (small's n 16, p 51 and four 35-bit limbs with Delta 2^35, and a
P of two 40-bit limbs, so that level 1's last digit is one limb as at
ref: tiny's and small's own Delta lie so far below q that a rescale by q
would leave a scale below 1); the rescale alone against the reference's
exact division; the level-1 keys and SecretKey2 against the level-0
secret's limb prefix; the level bookkeeping and its errors; the spans.
On the card (-m cuda): each step at tiny bit for bit against the CPU,
with a request's gl2_key_products launches.
"""

import collections
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from fhebench.reference import gl2_chain as ref
from fhebench.reference.gl2 import Gl2Ring
from matrix_fhe_tpu_torch import Gl2Chain, LeveledChain
from matrix_fhe_tpu_torch.config import REF_P_MODULI, get_params
from matrix_fhe_tpu_torch.models.he2 import Ciphertext2, Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import (GemmRelinKey,
                                                    Gl2GemmRelin, HEMatmul2)
from matrix_fhe_tpu_torch.models.keyswitch import (RelinContext,
                                                   _greedy_groups)
from matrix_fhe_tpu_torch.models.leveled import LeveledCt
from matrix_fhe_tpu_torch.ops import _backend as be
from matrix_fhe_tpu_torch.utils import profiler

SEED = 2 ** 31 + 26
# two 40-bit limbs (== 1 mod lcm(4n, p) at n 16, p 51): groups of two
# 35-bit limbs, and level 1's last digit one limb, as at ref
SMALL_P = (1099511585089, 1099511575297)
TINY_NOISE = 1 << 20        # fhebench/tests/tiny.py's relin_noise


def _small():
    return dataclasses.replace(get_params("small"), name="small-d35",
                               delta=float(2 ** 35), p_moduli=SMALL_P)


def _sign(p, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 3, (p.phi, 2 * p.n), generator=g) - 1


def _messages(p, seed):
    rng = np.random.default_rng(seed)
    shape = (p.phi, p.n, p.n)
    return [torch.complex(*(torch.from_numpy(rng.uniform(-1, 1, shape))
                            for _ in range(2))) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _run(preset: str):
    """One chained request on the CPU: (chain, sign, messages, A, Q, B,
    B', G)."""
    p = get_params(preset) if preset == "tiny" else _small()
    sign = _sign(p, SEED)
    chain = Gl2Chain(p, seed=SEED, device="cpu", secret=sign)
    msgs = _messages(p, SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    a, q = (chain.encrypt(m.real, m.imag, g) for m in msgs)
    b = chain.matmul(a, q)
    b1 = chain.rescale(b)
    return chain, sign, msgs, a, q, b, b1, chain.matmul(b1, b1)


def _readings(preset: str, dtype=torch.complex128) -> dict:
    chain, sign, (m_a, m_q), a, q, b, b1, g = _run(preset)
    p = chain.base
    r = ref.Gl2ChainReference(p.moduli, p.n, p.p, p.delta, sign, 1e-4,
                              dtype)
    return r.readings(a.ct, q.ct, b.ct, b1.ct, g.ct, m_a, m_q)


def test_chain_steps_against_the_reference_at_tiny():
    """Each step's reading at tiny: the two GEMMs' key-switch noise and
    the rescale's rounding, small and above 0; levels and scales as the
    chain keeps them."""
    chain, _, _, a, _, b, b1, g = _run("tiny")
    got = _readings("tiny")
    for name in ("chain_noise0", "rescale_noise", "chain_noise1"):
        assert 0 < got[name] < TINY_NOISE, (name, got)
    d, q_last = chain.base.delta, chain.base.moduli[-1]
    assert (a.level, b.level, b1.level, g.level) == (0, 0, 1, 1)
    assert (b.scale, b1.scale) == (d * d, d * d / q_last)
    assert g.scale == b1.scale * b1.scale
    limbs = len(chain.base.moduli)
    assert tuple(g.ct.b.shape) == (limbs - 1, chain.base.phi, chain.base.n,
                                   2 * chain.base.n)


def test_decode_gap_and_contract_with_delta_near_q():
    """On the small geometry at Delta 2^35: the decode of G against the
    GEMM of B's decode (1e-6, gl2_gap's limit), the first product's 1e-4
    contract carried through the second (below 1), and the chain's own
    decrypt_decode of G at its scale against (Q^H A)^H (Q^H A).  A
    complex64 decode fails the gap."""
    got = _readings("small")
    assert got["chain_gap"] < 1e-6 and got["chain_err"] < 1, got
    for name in ("chain_noise0", "rescale_noise", "chain_noise1"):
        assert 0 < got[name] < 2 ** 25, (name, got)
    assert _readings("small", torch.complex64)["chain_gap"] > 1e-6
    chain, _, (m_a, m_q), _, _, _, _, g = _run("small")
    assert 2 ** 34 < g.scale ** 0.5 < 2 ** 36
    b_true = ref.product(m_a, m_q)
    re, im = chain.decrypt_decode(g)
    assert float((torch.complex(re, im) - ref.product(b_true, b_true))
                 .abs().max()) < 1e-4


def test_rescale_alone_is_the_reference_division():
    """Gl2Chain.rescale on residues drawn over the whole of each limb ==
    the reference's round(y / q_last) of each component, bit for bit, at
    tiny and small."""
    for preset in ("tiny", "small"):
        chain = _run(preset)[0]
        p = chain.base
        shape = (len(p.moduli), p.phi, p.n, 2 * p.n)
        gen = np.random.default_rng(3)
        comps = [torch.from_numpy(np.stack([gen.integers(0, q, shape[1:])
                                            for q in p.moduli]))
                 for _ in range(2)]
        out = chain.rescale(LeveledCt(Ciphertext2(*comps), 0, 1.0))
        ring = Gl2Ring(p.moduli, p.n, p.p, "cpu")
        assert (out.level, out.scale) == (1, 1.0 / p.moduli[-1])
        for got, y in zip(out.ct, comps):
            assert torch.equal(got, ref.rescale(ring, y))


def test_level_keys_and_secret_are_the_level0_prefix():
    """sk(1) is sk(0) on the first L - 1 limbs; the level-1 GEMM keys are
    what a Gl2GemmRelin of the level-1 parameters makes from that prefix
    and the chain's level-1 generator, bit for bit; level 1's groups end
    in a one-limb digit."""
    chain = _run("small")[0]
    sk0, sk1 = chain.sk(0), chain.sk(1)
    assert torch.equal(sk1.s_mont, sk0.s_mont[:-1])
    assert torch.equal(sk1.s_sign, sk0.s_sign)
    assert chain.gemm(0).rc.groups == [(0, 1), (2, 3)]
    assert chain.gemm(1).rc.groups == [(0, 1), (2,)]
    ctx1 = Gl2Context(chain.params_at(1), device="cpu")
    gr1 = Gl2GemmRelin(HEMatmul2(ctx1), RelinContext(ctx1))
    assert gr1.rc.qp_moduli == chain.gemm(1).rc.qp_moduli
    want = gr1.gen_keys(sk0._replace(s_mont=sk0.s_mont[:-1]),
                        chain._generator(1))
    got = chain.gemm_keys(1)
    for g_part, w_part in zip(got, want):
        assert len(g_part) == 2
        for g_k, w_k in zip(g_part, w_part):
            assert g_k.shape[0] == len(chain.gemm(1).rc.qp_moduli)
            assert torch.equal(g_k, w_k)


def test_ref_groups_and_chunks_at_both_levels():
    """ref's key-switch groups and QP chunk at levels 0 and 1, as the
    configuration ref_gl2_chain states them: level 1 has 13 QP limbs,
    its last digit one limb, one chunk of 872.4 MB under 1 GiB."""
    p = get_params("ref")
    big_p = math.prod(REF_P_MODULI)
    assert _greedy_groups(p.moduli, big_p) == [
        (0, 1, 2), (3, 4, 5), (6, 7, 8), (9, 10)]
    assert _greedy_groups(p.moduli[:10], big_p) == [
        (0, 1, 2), (3, 4, 5), (6, 7, 8), (9,)]
    plane = p.phi * (2 * p.n) ** 2 * 8
    assert (10 + len(REF_P_MODULI)) * plane == 872_415_232 < 1 << 30
    assert (11 + len(REF_P_MODULI)) * plane <= 1 << 30


def test_level_and_chain_errors():
    chain, sign, _, a, _, b, b1, g = _run("tiny")
    with pytest.raises(ValueError, match="level mismatch 1 != 0"):
        chain.matmul(b1, a)
    deep = LeveledCt(Ciphertext2(g.ct.b[:1], g.ct.a[:1]), chain.depth, 1.0)
    with pytest.raises(ValueError, match="chain exhausted"):
        chain.rescale(deep)
    with pytest.raises(ValueError, match="outside chain"):
        chain.ctx(chain.depth + 1)
    with pytest.raises(ValueError, match="Gl2Chain"):
        LeveledChain(chain.base, ring="gl2", device="cpu")
    with pytest.raises(ValueError, match="ternary"):
        chain.ctx(0).secret_key(2 * sign)
    with pytest.raises(ValueError, match="ternary"):
        chain.ctx(0).secret_key(sign[:, :-1])


def test_spans_of_a_chained_request():
    """Under a profile: one "gl2.step" a GEMM (index: the level), each
    holding a "gl2.tensor" and a "gl2.relin"; one "gl2.rescale" holding
    the negacyclic chain's own "ks.rescale", whose children are two
    "rns.extend" (one base conversion a component)."""
    chain, _, _, a, q, _, _, _ = _run("tiny")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        b1 = chain.rescale(chain.matmul(a, q))
        chain.matmul(b1, b1)
    recs = profiler.records()
    steps = [r for r in recs if r.name == "gl2.step"]
    assert [r.index for r in steps] == [0, 1]
    assert all(r.parent is None for r in steps)
    for s in steps:
        kids = collections.Counter(r.name for r in recs if r.parent == s.id)
        assert kids == {"gl2.tensor": 1, "gl2.relin": 1}
    (resc,) = [r for r in recs if r.name == "gl2.rescale"]
    assert resc.parent is None
    (inner,) = [r for r in recs if r.parent == resc.id]
    assert inner.name == "ks.rescale"
    assert [r.name for r in recs if r.parent == inner.id] == ["rns.extend"] * 2


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    items = [_to(t, dev) for t in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_cuda_chain_steps_are_the_cpu_bits(cuda, preset):
    """Each step on the card (the kernels) == the CPU's plain twins, bit
    for bit, with the CPU's keys and ciphertexts moved across; the
    request launches gl2_key_products 2 components x dnum x 1 chunk a
    GEMM, and base_conv once a component in the rescale."""
    chain, sign, _, a, q, b, b1, g = _run(preset)
    card = Gl2Chain(chain.base, seed=SEED, device=cuda, secret=sign)
    assert torch.equal(card.sk(0).s_mont.cpu(), chain.sk(0).s_mont)
    for level in (0, 1):
        card.set_gemm_keys(level, chain.gemm_keys(level))
    x, y = (LeveledCt(_to(c.ct, cuda), 0, c.scale) for c in (a, q))
    own = be.Launches()
    with own:
        got_b = card.matmul(x, y)
        got_b1 = card.rescale(got_b)
        got_g = card.matmul(got_b1, got_b1)
    torch.cuda.synchronize()
    for got, want in ((got_b, b), (got_b1, b1), (got_g, g)):
        assert (got.level, got.scale) == (want.level, want.scale)
        assert all(torch.equal(t.cpu(), w) for t, w in zip(got.ct, want.ct))
    dnum = [card.gemm(level).rc.dnum for level in (0, 1)]
    assert own.counts()["gl2_key_products"] == 2 * sum(dnum)
    assert isinstance(card.gemm_keys(1), GemmRelinKey)
