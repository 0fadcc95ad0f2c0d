"""csrc/crt_compose.cu's method, transcribed in numpy, against the plain
CRTComposer.compose_to_float on the CPU; the kernel against the plain
version on the card.

The transcription takes the C launcher's arguments (the residue planes, the
uint64 constant table the wrapper passes, L, words, n, delta) and repeats
the kernel's arithmetic on 64-bit words: t_l by a Shoup product, M_l t_l
added to the accumulator through the (lo, hi) product and addition carry
chains, a conditional -Q after each limb, the strict centre against
floor(Q/2), Q - acc by a borrow chain, the fold from the most significant
word down with each word rounded once to f64, and one IEEE division by
delta.  It is held to the plain version bit for bit at tiny, mid and ref on
random residues and at the edges (0, Q - 1, the centre, values past 2^64,
running sums that cross Q at several limbs), at delta 1, Delta and
Delta^2.
"""

import collections
import functools
import math
import types

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu_torch import HEContext, HEMatmul
from matrix_fhe_tpu_torch.config import generate_primes_1mod, get_params
from matrix_fhe_tpu_torch.ops import _backend as be
from matrix_fhe_tpu_torch.ops import crt
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops.crt import CRTComposer
from matrix_fhe_tpu_torch.tables import build_tables

U64 = np.uint64
M32 = U64(0xFFFFFFFF)


def _umulhi(a, b):
    """The high 64 bits of a * b, elementwise on uint64 (__umul64hi)."""
    a, b = np.broadcast_arrays(np.asarray(a, U64), np.asarray(b, U64))
    a0, a1, b0, b1 = a & M32, a >> U64(32), b & M32, b >> U64(32)
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = (p00 >> U64(32)) + (p01 & M32) + (p10 & M32)
    return a1 * b1 + (p01 >> U64(32)) + (p10 >> U64(32)) + (mid >> U64(32))


def _shoup(x, w, wp, q):
    """x w mod q (mfhe::shoup_mul): one product by floor(w 2^64 / q)."""
    out = x * w - _umulhi(x, wp) * q
    assert (out < U64(2) * q).all()
    return np.where(out >= q, out - q, out)


def _sub_words(a, b):
    """a - b over the words (least significant first) with a borrow chain;
    returns (the difference's words, the final borrow as bool)."""
    out, borrow = [], U64(0)
    for aj, bj in zip(a, b):
        aj, bj = np.asarray(aj, U64), np.asarray(bj, U64)
        t = aj - bj
        out.append(t - borrow)
        borrow = ((aj < bj) | (t < borrow)).astype(U64)
    return out, borrow.astype(bool)


def crt_compose(x, table, L, words, n, delta):
    """mf_crt_compose's arithmetic on numpy arrays: x [L, n] int64, the
    table as the wrapper passes it; returns (out [n] f64, the number of
    limbs at which the conditional -Q fired, per position)."""
    tab = np.ascontiguousarray(table).view(U64)
    row = 3 + words
    assert tab.shape == (L * row + 2 * words,)
    rows = tab[:L * row].reshape(L, row)
    q_big, q_half = tab[L * row:L * row + words], tab[L * row + words:]
    xs = np.ascontiguousarray(x).view(U64).reshape(L, n)
    acc = [np.zeros(n, U64) for _ in range(words)]
    crossings = np.zeros(n, np.int64)
    for l in range(L):
        q, w, wp = rows[l, :3]
        t = _shoup(xs[l], w, wp, q)
        prod_carry, add_carry = np.zeros(n, U64), np.zeros(n, U64)
        for j in range(words):
            m = rows[l, 3 + j]
            lo, hi = m * t, _umulhi(m, t)
            p = lo + prod_carry
            hi = hi + (p < lo).astype(U64)
            s = acc[j] + p
            s2 = s + add_carry
            add_carry = ((s < p) | (s2 < s)).astype(U64)
            acc[j], prod_carry = s2, hi
        assert not prod_carry.any() and not add_carry.any()   # < 2 Q
        d, under = _sub_words(acc, q_big)
        acc = [np.where(under, a, b) for a, b in zip(acc, d)]
        crossings += ~under
    _, neg = _sub_words(q_half, acc)
    mag, _ = _sub_words(q_big, acc)
    f = np.zeros(n)
    for j in reversed(range(words)):
        f = f * 2.0 ** 64 + np.where(neg, mag[j], acc[j]).astype(np.float64)
    return np.where(neg, -f, f) / delta, crossings


def transcribed(comp, x, delta):
    """comp.compose_to_float_kernel's launch, with the transcription in
    place of the card: (out [...] f64, crossings [...])."""
    rest = tuple(x.shape[1:])
    out, crossings = crt_compose(x.numpy(), comp._table.numpy(),
                                 len(comp.moduli), comp.n_digits // 2,
                                 math.prod(rest), delta)
    return torch.from_numpy(out).reshape(rest), crossings.reshape(rest)


@functools.cache
def _composer(preset):
    return CRTComposer(build_tables(get_params(preset)))


def _residues_of(values, moduli):
    return torch.tensor([[v % q for v in values] for q in moduli],
                        dtype=torch.int64)


def _random_residues(moduli, count, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [g.integers(0, q, size=count, dtype=np.int64) for q in moduli]))


def _edges(preset):
    """(residues [L, k], positions whose running sum crosses Q): 0, 1,
    Q - 1, the centre floor(Q/2) and its neighbours (the strict >), powers
    of two about 2^64 and Delta^2-scaled values as the homomorphic product
    leaves them, both signs; then residue vectors built from
    t_l = x_l inv_l mod q_l in the upper half of [0, q_l), whose terms
    M_l t_l each exceed Q/2, the first two with t_l near q_l, whose sums
    cross Q at every limb after the first."""
    p = get_params(preset)
    moduli = tuple(int(q) for q in p.moduli)
    big_q, half = math.prod(moduli), math.prod(moduli) // 2
    vals = [0, 1, 2, big_q - 1, big_q - 2, half - 1, half, half + 1, half + 2]
    for b in (62, 63, 64, 65, 80, big_q.bit_length() - 2):
        for d in (-1, 0, 1):
            vals += [(1 << b) + d, -((1 << b) + d)]
    delta = int(p.delta)
    rng = np.random.default_rng(11)
    vals += [int(round(x * delta)) * delta for x in rng.uniform(-8, 8, 256)]
    plain = _residues_of(vals, moduli)
    m_mod = [big_q // q % q for q in moduli]
    ts = [[q - 1 for q in moduli], [q - 1 - (l % 2) for l, q in enumerate(moduli)],
          [q // 2 + 1 for q in moduli]]
    ts += [[int(rng.integers(q // 2, q)) for q in moduli] for _ in range(64)]
    crossing = torch.tensor([[t[l] * m_mod[l] % q for t in ts]
                             for l, q in enumerate(moduli)], dtype=torch.int64)
    x = torch.cat([plain, crossing], dim=1)
    cross = np.arange(plain.shape[1], x.shape[1])
    return x, cross


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("delta", ["one", "delta", "delta_sq", "three_delta"])
@pytest.mark.parametrize("inputs", ["random", "edge"])
@pytest.mark.parametrize("preset", ["tiny", "mid", "ref"])
def test_crt_compose_transcription_matches_plain(preset, inputs, delta):
    """The transcription == compose_to_float's digit code bit for bit, on
    4,096 random positions or the edge values; the edges reach past 2^64
    and cross Q at L - 1 limbs.  3 Delta is no power of two: a product by
    its reciprocal in place of the division would round differently."""
    comp = _composer(preset)
    p = get_params(preset)
    d = {"one": 1.0, "delta": float(p.delta), "delta_sq": float(p.delta) ** 2,
         "three_delta": 3.0 * p.delta}[delta]
    if inputs == "random":
        x = _random_residues(comp.moduli, 4096, 21 + len(preset))
    else:
        x, cross = _edges(preset)
    got, crossings = transcribed(comp, x, d)
    want = comp.compose_to_float(x, d)
    assert torch.equal(_bits(got), _bits(want))
    if inputs == "edge":
        assert (crossings[cross] >= 1).all()
        assert (crossings[cross[:2]] == len(comp.moduli) - 1).all()
        mag, neg = comp.compose_magnitude(x)
        assert bool((mag[2] != 0).any()) and bool(neg.any())
    else:
        assert len(np.unique(crossings)) > 1


def test_cpu_tensor_takes_the_plain_path(monkeypatch):
    """On a CPU tensor compose_to_float runs the digit code and launches
    nothing."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())

    def refuse(*args):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(CRTComposer, "compose_to_float_kernel", refuse)
    comp = _composer("mid")
    x = _random_residues(comp.moduli, 64, 5)
    got = comp.compose_to_float(x, 2.0 ** 70)
    assert torch.equal(_bits(got), _bits(comp.compose_to_float_plain(x, 2.0 ** 70)))
    assert be.LAUNCHES["crt_compose"] == 0


def _composer_of(moduli):
    """A CRTComposer over any coprime moduli, with the tables' CRT
    constants computed as tables.build_tables does."""
    big_q = math.prod(moduli)
    words = max(1, -(-big_q.bit_length() // 64))

    def limbs(v):
        return np.array([(v >> (64 * i)) & ((1 << 64) - 1)
                         for i in range(words)], dtype=U64)

    return CRTComposer(types.SimpleNamespace(
        params=types.SimpleNamespace(moduli=tuple(moduli)), crt_limbs64=words,
        crt_m=np.stack([limbs(big_q // q) for q in moduli]),
        crt_inv=np.array([pow(big_q // q % q, -1, q) for q in moduli], U64),
        crt_q_big=limbs(big_q), crt_q_half=limbs(big_q >> 1)))


def test_crt_compose_wrapper_refuses_what_the_kernel_does_not_take():
    """compose_to_float_kernel (the CUDA route) raises before a launch on
    more limbs than the kernel's table holds, more words than its
    registers hold, a Q with no spare bit for the sum of two residues, and
    on residues of the wrong shape, type or layout."""
    primes = [v for v in range(2, 400)
              if all(v % d for d in range(2, math.isqrt(v) + 1))][:65]
    many = _composer_of(primes)
    assert many.n_digits // 2 <= crt.MAX_WORDS
    with pytest.raises(ValueError, match="limbs"):
        many.compose_to_float_kernel(_random_residues(primes, 8, 1), 1.0)
    wide = _composer_of(generate_primes_1mod(12, 45, 2))
    assert len(wide.moduli) <= crt.MAX_LIMBS
    with pytest.raises(ValueError, match="words"):
        wide.compose_to_float_kernel(_random_residues(wide.moduli, 8, 2), 1.0)
    full = _composer_of((2 ** 61 - 1, 2 ** 62 - 57, 17))
    assert full.q_big.bit_length() == 64 * (full.n_digits // 2)
    with pytest.raises(ValueError, match="2 Q"):
        full.compose_to_float_kernel(_random_residues(full.moduli, 8, 3), 1.0)
    comp = _composer("ref")
    x = _random_residues(comp.moduli, 64, 4)
    with pytest.raises(ValueError, match="expected"):
        comp.compose_to_float_kernel(x[:10].contiguous(), 1.0)
    with pytest.raises(ValueError, match="not contiguous"):
        comp.compose_to_float_kernel(x[:, ::2], 1.0)
    with pytest.raises(TypeError, match="dtype"):
        comp.compose_to_float_kernel(x.to(torch.float64), 1.0)


@pytest.fixture
def kernel_route(monkeypatch):
    """compose_to_float takes the kernel route on CPU tensors, with the
    transcription in place of mf_crt_compose; every launch is counted in
    be.LAUNCHES under its key."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())

    def launch(key, fn_name, device, x, out, table, L, words, n, delta):
        assert fn_name == "mf_crt_compose" and key == "crt_compose"
        got, _ = crt_compose(x.numpy(), table.numpy(), L, words, n, delta)
        out.view(-1).copy_(torch.from_numpy(got))
        be.LAUNCHES[key] += 1

    monkeypatch.setattr(crt, "be", types.SimpleNamespace(
        on_device=lambda *tensors: True, check=be.check, launch=launch))


def test_kernel_route_takes_residues_of_any_layout(kernel_route):
    """compose_to_float on a CUDA tensor takes what the plain version
    takes: a strided view of the residues (as decode_lane_from_rns_eval's
    callers pass) is made contiguous for its one launch."""
    comp = _composer("mid")
    x = _random_residues(comp.moduli, 4096, 6).reshape(4, 64, 64)
    view = x.transpose(1, 2)
    assert not view.is_contiguous()
    got = comp.compose_to_float(view, 2.0 ** 70)
    assert be.LAUNCHES == {"crt_compose": 1}
    assert torch.equal(_bits(got),
                       _bits(comp.compose_to_float_plain(view, 2.0 ** 70)))


def _matmul_tensor(ctx, hm, gen):
    p = ctx.params
    rng = np.random.default_rng(6)
    cts = []
    sk = ctx.generate_secret_key(gen)
    for _ in range(2):
        m = [torch.from_numpy(rng.uniform(-1, 1, (p.phi, p.n, p.n)))
             .to(ctx.device) for _ in range(2)]
        pr, pi = ctx.batched_encoder.encode_to_wntt_eval(*m)
        cts.append(ctx.encrypt_pair(pr, pi, sk, generator=gen))
    return hm.matmul(*cts), sk


def test_delta_squared_decode_launches_crt_compose_twice(kernel_route,
                                                         monkeypatch):
    """HEMatmul.decrypt_and_decode at tiny through the kernel route: one
    crt_compose launch for re and one for im, no other kernel, and the
    plain route's bits."""
    ctx = HEContext(get_params("tiny"), ring="gl", device="cpu")
    hm = HEMatmul(ctx)
    tt, sk = _matmul_tensor(ctx, hm, torch.Generator().manual_seed(4))
    own = be.Launches()
    with own:
        got = hm.decrypt_and_decode(tt, sk)
    assert own.counts() == {"crt_compose": 2}
    monkeypatch.setattr(crt, "be", be)                # the plain route
    want = hm.decrypt_and_decode(tt, sk)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _delta_sq_residues(p, shape, dev, seed):
    """Residues of round(x Delta) Delta for x uniform in (-8, 8): the
    Delta^2-scaled values of a homomorphic product, past 2^64 at mid and
    ref."""
    g = torch.Generator(device=dev).manual_seed(seed)
    delta = int(p.delta)
    a = torch.randint(-8 * delta, 8 * delta, shape, generator=g, device=dev)
    q = mm.moduli_col(p.moduli, len(shape), dev)
    d = torch.tensor([delta % int(qi) for qi in p.moduli],
                     device=dev).reshape((-1,) + (1,) * len(shape))
    return mm.mul_mod(torch.remainder(a[None], q), d, q).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["mid", "ref"])
def test_cuda_crt_compose_matches_plain(cuda, preset):
    """The kernel == the digit code on the card bit for bit at
    [L, 512, 64, 64] on Delta^2-scaled values and random residues, on an
    odd count of positions (the 8-byte route) and on a strided view, at
    delta 1, Delta and
    Delta^2; == the digit code on the CPU at the edge values and on a
    slice of the Delta^2-scaled values at 3 Delta as well.  (On a CUDA
    tensor torch divides by a scalar as a product by its reciprocal, the
    same as a division only where delta is a power of two, as every
    caller's is; the kernel divides, as the CPU's digit code does.)"""
    p = get_params(preset)
    comp = CRTComposer(build_tables(p))
    shape = (p.phi, p.n, p.n)
    x_d2 = _delta_sq_residues(p, shape, cuda, 8)
    x_rand = _random_residues(p.moduli, math.prod(shape), 9).reshape(
        (len(p.moduli),) + shape).to(cuda)
    for x in (x_d2, x_rand, x_rand[:, 0, 0, :37].contiguous(),
              x_rand[:, :3].transpose(2, 3)):
        for d in (1.0, float(p.delta), float(p.delta) ** 2):
            got = comp.compose_to_float(x, d)
            want = comp.compose_to_float_plain(x, d)
            assert torch.equal(_bits(got), _bits(want))
    x_edge, _ = _edges(preset)
    for x in (x_edge, x_d2[:, :2].cpu()):
        for d in (1.0, float(p.delta) ** 2, 3.0 * p.delta):
            assert torch.equal(
                _bits(comp.compose_to_float(x.to(cuda), d).cpu()),
                _bits(comp.compose_to_float(x, d)))


@pytest.mark.cuda
def test_cuda_matmul_decode_launches_crt_compose_twice(cuda, monkeypatch):
    """HEMatmul.decrypt_and_decode at ref on the card: two crt_compose
    launches (re, im), and the bits of the same decode with the digit code
    in their place."""
    ctx = HEContext(get_params("ref"), ring="gl", device=cuda)
    hm = HEMatmul(ctx)
    tt, sk = _matmul_tensor(ctx, hm,
                            torch.Generator(device=cuda).manual_seed(4))
    own = be.Launches()
    with own:
        got = hm.decrypt_and_decode(tt, sk)
    assert own.counts().get("crt_compose") == 2
    monkeypatch.setattr(CRTComposer, "compose_to_float_kernel",
                        CRTComposer.compose_to_float_plain)
    want = hm.decrypt_and_decode(tt, sk)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
