"""The gl2 relinearize's key products: csrc/gl2_key_products.cu through
ops/key_products.KeyProducts on the card, Gl2GemmRelin._key_products_plain
(with _from_storage's one 2^-64) on the CPU.

On the CPU: the plain twin against exact Python integers, sum_i hat_i k_i
2^-64 mod q over the digits; a numpy transcription of the kernel's launch
(its layouts, Montgomery's REDC on the storage-form keys, the conditional
subtraction of the sums, the first digit that writes without reading)
held to the plain twin at every QP modulus of ref and mid, and put in the
card's place to run Gl2GemmRelin.matmul through the kernel route; the
wrapper's refusals; and that the CPU route launches nothing.  On the card
(-m cuda): the kernel against the plain twin at ref's [14, 512, 128, 128],
a request's launches and bits, and the ref_gl2.gemm cell with the kernel
replaced by a float64 product, which must come out not correct.
"""

import collections
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from fhebench.kinds import gl2gemm
from fhebench.run import cell, run_cell
from fhebench.tests.tiny import TINY, traffic
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import he_matmul2
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin
from matrix_fhe_tpu_torch.models.keyswitch import _default_p_moduli
from matrix_fhe_tpu_torch.ops import _backend as be
from matrix_fhe_tpu_torch.ops import key_products
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops.key_products import KeyProducts

U64 = np.uint64
M32 = U64(0xFFFFFFFF)
I64 = torch.int64
CELL = "ref_gl2.gemm"
_, _, REF_GL2, GL2GEMM = cell(CELL)


@functools.cache
def qp_moduli(preset):
    """The QP basis Gl2GemmRelin relinearizes over at a preset: the preset's
    P, or the JAX package's search where it pins none (mid)."""
    p = get_params(preset)
    ps = _default_p_moduli(p if p.p_moduli else
                           dataclasses.replace(p, p_moduli=()))
    return tuple(int(q) for q in p.moduli) + ps


def _umulhi(a, b):
    """The high 64 bits of a * b, elementwise on uint64 (__umul64hi)."""
    a, b = np.broadcast_arrays(np.asarray(a, U64), np.asarray(b, U64))
    a0, a1, b0, b1 = a & M32, a >> U64(32), b & M32, b >> U64(32)
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = (p00 >> U64(32)) + (p01 & M32) + (p10 & M32)
    return a1 * b1 + (p01 >> U64(32)) + (p10 >> U64(32)) + (mid >> U64(32))


def _mont_mul(a, b, q, qinv_neg):
    """a b 2^-64 mod q (mfhe::mont_mul): REDC of the 128-bit product."""
    hi, lo = _umulhi(a, b), a * b
    t = hi + _umulhi(lo * qinv_neg, q) + (lo != 0).astype(U64)
    assert (t < U64(2) * q).all()
    return np.where(t >= q, t - q, t)


def transcribed_launch(hat, kb, ka, u0, u1, consts, limbs, lanes, m,
                       transposed, first):
    """mf_gl2_key_products' arithmetic on the launch's tensors, in place:
    hat read through its storage as the kernel reads the pointer
    ([x2, x1] per slab when transposed), each limb's (q, -q^-1) from the
    constant table."""
    phys = torch.as_strided(hat, (limbs * lanes * m * m,), (1,),
                            hat.storage_offset()).numpy().view(U64)
    h = phys.reshape(limbs, lanes, m, m)
    if transposed:
        h = h.swapaxes(-1, -2)
    tab = consts.numpy().view(U64)
    q, qinv = tab[:, 0].reshape(-1, 1, 1, 1), tab[:, 1].reshape(-1, 1, 1, 1)
    for key, acc in ((kb, u0), (ka, u1)):
        prod = _mont_mul(h, key.numpy().view(U64), q, qinv)
        out = acc.numpy().view(U64)
        if first:
            out[...] = prod
        else:
            s = out + prod
            out[...] = np.where(s >= q, s - q, s)


@pytest.fixture
def kernel_route(monkeypatch):
    """Gl2GemmRelin and KeyProducts take the card's route on CPU tensors,
    with the transcription in place of mf_gl2_key_products; each launch is
    counted in be.LAUNCHES under its key."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())

    def launch(key, fn_name, device, *args):
        assert (key, fn_name) == ("gl2_key_products", "mf_gl2_key_products")
        transcribed_launch(*args)
        be.LAUNCHES[key] += 1

    card = types.SimpleNamespace(on_device=lambda *tensors: True,
                                 check=be.check, launch=launch)
    monkeypatch.setattr(key_products, "be", card)
    monkeypatch.setattr(he_matmul2, "be", card)


def _residues(moduli, shape, seed, edges=True):
    """Random residues [L, *shape], with 0, 1, q - 1 and q - 2 in the first
    positions of every limb."""
    g = np.random.default_rng(seed)
    x = np.stack([g.integers(0, q, size=shape, dtype=np.int64)
                  for q in moduli])
    if edges:
        flat = x.reshape(len(moduli), -1)
        for l, q in enumerate(moduli):
            flat[l, :4] = (0, 1, q - 1, q - 2)
            flat[l, 4:8] = g.permutation([0, 1, q - 1, q - 2])
    return torch.from_numpy(x)


def _storage(x, moduli):
    return mm.to_mont(x, moduli)


def _digits(moduli, shape, dnum, seed, transposed):
    """dnum digits' (hat, kb, ka): hat as its layout asks (the transposed
    view of a contiguous [.., x2, x1] plane, as Gl2GemmRelin._ntt2d
    leaves it), the keys in storage form."""
    out = []
    for i in range(dnum):
        hat = _residues(moduli, shape, seed + 3 * i)
        if transposed:
            hat = hat.transpose(-1, -2).contiguous().transpose(-1, -2)
        kb, ka = (_storage(_residues(moduli, shape, seed + 3 * i + j),
                           moduli) for j in (1, 2))
        out.append((hat, kb, ka))
    return out


def plain_products(digits, moduli):
    """The CPU route of one chunk's key products: the plain twin over the
    digits, then one 2^-64."""
    q = mm.moduli_col(moduli, 3, "cpu")
    u0 = u1 = None
    for hat, kb, ka in digits:
        u0, u1 = Gl2GemmRelin._key_products_plain(hat, kb, ka, u0, u1, q)
    r_inv = mm.moduli_col([pow(1 << 64, -1, x) for x in moduli], 3, "cpu")
    return Gl2GemmRelin._from_storage(u0, u1, q, r_inv)


def _exact(digits, moduli):
    """sum_i hat_i k_i 2^-64 mod q in Python integers, k in storage form."""
    outs = []
    for which in (1, 2):
        acc = None
        for d in digits:
            term = (d[0].numpy().astype(object)
                    * d[which].numpy().astype(object))
            acc = term if acc is None else acc + term
        rows = [acc[l] * pow(1 << 64, -1, q) % q
                for l, q in enumerate(moduli)]
        outs.append(torch.from_numpy(np.stack(rows).astype(np.int64)))
    return outs


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dnum", [1, 4])
@pytest.mark.parametrize("preset", ["tiny", "mid", "ref"])
def test_plain_twin_is_the_exact_sum(preset, dnum, transposed):
    """The plain twin, then 2^-64, == sum_i hat_i k_i 2^-64 mod q exactly,
    on random residues and the edges 0, 1, q - 1, q - 2, for either hat
    layout."""
    moduli = qp_moduli(preset)
    digits = _digits(moduli, (2, 8, 8), dnum, 7 + dnum, transposed)
    got = plain_products(digits, moduli)
    want = _exact(digits, moduli)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("preset", ["mid", "ref"])
def test_transcription_is_the_plain_twin(kernel_route, preset, transposed):
    """KeyProducts through the transcription == the plain twin bit for bit,
    four digits at every QP modulus of the preset (ref's 55-bit P limb
    included), on random residues and the edges; one launch a digit, the
    first writing into fresh accumulators."""
    moduli = qp_moduli(preset)
    digits = _digits(moduli, (3, 8, 8), 4, 31, transposed)
    kp = KeyProducts(moduli, "cpu")
    u0 = u1 = None
    for i, (hat, kb, ka) in enumerate(digits):
        u0, u1 = kp(hat, kb, ka, u0, u1)
        assert be.LAUNCHES == {"gl2_key_products": i + 1}
        assert u0.is_contiguous() and u1.is_contiguous()
    got = (u0, u1)
    want = plain_products(digits, moduli)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(int(g.max()) < max(moduli) for g in got)


def test_transcription_first_digit_reads_no_accumulator(kernel_route):
    """On the first digit the accumulators are written, never read: fresh
    torch.empty memory (here filled with q - 1 beforehand) leaves no
    trace."""
    moduli = qp_moduli("ref")
    ((hat, kb, ka),) = _digits(moduli, (1, 4, 4), 1, 3, True)
    kp = KeyProducts(moduli, "cpu")
    real_empty = torch.empty

    def dirty(shape, **kw):
        return real_empty(shape, **kw).fill_(max(moduli) - 1)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(key_products.torch, "empty", dirty)
        u0, u1 = kp(hat, kb, ka)
    q = mm.moduli_col(moduli, 3, "cpu")
    want = Gl2GemmRelin._key_products_plain(hat, kb, ka, None, None, q)
    r_inv = mm.moduli_col([pow(1 << 64, -1, x) for x in moduli], 3, "cpu")
    want = Gl2GemmRelin._from_storage(*want, q, r_inv)
    assert torch.equal(u0, want[0]) and torch.equal(u1, want[1])


@functools.lru_cache(maxsize=None)
def _tiny_cell():
    """The ref_gl2.gemm cell's set-up at tiny (keys, pool), as
    fhebench/kinds/gl2gemm.py makes it."""
    return gl2gemm.setup(TINY, traffic("gl2gemm"), 2 ** 31 + 5, "cpu")


@pytest.mark.parametrize("chunk_limbs", [None, 1])
def test_matmul_through_the_kernel_route(kernel_route, monkeypatch,
                                         chunk_limbs):
    """Gl2GemmRelin.matmul at tiny with the transcription in the card's
    place: one gl2_key_products launch a digit, component and QP chunk
    (with chunk_limbs 1 every limb its own chunk, the P-only ones
    included), no 2^-64 record, and the CPU route's bits."""
    st = _tiny_cell()
    gr = Gl2GemmRelin(st["gr"].hm, st["gr"].rc, chunk_limbs=chunk_limbs)
    x, y = st["pool"][0], st["pool"][3]
    got = gr.matmul(x, y, st["keys"])
    chunks = gr._qp_chunks()
    assert len(chunks) == (1 if chunk_limbs is None
                           else len(gr.rc.qp_moduli))
    assert be.LAUNCHES == {"gl2_key_products": 2 * gr.rc.dnum * len(chunks)}
    monkeypatch.setattr(he_matmul2, "be", be)           # the CPU route
    want = gr.matmul(x, y, st["keys"])
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_cpu_route_launches_nothing(monkeypatch):
    """On CPU tensors Gl2GemmRelin.matmul runs the plain twin: no
    KeyProducts call, no launch."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(KeyProducts, "__call__", refuse)
    st = _tiny_cell()
    st["gr"].matmul(st["pool"][1], st["pool"][2], st["keys"])
    assert be.LAUNCHES["gl2_key_products"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """KeyProducts raises before any launch on moduli that are even or not
    below 2^56, a wrong dtype, mismatched shapes, an odd m, a hat layout
    other than contiguous or transposed in its last two axes,
    non-contiguous keys or accumulators, one accumulator without the
    other, operands on two devices, and (with everything right) CPU
    tensors."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())
    moduli = qp_moduli("ref")
    for bad in ((1 << 56) + 1, (1 << 61) - 1, 1 << 40):
        with pytest.raises(ValueError, match="odd moduli below 2\\^56"):
            KeyProducts(moduli[:2] + (bad,), "cpu")
    KeyProducts(moduli + ((1 << 56) - 5,), "cpu")      # the largest taken
    kp = KeyProducts(moduli, "cpu")
    ((hat, kb, ka),) = _digits(moduli, (4, 4, 4), 1, 5, True)
    u0, u1 = hat.contiguous(), hat.contiguous()
    with pytest.raises(TypeError, match="hat: dtype"):
        kp(hat.to(torch.int32), kb, ka)
    with pytest.raises(TypeError, match="kb: dtype"):
        kp(hat, kb.to(torch.float64), ka)
    with pytest.raises(TypeError, match="u1: dtype"):
        kp(hat, kb, ka, u0, u1.to(torch.int32))
    with pytest.raises(ValueError, match="kb: shape"):
        kp(hat[:-1], kb[:-1], ka[:-1])                   # a limb short
    with pytest.raises(ValueError, match="hat: shape"):
        kp(hat[:, :1], kb, ka)
    with pytest.raises(ValueError, match="ka: shape"):
        kp(hat, kb, ka[:, :1].contiguous())
    with pytest.raises(ValueError, match="u0: shape"):
        kp(hat, kb, ka, u0[:, :1].contiguous(), u1)
    odd = [t[..., :3, :3].contiguous() for t in (hat, kb, ka)]
    with pytest.raises(ValueError, match="even m"):
        kp(*odd)
    wide = torch.cat([hat.contiguous()] * 2, dim=-1)
    for view in (wide[..., ::2], hat.contiguous().transpose(1, 2)):
        assert view.shape == hat.shape
        with pytest.raises(ValueError,
                           match="neither contiguous nor transposed"):
            kp(view, kb, ka)
    with pytest.raises(ValueError, match="kb: not contiguous"):
        kp(hat, kb.transpose(-1, -2), ka)
    with pytest.raises(ValueError, match="u1: not contiguous"):
        kp(hat, kb, ka, u0, u1.transpose(-1, -2))
    with pytest.raises(ValueError, match="both accumulators or neither"):
        kp(hat, kb, ka, u0)
    meta = torch.empty(hat.shape, dtype=I64, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        kp(hat, kb, meta)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        kp(hat, kb, ka, u0, u1)
    assert be.LAUNCHES["gl2_key_products"] == 0


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_residues(moduli, shape, gen):
    q = mm.moduli_col(moduli, len(shape), "cuda")
    x = torch.randint(0, 1 << 62, (len(moduli),) + tuple(shape),
                      generator=gen, device="cuda", dtype=I64)
    return x % q


def _card_plain(digits, moduli):
    """The CPU route's arithmetic (plain twin and 2^-64) on card tensors."""
    q = mm.moduli_col(moduli, 3, "cuda")
    u0 = u1 = None
    for hat, kb, ka in digits:
        u0, u1 = Gl2GemmRelin._key_products_plain(hat, kb, ka, u0, u1, q)
    r_inv = mm.moduli_col([pow(1 << 64, -1, x) for x in moduli], 3, "cuda")
    return Gl2GemmRelin._from_storage(u0, u1, q, r_inv)


@pytest.mark.cuda
def test_cuda_kernel_is_the_plain_twin_at_ref(cuda):
    """The kernel == the plain twin on the card, bit for bit, over ref's
    four digits at [14, 512, 128, 128] with hat as Gl2GemmRelin._ntt2d's
    transposed view and contiguous; then on a W block (lanes 128:256, the
    keys cut as parallel/gl2.shard_key cuts them) and on chunk_limbs
    splits (Q limbs 0:4, the P-only 11:14)."""
    moduli = qp_moduli("ref")
    assert len(moduli) == 14
    gen = torch.Generator(device="cuda").manual_seed(25)
    shape = (512, 128, 128)
    keys = [tuple(mm.to_mont(_card_residues(moduli, shape, gen), moduli)
                  for _ in range(2)) for _ in range(4)]
    hats = [_card_residues(moduli, (512, 128, 128), gen).transpose(-1, -2)
            for _ in range(4)]
    cases = [(slice(None), slice(None), True), (slice(None), slice(None), False),
             (slice(None), slice(128, 256), True),
             (slice(0, 4), slice(None), True), (slice(11, 14), slice(None), True)]
    for limbs, lanes, transposed in cases:
        mods = moduli[limbs]
        digits = []
        for hat, (kb, ka) in zip(hats, keys):
            h = hat[limbs, lanes]
            h = (h.transpose(-1, -2).contiguous().transpose(-1, -2)
                 if transposed else h.contiguous())
            digits.append((h, kb[limbs, lanes].contiguous(),
                           ka[limbs, lanes].contiguous()))
        kp = KeyProducts(mods, cuda)
        own = be.Launches()
        u0 = u1 = None
        with own:
            for hat, kb, ka in digits:
                u0, u1 = kp(hat, kb, ka, u0, u1)
        torch.cuda.synchronize()
        assert own.counts() == {"gl2_key_products": 4}
        want = _card_plain(digits, mods)
        assert torch.equal(u0, want[0]) and torch.equal(u1, want[1]), \
            (limbs, lanes, transposed)
        del digits, want, u0, u1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 16, 48])
def test_cuda_kernel_is_the_plain_twin_at_other_m(cuda, m):
    """The kernel == the plain twin on the card where m is below a tile
    (tiny's 2n = 16) or not a multiple of one (48), in either hat
    layout, with the edges 0, 1, q - 1, q - 2 in every limb."""
    moduli = qp_moduli("ref")
    for transposed in (True, False):
        digits = [tuple(t.to(cuda) for t in d) for d in
                  _digits(moduli, (5, m, m), 3, 40 + m, transposed)]
        kp = KeyProducts(moduli, cuda)
        u0 = u1 = None
        for hat, kb, ka in digits:
            u0, u1 = kp(hat, kb, ka, u0, u1)
        want = _card_plain(digits, moduli)
        assert torch.equal(u0, want[0]) and torch.equal(u1, want[1])


@pytest.mark.cuda
def test_cuda_ref_request_launches_eight_and_keeps_the_bits(cuda,
                                                            monkeypatch):
    """One Gl2GemmRelin.matmul at ref on the card: 8 gl2_key_products
    launches (2 components x 4 digits x 1 QP chunk), and the bits of the
    same request through the plain twin on the card."""
    st = gl2gemm.setup(REF_GL2, GL2GEMM, 2 ** 31 + 25, cuda)
    gr = st["gr"]
    assert gr.rc.dnum == 4 and len(gr._qp_chunks()) == 1
    x, y = st["pool"][0], st["pool"][3]
    own = be.Launches()
    with own:
        got = gr.matmul(x, y, st["keys"])
    torch.cuda.synchronize()
    assert own.counts()["gl2_key_products"] == 8
    monkeypatch.setattr(he_matmul2, "be", types.SimpleNamespace(
        on_device=lambda *tensors: False))              # the plain twin
    want = gr.matmul(x, y, st["keys"])
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def _f64_products(kp, hat, kb, ka, u0=None, u1=None):
    """KeyProducts with float64 products: hat k 2^-64 mod q through two
    float64 products, wrong in the low bits."""
    q = mm.moduli_col(kp.moduli, 3, hat.device)
    r_inv = mm.moduli_col([pow(1 << 64, -1, x) for x in kp.moduli], 3,
                          hat.device)

    def fmul(a, b):
        r = torch.remainder(a.to(torch.float64) * b.to(torch.float64),
                            q.to(torch.float64))
        return r.to(I64).clamp(min=0) % q

    out = []
    for acc, key in ((u0, kb), (u1, ka)):
        t = fmul(fmul(hat, key), r_inv)
        out.append(t if acc is None else mm.add_mod(acc, t, q))
    return tuple(out)


@pytest.mark.cuda
def test_cuda_cell_with_float64_products_is_not_correct(cuda, monkeypatch):
    """ref_gl2.gemm on the card with the kernel replaced by float64
    products, the precision below the configuration's exact 64-bit words,
    reads correct false on its noise check."""
    monkeypatch.setattr(KeyProducts, "__call__", _f64_products)
    res = run_cell(CELL, 2 ** 31 + 13, 2.0, False, device="cuda")
    print({"correct": res["correct"], "checks": res["checks"]})
    assert not res["correct"], res["checks"]
    assert res["checks"]["gl2_noise"]["value"] > \
        res["checks"]["gl2_noise"]["limit"]
