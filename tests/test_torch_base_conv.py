"""csrc/base_conv.cu's method, transcribed in numpy, against the plain
BasisExtender on the CPU; the kernel against the plain version on the card.

The transcription takes the C launcher's arguments (the source planes, the
dividend or None, the uint64 constant tables the wrapper passes, Ls, Ld,
n) and repeats the kernel's arithmetic: r' by Shoup products, the f64
quotient in limb order with a product and a sum each rounded (numpy
contracts nothing into an FMA) and half-even rounding, the Ls + 1 lazy
Shoup terms of a target below 2^63 and their one reduction by
floor(2^64 / r), and the division epilogue.  It is held to the plain
version bit for bit at mid's and ref's base conversions (every digit group,
both ModDowns with their division, ref's rescale, dst_slice chunks) on
random residues and at the quotient's half-integer edge.
"""

import collections
import types

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu_torch import HEContext, RelinContext, SecretKey
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import keyswitch as tks
from matrix_fhe_tpu_torch.models.he2 import Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin, HEMatmul2
from matrix_fhe_tpu_torch.ops import _backend as be
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.ops import rns_ext
from matrix_fhe_tpu_torch.ops.rns_ext import BasisExtender

U64 = np.uint64
M32 = U64(0xFFFFFFFF)
EDGE = 2048


def _umulhi(a, b):
    """The high 64 bits of a * b, elementwise on uint64 (__umul64hi)."""
    a, b = np.broadcast_arrays(np.asarray(a, U64), np.asarray(b, U64))
    a0, a1, b0, b1 = a & M32, a >> U64(32), b & M32, b >> U64(32)
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = (p00 >> U64(32)) + (p01 & M32) + (p10 & M32)
    return a1 * b1 + (p01 >> U64(32)) + (p10 >> U64(32)) + (mid >> U64(32))


def _shoup_lazy(x, w, wp, q):
    """x w mod q up to one q, in [0, 2q)."""
    out = x * w - _umulhi(x, wp) * q
    assert (out < U64(2) * q).all()
    return out


def _shoup(x, w, wp, q):
    out = _shoup_lazy(x, w, wp, q)
    return np.where(out >= q, out - q, out)


def base_conv(src, dividend, src_table, dst_table, ls, ld, n):
    """mf_base_conv's arithmetic on numpy arrays: src [ls, n] int64,
    dividend [ld, n] or None, the tables [ls, 4] and [ld, 6 + 2 ls] as
    int64 words; returns out [ld, n] int64."""
    st, dt = (np.ascontiguousarray(t).view(U64) for t in (src_table, dst_table))
    assert st.shape == (ls, 4) and dt.shape == (ld, 6 + 2 * ls)
    rows = np.ascontiguousarray(src).view(U64).reshape(ls, n)
    rp = [_shoup(rows[l], st[l, 1], st[l, 2], st[l, 0]) for l in range(ls)]
    kf = None
    for l in range(ls):
        term = rp[l].astype(np.int64).astype(np.float64) * \
            st[l, 3:4].view(np.float64)[0]
        kf = term if kf is None else kf + term
    k = np.rint(kf).astype(np.int64).view(U64)
    out = np.empty((ld, n), dtype=U64)
    for t in range(ld):
        c = dt[t]
        r = c[0]
        acc = _shoup_lazy(k, c[2], c[3], r)
        for l in range(ls):
            term = _shoup_lazy(rp[l], c[6 + 2 * l], c[7 + 2 * l], r)
            assert (acc < U64(1 << 63) - term).all()    # lazily below 2^63
            acc = acc + term
        cr = acc - _umulhi(acc, c[1]) * r
        assert (cr < U64(2) * r).all()
        cr = np.where(cr >= r, cr - r, cr)
        if dividend is not None:
            y = np.ascontiguousarray(dividend).view(U64).reshape(ld, n)[t]
            cr = _shoup(np.where(y >= cr, y - cr, y + r - cr), c[4], c[5], r)
        out[t] = cr
    return out.view(np.int64)


def transcribed(ext, x, dst_slice=None, dividend=None):
    """ext.kernel's launch, with the transcription in place of the card."""
    lo, hi = (0, len(ext.dst)) if dst_slice is None else dst_slice
    rest = tuple(x.shape[1:])
    n = int(np.prod(rest, dtype=np.int64))
    out = base_conv(x.numpy(), None if dividend is None else dividend.numpy(),
                    ext._src_table.numpy(), ext._dst_table[lo:hi].numpy(),
                    len(ext.src), hi - lo, n)
    return torch.from_numpy(out).reshape((hi - lo,) + rest)


def _residues(moduli, shape, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [g.integers(0, int(q), size=shape, dtype=np.int64) for q in moduli]))


def _edge_residues(moduli):
    """Residues of M/2, M/3, M/4, 0 and M - 1 (+-EDGE) for M = prod(moduli):
    at M/2 the f64 quotient is K + 1/2 to the last bit, and half-even
    rounding decides the representative.  [Ls, 5 (2 EDGE + 1)]."""
    big_m = tks._prod(int(q) for q in moduli)
    ds = range(-EDGE, EDGE + 1)
    vals = [(c + d) % big_m for c in (big_m // 2, big_m // 3, big_m // 4, 0)
            for d in ds] + [(big_m - 1 - d) % big_m for d in ds]
    return torch.tensor([[v % int(q) for v in vals] for q in moduli],
                        dtype=torch.int64)


def _conversions(preset):
    """{name: (src, dst, divides)}: the digit groups to QP and ModDown P -> Q
    at `preset` (RelinContext's P), and at ref the rescale q_last -> rest."""
    p = get_params(preset)
    qs = tuple(int(q) for q in p.moduli)
    ps = tks._default_p_moduli(p)
    out = {f"digit{i}": ([qs[l] for l in g], qs + ps, False)
           for i, g in enumerate(tks._greedy_groups(qs, tks._prod(ps)))}
    out["moddown"] = (ps, qs, True)
    if preset == "ref":
        out["rescale"] = (qs[-1:], qs[:-1], True)
    return out


CASES = [(preset, name) for preset in ("mid", "ref")
         for name in _conversions(preset)]


@pytest.mark.parametrize("inputs", ["random", "edge"])
@pytest.mark.parametrize("preset,name", CASES)
def test_base_conv_transcription_matches_plain(preset, name, inputs):
    """extend, in full and in chunks of 3 targets (the chunks also == the
    plain version's target half, extend_from, on r' and k computed once),
    and its division where the conversion divides: the transcription ==
    the plain version bit for bit, on 4,096 random positions or the 20,485
    edge values."""
    src, dst, divides = _conversions(preset)[name]
    ext = BasisExtender(src, dst, "cpu")
    x = (_residues(src, (4096,), 31) if inputs == "random"
         else _edge_residues(src))
    assert torch.equal(transcribed(ext, x), ext.plain(x))
    rp, k = ext.scaled_residues(x)
    if inputs == "edge":
        assert len(np.unique(k.numpy())) > 1
    for lo in range(0, len(dst), 3):
        sl = (lo, min(lo + 3, len(dst)))
        got = transcribed(ext, x, sl)
        assert torch.equal(got, ext.plain(x, sl))
        assert torch.equal(got, ext.extend_from(rp, k, sl))
    if divides:
        y = _residues(dst, tuple(x.shape[1:]), 32)
        got = transcribed(ext, x, dividend=y)
        assert torch.equal(got, ext.plain(x, dividend=y))
        assert torch.equal(got, ext.extend(x, dividend=y))


def test_base_conv_wrapper_refuses_what_the_kernel_does_not_take():
    ext = BasisExtender(_conversions("ref")["digit0"][0],
                        _conversions("ref")["digit0"][1], "cpu")
    x = _residues(ext.src, (64,), 35)
    with pytest.raises(ValueError, match="target slice"):
        ext.kernel(x, dst_slice=(3, 3))
    with pytest.raises(ValueError, match="prime to every target"):
        ext.kernel(x, dividend=torch.zeros((len(ext.dst), 64),
                                           dtype=torch.int64))
    with pytest.raises(ValueError, match="expected"):
        ext.kernel(x[:2].contiguous())
    with pytest.raises(ValueError, match="not contiguous"):
        ext.kernel(x[:, ::2])
    wide = BasisExtender(tuple(ext.dst[:9]), (ext.dst[9],), "cpu")
    with pytest.raises(ValueError, match="source limbs"):
        wide.kernel(_residues(wide.src, (8,), 36))


@pytest.fixture
def kernel_route(monkeypatch):
    """rns_ext's wrappers take the kernel route on CPU tensors, with the
    transcription in place of mf_base_conv; every launch is counted in
    be.LAUNCHES under its key."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())

    def launch(key, fn_name, device, x, dividend, out, src_table, dst_table,
               ls, ld, n):
        assert fn_name == "mf_base_conv" and key == "base_conv"
        out.view(-1).copy_(torch.from_numpy(base_conv(
            x.numpy(), None if dividend is None else dividend.numpy(),
            src_table.numpy(), dst_table.numpy(), ls, ld, n)).view(-1))
        be.LAUNCHES[key] += 1

    monkeypatch.setattr(rns_ext, "be", types.SimpleNamespace(
        on_device=lambda *tensors: True, check=be.check, launch=launch))


def test_multiply_relinearize_launches_base_conv_per_digit_and_mod_down(
        kernel_route, monkeypatch):
    """A multiply_relinearize at tiny (three digits, two 28-bit P limbs)
    through the kernel route: one base_conv launch for each digit and each
    of the two ModDowns, no other extension, and the plain route's bits."""
    p = get_params("tiny")
    ctx = HEContext(p, ring="nega", device="cpu")
    rc = RelinContext(ctx, p_moduli=(268434721, 268433761))
    assert rc.dnum == 3
    gen = torch.Generator().manual_seed(5)
    s = torch.randint(0, 3, (p.phi, p.n), generator=gen) - 1
    s_res = torch.remainder(s[None], torch.tensor(p.moduli).reshape(-1, 1, 1))
    sk = SecretKey(mm.to_mont(ctx.xntt.forward(ctx.wt.forward(s_res)),
                              p.moduli))
    rlk = rc.gen_relin_key(s_res, gen)
    m1, m2 = (torch.randint(0, 1 << 20, (len(p.moduli), p.phi, p.n, p.n),
                            generator=gen) for _ in range(2))
    ct1, ct2 = ctx.encrypt(m1, sk), ctx.encrypt(m2, sk)
    own = be.Launches()
    with own:
        got = rc.multiply_relinearize(ct1, ct2, rlk)
    assert own.counts() == {"base_conv": rc.dnum + 2}
    monkeypatch.setattr(rns_ext, "be", be)            # the plain route
    want = rc.multiply_relinearize(ct1, ct2, rlk)
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_gl2_relinearize_extends_each_chunk_in_one_launch_a_digit(
        kernel_route, monkeypatch):
    """Gl2GemmRelin.relinearize at tiny (three digits, two 28-bit P limbs)
    in 1-limb QP chunks through the kernel route: for each of the two switched components, one base_conv
    launch a (chunk, digit) and one for its two ModDowns, and the plain
    route's bits."""
    p = get_params("tiny")
    ctx = Gl2Context(p, device="cpu")
    hm = HEMatmul2(ctx)
    gen = torch.Generator().manual_seed(3)
    sk = ctx.generate_secret_key(gen)
    rng = np.random.default_rng(41)
    cts = [ctx.encrypt(ctx.encode(*(torch.from_numpy(rng.uniform(
        -2, 2, (p.phi, p.n, p.n))) for _ in range(2))), sk, gen)
        for _ in range(2)]
    gr = Gl2GemmRelin(hm, RelinContext(ctx, p_moduli=(268434721, 268433761)),
                      chunk_limbs=1)
    keys = gr.gen_keys(sk, torch.Generator().manual_seed(9))
    tt = hm.matmul_tensor(*cts)
    own = be.Launches()
    with own:
        got = gr.relinearize(tt, keys)
    chunks = len(gr.rc.qp_moduli)
    assert chunks == len(gr._qp_chunks()) and gr.rc.dnum > 1
    assert own.counts() == {"base_conv": 2 * (chunks * gr.rc.dnum + 2)}
    monkeypatch.setattr(rns_ext, "be", be)            # the plain route
    want = gr.relinearize(tt, keys)
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_rescale_is_one_base_conv_launch_a_component(kernel_route,
                                                      monkeypatch):
    p = get_params("ref")
    rs = tks.Rescaler(p.moduli, "cpu")
    y = _residues(p.moduli, (2, 4, 4), 37)
    got = rs.rescale_component(y)
    assert be.LAUNCHES == {"base_conv": 1}
    monkeypatch.setattr(rns_ext, "be", be)
    assert torch.equal(got, rs.rescale_component(y))


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("preset,name", CASES)
def test_cuda_base_conv_matches_plain(cuda, preset, name):
    """The kernel == the plain version on [Ls, 8, 64, 64] (both vector
    widths: an even and an odd count of positions), the edge values, a
    dst_slice chunk, and the division."""
    src, dst, divides = _conversions(preset)[name]
    ext, dev_ext = BasisExtender(src, dst, "cpu"), BasisExtender(src, dst, cuda)
    for x in (_residues(src, (8, 64, 64), 38), _residues(src, (3, 5, 7), 39),
              _edge_residues(src)):
        assert torch.equal(dev_ext.extend(x.to(cuda)).cpu(), ext.extend(x))
        sl = (1, len(dst) - 1) if len(dst) > 2 else (0, 1)
        assert torch.equal(dev_ext.extend(x.to(cuda), sl).cpu(),
                           ext.extend(x, sl))
        if divides:
            y = _residues(dst, tuple(x.shape[1:]), 40)
            assert torch.equal(
                dev_ext.extend(x.to(cuda), dividend=y.to(cuda)).cpu(),
                ext.extend(x, dividend=y))
