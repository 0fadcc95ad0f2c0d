"""Port leveled chain (models/leveled.py) and debug meters (utils/debug.py)
against the JAX package.

With the JAX chain's keys installed by convert.leveled_keys, every step
of the depth-2 circuit (multiply, rescale, multiply after mod_switch,
rotate with one key and with the full Galois set) must give the JAX
ciphertext bit for bit, with the same levels and scales (tolerance 0).  The
port's own chain (keys from torch.Generators) is held to
examples/leveled.py's oracle bound, and the exact noise meter to the JAX
host version.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu.models.leveled import LeveledChain as JaxChain
from matrix_fhe_tpu.utils import debug as jdebug
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.models.keyswitch import w_automorphism_perm
from matrix_fhe_tpu_torch.models.leveled import LeveledChain
from matrix_fhe_tpu_torch.ops import modmath as tmm
from matrix_fhe_tpu_torch.utils import debug

J = 2   # the rotation of examples/leveled.py: the first unit above 1


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want))


def _lct_eq(got, want) -> None:
    assert (got.level, got.scale) == (want.level, want.scale)
    _eq(got.ct.b, want.ct.b)
    _eq(got.ct.a, want.ct.a)


def _coeffs(p, seed, bits):
    c = np.random.default_rng(seed).integers(0, 1 << bits, (p.phi, p.n, p.n))
    return np.stack([(c % int(q)).astype(np.uint64) for q in p.moduli])


@functools.lru_cache(maxsize=None)
def _jax_dance():
    """The depth-2 circuit on the JAX chain at tiny; its keys are made on
    the way."""
    jp = jax_params("tiny")
    jc = JaxChain(jp, ring="nega", key=jax.random.key(0))
    msgs = [np.asarray(jc.ctx(0).wt.forward(jnp.asarray(_coeffs(jp, s, 16))))
            for s in (1, 2)]
    x, y = (jc.encrypt(jnp.asarray(m)) for m in msgs)
    z = jc.multiply(x, y)
    zr = jc.rescale(z)
    w = jc.multiply(zr, jc.mod_switch(x, 1))
    steps = {"x": x, "z": z, "zr": zr, "w": w, "rot": jc.rotate(w, J),
             "rot_full": jc.rotate(w, J, full=True)}
    return jc, msgs, steps


def test_leveled_chain_matches_jax_with_converted_keys():
    jc, msgs, want = _jax_dance()
    chain = LeveledChain(get_params("tiny"), device="cpu")
    convert.leveled_keys(jc, chain)
    assert sorted(chain._rlk) == [0, 1]
    assert set(chain._gk) == {(1, J), ("full", 1)}
    x, y = (chain.encrypt(convert.residues(m)) for m in msgs)
    z = chain.multiply(x, y)
    zr = chain.rescale(z)
    w = chain.multiply(zr, chain.mod_switch(x, 1))
    got = {"x": x, "z": z, "zr": zr, "w": w, "rot": chain.rotate(w, J),
           "rot_full": chain.rotate(w, J, full=True)}
    for name in want:
        _lct_eq(got[name], want[name])
    assert w.level == 1 and w.ct.b.shape[0] == len(chain.base.moduli) - 1
    _eq(chain.decrypt_to_eval(got["rot"]),
        jc.decrypt_to_eval(want["rot"]))


def test_leveled_chain_guards():
    p = get_params("tiny")
    chain = LeveledChain(p, device="cpu")
    x = chain.encrypt(chain.ctx(0).wt.forward(convert.residues(
        _coeffs(p, 3, 12))))
    zr = chain.rescale(chain.multiply(x, x))
    assert zr.level == 1
    assert abs(zr.scale - p.delta ** 2 / p.moduli[-1]) < 1e-6 * zr.scale
    with pytest.raises(ValueError, match="level mismatch"):
        chain.multiply(zr, x)
    with pytest.raises(ValueError, match="scale mismatch"):
        chain.add(x, chain.multiply(x, x))
    with pytest.raises(ValueError, match="larger modulus"):
        chain.mod_switch(zr, 0)
    with pytest.raises(ValueError, match="outside chain"):
        chain.params_at(len(p.moduli))
    last = chain.mod_switch(x, chain.depth)
    with pytest.raises(ValueError, match="exhausted"):
        chain.rescale(last)
    with pytest.raises(ValueError, match="nega"):
        LeveledChain(p, ring="gl2", device="cpu")
    s = chain.add(x, x)
    assert s.scale == x.scale and s.level == 0
    plain = chain.ctx(0).wt.forward(convert.residues(_coeffs(p, 4, 8)))
    assert chain.multiply_plain(x, plain, 2.0).scale == 2 * x.scale
    assert torch.equal(chain.add_plain(x, plain).ct.a, x.ct.a)


def test_leveled_complex_pair_matches_jax():
    """encrypt_complex / multiply_complex / rescale_pair on the converted
    level-0 key == the JAX chain's, bit for bit."""
    jc, _, _ = _jax_dance()
    jp = jc.base
    ms = [np.asarray(jc.ctx(0).wt.forward(jnp.asarray(_coeffs(jp, s, 12))))
          for s in (5, 6, 7, 8)]
    ja = jc.encrypt_complex(jnp.asarray(ms[0]), jnp.asarray(ms[1]))
    jb = jc.encrypt_complex(jnp.asarray(ms[2]), jnp.asarray(ms[3]))
    jprod = jc.multiply_complex(ja, jb)
    jr = jc.rescale_pair(jprod)

    chain = LeveledChain(get_params("tiny"), device="cpu")
    convert.leveled_keys(jc, chain)
    a = chain.encrypt_complex(*(convert.residues(m) for m in ms[:2]))
    b = chain.encrypt_complex(*(convert.residues(m) for m in ms[2:]))
    prod = chain.multiply_complex(a, b)
    assert prod[0].scale == float(jp.delta) ** 2
    for got, want in zip(a + b + prod + chain.rescale_pair(prod),
                         ja + jb + jprod + jr):
        _lct_eq(got, want)


def test_decrypt_decode_complex_fresh_pair():
    """encrypt_complex of encoded matrices decodes at the pair's scale
    within test_keyswitch.py:703's bound, and to the JAX chain's floats
    within 1e-9 (both decode through exact composes; the f64 tail may
    round differently)."""
    p = get_params("tiny")
    rng = np.random.default_rng(9)
    re = rng.uniform(-2, 2, (p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, (p.phi, p.n, p.n))
    chain = LeveledChain(p, device="cpu")
    pr, pi = chain.ctx(0).batched_encoder.encode_to_wntt_eval(
        torch.from_numpy(re), torch.from_numpy(im))
    dr, di = chain.decrypt_decode_complex(chain.encrypt_complex(pr, pi))
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 0.2
    jc = JaxChain(jax_params("tiny"), ring="nega", key=jax.random.key(0))
    jdr, jdi = jc.decrypt_decode_complex(jc.encrypt_complex(
        jnp.asarray(pr.numpy().view(np.uint64)),
        jnp.asarray(pi.numpy().view(np.uint64))))
    np.testing.assert_allclose(dr.numpy(), np.asarray(jdr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(di.numpy(), np.asarray(jdi), rtol=0, atol=1e-9)


def test_own_chain_depth2_circuit_meets_the_oracle():
    """examples/leveled.py on the port's own keys at tiny: multiply,
    rescale, multiply with mod_switch(x, 1), rotate(j, full=True), decrypt,
    against the exact ring oracle, composed max below 2^40 (:86 there)."""
    p = get_params("tiny")
    chain = LeveledChain(p, seed=3, device="cpu")

    def msg(seed):
        return chain.ctx(0).wt.forward(convert.residues(_coeffs(p, seed, 16)))

    x, y = chain.encrypt(msg(10)), chain.encrypt(msg(11))
    zr = chain.rescale(chain.multiply(x, y))
    w = chain.rotate(chain.multiply(zr, chain.mod_switch(x, 1)), J, full=True)
    got = chain.decrypt_to_eval(w)
    c0, c1 = chain.ctx(0), chain.ctx(1)
    px = c0.decrypt_to_eval(x.ct, chain.sk(0))
    pz = c1.decrypt_to_eval(zr.ct, chain.sk(1))
    xn = c1.xntt
    want = xn.inverse(xn.forward_mul(px[:-1], xn.forward_mul(pz, c1._r2_tw)))
    want = want[:, torch.from_numpy(w_automorphism_perm(chain.params_at(1),
                                                        J))]
    mag = debug.composed_magnitude(c1, tmm.sub_mod(got, want, c1._q4))
    assert mag < 1 << 40
    assert w.level == 1 and w.scale == zr.scale * x.scale


# -- utils/debug.py -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _contexts():
    return (JaxContext(jax_params("tiny"), ring="nega"),
            HEContext(get_params("tiny"), device="cpu"))


@pytest.mark.parametrize("bits", [8, 40, None])
def test_composed_magnitude_matches_jax_host_version(bits):
    """The exact device compose == the JAX host big-int compose, on small
    limb-consistent elements and on full-range residues (exact)."""
    jctx, ctx = _contexts()
    p = ctx.params
    if bits is None:
        rng = np.random.default_rng(12)
        x = np.stack([rng.integers(0, int(q), (p.phi, p.n, p.n),
                                   dtype=np.uint64) for q in p.moduli])
    else:                           # signed coefficients, |c| < 2^bits
        c = np.random.default_rng(12).integers(-(1 << bits), 1 << bits,
                                               (p.phi, p.n, p.n))
        x = np.asarray(jctx.wt.forward(jnp.asarray(np.stack(
            [(c % int(q)).astype(np.uint64) for q in p.moduli]))))
    want = jdebug.composed_magnitude(jctx, jnp.asarray(x))
    assert debug.composed_magnitude(ctx, convert.residues(x)) == want


def test_debug_counts_and_checks_match_jax():
    jctx, ctx = _contexts()
    assert debug.check_moduli(ctx) and jdebug.check_moduli(jctx)
    rng = np.random.default_rng(13)
    x = rng.integers(0, 3, (5, 7)) * rng.integers(0, 2, (5, 7))
    words = rng.integers(0, 2, (6, 4)) * (rng.integers(0, 3, (6, 4)) == 0)
    assert debug.count_nonzero(torch.from_numpy(x)) == \
        jdebug.count_nonzero(jnp.asarray(x))
    assert debug.count_over_i64(torch.from_numpy(words)) == \
        jdebug.count_over_i64(jnp.asarray(words))
    bad = types.SimpleNamespace(params=ctx.params, _q4=ctx._q4 + 2,
                                wt=ctx.wt, xntt=ctx.xntt)
    assert not debug.check_moduli(bad)


def test_noise_magnitude_matches_jax():
    jctx, ctx = _contexts()
    p = ctx.params
    m = np.asarray(jctx.wt.forward(jnp.asarray(_coeffs(p, 14, 20))))
    jsk = jctx.generate_secret_key()
    jct = jctx.encrypt(jnp.asarray(m), jsk)
    want = jdebug.noise_magnitude(jctx, jct, jsk, m)
    got = debug.noise_magnitude(ctx, convert.ciphertext(jct),
                                convert.secret_key(jsk), convert.residues(m))
    assert got == want and 0 < got < 64
