"""The port's example programs (matrix_fhe_tpu_torch.examples) against the
JAX package's examples/ at the tiny preset.

The JAX scripts are not run as processes; the same numpy inputs go through
the JAX functions those scripts call and through the port's example code.
Each run("tiny", device="cpu") must meet its JAX script's criterion, and
main(argv) must print the script's pass line and exit 0 (1 on a failed
check).  On the CPU every kernel runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu.models.he_matmul import HEMatmul as JaxHEMatmul
from matrix_fhe_tpu.ops import modmath as jmm
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.examples import (complex_pair, leveled, main, matmul,
                                           matmul_gl2, relinearize)
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.models.he_matmul import HEMatmul
from matrix_fhe_tpu_torch.utils.debug import relin_noise, ring_mul

EXAMPLES = {"main": main, "matmul": matmul, "matmul_gl2": matmul_gl2,
            "relinearize": relinearize, "leveled": leveled}


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, int(q), size=shape, dtype=np.uint64)
                     for q in moduli])


def test_main_steps_match_jax():
    """examples/main.py's flow (encode_to_wntt_eval, encrypt_pair,
    decrypt_and_decode on the parity key and streams) at tiny: the port's
    decoded output within 1e-9 of the JAX package's on the JAX script's
    own route (its default split-f32 transforms; 7.4e-10 apart here)."""
    jp = jax_params("tiny")
    jctx = JaxContext(jp)
    jsk = jctx.generate_secret_key()
    re, im = main.message(get_params("tiny"))
    pr, pi = jctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(re),
                                                      jnp.asarray(im))
    want = jctx.decrypt_and_decode(*jctx.encrypt_pair(pr, pi, jsk), jsk)
    ctx = HEContext(get_params("tiny"), device="cpu")
    got = main.steps(ctx, ctx.generate_secret_key(), torch.from_numpy(re),
                     torch.from_numpy(im))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)


def test_matmul_product_matches_jax():
    """examples/matmul.py at tiny on the JAX script's keys and ciphertexts
    (jax.random.key(3), key(11), key(12)), converted: the port's decoded
    C within 1e-9 of the JAX package's (its default route, as the script
    runs it), and within the script's 0.5 of Y^H X."""
    jp = jax_params("tiny")
    jctx = JaxContext(jp, ring="gl")
    jhm = JaxHEMatmul(jctx)
    A, B = complex_pair(get_params("tiny"))
    jsk = jctx.generate_secret_key(key=jax.random.key(3))
    jcts = []
    for M, k in ((A, 11), (B, 12)):
        pm = jctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(M.real),
                                                      jnp.asarray(M.imag))
        jcts.append(jctx.encrypt_pair(*pm, jsk, key=jax.random.key(k)))
    jr, ji = jhm.decrypt_and_decode(jhm.matmul(*jcts), jsk)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    hm = HEMatmul(HEContext(get_params("tiny"), ring="gl", device="cpu"))
    times = {}
    got = matmul.product(hm, *(tuple(convert.ciphertext(c) for c in ct)
                               for ct in jcts), convert.secret_key(jsk), times)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert set(times) == {"gemm_s", "decode_s"}
    assert np.abs(got - np.conj(np.swapaxes(B, 1, 2)) @ A).max() < 0.5


def test_ring_mul_is_the_jax_mont_mul_oracle():
    """utils.debug.ring_mul, the oracle of examples/leveled.py and the
    relinearization noise, equals the JAX scripts' xntt.inverse(mont_mul(
    to_mont(NTT a), NTT b)) bit for bit."""
    jp = jax_params("tiny")
    jctx = JaxContext(jp)
    ctx = HEContext(get_params("tiny"), device="cpu")
    a, b = (_residues(jp.moduli, (jp.phi, jp.n, jp.n), s) for s in (1, 2))
    c4 = jctx._c4
    ha = jctx.xntt.forward(jnp.asarray(a))
    hb = jctx.xntt.forward(jnp.asarray(b))
    want = jctx.xntt.inverse(jmm.mont_mul(
        jmm.to_mont(ha, c4["q"], c4["qinv_neg"], c4["r2"]), hb, c4["q"],
        c4["qinv_neg"]))
    got = ring_mul(ctx, convert.residues(a), convert.residues(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))


def test_relin_noise_is_the_jax_scripts_meter():
    """The noise meter of examples/relinearize.py (decrypt the three
    ciphertexts, subtract the ring product, W-CRT inverse, centered max at
    limb 0) on the same ciphertexts and parity key: the same integer."""
    jp = jax_params("tiny")
    jctx = JaxContext(jp)
    jsk = jctx.generate_secret_key()
    shape = (jp.phi, jp.n, jp.n)
    from matrix_fhe_tpu.models.he import Ciphertext as JaxCiphertext
    jcts = [JaxCiphertext(jnp.asarray(_residues(jp.moduli, shape, 2 * s)),
                          jnp.asarray(_residues(jp.moduli, shape, 2 * s + 1)))
            for s in range(3)]
    got = jctx.decrypt_to_eval(jcts[0], jsk)
    p1, p2 = (jctx.decrypt_to_eval(c, jsk) for c in jcts[1:])
    c4 = jctx._c4
    want = jctx.xntt.inverse(jmm.mont_mul(
        jmm.to_mont(jctx.xntt.forward(p1), c4["q"], c4["qinv_neg"], c4["r2"]),
        jctx.xntt.forward(p2), c4["q"], c4["qinv_neg"]))
    v = np.asarray(jctx.wt.inverse(jmm.sub_mod(got, want, c4["q"])))[0]
    v = v.astype(np.int64)
    q0 = int(jp.moduli[0])
    mag = int(np.abs(np.where(v > q0 // 2, v - q0, v)).max())
    ctx = HEContext(get_params("tiny"), device="cpu")
    assert relin_noise(ctx, *(convert.ciphertext(c) for c in jcts),
                       convert.secret_key(jsk)) == mag


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_run_meets_the_jax_criterion(name):
    """run("tiny", device="cpu") of every example meets its JAX script's
    pass criterion, and its launches are empty on the CPU (no kernel)."""
    mod = EXAMPLES[name]
    res = mod.run("tiny", device="cpu")
    assert res["ok"], res
    assert res["device"] == "cpu" and res["launches"] == {}
    limit = {"main": lambda r: r["max_err"] < r["tol"] == 0.5,
             "matmul": lambda r: r["err"] < r["tol"] == 0.5,
             "matmul_gl2": lambda r: r["err"] < 2 * r["base_err"] + 0.1,
             "relinearize": lambda r: r["noise"] < 1 << 25,
             "leveled": lambda r: r["oracle"] < 1 << 40 and r["level"] == 1}
    assert limit[name](res), res


@pytest.mark.parametrize("name,args,line", [
    ("main", [], "SUCCESS (threshold 0.5)"),
    ("matmul", [], "[matmul] PASS"),
    ("matmul_gl2", ["--auto-p"], "[gl2-gemm] OK"),
    ("relinearize", ["--auto-p"], "[relin] PASS"),
    ("leveled", [], "[leveled] |ct - oracle| composed max")])
def test_main_prints_the_scripts_lines(capsys, name, args, line):
    """main(argv) prints the JAX script's lines, one {"launches": ...}
    line and exits 0 (the gl2 and relinearize ones on the generated P
    basis, the JAX scripts' MFHE_AUTO_P=1)."""
    mod = EXAMPLES[name]
    assert mod.main(["tiny", "--device", "cpu", *args]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith(line) for ln in out), out
    assert sum(ln.startswith('{"launches": ') for ln in out) == 1


def test_a_failed_check_exits_1(monkeypatch, capsys):
    """A failed criterion is never caught into exit 0."""
    monkeypatch.setattr(main, "tolerance", lambda delta: 0.0)
    assert main.main(["tiny", "--device", "cpu"]) == 1
    assert capsys.readouterr().out.splitlines()[-1].startswith("FAILURE")
