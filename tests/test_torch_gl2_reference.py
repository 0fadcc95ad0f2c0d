"""The port's gl2 ciphertext-out GEMM (Gl2Context, HEMatmul2, Gl2GemmRelin)
held to the benchmark's plain reference (fhebench/reference/gl2.py, plain
torch) at tiny on the CPU, keyed as the ref_gl2.gemm cell keys it
(fhebench/kinds/gl2gemm.py); the reference's own identities; and the
GEMM's spans.
"""

import functools
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_workers  # noqa: F401
from fhebench.kinds import gl2gemm
from fhebench.reference.gl2 import Gl2Ring
from fhebench.reference.scheme import Codec, max_abs
from fhebench.tests.tiny import TINY, traffic
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin
from matrix_fhe_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE_LIMIT = TINY["precision"]["relin_noise"]
ERR_LIMIT = TINY["precision"]["matmul_max_abs_err"]
RT_LIMIT = TINY["precision"]["roundtrip_max_abs_err"]
DELTA = 2.0 ** TINY["delta_bits"]


@functools.lru_cache(maxsize=None)
def _setup():
    """The cell's set-up at tiny (secret, switch keys, a pool of 4
    ciphertexts of complex uniform(-1, 1) messages), the reference's ring
    and its secret's product matrices."""
    st = gl2gemm.setup(TINY, traffic("gl2gemm"), 2 ** 31 + 5, "cpu")
    ring = Gl2Ring(TINY["moduli"], TINY["n"], TINY["p"], "cpu")
    return st, ring, ring.secret(st["s"])


def _decrypt(ring, s_mat, ct):
    return ring.decrypt(ct.b, ct.a, s_mat)


def _product(x, y):
    return y.conj().transpose(-1, -2) @ x


def _messages(st, k):
    return torch.complex(*(torch.from_numpy(v) for v in st["msgs"][k]))


@pytest.mark.parametrize("k", [0, 3])
def test_reference_decrypt_is_the_programs(k):
    st, ring, s_mat = _setup()
    ct = st["pool"][k]
    sk = gl2gemm.secret_key2(st["ctx"], st["s"])
    want = st["ctx"].decrypt_to_eval(ct, sk)
    assert torch.equal(_decrypt(ring, s_mat, ct), want)


@pytest.mark.parametrize("kx", [0, 2])
def test_reference_owed_is_the_programs_opening(kx):
    """The reference's owed plaintext of the decrypted inputs is
    HEMatmul2.decrypt_tensor_fn of the tensor, bit for bit."""
    st, ring, s_mat = _setup()
    hm, pool = st["gr"].hm, st["pool"]
    ct_x, ct_y = pool[kx], pool[(kx + 3) % len(pool)]
    sk = gl2gemm.secret_key2(st["ctx"], st["s"])
    want = hm.decrypt_tensor_fn(hm.tensor_fn(ct_x, ct_y), sk)
    got = ring.owed(_decrypt(ring, s_mat, ct_x), _decrypt(ring, s_mat, ct_y))
    assert torch.equal(got, want)


def test_reference_decodes_its_plaintexts():
    """The reference's decode of a fresh encryption gives its messages
    within the fresh noise, and the Delta^2 decode of the owed plaintext
    is the product of the decoded inputs (the reference's exact trace
    GEMM, with no key switch in between)."""
    st, ring, s_mat = _setup()
    m = [_decrypt(ring, s_mat, ct) for ct in st["pool"][:2]]
    codec = Codec(TINY["n"], TINY["p"], DELTA, "cpu")
    d = [ring.decode(x, codec) for x in m]
    for k in (0, 1):
        assert max_abs(d[k] - _messages(st, k)) < RT_LIMIT
    codec2 = Codec(TINY["n"], TINY["p"], DELTA * DELTA, "cpu")
    assert max_abs(ring.decode(ring.owed(*m), codec2)
                   - _product(*d)) < 1e-9


def test_reference_sigma_is_an_involution():
    st, ring, s_mat = _setup()
    z = _decrypt(ring, s_mat, st["pool"][1])
    assert not torch.equal(ring.sigma(z), z)
    assert torch.equal(ring.sigma(ring.sigma(z)), z)


@pytest.mark.parametrize("kx", [0, 1])
def test_gemm_meets_the_reference(kx):
    """Gl2GemmRelin.matmul: dec(C) less the owed plaintext is the key
    switch's noise, small and not zero; the Delta^2 decode of dec(C) meets
    Y^H X and is the program's own decode."""
    st, ring, s_mat = _setup()
    pool = st["pool"]
    ky = (kx + 3) % len(pool)
    out = st["gr"].matmul(pool[kx], pool[ky], st["keys"])
    m_x, m_y = (_decrypt(ring, s_mat, pool[k]) for k in (kx, ky))
    got = _decrypt(ring, s_mat, out)
    diff = (got - ring.owed(m_x, m_y)) % ring.q(got.dim())
    noise = max_abs(ring.composed(diff))
    assert 0 < noise < NOISE_LIMIT
    codec2 = Codec(TINY["n"], TINY["p"], DELTA * DELTA, "cpu")
    c = ring.decode(got, codec2)
    assert max_abs(c - _product(_messages(st, kx), _messages(st, ky))) \
        < ERR_LIMIT
    sk = gl2gemm.secret_key2(st["ctx"], st["s"])
    re, im = st["ctx"].decrypt_and_decode(out, sk,
                                          delta_override=DELTA * DELTA)
    assert max_abs(c - torch.complex(re, im)) < 1e-9
    # one residue changed in one limb reads near half of Q
    bad = got.clone()
    bad[1, 0, 0, 0] = (bad[1, 0, 0, 0] + 1) % ring.moduli[1]
    assert max_abs(ring.composed(
        (bad - ring.owed(m_x, m_y)) % ring.q(got.dim()))) > 2.0 ** 50


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiler.records()


@pytest.mark.parametrize("chunk_limbs", [None, 2])
def test_gemm_spans(chunk_limbs):
    """gl2.tensor and gl2.relin are roots; gl2.relin_chunk nests under
    gl2.relin and gl2.key_products under gl2.relin_chunk, dnum + 1 a chunk
    and component (each digit's pair, index the digit, then the 2^-64
    factor); the output is the same bits as without the profiler."""
    st, _, _ = _setup()
    gr0 = st["gr"]
    gr = Gl2GemmRelin(gr0.hm, gr0.rc, chunk_limbs=chunk_limbs)
    x, y = st["pool"][0], st["pool"][3]
    want = gr0.matmul(x, y, st["keys"])
    got, recs = _profiled(lambda: gr.matmul(x, y, st["keys"]))
    assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)
    by_id = {r.id: r for r in recs}
    assert [r.name for r in recs if r.parent is None] == \
        ["gl2.tensor", "gl2.relin"]
    relin = next(r for r in recs if r.name == "gl2.relin")
    chunks = [r for r in recs if r.name == "gl2.relin_chunk"]
    n_chunks = len(gr._qp_chunks())
    assert n_chunks == (1 if chunk_limbs is None else 4)
    assert len(chunks) == 2 * n_chunks
    assert all(r.parent == relin.id for r in chunks)
    kp = [r for r in recs if r.name == "gl2.key_products"]
    dnum = gr.rc.dnum
    assert len(kp) == 2 * n_chunks * (dnum + 1)
    assert all(by_id[r.parent].name == "gl2.relin_chunk" for r in kp)
    for c in chunks:
        mine = [r.index for r in kp if r.parent == c.id]
        assert mine == list(range(dnum)) + [None]
    inner = [r for r in recs if r.name in ("rns.extend", "ks.mod_down")]
    assert inner and all(r.root == relin.id for r in inner)


def test_secret_key_is_the_contexts_from_the_same_sign():
    """The cell's SecretKey2 is what Gl2Context makes of the same ternary
    pattern: its residues through the W-CRT and the 2n-point X-NTT."""
    from matrix_fhe_tpu_torch.models.he2 import Gl2Context
    from matrix_fhe_tpu_torch.ops import modmath as mm
    st, _, _ = _setup()
    ctx = st["ctx"]
    sk = gl2gemm.secret_key2(ctx, st["s"])
    assert sk.s_sign.dtype == torch.int8
    assert sk.s_sign.shape == (ctx.params.phi, 2 * ctx.params.n)
    res = Gl2Context._ternary_residues(sk.s_sign, ctx.params.moduli)
    want = mm.to_mont(ctx.xntt.forward(ctx.wt.forward(res)),
                      ctx.params.moduli)
    assert torch.equal(sk.s_mont, want)


def test_reference_imports_nothing_of_the_programs():
    code = ("import sys, json\n"
            "from fhebench.reference import gl2\n"
            "r = gl2.Gl2Ring([1073742721], 8, 15, 'cpu')\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "matrix_fhe_tpu",
                       "matrix_fhe_tpu_torch"}
    assert "torch" in mods
