"""Port HE scheme (matrix_fhe_tpu_torch.models.he) against the JAX package.

Keys and ciphertexts must match bit for bit, a JAX ciphertext converted
with matrix_fhe_tpu_torch.convert must decrypt in the port, and the whole
ref-path roundtrip must reproduce the JAX _roundtrip_pair_fn.
"""

import ast
import glob
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu_torch import convert, init_he_backend
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.ops.ntt import RING_GL, RING_NEGACYCLIC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _residues(p, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (p.phi, p.n, p.n), dtype=np.uint64)
                     for q in p.moduli])


def _t(x):
    return convert.residues(x)


def _message(p, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-4, 4, (p.phi, p.n, p.n)),
            rng.uniform(-4, 4, (p.phi, p.n, p.n)))


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_keygen_and_encrypt_pair_match_jax(ring):
    """s_mont and both ciphertexts (b, a) bit for bit."""
    p = get_params("tiny")
    jctx = JaxContext(jax_params("tiny"), ring=ring)
    ctx = HEContext(p, ring=ring, device="cpu")
    jsk, sk = jctx.generate_secret_key(), ctx.generate_secret_key()
    assert torch.equal(sk.s_mont, convert.secret_key(jsk).s_mont)
    m_re, m_im = _residues(p, 1), _residues(p, 2)
    jcts = jctx.encrypt_pair(jnp.asarray(m_re), jnp.asarray(m_im), jsk)
    cts = ctx.encrypt_pair(_t(m_re), _t(m_im), sk)
    for jct, ct in zip(jcts, cts):
        want = convert.ciphertext(jct)
        assert torch.equal(ct.b, want.b) and torch.equal(ct.a, want.a)


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_zero_noise_encrypt_decrypt_identity(ring):
    p = get_params("tiny")
    ctx = HEContext(p, ring=ring, zero_noise=True, device="cpu")
    sk = ctx.generate_secret_key()
    m_re, m_im = _t(_residues(p, 3)), _t(_residues(p, 4))
    ev_re, ev_im = ctx.decrypt_pair_to_eval(*ctx.encrypt_pair(m_re, m_im, sk),
                                            sk)
    assert torch.equal(ev_re, m_re) and torch.equal(ev_im, m_im)


def test_decrypt_jax_ciphertext():
    """A ciphertext and key made by the JAX package, converted, decrypt in
    the port to the JAX decryption and decode to the message."""
    jp = jax_params("tiny")
    jctx = JaxContext(jp)
    jsk = jctx.generate_secret_key()
    re, im = _message(jp, 5)
    pr, pi = jctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(re),
                                                      jnp.asarray(im))
    jct_re, jct_im = jctx.encrypt_pair(pr, pi, jsk)
    want = jctx.decrypt_pair_to_eval(jct_re, jct_im, jsk)

    ctx = HEContext(get_params("tiny"), device="cpu")
    sk = convert.secret_key(jsk)
    ct_re, ct_im = convert.ciphertext(jct_re), convert.ciphertext(jct_im)
    got = ctx.decrypt_pair_to_eval(ct_re, ct_im, sk)
    for g, w in zip(got, want):
        assert torch.equal(g, _t(w))
    dr, di = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    # tests/test_pipeline.py: 0.5 at tiny's Delta = 2^12
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 0.5


def test_roundtrip_matches_jax_roundtrip_pair_fn(monkeypatch):
    """The whole roundtrip at small against the JAX fast path
    (_roundtrip_pair_fn with interpret-mode Pallas kernels and the
    fixed-point transforms), bit for bit.  The JAX side gets exact powers
    of two: XLA:CPU's exp2 is off by an ulp at most integer exponents,
    which alone moves the decoded f64 output by ulps (see
    test_torch_encoder.test_decode_within_1e9_of_jax)."""
    monkeypatch.setenv("MFHE_FP_TRANSFORMS", "1")
    monkeypatch.setattr(jnp, "exp2", lambda e: jnp.ldexp(
        jnp.ones_like(e), e.astype(jnp.int32)))
    jp = jax_params("small")
    jctx = JaxContext(jp, use_pallas=True, fast_float=True)
    jsk = jctx.generate_secret_key()
    re, im = _message(jp, 3)
    want = jctx._roundtrip_pair_fn(jnp.asarray(re), jnp.asarray(im), jsk)

    ctx = HEContext(get_params("small"), device="cpu")
    got = ctx.roundtrip(torch.from_numpy(re), torch.from_numpy(im),
                        ctx.generate_secret_key())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.hypot(got[0].numpy() - re, got[1].numpy() - im).max() < 0.05


def test_step_api_equals_roundtrip():
    p = get_params("tiny")
    ctx = init_he_backend("tiny", device="cpu")
    assert init_he_backend("tiny", device="cpu") is ctx
    sk = ctx.generate_secret_key()
    re, im = (torch.from_numpy(x) for x in _message(p, 6))
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    steps = ctx.decrypt_and_decode(*ctx.encrypt_pair(pr, pi, sk), sk)
    fused = ctx.roundtrip(re, im, sk)
    assert torch.equal(steps[0], fused[0]) and torch.equal(steps[1], fused[1])


def test_fresh_randomness_pipeline():
    p = get_params("tiny")
    ctx = HEContext(p, device="cpu")
    gen = torch.Generator().manual_seed(42)
    sk = ctx.generate_secret_key(gen)
    assert not torch.equal(sk.s_mont, ctx.generate_secret_key().s_mont)
    re, im = (torch.from_numpy(x) for x in _message(p, 7))
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    ct_re, ct_im = ctx.encrypt_pair(pr, pi, sk, generator=gen)
    assert torch.equal(ct_re.a, ct_im.a)
    dr, di = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    assert np.hypot((dr - re).numpy(), (di - im).numpy()).max() < 0.5


def test_package_never_imports_jax():
    """Every module of the port imports no JAX and nothing of the JAX
    package, and a run of the package opens and compiles no file under
    matrix_fhe_tpu/ (an audit hook watches every open and subprocess)."""
    code = ("import os, sys\n"
            "bad_files = []\n"
            "jax_dir = os.path.join(os.getcwd(), 'matrix_fhe_tpu') + os.sep\n"
            "def hook(event, args):\n"
            "    if event in ('open', 'subprocess.Popen') and jax_dir in str(args):\n"
            "        bad_files.append((event, str(args)[:200]))\n"
            "sys.addaudithook(hook)\n"
            "import matrix_fhe_tpu_torch as m\n"
            "from matrix_fhe_tpu_torch import convert\n"
            "from matrix_fhe_tpu_torch.native import tablegen\n"
            "from matrix_fhe_tpu_torch.ops import ntt_large, crt, gint, cgemm, "
            "rns_ext, probes\n"
            "from matrix_fhe_tpu_torch.models import trace, he_matmul, he2, "
            "he_matmul2, keyswitch, leveled\n"
            "from matrix_fhe_tpu_torch.utils import debug, timer, profiler, "
            "serialization, logging\n"
            "from matrix_fhe_tpu_torch.native import golden\n"
            "from matrix_fhe_tpu_torch.scripts import micro_vpu, "
            "micro_coissue, ks_phases, rt_phases, bench_dist\n"
            "from matrix_fhe_tpu_torch.parallel import launch, multihost, "
            "mesh, dist_ntt, pipeline, keyswitch, gl2\n"
            "from matrix_fhe_tpu_torch.examples import main, matmul, "
            "matmul_gl2, relinearize, leveled\n"
            "from matrix_fhe_tpu_torch.scripts import bench\n"
            "from matrix_fhe_tpu_torch import entry\n"
            "tablegen.available()\n"
            "assert golden.available()\n"
            "ctx = m.init_he_backend('tiny', device='cpu')\n"
            "ctx.generate_secret_key()\n"
            "m.HEMatmul(m.init_he_backend('tiny', ring='gl', device='cpu'))\n"
            "gr = m.Gl2GemmRelin(m.HEMatmul2(m.Gl2Context(m.get_params('tiny'), "
            "device='cpu')))\n"
            "import torch\n"
            "g2 = gr.ctx.generate_secret_key(torch.Generator().manual_seed(1))\n"
            "m.Gl2Conj(gr.hm, gr.rc, g2, torch.Generator().manual_seed(2))\n"
            "chain = m.LeveledChain(m.get_params('tiny'), device='cpu')\n"
            "chain.rc(1)\n"
            "bad = [k for k in sys.modules "
            "if k == 'jax' or k.startswith(('jax.', 'matrix_fhe_tpu.')) "
            "or k == 'matrix_fhe_tpu']\n"
            "assert not bad, bad\n"
            "assert not bad_files, bad_files\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _program_strings(path):
    """String constants of a Python file outside its docstrings."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_names_no_file_of_the_jax_package():
    """No port file and not chip_smoke.py names a path under
    matrix_fhe_tpu/ that it could open or compile: its program strings
    hold no such path (a "file.py:line" citation of the reference is fine)
    and no CUDA or C++ source includes one."""
    port = os.path.join(ROOT, "matrix_fhe_tpu_torch")
    cite = re.compile(r"matrix_fhe_tpu/[\w/]+\.py:\d+(-\d+)?")
    py = glob.glob(os.path.join(port, "**", "*.py"), recursive=True)
    assert len(py) > 20
    for path in py + [os.path.join(ROOT, "chip_smoke.py")]:
        for s in _program_strings(path):
            assert s != "matrix_fhe_tpu", path
            for m in re.finditer(r"matrix_fhe_tpu/\S*", s):
                assert cite.fullmatch(m.group(0).rstrip(",;)")), (path, s)
    for ext in ("cu", "cuh", "cpp"):
        for path in glob.glob(os.path.join(port, "**", "*." + ext),
                              recursive=True):
            for line in open(path):
                assert not (line.startswith("#include")
                            and "matrix_fhe_tpu/" in line), (path, line)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line on a host
    without CUDA, from the repo and from a directory holding only it."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script],
                              cwd=os.path.dirname(script),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_cuda_backend_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_he_backend("tiny", device="cuda")


@pytest.mark.parametrize("entry", ["init_he_backend", "HEContext",
                                   "Gl2Context", "FourStepNTT",
                                   "LeveledChain", "examples.main",
                                   "examples.matmul", "examples.matmul_gl2",
                                   "examples.relinearize", "examples.leveled",
                                   "scripts.bench", "entry.entry",
                                   "entry.dryrun_multichip"])
def test_entry_points_default_to_the_card(entry):
    """Without a device argument every public entry point (the examples'
    run, the bench and the top-level entry points too) runs on the card, so
    on a host without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    import matrix_fhe_tpu_torch as m
    from matrix_fhe_tpu_torch import entry as m_entry
    from matrix_fhe_tpu_torch.examples import (leveled, main, matmul,
                                               matmul_gl2, relinearize)
    from matrix_fhe_tpu_torch.ops import ntt_large
    from matrix_fhe_tpu_torch.scripts import bench

    p = get_params("tiny")
    build = {"init_he_backend": lambda: m.init_he_backend("tiny"),
             "HEContext": lambda: m.HEContext(p),
             "Gl2Context": lambda: m.Gl2Context(p),
             "FourStepNTT": lambda: ntt_large.FourStepNTT(
                 ntt_large.FourStepPlan.make(64, ntt_large.generate_primes_1mod(
                     1, 35, 128))),
             "LeveledChain": lambda: m.LeveledChain(p),
             "scripts.bench": lambda: bench.run(batch=2, iters=2),
             "entry.entry": lambda: m_entry.entry(),
             "entry.dryrun_multichip": lambda: m_entry.dryrun_multichip(2)}
    build.update({f"examples.{name}": (lambda mod=mod: mod.run("tiny"))
                  for name, mod in (("main", main), ("matmul", matmul),
                                    ("matmul_gl2", matmul_gl2),
                                    ("relinearize", relinearize),
                                    ("leveled", leveled))})
    build = build[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
