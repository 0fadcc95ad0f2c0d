"""Port utils/ (serialization, timer, profiler, logging) against the JAX
package.

Checkpoints share one file format: the same .npz keys, uint64 arrays and
params fingerprint, so a file written by either package loads into either
one; keys come back through the port's from_keys constructors and apply as
the originals did.  Timer and benchmark run on the CPU clock here.
"""

import dataclasses
import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import keyswitch as jks
from matrix_fhe_tpu.models import rng as jrng
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu.models.he_matmul import MatmulTensor as JaxMatmulTensor
from matrix_fhe_tpu.utils import serialization as jser
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import generate_ntt_primes, get_params
from matrix_fhe_tpu_torch.models import keyswitch as tks
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.utils import serialization as ser

PRESET = "tiny"
KINDS = ["ciphertext", "secret_key", "matmul_tensor", "relin_key", "galois_w",
         "galois_x", "galois_full"]
J_W, K_X = 2, 3          # the W and X automorphism indices


def _tensors(obj):
    """Every residue tensor / array of a saved object, in a fixed order."""
    if isinstance(obj, (tks.GaloisKeys, tks.XGaloisKeys, jks.GaloisKeys,
                        jks.XGaloisKeys)):
        return [x for j in sorted(obj._keys)
                for x in obj._keys[j].b + obj._keys[j].a]
    if isinstance(obj, (tks.FullGaloisKeys, jks.FullGaloisKeys)):
        return _tensors(obj._gk)
    if hasattr(obj, "b") and isinstance(obj.b, tuple):      # RelinKey
        return list(obj.b + obj.a)
    return list(obj)


def _same(got, want) -> None:
    """Port tensors (or JAX arrays) == JAX arrays (or port tensors)."""
    def u64(x):
        if isinstance(x, torch.Tensor):
            return x.numpy().view(np.uint64)
        return np.asarray(x)
    g, w = _tensors(got), _tensors(want)
    assert len(g) == len(w) and g
    for a, b in zip(g, w):
        np.testing.assert_array_equal(u64(a), u64(b))


@functools.lru_cache(maxsize=None)
def _jax_objects():
    """Every checkpointable JAX object at tiny, and its RelinContext."""
    p = jax_params(PRESET)
    ctx = JaxContext(p, ring="nega")
    rc = jks.RelinContext(ctx)
    sk = ctx.generate_secret_key()
    s = jnp.asarray(jrng.ternary_secret(p))
    rng = np.random.default_rng(3)
    m = jnp.asarray(np.stack([rng.integers(0, 1 << 20, (p.phi, p.n, p.n))
                              .astype(np.uint64) for _ in p.moduli]))
    tt = JaxMatmulTensor(*(jnp.asarray(np.stack(
        [rng.integers(0, int(q), (p.phi, p.n, p.n), dtype=np.uint64)
         for q in p.moduli])) for _ in JaxMatmulTensor._fields))
    objs = {"ciphertext": ctx.encrypt(m, sk), "secret_key": sk,
            "matmul_tensor": tt,
            "relin_key": rc.gen_relin_key(s, jax.random.key(5)),
            "galois_w": jks.GaloisKeys(rc, s, [J_W], jax.random.key(31)),
            "galois_x": jks.XGaloisKeys(rc, s, [K_X], jax.random.key(32)),
            "galois_full": jks.FullGaloisKeys(rc, s, jax.random.key(52))}
    return p, rc, objs


@pytest.fixture(scope="module")
def port_rc():
    return tks.RelinContext(HEContext(get_params(PRESET), device="cpu"))


def _convert(kind, obj, rc):
    return {"ciphertext": lambda: convert.ciphertext(obj),
            "secret_key": lambda: convert.secret_key(obj),
            "matmul_tensor": lambda: convert.matmul_tensor(obj),
            "relin_key": lambda: convert.relin_key(obj),
            "galois_w": lambda: convert.galois_keys(obj, rc),
            "galois_x": lambda: convert.x_galois_keys(obj, rc),
            "galois_full": lambda: convert.full_galois_keys(obj, rc)}[kind]()


def _save(mod, kind, path, obj, params, rc):
    """save_* of module `mod` (either package's serialization)."""
    if kind in ("ciphertext", "secret_key", "matmul_tensor"):
        getattr(mod, f"save_{kind}")(path, obj, params)
    elif kind == "relin_key":
        mod.save_relin_key(path, obj, rc)
    elif kind == "galois_full":
        mod.save_full_galois_keys(path, obj)
    else:
        mod.save_galois_keys(path, obj)


def _load(mod, kind, path, params, rc, **dev):
    loader = {"galois_w": "load_galois_keys", "galois_x": "load_x_galois_keys",
              "galois_full": "load_full_galois_keys"}.get(kind, f"load_{kind}")
    if kind in ("ciphertext", "secret_key", "matmul_tensor"):
        return getattr(mod, loader)(path, params, **dev)
    return getattr(mod, loader)(path, rc)


# -- fingerprint ---------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "small", "ref"])
def test_params_fingerprint_matches_jax(preset):
    assert ser.params_fingerprint(get_params(preset)) == \
        jser.params_fingerprint(jax_params(preset))


@pytest.mark.parametrize("preset", ["tiny", "small", "ref"])
def test_ext_params_fingerprint_matches_jax(preset):
    """The QP ext_params of a RelinContext (tiny, small: both packages'
    contexts; ref: the same replace of the preset by its P basis, without
    building the QP tables)."""
    if preset == "ref":
        tp, jp = get_params(preset), jax_params(preset)
        ext_t = dataclasses.replace(
            tp, name="ref-qp", moduli=tp.moduli + tks._default_p_moduli(tp),
            p_moduli=())
        ext_j = dataclasses.replace(
            jp, name="ref-qp", moduli=jp.moduli + jks._default_p_moduli(jp),
            p_moduli=())
    else:
        ext_t = tks.RelinContext(
            HEContext(get_params(preset), device="cpu")).ext_params
        ext_j = jks.RelinContext(JaxContext(jax_params(preset))).ext_params
    assert ser.params_fingerprint(ext_t) == jser.params_fingerprint(ext_j)


# -- the file format, both ways --------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_port_roundtrip(kind, port_rc, tmp_path):
    """Port save -> port load: the same tensors, on the asked device."""
    p, _, objs = _jax_objects()
    obj = _convert(kind, objs[kind], port_rc)
    path = str(tmp_path / f"{kind}.npz")
    _save(ser, kind, path, obj, port_rc.ctx.params, port_rc)
    got = _load(ser, kind, path, port_rc.ctx.params, port_rc, device="cpu")
    assert type(got) is type(obj)
    for a, b in zip(_tensors(got), _tensors(obj)):
        assert a.dtype == torch.int64 and a.device.type == "cpu"
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_loads_in_port(kind, port_rc, tmp_path):
    """A file written by the JAX package loads in the port and equals
    convert.* of the JAX object."""
    p, jrc, objs = _jax_objects()
    path = str(tmp_path / f"{kind}.npz")
    _save(jser, kind, path, objs[kind], p, jrc)
    got = _load(ser, kind, path, port_rc.ctx.params, port_rc, device="cpu")
    want = _convert(kind, objs[kind], port_rc)
    for a, b in zip(_tensors(got), _tensors(want)):
        assert torch.equal(a, b)
    _same(got, objs[kind])


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_in_jax(kind, port_rc, tmp_path):
    """A file written by the port loads in the JAX package and equals the
    JAX object the port's was converted from."""
    p, jrc, objs = _jax_objects()
    path = str(tmp_path / f"{kind}.npz")
    _save(ser, kind, path, _convert(kind, objs[kind], port_rc),
          port_rc.ctx.params, port_rc)
    _same(_load(jser, kind, path, p, jrc), objs[kind])


def test_loaded_galois_keys_apply_as_the_originals(port_rc, tmp_path):
    """W, X and full Galois keys restored from JAX files rotate a port
    ciphertext exactly as the converted originals do (tables re-derived,
    no keygen)."""
    p, jrc, objs = _jax_objects()
    ctx = port_rc.ctx
    ct = convert.ciphertext(objs["ciphertext"])
    for kind, idx in (("galois_w", J_W), ("galois_x", K_X),
                      ("galois_full", J_W)):
        path = str(tmp_path / f"{kind}.npz")
        _save(jser, kind, path, objs[kind], p, jrc)
        got = _load(ser, kind, path, ctx.params, port_rc).apply(ct, idx)
        want = _convert(kind, objs[kind], port_rc).apply(ct, idx)
        assert torch.equal(got.b, want.b) and torch.equal(got.a, want.a)


def test_mismatch_raises_the_jax_errors(port_rc, tmp_path):
    """A fingerprint mismatch (same Q, another P basis) and a wrong-kind
    loader raise the JAX package's ValueErrors, messages and all."""
    p, jrc, objs = _jax_objects()
    ctx = port_rc.ctx
    path = str(tmp_path / "rlk.npz")
    ser.save_relin_key(path, convert.relin_key(objs["relin_key"]), port_rc)
    cand = generate_ntt_primes(len(p.moduli) + 6, 33, p.n, p.p)
    other = [q for q in cand if q not in p.moduli][:3]
    rc2 = tks.RelinContext(ctx, p_moduli=other)
    jrc2 = jks.RelinContext(jrc.ctx, p_moduli=other)
    errs = []
    for mod, rc in ((ser, rc2), (jser, jrc2)):
        with pytest.raises(ValueError, match="checkpoint was written") as e:
            mod.load_relin_key(path, rc)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    q_path = str(tmp_path / "ct.npz")
    ser.save_ciphertext(q_path, convert.ciphertext(objs["ciphertext"]),
                        ctx.params)
    with pytest.raises(ValueError, match="checkpoint was written"):
        ser.load_ciphertext(q_path, get_params("small"), device="cpu")

    for kind, wrong, right in (("galois_x", "galois_w", "load_x_galois_keys"),
                               ("galois_full", "galois_w",
                                "load_full_galois_keys"),
                               ("galois_w", "galois_full",
                                "load_galois_keys")):
        path = str(tmp_path / f"{kind}.npz")
        _save(ser, kind, path, _convert(kind, objs[kind], port_rc),
              ctx.params, port_rc)
        errs = []
        for mod, rc in ((ser, port_rc), (jser, jrc)):
            with pytest.raises(ValueError, match=right) as e:
                _load(mod, wrong, path, ctx.params, rc)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_save_galois_keys_takes_a_full_set(port_rc, tmp_path):
    """save_galois_keys on a FullGaloisKeys writes the 'w-full' file."""
    _, _, objs = _jax_objects()
    fk = _convert("galois_full", objs["galois_full"], port_rc)
    path = str(tmp_path / "fk.npz")
    ser.save_galois_keys(path, fk)
    assert str(np.load(path)["kind"]) == "w-full"
    _same(ser.load_full_galois_keys(path, port_rc), fk)


def test_loaders_default_to_the_card(tmp_path):
    """Ciphertext and secret-key loaders take device="cuda" unless asked,
    and raise without a card, as every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = get_params(PRESET)
    sk = HEContext(p, device="cpu").generate_secret_key()
    path = str(tmp_path / "sk.npz")
    ser.save_secret_key(path, sk, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        ser.load_secret_key(path, p)
    assert torch.equal(ser.load_secret_key(path, p, device="cpu").s_mont,
                       sk.s_mont)


# -- timer, profiler, logging ------------------------------------------------------

def test_timer_sections_on_cpu():
    from matrix_fhe_tpu_torch.utils.timer import Timer

    t = Timer()
    x = torch.ones(64, 64)
    for _ in range(2):
        with t.section("matmul", fence=x):
            y = x @ x
    with t.section("nothing"):
        pass
    assert t.counts == {"matmul": 2, "nothing": 1}
    assert t.totals["matmul"] > 0 and y.shape == x.shape
    rep = t.report().splitlines()
    assert rep[0].startswith("matmul: ") and rep[0].endswith("(2 calls)")
    assert rep[1].startswith("nothing: ")


def test_benchmark_on_cpu():
    from matrix_fhe_tpu_torch.utils.timer import benchmark

    calls = []

    def f(a, b):
        calls.append(1)
        return a @ b

    x = torch.ones(32, 32, dtype=torch.float64)
    s = benchmark(f, x, x, iters=4, warmup=2)
    assert len(calls) == 6 and 0 < s < 1
    assert benchmark(f, x, x, iters=3, warmup=0) > 0 and len(calls) == 9


def test_host_clock_fences_cuda_work(monkeypatch):
    """An output that holds no tensor (here an object, as a Gl2Conj would
    be) is timed by the host clock, and where CUDA is in use that clock is
    fenced by a synchronize before and after, in benchmark and in an
    unfenced Timer.section alike."""
    from matrix_fhe_tpu_torch.utils.timer import Timer, benchmark

    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    made = []

    def build():
        made.append(object())
        return made[-1]

    assert benchmark(build, iters=3, warmup=1) > 0 and len(made) == 4
    assert len(syncs) == 2
    t = Timer()
    with t.section("build"):
        build()
    assert len(syncs) == 4 and t.counts == {"build": 1}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert benchmark(build, iters=2, warmup=0) > 0 and len(syncs) == 4


def test_profiler_trace_holds_the_annotation(tmp_path):
    from matrix_fhe_tpu_torch.utils import profiler

    logdir = str(tmp_path / "trace")
    with profiler.trace(logdir) as d:
        with profiler.annotate("roundtrip"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    assert d == logdir
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(os.path.join(logdir, files[0])))["traceEvents"]
    assert any(e.get("name") == "roundtrip" for e in events)


def test_get_logger_has_one_handler(monkeypatch):
    from matrix_fhe_tpu_torch.utils.logging import get_logger

    monkeypatch.setenv("MATRIX_FHE_LOG", "DEBUG")
    name = "test-torch-utils"
    logging.getLogger(f"matrix_fhe_tpu_torch.{name}").handlers.clear()
    log = get_logger(name)
    assert get_logger(name) is log and len(log.handlers) == 1
    assert log.name == f"matrix_fhe_tpu_torch.{name}"
    assert log.level == logging.DEBUG and not log.propagate


def test_rt_phases_table_on_cpu():
    """scripts/rt_phases at tiny on the CPU: every phase timed, their sum,
    the fused roundtrip, and the roundtrip's error as a direct call gives
    it."""
    from matrix_fhe_tpu_torch import init_he_backend
    from matrix_fhe_tpu_torch.scripts import rt_phases

    out = rt_phases.run("tiny", 1, device="cpu")
    assert list(out["phase_ms"]) == [
        "encode", "mul_s (a*s, shared by encrypt and decrypt)",
        "combine (b and ev adds)", "decode"]
    assert all(v > 0 for v in out["phase_ms"].values()) and out["fused_ms"] > 0
    assert out["phase_sum_ms"] == pytest.approx(sum(out["phase_ms"].values()))
    p = get_params("tiny")
    ctx = init_he_backend("tiny", device="cpu")
    rng = np.random.default_rng(7)
    re, im = (torch.from_numpy(rng.uniform(-500, 500, (p.phi, p.n, p.n)))
              for _ in range(2))
    dr, di = ctx.roundtrip(re, im, ctx.generate_secret_key())
    assert out["err"] == float(torch.hypot(dr - re, di - im).max())


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events, CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_timer_and_benchmark_on_cuda(cuda):
    """A CUDA fence times a section by CUDA events; benchmark of a card
    function runs between events (one synchronize after the last call)."""
    from matrix_fhe_tpu_torch.utils.timer import Timer, benchmark

    x = torch.ones(1024, 1024, device=cuda)
    t = Timer()
    with t.section("mm", fence=x):
        x @ x
    assert t.counts == {"mm": 1} and t.totals["mm"] > 0
    assert 0 < benchmark(torch.matmul, x, x, iters=5) < 1


@pytest.mark.cuda
def test_profiler_trace_holds_a_cuda_kernel(cuda, tmp_path):
    from matrix_fhe_tpu_torch.utils import profiler

    with profiler.trace(str(tmp_path)):
        with profiler.annotate("mm"):
            x = torch.ones(256, 256, device=cuda)
            x @ x
    (f,) = os.listdir(tmp_path)
    events = json.load(open(tmp_path / f))["traceEvents"]
    assert any(e.get("name") == "mm" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
