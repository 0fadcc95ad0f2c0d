"""utils/profiler.span: the port's spans at tiny on the CPU.

Off (no profiler records): one shared no-op context after one check of the
profiler's state, no profiler range, no CUDA event, no record.  On (under
torch.profiler.profile): a tree of records per top-level call, each host
interval inside kineto's range of the same "mfhe." name, records cleared
when the next profile starts, and the program's outputs bit for bit
those of a run without a profiler.
"""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu_torch import HEContext, HEMatmul, RelinContext, SecretKey
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.ops import _backend
from matrix_fhe_tpu_torch.ops import modmath as mm
from matrix_fhe_tpu_torch.utils import profiler

# two 28-bit P primes: the three 30-bit limbs of tiny take one digit each
P_MODULI = (268434721, 268433761)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def tiny():
    p = get_params("tiny")
    ctx = HEContext(p, ring="nega", device="cpu")
    rc = RelinContext(ctx, p_moduli=P_MODULI)
    gen = torch.Generator().manual_seed(5)
    s = torch.randint(0, 3, (p.phi, p.n), generator=gen) - 1
    s_res = torch.remainder(s[None], torch.tensor(p.moduli).reshape(-1, 1, 1))
    sk = SecretKey(mm.to_mont(ctx.xntt.forward(ctx.wt.forward(s_res)),
                              p.moduli))
    rlk = rc.gen_relin_key(s_res, gen)
    shape = (len(p.moduli), p.phi, p.n, p.n)
    m1, m2 = (torch.randint(0, 1 << 20, shape, generator=gen)
              for _ in range(2))
    cts = ctx.encrypt_pair(m1, m2, sk, generator=gen)
    rng = np.random.default_rng(5)
    msg = tuple(torch.from_numpy(rng.uniform(-1, 1, (p.phi, p.n, p.n)))
                for _ in range(2))
    return {"p": p, "ctx": ctx, "rc": rc, "sk": sk, "rlk": rlk, "cts": cts,
            "msg": msg}


@pytest.fixture(scope="module")
def gl():
    p = get_params("tiny")
    ctx = HEContext(p, ring="gl", device="cpu")
    hm = HEMatmul(ctx)
    gen = torch.Generator().manual_seed(6)
    sk = ctx.generate_secret_key(gen)
    rng = np.random.default_rng(6)
    cts = []
    for _ in range(2):
        pr, pi = ctx.batched_encoder.encode_to_wntt_eval(
            *(torch.from_numpy(rng.uniform(-1, 1, (p.phi, p.n, p.n)))
              for _ in range(2)))
        cts.append(ctx.encrypt_pair(pr, pi, sk, generator=gen))
    return {"ctx": ctx, "hm": hm, "sk": sk, "tt": hm.matmul(*cts)}


def _multiply(t):
    return t["rc"].multiply_relinearize(*t["cts"], t["rlk"])


def _roundtrip(t):
    ctx, be = t["ctx"], t["ctx"].batched_encoder
    gen = torch.Generator().manual_seed(9)
    ct = ctx.encrypt_pair(*be.encode_to_wntt_eval(*t["msg"]), t["sk"],
                          generator=gen)
    return be.decode_from_wntt_eval(*ctx.decrypt_pair_to_eval(*ct, t["sk"]))


def _d2_decode(g):
    return g["hm"].decrypt_and_decode(g["tt"], g["sk"])


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


@pytest.fixture(scope="module")
def multiply_profile(tiny):
    with _profile():                # warms the profiler's first ranges
        _multiply(tiny)
    with _profile() as prof:
        _multiply(tiny)
    return prof, profiler.records()


def test_off_path_is_one_shared_noop(tiny, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiler.span("a") is profiler.span("b", 3)
    before = profiler.records()

    def refuse(*args, **kwargs):
        raise AssertionError("a span opened a range or an event while off")

    monkeypatch.setattr(profiler, "_range", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _roundtrip(tiny)
    _multiply(tiny)
    assert [r.id for r in profiler.records()] == [r.id for r in before]
    span = profiler.span
    for _ in range(10):
        with span("x"):
            pass
    tracemalloc.start()
    try:
        start, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(2000):
            with span("x"):
                pass
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak - start < 2000          # nothing kept or made per span


def test_multiply_span_tree(tiny, multiply_profile):
    _, recs = multiply_profile
    dnum = tiny["rc"].dnum
    assert dnum == 3
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "ks.multiply" and root.id == root.root
    assert all(r.root == root.id for r in recs)
    by = {r.id: r for r in recs}
    front, finish = _by_name(recs, "ks.front"), _by_name(recs, "ks.finish")
    digits = _by_name(recs, "ks.digit")
    assert len(front) == 1 and len(finish) == 1
    assert [d.index for d in digits] == list(range(dnum))
    for r in front + digits + finish:
        assert r.parent == root.id
    downs = _by_name(recs, "ks.mod_down")
    assert len(downs) == 2 and all(d.parent == finish[0].id for d in downs)
    extends = _by_name(recs, "rns.extend")
    assert len(extends) == dnum + 2
    assert [by[r.parent].name for r in extends] == \
        ["ks.digit"] * dnum + ["ks.mod_down"] * 2
    assert len(recs) == 1 + 1 + dnum + 1 + 2 + (dnum + 2)
    for r in recs:
        if r.parent is not None:
            p = by[r.parent]
            assert p.host_start_ns <= r.host_start_ns <= r.host_end_ns \
                <= p.host_end_ns


def test_spans_sit_on_kinetos_clock(multiply_profile):
    prof, recs = multiply_profile
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiler.PREFIX):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    slack = 0
    for r in recs:
        inside = [(s, e) for s, e in ranges[profiler.PREFIX + r.name]
                  if s <= r.host_start_ns and r.host_end_ns <= e]
        assert inside, r
        s, e = min(inside, key=lambda se: se[1] - se[0])
        slack += (r.host_start_ns - s) + (e - r.host_end_ns)
    assert slack < 1_000_000, slack / 1e6


@pytest.mark.parametrize("op", ["multiply", "roundtrip", "d2_decode"])
def test_outputs_identical_under_the_profiler(tiny, gl, op):
    run = {"multiply": lambda: _multiply(tiny),
           "roundtrip": lambda: _roundtrip(tiny),
           "d2_decode": lambda: _d2_decode(gl)}[op]
    off = run()
    with _profile():
        on = run()
    assert profiler.records()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_records_cleared_at_the_next_profiles_first_span():
    with _profile():
        with profiler.span("first"):
            pass
    assert [r.name for r in profiler.records()] == ["first"]
    assert [r.name for r in profiler.records()] == ["first"]   # re-readable
    try:
        with _profile():
            assert profiler.records() == []
            with profiler.span("second", 2) as rec:
                _backend.LAUNCHES["probe"] += 2
            assert [r.name for r in profiler.records()] == ["second"]
    finally:
        _backend.LAUNCHES.pop("probe", None)
    assert rec.index == 2 and rec.launches == {"probe": 2}
    assert rec.device_ms == rec.host_ms > 0


def test_a_profile_without_spans_keeps_no_records():
    with _profile():
        with profiler.span("first"):
            pass
    assert [r.name for r in profiler.records()] == ["first"]
    with _profile():
        torch.ones(4).sum()
    assert profiler.records() == []


def test_encode_and_decode_steps(tiny):
    with _profile():
        _roundtrip(tiny)
    recs = profiler.records()
    roots = [r.name for r in recs if r.parent is None]
    assert roots == ["encode", "encrypt", "decrypt", "decode"]
    by = {r.id: r for r in recs}
    kids = {}
    for r in recs:
        if r.parent is not None:
            kids.setdefault(by[r.parent].name, []).append(r.name)
    assert kids == {
        "encode": ["encode.sandwich", "encode.widft", "encode.quantize",
                   "encode.wcrt"],
        "decode": ["decode.compose", "decode.wdft", "decode.sandwich"]}


def test_delta_squared_decode_composes_exactly(gl):
    with _profile():
        _d2_decode(gl)
    recs = profiler.records()
    names = [r.name for r in recs]
    assert "decode.compose" not in names
    by = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "gemm.decrypt_decode"
    (decode,) = _by_name(recs, "decode")
    assert [by[r.parent].name for r in recs if r.parent is not None] == \
        ["gemm.decrypt_decode"] + ["decode"] * 4 + ["gemm.decrypt_decode"]
    assert [r.name for r in recs if r.parent == decode.id] == [
        "decode.wcrt_inverse", "decode.compose_exact", "decode.wdft",
        "decode.sandwich"]
    assert names[0] == "gemm.decrypt"


def test_summary_sums_by_name(tiny):
    with _profile():
        _multiply(tiny)
    recs, summ = profiler.records(), profiler.summary()
    assert summ["ks.digit"]["calls"] == 3
    assert sum(s["calls"] for s in summ.values()) == len(recs)
    for name, s in summ.items():
        assert 0 <= s["host_self_ms"] <= s["host_ms"] + 1e-9
        assert s["device_ms"] == pytest.approx(s["host_ms"])  # the CPU
        assert s["launches"] == {}
    kids = sum(r.host_ms for r in recs if r.parent is not None
               and r.parent == recs[-1].id)
    assert summ["ks.multiply"]["host_self_ms"] == \
        pytest.approx(recs[-1].host_ms - kids)


def test_trace_names_the_ports_steps(tiny, tmp_path):
    logdir = str(tmp_path / "trace")
    with profiler.trace(logdir):
        _roundtrip(tiny)
    (name,) = os.listdir(logdir)
    events = json.load(open(os.path.join(logdir, name)))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"mfhe.encode", "mfhe.encode.wcrt", "mfhe.decode.compose",
            "mfhe.encrypt", "mfhe.decrypt"} <= names
