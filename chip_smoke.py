#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (matrix_fhe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from matrix_fhe_tpu_torch/csrc/ (one nvcc per
source, in parallel) and drives four paths of the port through their
public entry points, each with the launch counts set to 0 just before it
and read just after:

  1. the ref-preset HE roundtrip (init_he_backend on "cuda", keygen,
     roundtrip, and encode -> encrypt_pair -> decrypt_and_decode), kernels
     K1-K4, max error < 1e-4;
  2. the bench NTT, N = 2^16, L = 16, B = 128 at 35- and 28-bit primes
     (FourStepNTT forward / inverse, kernel K5): NTT/s over chained
     forwards, and inverse(forward(x)) == x on the whole batch;
  3. the homomorphic matrix product at ref (ring "gl", HEMatmul, kernel K6
     with K1, K2 and K4), max |C - Y^H X| < 1e-4 as examples/matmul.py;
  4. the gl2 ciphertext GEMM at ref as examples/matmul_gl2.py (Gl2Context,
     HEMatmul2, Gl2GemmRelin with the preset's P basis, dnum = 4): keygen,
     switch keys, encode, encrypt, tensor (K7), relinearize, decrypt and the
     Delta^2 decode (K1, K2 at 2n = 128, K4), error < 2 base_err + 0.1
     where base_err is the two-sided opening's; phase times and memory;
     then a tiny gl2 GEMM on the card against the CPU plain path.

Every kernel is held bit for bit against its plain PyTorch version at the
shapes its path gives it, and both are timed.  Fails (nonzero exit, no
result line) without a CUDA device, on a build or launch error, on any
disagreement, or when a path's check fails.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TOL = 1e-4                 # src/main.cu:150, bench.py:310, examples/matmul.py:73
NTT_N, NTT_L, NTT_B = 1 << 16, 16, 128      # bench.py:94-96
NTT_ITERS = 20
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_residues(moduli, shape, gen) -> torch.Tensor:
    q = torch.tensor(moduli, dtype=torch.int64, device="cuda")
    q = q.reshape((len(moduli),) + (1,) * len(shape))
    x = torch.randint(0, 1 << 62, (len(moduli),) + tuple(shape),
                      generator=gen, device="cuda", dtype=torch.int64)
    return x % q


def max_abs_diff(a, b) -> int:
    """Largest integer difference over matching tensors (0 = bit-exact)."""
    if isinstance(a, (tuple, list)):
        return max(max_abs_diff(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape} {b.shape}")
    return int((a - b).abs().max())


def check_kernel(name, key, source, replaces, kernel_fn, plain_fn, reps=5):
    """Hold one kernel against its plain version (bit-exact) and time both;
    `key` names its launch counter."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_diff(got, want)
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, max(1, reps // 2))
    log(f"[kernel] {name}: max_abs_err={err} kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return {"name": name, "key": key, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def kernel_checks(ctx, gen):
    """K1-K4 against their plain versions at the ref path's shapes."""
    from matrix_fhe_tpu_torch.ops.fpmatmul import (fp_cmatmul_kernel,
                                                   fp_cmatmul_plain)
    p = ctx.params
    W, n = p.phi, p.n
    wt, xntt = ctx.wt, ctx.xntt
    rows = []
    d_w = random_residues(p.moduli, (W, n * n), gen)
    rows.append(check_kernel(
        "stage (K1, W-CRT forward)", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: wt._fwd.kernel(d_w), lambda: wt._fwd.plain(d_w)))
    d_x = random_residues(p.moduli, (W, n), gen)
    rows.append(check_kernel(
        "stage (K1, X-NTT)", "stage", "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: xntt._fwd.kernel(d_x), lambda: xntt._fwd.plain(d_x)))
    a_rows = random_residues(p.moduli, (W * n, n), gen)
    s_mont = random_residues(p.moduli, (W, n), gen)
    rows.append(check_kernel(
        "ntt_mul_ntt (K2)", "ntt_mul_ntt",
        "matrix_fhe_tpu_torch/csrc/ntt_mul_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1851",
        lambda: xntt._mul_s.kernel(a_rows, s_mont),
        lambda: xntt._mul_s.plain(a_rows, s_mont)))
    x_ev = random_residues(p.moduli, (W, 2 * n * n), gen)
    rows.append(check_kernel(
        "inv_compose (K3)", "inv_compose",
        "matrix_fhe_tpu_torch/csrc/inv_compose.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1731",
        lambda: wt._inv_compose.kernel(x_ev),
        lambda: wt._inv_compose.plain(x_ev)))
    for label, fp, k, m in (("sigma sandwich", ctx.encoder._fp_vi, n, W * n),
                            ("W-DFT", wt._fp_dft, W, n * n)):
        xr, xi = (torch.randint(-(1 << 37), 1 << 37, (k, m), generator=gen,
                                device="cuda", dtype=torch.int64)
                  for _ in range(2))
        rows.append(check_kernel(
            f"fp_cmatmul (K4, {label})", "fp_cmatmul",
            "matrix_fhe_tpu_torch/csrc/fp_cmatmul.cu",
            "matrix_fhe_tpu/ops/fpmatmul.py:129",
            lambda fp=fp, xr=xr, xi=xi: fp_cmatmul_kernel(fp.tr, fp.ti, xr, xi),
            lambda fp=fp, xr=xr, xi=xi: fp_cmatmul_plain(fp.tr, fp.ti, xr, xi)))
    return rows


def ntt_path(bits: int, gen):
    """The bench NTT at one prime width: forward throughput from chained
    forwards, the bit-exact roundtrip fence, then K5 against its plain
    version (outside the counted run).  Returns (rows, summary)."""
    from matrix_fhe_tpu_torch.ops import _backend as be
    from matrix_fhe_tpu_torch.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                                    generate_primes_1mod)
    N, L, B = NTT_N, NTT_L, NTT_B
    primes = generate_primes_1mod(L, bits, 2 * N)
    t0 = time.perf_counter()
    ntt = FourStepNTT(FourStepPlan.make(N, primes), "cuda")
    torch.cuda.synchronize()
    log(f"[ntt{bits}] N={N} L={L} B={B} plan {ntt.plan.n1}x{ntt.plan.n2}, "
        f"tables on the card in {time.perf_counter() - t0:.2f} s")
    x = random_residues(primes, (B, N), gen)

    be.reset_launches()
    spec = ntt.forward(x)
    fwd_ms = cuda_ms(lambda: ntt.forward(spec), NTT_ITERS)
    a = x
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(NTT_ITERS):                 # chained, as bench.py measures
        a = ntt.forward(a)
    end.record()
    torch.cuda.synchronize()
    chained_ms = start.elapsed_time(end) / NTT_ITERS
    inv_ms = cuda_ms(lambda: ntt.inverse(spec), NTT_ITERS)
    exact = torch.equal(ntt.inverse(spec), x)
    torch.cuda.synchronize()
    launches = dict(be.LAUNCHES)
    log(f"[ntt{bits}] forward {chained_ms:.3f} ms chained "
        f"({fwd_ms:.3f} ms repeated), {L * B / (chained_ms / 1e3):,.0f} NTT/s; "
        f"inverse {inv_ms:.3f} ms; roundtrip exact: {exact}; "
        f"launches {launches}")
    if not exact:
        raise AssertionError(f"{bits}-bit NTT roundtrip inverse(forward(x)) != x")
    if spec.shape != x.shape or not bool((spec >= 0).all()):
        raise AssertionError("NTT spectrum has the wrong shape or values")
    del a

    log(f"[ntt{bits}] K5 against its plain version at B={B}")
    rows = [check_kernel(
        f"four_step_ntt (K5, forward, {bits}-bit)", "four_step_fwd",
        "matrix_fhe_tpu_torch/csrc/four_step_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1430",
        lambda: ntt.forward_kernel(x), lambda: ntt.forward_plain(x), reps=10),
        check_kernel(
        f"four_step_ntt (K5, inverse, {bits}-bit)", "four_step_inv",
        "matrix_fhe_tpu_torch/csrc/four_step_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1430",
        lambda: ntt.inverse_kernel(spec), lambda: ntt.inverse_plain(spec),
        reps=10)]
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)
    summary = {f"ntt{bits}_per_sec": L * B / (chained_ms / 1e3),
               f"ntt{bits}_plain_per_sec": L * B / (rows[0]["plain_ms"] / 1e3),
               f"ntt{bits}_forward_ms": chained_ms,
               f"ntt{bits}_inverse_ms": inv_ms}
    return rows, summary


def matmul_path():
    """examples/matmul.py on the port at ref: C = Y^H X on 512 encrypted
    64x64 lanes, then K6 against its plain version at the ref shape
    (outside the counted run).  Returns (rows, summary)."""
    from matrix_fhe_tpu_torch import HEMatmul, init_he_backend
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models import trace
    from matrix_fhe_tpu_torch.ops import _backend as be

    p = get_params("ref")
    t0 = time.perf_counter()
    ctx = init_he_backend("ref", ring="gl", device="cuda")
    hm = HEMatmul(ctx)
    log(f"[matmul] ref gl context in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(7)
    W, n = p.phi, p.n
    A = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    B = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)          # fresh key, `a` and noise, from one seed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # contexts of earlier paths
    be.reset_launches()
    sk = ctx.generate_secret_key(gen)
    cts = []
    for M in (A, B):
        pr, pi = ctx.batched_encoder.encode_to_wntt_eval(
            torch.from_numpy(M.real).cuda(), torch.from_numpy(M.imag).cuda())
        cts.append(ctx.encrypt_pair(pr, pi, sk, generator=gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tt = hm.matmul(*cts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dr, di = hm.decrypt_and_decode(tt, sk)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(be.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    C = dr.cpu().numpy() + 1j * di.cpu().numpy()
    ref = np.conj(np.swapaxes(B, 1, 2)) @ A
    err = float(np.abs(C - ref).max())
    log(f"[matmul] first call: tensor {1e3 * (t1 - t0):.1f} ms, decrypt+decode "
        f"{1e3 * (t2 - t1):.1f} ms; max |C - Y^H X| = {err:.3e} (|Y^H X| up "
        f"to {np.abs(ref).max():.2f}); max_memory_allocated {peak} B, of "
        f"which {peak - held} B above what was held before the path; "
        f"launches {launches}")
    if C.shape != ref.shape or not np.isfinite(C).all() or not err < TOL:
        raise AssertionError(f"ref trace matmul max err {err} (limit {TOL})")

    tensor_ms = statistics.median(
        cuda_ms(lambda: hm.matmul(*cts), 1) for _ in range(3))
    decode_ms = statistics.median(
        cuda_ms(lambda: hm.decrypt_and_decode(tt, sk), 1) for _ in range(3))
    log(f"[matmul] tensor {tensor_ms:.3f} ms, decrypt+decode {decode_ms:.3f} ms "
        f"(median of 3 after a warm-up, CUDA events)")

    gemm = trace._cgemm(tuple(p.moduli), n, torch.device("cuda"))
    ops = [random_residues(p.moduli, (W, n, n), gen) for _ in range(4)]
    row = check_kernel("cgemm (K6, trace GEMM)", "cgemm",
                       "matrix_fhe_tpu_torch/csrc/cgemm.cu",
                       "matrix_fhe_tpu/ops/pallas_cgemm.py:41",
                       lambda: gemm.kernel(*ops), lambda: gemm.plain(*ops))
    row["launches"] = launches.get(row.pop("key"), 0)
    summary = {"ref_matmul_err": err, "ref_matmul_tensor_ms": tensor_ms,
               "ref_matmul_decrypt_decode_ms": decode_ms,
               "ref_matmul_max_memory_allocated": peak,
               "ref_matmul_memory_above_held": peak - held}
    return [row], summary


def event_ms(fn) -> float:
    """Milliseconds of one call from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def gl2_path():
    """examples/matmul_gl2.py on the port at ref: C = Y^H X, ciphertext in,
    standard ciphertext out, on 512 packed 64x64 lanes; then K7, K2 at
    2n = 128, K1 over the QP basis and K4 on the encode's inverse tables
    against their plain versions at the path's shapes (outside the counted
    run), and a tiny gl2 GEMM on the card against the CPU.  Returns (rows,
    summary)."""
    from matrix_fhe_tpu_torch import Gl2Context, Gl2GemmRelin, HEMatmul2
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.ops import _backend as be

    p = get_params("ref")
    t0 = time.perf_counter()
    ctx = Gl2Context(p, device="cuda")
    hm = HEMatmul2(ctx)
    gr = Gl2GemmRelin(hm)
    rc = gr.rc
    torch.cuda.synchronize()
    log(f"[gl2] ref gl2 context, P of {[q.bit_length() for q in rc.p_moduli]}"
        f" bits, dnum {rc.dnum}, Lqp {len(rc.qp_moduli)}, QP chunks "
        f"{gr._qp_chunks()}, in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(7)
    W, n = p.phi, p.n
    X = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    Y = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    C = np.conj(np.swapaxes(Y, -1, -2)) @ X
    xr, xi, yr, yi = (torch.from_numpy(v).cuda()
                      for v in (X.real, X.imag, Y.real, Y.imag))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)          # key, switch keys, `a` and noise
    d2 = float(p.delta) ** 2

    def keygen():
        sk_ = ctx.generate_secret_key(gen)
        return sk_, gr.gen_keys(sk_, gen)

    def encrypt_both():
        return (ctx.encrypt(ctx.encode(xr, xi), sk, gen),
                ctx.encrypt(ctx.encode(yr, yi), sk, gen))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # what earlier paths hold
    be.reset_launches()
    t0 = time.perf_counter()
    sk, ks = keygen()
    ctX, ctY = encrypt_both()
    tt = hm.matmul_tensor(ctX, ctY)
    ct_out = gr.relinearize(tt, ks)
    dr, di = ctx.decrypt_and_decode(ct_out, sk, delta_override=d2)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(be.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    key_bytes = sum(k.numel() * k.element_size() for part in ks for k in part)
    out = dr.cpu().numpy() + 1j * di.cpu().numpy()
    br, bi = ctx.decode(hm.decrypt_tensor_fn(tt, sk), delta_override=d2)
    base = br.cpu().numpy() + 1j * bi.cpu().numpy()
    err = float(np.abs(out - C).max())
    base_err = float(np.abs(base - C).max())
    log(f"[gl2] first call {first_s:.2f} s; max |C - Y^H X| = {err:.3e}, "
        f"two-sided opening {base_err:.3e} (limit {2 * base_err + 0.1:.3e}); "
        f"switch keys {key_bytes} B; max_memory_allocated {peak} B, of which "
        f"{peak - held} B above what was held before the path; "
        f"launches {launches}")
    shape = (len(p.moduli), W, n, 2 * n)
    if tuple(ct_out.b.shape) != shape or tuple(ct_out.a.shape) != shape:
        raise AssertionError(f"gl2 output ciphertext {tuple(ct_out.b.shape)}, "
                             f"expected {shape}")
    if out.shape != C.shape or not np.isfinite(out).all():
        raise AssertionError("gl2 decoded output has the wrong shape or "
                             "non-finite values")
    if not err < 2 * base_err + 0.1:
        raise AssertionError(f"gl2 GEMM err {err} >= 2 * {base_err} + 0.1")

    phases = {}
    for name, fn in (("keygen", keygen), ("encode_encrypt", encrypt_both),
                     ("tensor", lambda: hm.matmul_tensor(ctX, ctY)),
                     ("relinearize", lambda: gr.relinearize(tt, ks)),
                     ("decrypt_decode", lambda: ctx.decrypt_and_decode(
                         ct_out, sk, delta_override=d2))):
        phases[name] = statistics.median(event_ms(fn) for _ in range(3))
    log("[gl2] phase ms (median of 3 after the first call, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    sy_b, sy_a = hm._ry_map(hm._sigma(ctY.b)), hm._ry_map(hm._sigma(ctY.a))
    x_b, x_a = hm._tw(ctX.b), hm._tw(ctX.a)
    ops = [t.contiguous() for t in (sy_b, sy_a, x_b, x_a)]
    del tt, ct_out, ks
    torch.cuda.empty_cache()
    rows = [check_kernel(
        "gemm2x2 (K7, gl2 GEMM tensor)", "gemm2x2",
        "matrix_fhe_tpu_torch/csrc/gemm2x2.cu",
        "matrix_fhe_tpu/ops/pallas_cgemm.py:266",
        lambda: hm._gemm.kernel(*ops), lambda: hm._gemm.plain(*ops))]
    del ops, sy_b, sy_a, x_b, x_a
    k2 = ctx.xntt._mul_s
    a_rows = ctX.a.reshape(len(p.moduli), -1, 2 * n)
    rows.append(check_kernel(
        "ntt_mul_ntt (K2, gl2 ring 2n = 128)", "ntt_mul_ntt",
        "matrix_fhe_tpu_torch/csrc/ntt_mul_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1851",
        lambda: k2.kernel(a_rows, sk.s_mont), lambda: k2.plain(a_rows, sk.s_mont)))
    del a_rows
    # K1 over the 14-limb QP basis (55-bit P prime included) as relinearize
    # and keygen run it: the W-CRT of a [W, 2n, 2n] digit, and one 2n-point
    # pass of the 2D X-NTT
    m = 2 * n
    d_w = random_residues(rc.qp_moduli, (W, m * m), gen)
    rows.append(check_kernel(
        f"stage (K1, QP W-CRT forward, {len(rc.qp_moduli)} limbs)", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: rc.wt_qp._fwd.kernel(d_w), lambda: rc.wt_qp._fwd.plain(d_w)))
    d_x = d_w.reshape(len(rc.qp_moduli), W * m, m)
    rows.append(check_kernel(
        f"stage (K1, QP X-NTT, {m} points)", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: rc.xntt_qp._fwd.kernel(d_x), lambda: rc.xntt_qp._fwd.plain(d_x)))
    del d_w, d_x
    # K4 on the encode's inverse tables (Encoder.idft2_exact and
    # WTransform.dft_inverse_pair) at [W, n, n]
    from matrix_fhe_tpu_torch.ops.fpmatmul import (fp_cmatmul_kernel,
                                                   fp_cmatmul_plain)
    for label, fp, k, cols in (
            ("inverse sigma sandwich", ctx.encoder._fp_vi, n, W * n),
            ("W-IDFT", ctx.wt._fp_idft, W, n * n)):
        wr, wi = (torch.randint(-(1 << 37), 1 << 37, (k, cols), generator=gen,
                                device="cuda", dtype=torch.int64)
                  for _ in range(2))
        rows.append(check_kernel(
            f"fp_cmatmul (K4, gl2 {label})", "fp_cmatmul",
            "matrix_fhe_tpu_torch/csrc/fp_cmatmul.cu",
            "matrix_fhe_tpu/ops/fpmatmul.py:129",
            lambda fp=fp, wr=wr, wi=wi: fp_cmatmul_kernel(fp.tr, fp.ti, wr, wi),
            lambda fp=fp, wr=wr, wi=wi: fp_cmatmul_plain(fp.tr, fp.ti, wr, wi)))
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)

    # a tiny gl2 GEMM with keys and ciphertexts made on the CPU, on the card
    # and on the CPU's plain path: the same bits
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2, SecretKey2
    from matrix_fhe_tpu_torch.models.he_matmul2 import GemmRelinKey
    pt = get_params("tiny")
    cpu = Gl2Context(pt)
    gr_cpu = Gl2GemmRelin(HEMatmul2(cpu))
    gr_gpu = Gl2GemmRelin(HEMatmul2(Gl2Context(pt, device="cuda")))
    g = torch.Generator().manual_seed(5)
    r2 = np.random.default_rng(5)
    sk_c = cpu.generate_secret_key(g)
    cts_c = [cpu.encrypt(cpu.encode(
        torch.from_numpy(r2.uniform(-1, 1, (pt.phi, pt.n, pt.n))),
        torch.from_numpy(r2.uniform(-1, 1, (pt.phi, pt.n, pt.n)))), sk_c, g)
        for _ in range(2)]
    ks_c = gr_cpu.gen_keys(sk_c, g)
    want = gr_cpu.matmul(*cts_c, ks_c)
    got = gr_gpu.matmul(*(Ciphertext2(*(t.cuda() for t in ct)) for ct in cts_c),
                        GemmRelinKey(*(tuple(k.cuda() for k in part)
                                       for part in ks_c)))
    dec_c = cpu.decrypt_and_decode(want, sk_c, delta_override=pt.delta ** 2)
    dec_g = gr_gpu.ctx.decrypt_and_decode(
        got, SecretKey2(*(t.cuda() for t in sk_c)), delta_override=pt.delta ** 2)
    same = (torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)
            and all(torch.equal(x.cpu(), y) for x, y in zip(dec_g, dec_c)))
    if not same:
        raise AssertionError("tiny gl2 GEMM on the card differs from the CPU path")
    log("[check] tiny gl2 GEMM (tensor, relinearize, decode): card == CPU "
        "plain path, bit for bit")

    summary = {"ref_gl2_err": err, "ref_gl2_base_err": base_err,
               "ref_gl2_first_call_s": first_s,
               "ref_gl2_switch_key_bytes": key_bytes,
               "ref_gl2_max_memory_allocated": peak,
               "ref_gl2_memory_above_held": peak - held}
    summary.update({f"ref_gl2_{k}_ms": v for k, v in phases.items()})
    return rows, summary


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 2
    from matrix_fhe_tpu_torch import init_he_backend
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.ops import _backend as be

    card = subprocess.run(CARD_QUERY, check=True, capture_output=True,
                          text=True).stdout.strip()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    be.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    p = get_params("ref")
    t0 = time.perf_counter()
    ctx = init_he_backend("ref", device="cuda")
    log(f"[setup] ref context (tables on the card) in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = kernel_checks(ctx, gen)

    # -- path 1: the ref roundtrip, counted ---------------------------------
    be.reset_launches()
    ctx = init_he_backend("ref", device="cuda")
    t0 = time.perf_counter()
    sk = ctx.generate_secret_key()
    torch.cuda.synchronize()
    log(f"[main] keygen in {time.perf_counter() - t0:.2f} s")
    r = np.random.default_rng(7)
    re = r.uniform(-4, 4, size=(p.phi, p.n, p.n))
    im = r.uniform(-4, 4, size=(p.phi, p.n, p.n))
    re_t = torch.from_numpy(re).cuda()
    im_t = torch.from_numpy(im).cuda()
    t0 = time.perf_counter()
    dr, di = ctx.roundtrip(re_t, im_t, sk)
    torch.cuda.synchronize()
    err_rt = float(torch.hypot(dr - re_t, di - im_t).max())
    log(f"[main] roundtrip (bench input) first call "
        f"{time.perf_counter() - t0:.2f} s, max err {err_rt:.3e}")

    n2 = p.n * p.n
    ell = np.arange(p.phi, dtype=np.float64)[:, None]
    idx = np.arange(n2, dtype=np.float64)[None, :]
    re2 = torch.from_numpy((ell + idx * 1e-5).reshape(p.phi, p.n, p.n)).cuda()
    im2 = torch.from_numpy((ell - idx * 1e-5).reshape(p.phi, p.n, p.n)).cuda()
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re2, im2)
    ct_re, ct_im = ctx.encrypt_pair(pr, pi, sk)
    d2r, d2i = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    torch.cuda.synchronize()
    launches = dict(be.LAUNCHES)
    err_steps = float(torch.hypot(d2r - re2, d2i - im2).max())
    log(f"[main] step API (examples/main.py input) max err {err_steps:.3e}")
    log(f"[main] launches over keygen + roundtrip + step API: {launches}")
    for err, what in ((err_rt, "roundtrip"), (err_steps, "step API")):
        if not (np.isfinite(err) and err < TOL):
            raise AssertionError(f"ref {what} max err {err} >= {TOL}")
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on the path")
    for out in (dr, di, d2r, d2i):
        if out.shape != (p.phi, p.n, p.n) or not torch.isfinite(out).all():
            raise AssertionError("decoded output has the wrong shape or "
                                 "non-finite values")

    # -- roundtrip time and memory ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    ctx.roundtrip(re_t, im_t, sk)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ctx.roundtrip(re_t, im_t, sk)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    rt_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    log(f"[perf] ref roundtrip median {rt_ms:.3f} ms over {len(times)} runs "
        f"(min {min(times):.3f}, max {max(times):.3f}); "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")

    # -- zero-noise identity at ref -----------------------------------------
    ctx0 = init_he_backend("ref", zero_noise=True, device="cuda")
    m_re = random_residues(p.moduli, (p.phi, p.n, p.n), gen)
    m_im = random_residues(p.moduli, (p.phi, p.n, p.n), gen)
    c_re, c_im = ctx0.encrypt_pair(m_re, m_im, sk)
    e_re, e_im = ctx0.decrypt_pair_to_eval(c_re, c_im, sk)
    if not (torch.equal(e_re, m_re) and torch.equal(e_im, m_im)):
        raise AssertionError("zero-noise ref encrypt -> decrypt is not the identity")
    log("[check] zero-noise ref encrypt -> decrypt identity: exact")

    # -- a small input against the plain (CPU) path --------------------------
    ps = get_params("small")
    ctx_gpu = init_he_backend("small", device="cuda")
    ctx_cpu = init_he_backend("small", device="cpu")
    rs = np.random.default_rng(3)
    sr = torch.from_numpy(rs.uniform(-4, 4, size=(ps.phi, ps.n, ps.n)))
    si = torch.from_numpy(rs.uniform(-4, 4, size=(ps.phi, ps.n, ps.n)))
    g = ctx_gpu.roundtrip(sr.cuda(), si.cuda(), ctx_gpu.generate_secret_key())
    c = ctx_cpu.roundtrip(sr, si, ctx_cpu.generate_secret_key())
    if not (torch.equal(g[0].cpu(), c[0]) and torch.equal(g[1].cpu(), c[1])):
        raise AssertionError("small roundtrip on the card differs from the CPU path")
    log("[check] small roundtrip: card == CPU plain path, bit for bit")

    # -- path 2: the bench NTT (K5) ----------------------------------------
    summary = {"ref_roundtrip_ms": rt_ms, "ref_roundtrip_err": err_rt,
               "ref_step_api_err": err_steps, "max_memory_allocated": peak}
    for bits in (35, 28):
        ntt_rows, ntt_summary = ntt_path(bits, gen)
        rows += ntt_rows
        summary.update(ntt_summary)
        torch.cuda.empty_cache()

    # -- path 3: the homomorphic matrix product at ref (K6) -----------------
    mm_rows, mm_summary = matmul_path()
    rows += mm_rows
    summary.update(mm_summary)
    torch.cuda.empty_cache()

    # -- path 4: the gl2 ciphertext GEMM at ref (K7, K2 at 2n = 128) --------
    gl2_rows, gl2_summary = gl2_path()
    rows += gl2_rows
    summary.update(gl2_summary)
    for row in rows:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its path")

    log("[summary] " + json.dumps(summary))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
