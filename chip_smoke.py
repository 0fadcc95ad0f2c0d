#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (matrix_fhe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from matrix_fhe_tpu_torch/csrc/ (one nvcc per
source, in parallel) and drives the paths below through the port's
public entry points, each with the launch counts set to 0 just before it
and read just after:

  1. the ref-preset HE roundtrip (init_he_backend on "cuda", keygen,
     roundtrip, and encode -> encrypt_pair -> decrypt_and_decode), kernels
     K1-K4, max error < 1e-4; then, outside the counted run, the
     roundtrip's phase table (scripts.rt_phases: encode, mul_s, combine,
     decode, their sum and the fused time), a ref ciphertext and the
     secret key through utils.serialization (saved, loaded onto the card,
     decrypted bit for bit), K1 against the independent C++ oracle
     (native/golden: the X-NTT polymul and the W-CRT matvec on a
     Vandermonde built from the moduli, at every ref limb), the lane
     encoder, inverse_scaled and the centered W-CRT oracle on the card, and
     one roundtrip under utils.profiler.trace (the trace must hold its
     annotate span and a K2 kernel event);
  2. the bench NTT, N = 2^16, L = 16, B = 128 at 35- and 28-bit primes
     (FourStepNTT forward / inverse, kernel K5 on 64-bit words at 35 bits,
     32-bit words at 28): NTT/s over chained forwards, and
     inverse(forward(x)) == x on the whole batch; at 28 bits both word
     routes are timed in turns;
  3. the homomorphic matrix product at ref (ring "gl", HEMatmul, kernel K6
     with K1, K2 and K4), max |C - Y^H X| < 1e-4 as examples/matmul.py;
  4. the gl2 ciphertext GEMM at ref as examples/matmul_gl2.py (Gl2Context,
     HEMatmul2, Gl2GemmRelin with the preset's P basis, dnum = 4): keygen,
     switch keys, encode, encrypt, tensor (K7), relinearize, decrypt and the
     Delta^2 decode (K1, K2 at 2n = 128, K4), error < 2 base_err + 0.1
     where base_err is the two-sided opening's; phase times and memory;
     then a tiny gl2 GEMM on the card against the CPU plain path; then
     Gl2Conj at ref on the same context, P basis and secret key (its key,
     encrypt, conjugate, decrypt, decode, counted apart: K1, K10a's twiddle
     form, K2), max |dec - conj(X)| < 1e-4, keygen and apply times, a
     tiny conjugation on the card against the CPU, and K10a's twiddle form
     at the conjugation's 128-point digit-step shape;
  5. key switching and the leveled chain at ref (LeveledChain, the preset's
     P, dnum = 4): examples/relinearize.py (keygen, two encrypts,
     multiply_relinearize, noise < 2^25), examples/leveled.py's depth-2
     circuit (multiply, rescale, multiply after mod_switch, rotate j = 2
     with the full Galois set, decrypt) against the exact ring oracle
     (< 2^40), a fresh complex pair (error < 1e-4), a tiny leveled circuit
     on the card against the CPU, and the ks_phases table (K10a's twiddle
     form with K1-K4);
 5b. key switching at mid, the basis three examples run by default
     (RelinContext's generated P: six 28-bit limbs, dnum 1): the
     relinearization key, two messages and their encryptions made on the
     CPU from one seeded generator and moved across; multiply_relinearize
     on the card (counted: K10a's twiddle form, K1) equal to the CPU plain
     path bit for bit, noise < 2^25, the card's and the CPU's times; K1
     and K10a's twiddle form at mid's QP shapes (the first rows with
     28-bit, 4-digit limbs); native/tablegen's root searches against the
     Python ones at every Q and P limb of tiny, small, mid and ref;
  6. the probes: python3 -m matrix_fhe_tpu_torch.scripts.micro_vpu (K11)
     and micro_coissue (K12) at their default shapes, then every variant
     and mode against its plain version at those shapes and on a reduced
     grid;
  7. parallel/ on worlds of ranks sharing this one card
     (parallel.launch.run_world, spawned, with the kernels already built
     here): four gloo ranks run the coefficient-sharded NTT at N = 2^17,
     L = 4, B = 2 over all four (equal to the single-device
     FourStepNTT.forward, the stage route, and to forward_plain; exact
     inverse), ShardedPipeline at ref on dp 2 x tp 2
     over 4 messages of default_rng(7).uniform(-4, 4) (equal to
     HEContext.roundtrip_batch bit for bit, error < 1e-4) and the
     W-sharded multiply_relinearize at ref over tp 4 (keys made on every
     rank from one seed, their checksums all_gathered; equal to the
     unsharded product bit for bit, noise < 2^25); the same programs in a
     one-rank nccl world; then scripts.bench_dist's card mode (the
     limb-sharded K5 NTT at N = 2^16, the dist NTT, the cost model on
     path 2's NTT/s).  The path's launches are those of the sharded
     calls alone, summed over the ranks (each program counts its own
     window: keygen, encryption and the single-rank references stay
     out); each program must launch its kernels (the dist NTT K1 and
     K10a's twiddle form, the pipeline K1-K4, the key switch K1 and the
     twiddle form, the limb-sharded NTT K5).  Rank 0 holds K1 and the
     twiddle form to their plain versions at the dist NTT's stage shapes,
     K1 on the key switch's lane-sliced QP W-CRT table and K2 at the
     pipeline's row block.  Times and per-rank peak memory are logged as
     four ranks sharing one card: a validation, not a scaling figure;
  8. the entry points, each run as its own process from the repository
     root so that the real command line is what is checked: the five
     examples at their JAX default presets (python -m
     matrix_fhe_tpu_torch.examples.main at ref, matmul at ref,
     matmul_gl2, relinearize and leveled at mid), scripts.bench at its
     defaults (N = 2^16, L = 16, B = 128, 35 and 28 bits, the ref gate;
     its JSON line is logged) and entry --dryrun 4 (dryrun_multichip(4):
     four gloo ranks sharing the card); each must exit 0, print its pass
     line and launch the kernels it runs (its {"launches": ...} line,
     which counts the program's own calls: not its set-up, keys,
     encryptions, oracles, baselines, fences or rank 0's unsharded
     references);
     then, in process, FourStepNTT at N = 2^13, 2^15 and 2^17 (n1 != n2:
     the stage route, K10a's twiddle form and K1, never K5) held to
     forward_plain / inverse_plain bit for bit, and both kernels at the
     route's N = 2^17 stage shapes.

Every kernel is held bit for bit against its plain PyTorch version at the
shapes its path gives it, and both are timed, with the least time the card
could take for the same work (bytes at 3.35 TB/s; K1, K10a, K2, K3, K6
and K7's u8 digit products, K4's s8 digit products by the JAX kernel's
Karatsuba method and K12's s8 dots at the int8 tensor-core rate of 1,979
TOP/s; K5's Shoup products at the IMADs a product of its register
kernel's SASS, per word width, its index and address IMADs left out, at
the card's IMAD rate of 64 a clock on each SM) and, where one PyTorch call
computes the same function, that call's time (K11's copy: Tensor.copy_ on
the same buffers, in turns).  For every row a [bound] line logs the byte
and operation bounds apart; K3's parts (split, GEMM, compose) and K4's
split pass are timed apart on [kernel] lines, and so is K2's function as
two launches (K10a's twiddle form forward with s as the twiddle, then
K1's inverse), the yardstick of its fusion.  The rows of K2, K1 and K10a's
twiddle form carry their launches on every path (`launches_by_path`, the
conjugation of path 4 as "4_gl2_conj"); K10a's twiddle-form rows carry only
the path that runs their shape (path 5 at 64 points, the conjugation at
128, path 7's dist NTT at 256, path 8's stage route "8_four_step" at 256
on [4, 1024, 256]); path 8's entry points count as "8_entry_points", the
sum of the {"launches": ...} lines of its processes (for mid's rows, of
the relinearize and leveled processes, which switch keys at mid, beside
"5b_mid_keyswitch").  The SASS check fails if
a kernel whose products run on the tensor cores (K1, K2, K4, K6, K7, and
K12's mxu, both and dep instantiations) has no wgmma instruction.
Fails (nonzero exit, no result line) without a CUDA device, on a build or
launch error, on any disagreement, or when a path's check fails.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from matrix_fhe_tpu_torch.utils.timing import cuda_ms  # noqa: E402

TOL = 1e-4                 # src/main.cu:150, bench.py:310, examples/matmul.py:73
NTT_N, NTT_L, NTT_B = 1 << 16, 16, 128      # bench.py:94-96
NTT_ITERS = 20
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core rate (data sheet)
# 32-bit integer multiply-adds (IMAD): 64 a clock on each of 132 SMs at the
# 1.98 GHz of the data sheet's 67 TFLOP/s fp32; two int32 operations each
IMAD_PER_S = 64 * 132 * 1.98e9
INT32_OPS_PER_S = 2 * IMAD_PER_S


def log(msg: str) -> None:
    print(msg, flush=True)


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


def nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(nbytes(t) for t in x)
    return x.numel() * x.element_size()


def check_kernel(name, key, source, replaces, kernel_fn, plain_fn, inputs,
                 work, reps=5, library_fn=None):
    """Hold one kernel against its plain version (bit-exact) and time both;
    `key` names its launch counter, `inputs` are the tensors the function
    reads (with the outputs, they make the bytes of the bound) and `work`
    its operations by type ("imad": IMAD-class instructions, "int32",
    "int8")."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_diff(got, want)
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, max(1, reps // 2))
    library_ms = None if library_fn is None else cuda_ms(library_fn, reps)
    log(f"[kernel] {name}: max_abs_err={err} kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms"
        + ("" if library_ms is None else f", library {library_ms:.3f} ms"))
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    row = {"name": name, "key": key, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bytes": nbytes(inputs) + nbytes(got), "work": work}
    return row


def stage_work(stage, data) -> dict:
    """Operations of one K1 / K10a call by the digit-plane method: u8
    products, 2 x rows x cols x (d_l K) x d_l a limb, with d_l =
    ceil(bits / 8) data digits and table planes, on every side (the right
    side's kernel reads each int64 as 8 byte slots, 8 K digit rows: the
    zero slots are the design's cost, not the function's work).  A
    twiddle's one Montgomery product an output is not counted: it never set
    a row's bound."""
    from matrix_fhe_tpu_torch.ops.cuda_ntt import digit_count
    L, W, K = stage.table.shape
    outs = (data.numel() // K) * W // L      # outputs of one limb
    return {"int8": sum(2 * outs * d * K * d
                        for d in map(digit_count, stage.moduli))}


def ntt_mul_ntt_work(k2, a_rows) -> dict:
    """Operations of one K2 call by the digit-plane method: the function's
    u8 digit products, two transforms of 2 R n (d_l n) d_l a limb (the
    kernel's 8 byte slots a term do 8 / d_l of that: the design's cost,
    not counted)."""
    from matrix_fhe_tpu_torch.ops.cuda_ntt import digit_count
    L, R, n = a_rows.shape
    int8 = sum(2 * 2 * R * n * d * n * d
               for d in map(digit_count, k2.moduli))
    return {"int8": int8}


def gemm2x2_work(gemm, u) -> dict:
    """Operations of one K7 call by the digit-plane method: four products
    of 2 W m^2 (d_l y) d_l u8 digit products a limb (the d_l Shoup
    products an element of V that pre-reduce it are not counted)."""
    from matrix_fhe_tpu_torch.ops.cuda_ntt import digit_count
    L, W, y, m = u.shape
    int8 = sum(4 * 2 * W * m * m * d * y * d
               for d in map(digit_count, gemm.moduli))
    return {"int8": int8}


def cgemm_work(gemm, a) -> dict:
    """Operations of one K6 call by the digit-plane method: four real
    products of 2 W n^2 (d_l n) d_l u8 digit products a limb, 8 W n^3 d_l^2
    (the d_l Shoup products an element of B that pre-reduce it are not
    counted)."""
    from matrix_fhe_tpu_torch.ops.cuda_ntt import digit_count
    L, W, n, _ = a.shape
    return {"int8": sum(8 * W * n ** 3 * d * d
                        for d in map(digit_count, gemm.moduli))}


def fp_work(fp, m: int) -> dict:
    """Operations of one K4 call on [m] columns by the JAX kernel's method:
    s8 digit products, 3 tchunks dchunks 2 W K m (Karatsuba's three
    products, tchunks balanced 7-bit digits of the table as
    _split_tables_balanced counts them, dchunks = DATA_CHUNKS = 6 at
    X_BITS = 37).  The kernel makes four real products on 8-bit digits,
    100/90 of that: the design's cost, not counted."""
    from matrix_fhe_tpu_torch.ops.fpmatmul import X_BITS
    W, K = fp.tr.shape
    mx = int(torch.stack([fp.tr.abs().max(), fp.ti.abs().max(),
                          (fp.tr + fp.ti).abs().max()]).max())
    tchunks = 1
    while 127 * 128 ** (tchunks - 1) // 2 <= mx:
        tchunks += 1
    dchunks = -(-(X_BITS + 3) // 7)
    return {"int8": 3 * tchunks * dchunks * 2 * W * K * m}


def check_fp_cmatmul(name, fp, m, gen):
    """K4's row at [W, K] @ [K, m] on random data |x| < 2^37 (the extreme
    2^37 in a few entries) through the table's cut planes, and its split
    pass timed alone on a [kernel] log line."""
    from matrix_fhe_tpu_torch.ops import _backend as be
    from matrix_fhe_tpu_torch.ops.fpmatmul import (fp_cmatmul_kernel,
                                                   fp_cmatmul_plain)
    k = fp.tr.shape[1]
    xr, xi = (torch.randint(-(1 << 37), 1 << 37, (k, m), generator=gen,
                            device="cuda", dtype=torch.int64)
              for _ in range(2))
    xr[0, :5] = 1 << 37
    xi[0, :5] = -(1 << 37)
    planes = fp.planes()
    row = check_kernel(
        name, "fp_cmatmul", "matrix_fhe_tpu_torch/csrc/fp_cmatmul.cu",
        "matrix_fhe_tpu/ops/fpmatmul.py:129",
        lambda: fp_cmatmul_kernel(fp.tr, fp.ti, xr, xi, planes),
        lambda: fp_cmatmul_plain(fp.tr, fp.ti, xr, xi),
        [fp.tr, fp.ti, xr, xi], fp_work(fp, m))
    xp = torch.empty((2, planes.shape[1], m, planes.shape[-1]),
                     dtype=torch.int8, device="cuda")
    split_ms = cuda_ms(lambda: be.launch(
        "fp_cmatmul_split", "mf_fp_split", xr.device, xr, xi, xp, k, m,
        planes.shape[-1]), 5)
    log(f"[kernel] {name}: split pass alone {split_ms:.3f} ms")
    return row


def _sass_loops(lines):
    """(start, end) address ranges of the backward branches in SASS."""
    addr_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*)")
    insts, loops = [], []
    for line in lines:
        m = addr_re.search(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        insts.append((addr, text))
        b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            loops.append((int(b.group(1), 16), addr))
    return insts, loops


def sass_functions() -> dict:
    """cuobjdump -sass of the built library, {function name: SASS}."""
    from matrix_fhe_tpu_torch.ops import _backend as be
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", be.LIBRARY], check=True,
                          capture_output=True, text=True).stdout
    return {f.split()[0]: f for f in re.split(r"\n\s*Function : ", sass)[1:]}


def _opcode(text):
    return text.split()[1] if text.startswith("@") else text.split()[0]


def _is_imad(text):
    """An IMAD-class instruction (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X; not the
    IMAD.MOV / SHL / IADD forms, which move, shift or add)."""
    op = _opcode(text)
    return op.startswith("IMAD") and not any(
        k in op for k in ("MOV", "SHL", "IADD"))


# K5's register kernel four_step_reg<W, R, COL, PRE, POST> (csrc/
# four_step_ntt.cu) as cuobjdump names it: W is j (uint32_t) or m / y
# (uint64_t)
K5_REG_RE = re.compile(r"four_step_regI([jmy])Li(\d+)ELb([01])ELb([01])ELb([01])E")


def dif_products(r: int) -> int:
    """Shoup products of K5's R-point DIF DFT (the j = 0 butterflies of
    each stage take none)."""
    out, length = 0, r // 2
    while length >= 1:
        out += r // (2 * length) * (length - 1)
        length //= 2
    return out


def _register_operands(text):
    """True if an instruction's operands are registers only: no immediate
    and no constant-bank operand, as in a Shoup product's multiplies (its
    operands are residues, table pairs and the modulus, all loaded); the
    index and address arithmetic multiplies by constants."""
    ops = text.split(";")[0].split(None, 2 if text.startswith("@") else 1)
    return not re.search(r"\b0x[0-9a-f]+\b|\bc\[", ops[-1])


def k5_reg_products(r: int, wide: bool, pre: bool, post: bool) -> int:
    """Shoup products a thread of K5's four_step_reg makes: two R-point DFTs
    and the inner twiddles w_m^(j k1), k1 >= 1 (k1 = 0 too on 64-bit
    words, by w_m^0 = 1, to come back below 2q), R for the pre-product,
    and R at the store for the post-product, or on 64-bit words by w_m^0."""
    return (2 * dif_products(r) + (r if wide else r - 1)
            + r * pre + r * (post or wide))


def k5_imads_per_product(funcs, r: int = 16) -> dict:
    """IMAD-class instructions per Shoup product in K5's register kernel at
    R = 16 (m = 256, the bench's split), per word width: over the pass
    instantiations of that width, the IMADs of the straight-line body
    (every loop is unrolled but the root-table copy, which is left out)
    whose operands are registers only (`_register_operands`: the index and
    address IMADs are left out), over the products the body makes a thread
    (`k5_reg_products`).  Returns {32: IMADs a product, 64: ...}."""
    tot = {32: [0, 0], 64: [0, 0]}
    for name, body in funcs.items():
        m = K5_REG_RE.search(name)
        if not m or int(m.group(2)) != r:
            continue
        width = 32 if m.group(1) == "j" else 64
        products = k5_reg_products(r, width == 64, m.group(4) == "1",
                                   m.group(5) == "1")
        insts, loops = _sass_loops(body.splitlines())
        tot[width][0] += sum(
            1 for a, t in insts if _is_imad(t) and _register_operands(t)
            and not any(lo <= a <= hi for lo, hi in loops))
        tot[width][1] += products
    if any(p == 0 for _, p in tot.values()):
        raise AssertionError(f"no four_step_reg instantiation at R = {r} "
                             f"for a word width: {tot}")
    return {w: i / p for w, (i, p) in tot.items()}


def tensor_core_ops(funcs, kernel: str) -> int:
    """Warpgroup tensor-core instructions (IGMMA) in a kernel whose
    products run on the int8 tensor cores (K1's stage_kernel, K2's
    ntt_mul_ntt_kernel, K4's fp_cmatmul_kernel, K6's cgemm_kernel, K7's
    gemm2x2_kernel, K12's coissue_kernel<1, 3, 4>: a name's part as
    cuobjdump mangles it, "coissue_kernelILi1E"), summed over the
    instantiations whose names hold `kernel`; each must have some."""
    bodies = [f for name, f in funcs.items() if kernel in name]
    if not bodies:
        raise AssertionError(f"no function {kernel} in the library")
    total = 0
    for body in bodies:
        insts, _ = _sass_loops(body.splitlines())
        n = sum(1 for _, t in insts if "GMMA" in _opcode(t))
        if n == 0:
            raise AssertionError(f"{kernel} has no wgmma instruction")
        total += n
    return total


def kernel_checks(ctx, gen):
    """K1-K4 against their plain versions at the ref path's shapes."""
    p = ctx.params
    W, n = p.phi, p.n
    wt, xntt = ctx.wt, ctx.xntt
    rows = []
    L = len(p.moduli)
    d_w = random_residues(p.moduli, (W, n * n), gen)
    rows.append(check_kernel(
        "stage (K1, W-CRT forward)", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: wt._fwd.kernel(d_w), lambda: wt._fwd.plain(d_w),
        [wt._fwd.table, d_w], stage_work(wt._fwd, d_w)))
    d_x = random_residues(p.moduli, (W, n), gen)
    rows.append(check_kernel(
        "stage (K1, X-NTT)", "stage", "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: xntt._fwd.kernel(d_x), lambda: xntt._fwd.plain(d_x),
        [xntt._fwd.table, d_x], stage_work(xntt._fwd, d_x)))
    a_rows = random_residues(p.moduli, (W * n, n), gen)
    s_mont = random_residues(p.moduli, (W, n), gen)
    k2 = xntt._mul_s
    rows.append(check_kernel(
        "ntt_mul_ntt (K2)", "ntt_mul_ntt",
        "matrix_fhe_tpu_torch/csrc/ntt_mul_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1851",
        lambda: k2.kernel(a_rows, s_mont), lambda: k2.plain(a_rows, s_mont),
        [k2.fwd, k2.inv, a_rows, s_mont], ntt_mul_ntt_work(k2, a_rows)))
    # the yardstick of the fusion: the same function as two launches, K10a's
    # twiddle form forward with s as the twiddle, then K1's inverse (the
    # spectrum written to and read from device memory)
    s_rows = s_mont.repeat_interleave(n, 1)

    def two():
        return xntt._inv.kernel(xntt._fwd.kernel(a_rows, s_rows))

    if not torch.equal(two(), k2.kernel(a_rows, s_mont)):
        raise AssertionError("K2 differs from K10a-tw forward then K1 inverse")
    log(f"[kernel] ntt_mul_ntt (K2) as two launches (K10a-tw forward x s, "
        f"K1 inverse): {cuda_ms(two, 5):.3f} ms, the fused kernel "
        f"{rows[-1]['ms']:.3f} ms")
    del s_rows
    x_ev = random_residues(p.moduli, (W, 2 * n * n), gen)
    k3 = wt._inv_compose
    rows.append(check_kernel(
        "inv_compose (K3)", "inv_compose",
        "matrix_fhe_tpu_torch/csrc/inv_compose.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1731",
        lambda: k3.kernel(x_ev), lambda: k3.plain(x_ev), [k3.table, x_ev],
        stage_work(k3._stage, x_ev)))
    r_ev = k3._stage.kernel(x_ev)
    log(f"[kernel] inv_compose (K3) in parts: split "
        f"{cuda_ms(lambda: k3._stage.split_digits(x_ev), 5):.3f} ms, split + "
        f"GEMM {cuda_ms(lambda: k3._stage.kernel(x_ev), 5):.3f} ms, compose "
        f"{cuda_ms(lambda: k3.compose(r_ev), 5):.3f} ms (its bytes, r' read "
        f"and acc, k written: "
        f"{1e3 * 8 * (L + 2) * W * 2 * n * n / HBM_BYTES_PER_S:.3f} ms)")
    del r_ev
    for label, fp, m in (("sigma sandwich", ctx.encoder._fp_vi, W * n),
                         ("W-DFT", wt._fp_dft, n * n)):
        rows.append(check_fp_cmatmul(f"fp_cmatmul (K4, {label})", fp, m, gen))
    return rows


def ntt_path(bits: int, gen, k5_imads: dict):
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
    # chained, as bench.py measures: the first chain as it comes (the
    # caching allocator finds its buffers during it), then a second one
    cold_ms = cuda_ms(ntt.forward, NTT_ITERS, warmup=False, chain=x)
    chained_ms = cuda_ms(ntt.forward, NTT_ITERS, warmup=False, chain=x)
    inv_ms = cuda_ms(lambda: ntt.inverse(spec), NTT_ITERS)
    exact = torch.equal(ntt.inverse(spec), x)
    torch.cuda.synchronize()
    launches = dict(be.LAUNCHES)
    log(f"[ntt{bits}] forward {chained_ms:.3f} ms chained "
        f"({fwd_ms:.3f} ms repeated), {L * B / (chained_ms / 1e3):,.0f} NTT/s; "
        f"first chain {cold_ms:.3f} ms, {L * B / (cold_ms / 1e3):,.0f} NTT/s; "
        f"inverse {inv_ms:.3f} ms; roundtrip exact: {exact}; "
        f"launches {launches}")
    if not exact:
        raise AssertionError(f"{bits}-bit NTT roundtrip inverse(forward(x)) != x")
    if spec.shape != x.shape or not bool((spec >= 0).all()):
        raise AssertionError("NTT spectrum has the wrong shape or values")

    log(f"[ntt{bits}] K5 against its plain version at B={B}, "
        f"{ntt.word_bits}-bit route")
    kt = ntt._kernel_tables
    # the function's modular products: N/2 log2 N butterflies and 2N
    # element-wise products, at the route's IMADs a Shoup product
    products = L * B * (N // 2 * (N.bit_length() - 1) + 2 * N)
    work = {"imad": products * k5_imads[ntt.word_bits]}
    rows = []
    for label, key, kernel, plain, data, names in (
            ("forward", "four_step_fwd", ntt.forward_kernel, ntt.forward_plain,
             x, ("roots_f", "twist_f", "tw_f")),
            ("inverse", "four_step_inv", ntt.inverse_kernel, ntt.inverse_plain,
             spec, ("roots_i", "tw_i", "post_i"))):
        rows.append(check_kernel(
            f"four_step_ntt (K5, {label}, {bits}-bit, {ntt.word_bits}-bit "
            f"words)", key, "matrix_fhe_tpu_torch/csrc/four_step_ntt.cu",
            "matrix_fhe_tpu/ops/pallas_ntt.py:1430",
            lambda kernel=kernel, data=data: kernel(data),
            lambda plain=plain, data=data: plain(data),
            [data] + [kt[k] for k in names], dict(work), reps=10))
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)
    route = {}
    if ntt.word_bits == 32:
        # the same plan on the 64-bit route, against the 32-bit one it
        # takes: in turns, on the same inputs (outside the counted run)
        wide = FourStepNTT(ntt.plan, "cuda", words=64)
        if not (torch.equal(wide.forward_kernel(x), spec)
                and torch.equal(wide.inverse_kernel(spec), x)):
            raise AssertionError(f"{bits}-bit K5 on 64-bit words disagrees")
        for _ in range(2):
            for label, obj in (("32", ntt), ("64", wide)):
                route.setdefault(f"fwd{label}", []).append(
                    cuda_ms(lambda obj=obj: obj.forward_kernel(x), NTT_ITERS))
                route.setdefault(f"inv{label}", []).append(
                    cuda_ms(lambda obj=obj: obj.inverse_kernel(spec), NTT_ITERS))
        route = {k: min(v) for k, v in route.items()}
        log(f"[route] {bits}-bit K5 (best of 2, in turns): 32-bit words "
            f"forward {route['fwd32']:.3f} ms, inverse {route['inv32']:.3f}; "
            f"64-bit words forward {route['fwd64']:.3f}, inverse "
            f"{route['inv64']:.3f}")
        del wide
    summary = {f"ntt{bits}_per_sec": L * B / (chained_ms / 1e3),
               f"ntt{bits}_first_chain_per_sec": L * B / (cold_ms / 1e3),
               f"ntt{bits}_plain_per_sec": L * B / (rows[0]["plain_ms"] / 1e3),
               f"ntt{bits}_forward_ms": chained_ms,
               f"ntt{bits}_inverse_ms": inv_ms}
    summary.update({f"ntt{bits}_k5_{k}_ms": v for k, v in route.items()})
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
                       lambda: gemm.kernel(*ops), lambda: gemm.plain(*ops),
                       ops, cgemm_work(gemm, ops[0]))
    row["launches"] = launches.get(row.pop("key"), 0)
    summary = {"ref_matmul_err": err, "ref_matmul_tensor_ms": tensor_ms,
               "ref_matmul_decrypt_decode_ms": decode_ms,
               "ref_matmul_max_memory_allocated": peak,
               "ref_matmul_memory_above_held": peak - held}
    return [row], summary, launches


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
        phases[name] = statistics.median(cuda_ms(fn, warmup=False)
                                         for _ in range(3))
    log("[gl2] phase ms (median of 3 after the first call, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    sy_b, sy_a = hm._ry_map(hm._sigma(ctY.b)), hm._ry_map(hm._sigma(ctY.a))
    x_b, x_a = hm._tw(ctX.b), hm._tw(ctX.a)
    ops = [t.contiguous() for t in (sy_b, sy_a, x_b, x_a)]
    del tt, ct_out, ks
    torch.cuda.empty_cache()
    L = len(p.moduli)
    rows = [check_kernel(
        "gemm2x2 (K7, gl2 GEMM tensor)", "gemm2x2",
        "matrix_fhe_tpu_torch/csrc/gemm2x2.cu",
        "matrix_fhe_tpu/ops/pallas_cgemm.py:266",
        lambda: hm._gemm.kernel(*ops), lambda: hm._gemm.plain(*ops),
        ops, gemm2x2_work(hm._gemm, ops[0]))]
    del ops, sy_b, sy_a, x_b, x_a
    k2 = ctx.xntt._mul_s
    a_rows = ctX.a.reshape(len(p.moduli), -1, 2 * n)
    m = 2 * n
    rows.append(check_kernel(
        "ntt_mul_ntt (K2, gl2 ring 2n = 128)", "ntt_mul_ntt",
        "matrix_fhe_tpu_torch/csrc/ntt_mul_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1851",
        lambda: k2.kernel(a_rows, sk.s_mont), lambda: k2.plain(a_rows, sk.s_mont),
        [k2.fwd, k2.inv, a_rows, sk.s_mont], ntt_mul_ntt_work(k2, a_rows)))
    del a_rows
    # K1 over the 14-limb QP basis (55-bit P prime included) as relinearize
    # and keygen run it: the W-CRT of a [W, 2n, 2n] digit, and one 2n-point
    # pass of the 2D X-NTT
    d_w = random_residues(rc.qp_moduli, (W, m * m), gen)
    fwd_w, fwd_x = rc.wt_qp._fwd, rc.xntt_qp._fwd
    rows.append(check_kernel(
        f"stage (K1, QP W-CRT forward, {len(rc.qp_moduli)} limbs)", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: fwd_w.kernel(d_w), lambda: fwd_w.plain(d_w),
        [fwd_w.table, d_w], stage_work(fwd_w, d_w)))
    d_x = d_w.reshape(len(rc.qp_moduli), W * m, m)
    rows.append(check_kernel(
        f"stage (K1, QP X-NTT, {m} points)", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: fwd_x.kernel(d_x), lambda: fwd_x.plain(d_x),
        [fwd_x.table, d_x], stage_work(fwd_x, d_x)))
    del d_w, d_x
    # K4 on the encode's inverse tables (Encoder.idft2_exact and
    # WTransform.dft_inverse_pair) at [W, n, n]
    for label, fp, cols in (
            ("inverse sigma sandwich", ctx.encoder._fp_vi, W * n),
            ("W-IDFT", ctx.wt._fp_idft, n * n)):
        rows.append(check_fp_cmatmul(f"fp_cmatmul (K4, gl2 {label})", fp,
                                     cols, gen))
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)

    # a tiny gl2 GEMM with keys and ciphertexts made on the CPU, on the card
    # and on the CPU's plain path: the same bits
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2, SecretKey2
    from matrix_fhe_tpu_torch.models.he_matmul2 import GemmRelinKey
    pt = get_params("tiny")
    cpu = Gl2Context(pt, device="cpu")
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
    del gr_cpu, gr_gpu, want, got, ks_c, cts_c

    # -- Gl2Conj at ref on this path's context, RelinContext and key -------
    t_conj = time.perf_counter()
    conj_row, conj_summary, conj_launches, _ = gl2_conj_path(ctx, hm, rc, sk,
                                                             X, gen)
    rows.append(conj_row)
    conj_summary["ref_conj_wall_s"] = time.perf_counter() - t_conj

    summary = {"ref_gl2_err": err, "ref_gl2_base_err": base_err,
               "ref_gl2_first_call_s": first_s,
               "ref_gl2_switch_key_bytes": key_bytes,
               "ref_gl2_max_memory_allocated": peak,
               "ref_gl2_memory_above_held": peak - held}
    summary.update({f"ref_gl2_{k}_ms": v for k, v in phases.items()})
    summary.update(conj_summary)
    return rows, summary, launches, conj_launches


def leveled_path():
    """Key switching at ref: examples/relinearize.py and examples/leveled.py
    on the port's LeveledChain (the preset's P basis, dnum = 4), a fresh
    complex pair, a tiny leveled circuit on the card against the CPU, and
    the ks_phases table; then K10a's twiddle form and K1 against their plain
    versions at the QP X-NTT and QP W-CRT shapes of the key switch, and the
    twiddle form's batched_left side, which no path runs (outside the
    counted run).  Returns (rows, summary, launches)."""
    from matrix_fhe_tpu_torch import LeveledChain, convert
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models.keyswitch import w_automorphism_perm
    from matrix_fhe_tpu_torch.ops import _backend as be
    from matrix_fhe_tpu_torch.ops import modmath as mm
    from matrix_fhe_tpu_torch.scripts import ks_phases
    from matrix_fhe_tpu_torch.utils.debug import (composed_magnitude,
                                                  ring_mul)
    from matrix_fhe_tpu_torch.utils.debug import relin_noise as noise

    p = get_params("ref")
    W, n, L = p.phi, p.n, len(p.moduli)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    be.reset_launches()
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = 1e3 * (time.perf_counter() - t0)
        return out

    chain = step("chain_setup", lambda: LeveledChain(p, seed=5, device="cuda"))
    ctx, rc = chain.ctx(0), chain.rc(0)
    log(f"[ks] ref chain: P of {[q.bit_length() for q in rc.p_moduli]} bits, "
        f"dnum {rc.dnum}, groups {rc.groups}")

    # -- examples/relinearize.py: keygen, two encrypts, multiply, noise ----
    rlk = step("relin_keygen", lambda: chain.rlk(0))
    rng = np.random.default_rng(9)
    m1, m2 = (torch.from_numpy(np.stack(
        [rng.integers(0, 1 << 30, size=(W, n, n)) for _ in p.moduli])).cuda()
        for _ in range(2))
    sk = chain.sk(0)
    ct1, ct2 = step("encrypt_two", lambda: (ctx.encrypt(m1, sk),
                                            ctx.encrypt(m2, sk)))
    ct = step("multiply_relinearize_first",
              lambda: rc.multiply_relinearize(ct1, ct2, rlk))
    mr_ms = statistics.median(
        cuda_ms(lambda: rc.multiply_relinearize(ct1, ct2, rlk), warmup=False)
        for _ in range(3))
    relin_noise = noise(ctx, ct, ct1, ct2, sk)
    log(f"[ks] relinearized multiply at ref: first call "
        f"{steps['multiply_relinearize_first']:.1f} ms, median of 3 "
        f"{mr_ms:.3f} ms; |relinearization noise| max {relin_noise} "
        f"(limit 2^25 = {1 << 25}; Delta = 2^35)")
    if not relin_noise < 1 << 25 or ct.b.shape != ct1.b.shape:
        raise AssertionError(f"relinearization noise {relin_noise} >= 2^25")
    del ct, ct1, ct2, m1, m2

    # -- examples/leveled.py: the depth-2 circuit and rotate(2, full) ------
    rng = np.random.default_rng(3)

    def msg():
        c = torch.from_numpy(rng.integers(0, 1 << 16, size=(W, n, n))).cuda()
        return ctx.wt.forward(torch.stack([c % int(q) for q in p.moduli]))

    x, y = chain.encrypt(msg()), chain.encrypt(msg())
    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    z = step("multiply_l0", lambda: chain.multiply(x, y))
    zr = step("rescale", lambda: chain.rescale(z))
    step("keygen_l1", lambda: (chain.rlk(1), chain.full_galois(1)))
    w = step("multiply_l1", lambda: chain.multiply(zr, chain.mod_switch(x, 1)))
    wr = step("rotate_full", lambda: chain.rotate(w, j, full=True))
    got = step("decrypt", lambda: chain.decrypt_to_eval(wr))
    launches = dict(be.LAUNCHES)
    # steady state of each step (the first calls above build the reduced
    # chain's tables and the level-1 contexts)
    x1 = chain.mod_switch(x, 1)
    steady = {name: statistics.median(cuda_ms(fn, warmup=False)
                                      for _ in range(3))
              for name, fn in (("multiply_l0", lambda: chain.multiply(x, y)),
                               ("rescale", lambda: chain.rescale(z)),
                               ("multiply_l1", lambda: chain.multiply(zr, x1)),
                               ("rotate_full", lambda: chain.rotate(
                                   w, j, full=True)),
                               ("decrypt", lambda: chain.decrypt_to_eval(wr)))}
    log("[leveled] steady step ms (median of 3 after the first call, CUDA "
        "events): " + ", ".join(f"{k} {v:.3f}" for k, v in steady.items()))
    c0, c1 = chain.ctx(0), chain.ctx(1)
    px = c0.decrypt_to_eval(x.ct, chain.sk(0))
    pz = c1.decrypt_to_eval(zr.ct, chain.sk(1))
    perm = torch.from_numpy(w_automorphism_perm(chain.params_at(1), j)).cuda()
    want = ring_mul(c1, pz, px[:-1])[:, perm]
    oracle = composed_magnitude(c1, mm.sub_mod(got, want, c1._q4))
    peak = torch.cuda.max_memory_allocated()
    log(f"[leveled] depth-2 circuit at ref (j = {j}): level {wr.level}, "
        f"scale 2^{np.log2(wr.scale):.1f}; |ct - oracle| composed max "
        f"{oracle} (limit 2^40); step ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in steps.items())
        + f"; max_memory_allocated {peak} B, {peak - held} B above what was "
        f"held before the path; launches {launches}")
    if not (oracle < 1 << 40 and wr.level == 1
            and got.shape == (L - 1, W, n, n)):
        raise AssertionError(f"leveled circuit oracle {oracle} >= 2^40")
    del x, y, z, zr, w, wr, got, px, pz, want, x1

    # -- a fresh complex pair at ref ------------------------------------------
    r5 = np.random.default_rng(5)
    re = torch.from_numpy(r5.uniform(-2, 2, (W, n, n))).cuda()
    im = torch.from_numpy(r5.uniform(-2, 2, (W, n, n))).cuda()
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    dr, di = chain.decrypt_decode_complex(chain.encrypt_complex(pr, pi))
    pair_err = float(torch.hypot(dr - re, di - im).max())
    log(f"[leveled] fresh complex pair at ref: max err {pair_err:.3e} "
        f"(limit 1e-4)")
    if not (np.isfinite(pair_err) and pair_err < TOL):
        raise AssertionError(f"fresh complex pair err {pair_err} >= {TOL}")
    qp = rc.qp_moduli
    fwd_x, fwd_w = rc.xntt_qp._fwd, rc.wt_qp._fwd     # the switch's stages
    del chain, ctx, rc, rlk, re, im, pr, pi, dr, di
    torch.cuda.empty_cache()

    # -- ks_phases at ref -----------------------------------------------------
    ks = ks_phases.run("ref", 3, "preset")
    log("[ks_phases] " + json.dumps(ks))
    torch.cuda.empty_cache()

    # -- a tiny leveled circuit: card == CPU ------------------------------------
    pt = get_params("tiny")
    outs = []
    cpu_chain = LeveledChain(pt, seed=7, device="cpu")
    for chain_t in (cpu_chain, LeveledChain(pt, seed=7, device="cuda")):
        if chain_t is not cpu_chain:
            convert.leveled_keys(cpu_chain, chain_t)
        c = np.random.default_rng(11).integers(0, 1 << 16, (pt.phi, pt.n, pt.n))
        mt = chain_t.ctx(0).wt.forward(torch.stack(
            [torch.from_numpy(c % int(q)) for q in pt.moduli]).to(
                chain_t.device))
        a = chain_t.encrypt(mt)
        b = chain_t.rescale(chain_t.multiply(a, a))
        b = chain_t.rotate(chain_t.multiply(b, chain_t.mod_switch(a, 1)), 2,
                           full=True)
        outs.append((b.ct.b.cpu(), b.ct.a.cpu(),
                     chain_t.decrypt_to_eval(b).cpu()))
    if not all(torch.equal(g, c) for g, c in zip(*outs)):
        raise AssertionError("tiny leveled circuit on the card differs from "
                             "the CPU path")
    log("[check] tiny leveled circuit (multiply, rescale, rotate, decrypt): "
        "card == CPU plain path, bit for bit")

    # -- K10a's twiddle form and K1 at the key switch's QP shapes ----------
    from matrix_fhe_tpu_torch.ops.cuda_ntt import Stage
    gen = torch.Generator(device="cuda").manual_seed(13)
    d = random_residues(qp, (W * n, n), gen)
    tw = random_residues(qp, (W * n, n), gen)
    rows = [check_kernel(
        f"stage_tw (K10a, QP X-NTT x twiddle, {len(qp)} limbs)", "stage_tw",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:460",
        lambda: fwd_x.kernel(d, tw), lambda: fwd_x.plain(d, tw),
        [fwd_x.table, d, tw], stage_work(fwd_x, d))]
    rows[0]["paths"] = ("5_keyswitch",)
    del d, tw
    d = random_residues(qp, (W, n * n), gen)
    rows.append(check_kernel(
        f"stage (K1, key-switch QP W-CRT forward, {len(qp)} limbs, "
        f"[{len(qp)}, {W}, {n * n}])", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: fwd_w.kernel(d), lambda: fwd_w.plain(d), [fwd_w.table, d],
        stage_work(fwd_w, d)))
    split_ms = cuda_ms(lambda: fwd_w.split_digits(d), 5)
    log(f"[kernel] {rows[-1]['name']}: its split pass (launch key "
        f"stage_split) alone {split_ms:.3f} ms of the row's "
        f"{rows[-1]['ms']:.3f}")
    del d, fwd_x, fwd_w
    # batched_left runs on no path (launch key stage_tw_batched): held at
    # the four-step stage shape, 256 x 256 tables and a batch of 16 a limb,
    # and logged, not listed among the path's kernels
    tbl = random_residues(p.moduli, (256, 256), gen)
    bl = Stage(tbl.cpu().numpy().view(np.uint64), p.moduli, "batched_left",
               "cuda")
    d = random_residues(p.moduli, (16, 256, 256), gen)
    tw = random_residues(p.moduli, (256, 256), gen)
    off_path = check_kernel(
        f"stage_tw (K10a, batched_left x twiddle, [{L}, 16, 256, 256], "
        f"on no path)", "stage_tw_batched", "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:460",
        lambda: bl.kernel(d, tw), lambda: bl.plain(d, tw), [bl.table, d, tw],
        stage_work(bl, d))
    del d, tw, bl
    torch.cuda.empty_cache()

    summary = {"ref_relin_noise": relin_noise, "ref_ks_k1_split_ms": split_ms,
               "ref_multiply_relinearize_ms": mr_ms,
               "ref_leveled_oracle": oracle, "ref_pair_err": pair_err,
               "ref_leveled_max_memory_allocated": peak,
               "ref_leveled_memory_above_held": peak - held,
               "ks_phases_ref": ks}
    summary.update({f"ref_leveled_{k}_ms": v for k, v in steps.items()})
    summary.update({f"ref_leveled_{k}_steady_ms": v for k, v in steady.items()})
    return rows, summary, launches, off_path


# -- path 5b: mid's key switch, card == CPU ------------------------------------

MID_SEED = 16                   # the CPU generator of the mid keys and messages
ROOT_PRESETS = ("tiny", "small", "mid", "ref")


def root_search_check() -> dict:
    """native/tablegen's find_eta and find_psi4n (the port's tablegen.cpp,
    built with g++ on this host) == the Python searches of ops/modmath at
    every Q limb and every limb of the key-switch P basis (ref's preset P,
    the generated P of the others)."""
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models.keyswitch import _default_p_moduli
    from matrix_fhe_tpu_torch.native import tablegen
    from matrix_fhe_tpu_torch.ops import modmath as mm

    t0 = time.perf_counter()
    count = 0
    for preset in ROOT_PRESETS:
        p = get_params(preset)
        f1, f2 = p.p_factors
        for q in tuple(p.moduli) + _default_p_moduli(p):
            q = int(q)
            if (tablegen.find_eta(q, p.p, f1, f2) != mm.find_eta(q, p.p, f1, f2)
                    or tablegen.find_psi4n(q, p.n) != mm.find_psi_4n(q, p.n)):
                raise AssertionError(f"native root search differs at {preset} "
                                     f"q = {q}")
            count += 1
    wall = time.perf_counter() - t0
    log(f"[check] native root searches == Python: find_eta and find_psi4n "
        f"at {count} Q and P limbs of {', '.join(ROOT_PRESETS)} "
        f"({wall:.2f} s)")
    return {"root_search_limbs": count}


def mid_keyswitch_path():
    """mid's key switch, the configuration three examples run by default:
    RelinContext's generated P (six 28-bit limbs, dnum 1, one group of the
    four Q limbs).  The relinearization key (generator seeded MID_SEED, on
    the CPU), the two messages (the same generator) and the parity-stream
    encryptions are made on the CPU and moved across; multiply_relinearize
    on the card (counted) must equal the CPU plain path's bit for bit, and
    its noise stay < 2^25.  Then K1 on the QP W-CRT and the QP X-NTT and
    K10a's twiddle form at the digit step's shape, against their plain
    versions, and the native root searches.  Returns (rows, summary,
    launches)."""
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models import rng as refrng
    from matrix_fhe_tpu_torch.models.he import (Ciphertext, HEContext,
                                                SecretKey)
    from matrix_fhe_tpu_torch.models.keyswitch import RelinContext, RelinKey
    from matrix_fhe_tpu_torch.ops import _backend as be
    from matrix_fhe_tpu_torch.utils.debug import relin_noise

    p = get_params("mid")
    W, n = p.phi, p.n
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx_c = HEContext(p, ring="nega", device="cpu")
    rc_c = RelinContext(ctx_c)
    ctx_g = HEContext(p, ring="nega", device="cuda")
    rc_g = RelinContext(ctx_g)
    setup_s = time.perf_counter() - t0
    bits = [q.bit_length() for q in rc_g.p_moduli]
    log(f"[mid-ks] mid: L = {len(p.moduli)}, P of {bits} bits, dnum "
        f"{rc_g.dnum}, groups {rc_g.groups}; both contexts in {setup_s:.1f} s")
    if not (rc_g.p_moduli == rc_c.p_moduli and bits == [28] * 6
            and rc_g.dnum == 1):
        raise AssertionError(f"mid's P basis is not six 28-bit limbs at dnum "
                             f"1: {bits}, dnum {rc_g.dnum}")

    # keys and ciphertexts on the CPU, from one generator
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(MID_SEED)
    sk_c = ctx_c.generate_secret_key()
    rlk_c = rc_c.gen_relin_key(refrng.ternary_secret(p, "cpu"), gen)
    m1, m2 = (torch.randint(0, 1 << 30, (len(p.moduli), W, n, n),
                            generator=gen, dtype=torch.int64)
              for _ in range(2))
    ct1_c, ct2_c = ctx_c.encrypt(m1, sk_c), ctx_c.encrypt(m2, sk_c)
    keygen_s = time.perf_counter() - t0

    def card(ct):
        return Ciphertext(*(t.cuda() for t in ct))

    sk_g = SecretKey(sk_c.s_mont.cuda())
    rlk_g = RelinKey(b=tuple(t.cuda() for t in rlk_c.b),
                     a=tuple(t.cuda() for t in rlk_c.a))
    ct1_g, ct2_g = card(ct1_c), card(ct2_c)

    torch.cuda.synchronize()
    be.reset_launches()
    t0 = time.perf_counter()
    out_g = rc_g.multiply_relinearize(ct1_g, ct2_g, rlk_g)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(be.LAUNCHES)
    card_ms = statistics.median(
        cuda_ms(lambda: rc_g.multiply_relinearize(ct1_g, ct2_g, rlk_g),
                warmup=False) for _ in range(3))
    t0 = time.perf_counter()
    out_c = rc_c.multiply_relinearize(ct1_c, ct2_c, rlk_c)
    cpu_s = time.perf_counter() - t0
    same = (torch.equal(out_g.b.cpu(), out_c.b)
            and torch.equal(out_g.a.cpu(), out_c.a))
    noise = relin_noise(ctx_g, out_g, ct1_g, ct2_g, sk_g)
    log(f"[mid-ks] multiply_relinearize at mid: card first call "
        f"{first_ms:.1f} ms, median of 3 {card_ms:.3f} ms (CUDA events); "
        f"CPU plain path {cpu_s:.1f} s ({torch.get_num_threads()} threads); "
        f"keys and ciphertexts on the CPU {keygen_s:.1f} s; noise {noise} "
        f"(limit 2^25); launches {launches}")
    if not same:
        raise AssertionError("mid multiply_relinearize on the card differs "
                             "from the CPU plain path")
    if not noise < 1 << 25:
        raise AssertionError(f"mid relinearization noise {noise} >= 2^25")
    for key in ("stage", "stage_tw"):
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"mid multiply_relinearize launched no {key}")
    log("[check] mid multiply_relinearize (dnum 1, 6 x 28-bit P): card == "
        "CPU plain path, bit for bit")
    del out_g, out_c, ct1_c, ct2_c, rlk_c, m1, m2, ctx_c, rc_c

    # -- K1 and K10a-tw at mid's QP shapes (4 Q limbs + six 28-bit P) --------
    qp = rc_g.qp_moduli
    fwd_w, fwd_x, inv_x = rc_g.wt_qp._fwd, rc_g.xntt_qp._fwd, rc_g.xntt_qp._inv
    g = torch.Generator(device="cuda").manual_seed(MID_SEED)
    d = random_residues(qp, (W, n * n), g)
    rows = [check_kernel(
        f"stage (K1, mid key-switch QP W-CRT forward, {len(qp)} limbs, "
        f"[{len(qp)}, {W}, {n * n}])", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: fwd_w.kernel(d), lambda: fwd_w.plain(d), [fwd_w.table, d],
        stage_work(fwd_w, d))]
    d = random_residues(qp, (W * n, n), g)
    rows.append(check_kernel(
        f"stage (K1, mid key-switch QP X-NTT inverse, {len(qp)} limbs, "
        f"[{len(qp)}, {W * n}, {n}])", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: inv_x.kernel(d), lambda: inv_x.plain(d), [inv_x.table, d],
        stage_work(inv_x, d)))
    tw = random_residues(qp, (W * n, n), g)
    rows.append(check_kernel(
        f"stage_tw (K10a, mid QP X-NTT x twiddle, {len(qp)} limbs, "
        f"[{len(qp)}, {W * n}, {n}])", "stage_tw",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:460",
        lambda: fwd_x.kernel(d, tw), lambda: fwd_x.plain(d, tw),
        [fwd_x.table, d, tw], stage_work(fwd_x, d)))
    del d, tw, fwd_w, fwd_x, inv_x, rc_g, ctx_g
    torch.cuda.empty_cache()

    summary = {"mid_multiply_relinearize_ms": card_ms,
               "mid_multiply_relinearize_first_ms": first_ms,
               "mid_multiply_relinearize_cpu_s": cpu_s,
               "mid_keys_cpu_s": keygen_s, "mid_relin_noise": noise,
               "mid_setup_s": setup_s}
    summary.update(root_search_check())
    return rows, summary, launches


def probe_path():
    """The probe entry points at their default shapes, counted; then every
    K11 variant and K12 mode against its plain version at those shapes and
    on a reduced grid, and the rows of both kernels.  Returns (rows,
    summary)."""
    from matrix_fhe_tpu_torch.ops import _backend as be
    from matrix_fhe_tpu_torch.ops import probes
    from matrix_fhe_tpu_torch.scripts import micro_coissue, micro_vpu

    shape, small_shape = (16, 128, 256, 256), (2, 8, 256, 256)
    grid, reps = 64, 8
    be.reset_launches()
    vpu = micro_vpu.run(shape, 30)
    co = micro_coissue.run(reps, grid, 30)
    torch.cuda.synchronize()
    launches = dict(be.LAUNCHES)
    log(f"[probe] launches {launches}")

    # every variant and mode bit for bit, on the scripts' own inputs at
    # their default shapes, and on a reduced grid
    x = micro_vpu.random_u32(shape, 0)
    xs = micro_vpu.random_u32(small_shape, 1)
    err_vpu = {}
    for kind, k in micro_vpu.VARIANTS:
        err_vpu[kind, k] = max_abs_diff(probes.u32_chain(x, kind, k),
                                        probes.u32_chain_plain(x, kind, k))
        reduced = max_abs_diff(probes.u32_chain(xs, kind, k),
                               probes.u32_chain_plain(xs, kind, k))
        log(f"[probe] K11 {kind} k={k}: max_abs_err {err_vpu[kind, k]} at "
            f"{list(shape)}, {reduced} at {list(small_shape)}")
        if err_vpu[kind, k] or reduced:
            raise AssertionError(f"K11 {kind} disagrees with its plain version")
    d8, t8, a, b = micro_coissue.make_inputs(grid)
    small = micro_coissue.make_inputs(4, seed=1)
    err_co = {}
    for mode in micro_coissue.MODES:
        err_co[mode] = max_abs_diff(
            probes.coissue(d8, t8, a, b, mode, reps),
            probes.coissue_plain(d8, t8, a, b, mode, reps))
        reduced = max_abs_diff(probes.coissue(*small, mode, 2),
                               probes.coissue_plain(*small, mode, 2))
        log(f"[probe] K12 {mode}: max_abs_err {err_co[mode]} at grid {grid} "
            f"reps {reps}, {reduced} at grid 4 reps 2")
        if err_co[mode] or reduced:
            raise AssertionError(f"K12 {mode} disagrees with its plain version")
    del xs, small

    rows = []
    el = x.numel()
    for kind, k in (("copy", 0), ("addmul", 512)):
        ms = next(r["ms"] for r in vpu if (r["kind"], r["k"]) == (kind, k))
        plain_ms = cuda_ms(lambda: probes.u32_chain_plain(x, kind, k),
                           warmup=False)
        lib = None
        if kind == "copy":
            # the kernel and Tensor.copy_ on the same buffers, by the same
            # timer, in turns; the medians of three
            dst = torch.empty_like(x)
            turns = [(cuda_ms(lambda: probes.u32_chain_kernel(
                x, "copy", 0, out=dst), 30), cuda_ms(lambda: dst.copy_(x), 30))
                for _ in range(3)]
            ms = statistics.median(t[0] for t in turns)
            lib = statistics.median(t[1] for t in turns)
            log(f"[probe] K11 copy into one buffer, kernel / Tensor.copy_ ms "
                f"in turns: {turns}; chained with fresh outputs "
                f"(scripts.micro_vpu): "
                f"{next(r['ms'] for r in vpu if r['kind'] == 'copy'):.3f}")
            del dst
        ops = micro_vpu.OPS_PER_STEP[kind] * k * el
        rows.append({"name": f"micro_vpu (K11, {kind} k={k}, {list(shape)})",
                     "key": "micro_vpu", "route": "cuda",
                     "source": "matrix_fhe_tpu_torch/csrc/micro_vpu.cu",
                     "replaces": "scripts/micro_vpu.py:28",
                     "max_abs_err": err_vpu[kind, k], "ms": ms,
                     "plain_ms": plain_ms,
                     "library_ms": lib, "bytes": 2 * 4 * el,
                     "work": {"int32": ops}})
        log(f"[kernel] {rows[-1]['name']}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms" + ("" if lib is None else
                                   f", Tensor.copy_ {lib:.3f} ms"))
    del x
    addmul = next(r for r in vpu if (r["kind"], r["k"]) == ("addmul", 512))
    steps_per_s = el * 512 / (addmul["ms"] / 1e3)

    G, P, N, K = d8.shape
    # the library yardstick of the dots: one torch._int_mm over both planes
    # (sum_p d8[g, p] @ t8[0, p]), reps / P times
    d8c = d8.permute(0, 2, 1, 3).reshape(G * N, P * K)
    t8c = t8[0].reshape(P * K, N)
    for mode in ("mxu", "both"):
        ms = co["us_per_cell"][mode] * G / 1e3
        plain_ms = cuda_ms(lambda: probes.coissue_plain(d8, t8, a, b, mode,
                                                        reps), warmup=False)
        lib = cuda_ms(lambda: torch._int_mm(d8c, t8c), 30) * (reps // P) \
            if mode == "mxu" else None
        work = {"int8": 2 * G * N * K * N * reps}
        if mode == "both":      # ~12 u32 operations a round and element
            work["int32"] = 12 * G * N * N * reps
        rows.append({"name": f"micro_coissue (K12, {mode}, grid {G}, reps "
                             f"{reps})",
                     "key": "micro_coissue", "route": "cuda",
                     "source": "matrix_fhe_tpu_torch/csrc/micro_coissue.cu",
                     "replaces": "scripts/micro_coissue.py:55",
                     "max_abs_err": err_co[mode], "ms": ms,
                     "plain_ms": plain_ms,
                     "library_ms": lib,
                     "bytes": nbytes([d8, t8, a, b]) + 2 * 4 * G * N * N,
                     "work": work})
        log(f"[kernel] {rows[-1]['name']}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms" + ("" if lib is None else
                                   f", torch._int_mm x {reps // P} "
                                   f"{lib:.3f} ms"))
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)
    summary = {"k11": vpu, "k12": co, "k11_addmul_steps_per_s": steps_per_s}
    return rows, summary


# -- path 7: the sharded programs on a world of ranks ---------------------------

PAR_NTT_N, PAR_NTT_L, PAR_NTT_B = 1 << 17, 4, 2   # bench_dist.py:185-213
PAR_MSGS = 4                    # ShardedPipeline batch, default_rng(7)
WORLD_S = 600                   # a world's time limit
# the cost model's link rates, named assumptions (no run measures them):
# H100 SXM NVLink 4, 900 GB/s both ways (data sheet), and one 400 Gb/s
# NDR InfiniBand port a host
NVLINK_GBPS, IB_GBPS = 450.0, 50.0


def parallel_rows(device, dp: int, tp: int) -> list:
    """Every rank builds the meshes (a collective); rank 0 holds the
    kernels to their plain versions at the shapes its sharded objects
    give them: K10a's twiddle form and K1 at the four-way dist NTT's
    stages (N = 2^17 as 256 x 512, B = 2: stage 1 x twiddle on
    [4, 256, 256] with a [4, 128, 256] twiddle, stage 2 on [4, 128, 512]),
    K1 on the key switch's lane-sliced QP W-CRT table at its gathered
    input, and K2 on the pipeline's rows of the parity a."""
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models.he import HEContext
    from matrix_fhe_tpu_torch.models.keyswitch import RelinContext
    from matrix_fhe_tpu_torch.ops.ntt_large import (FourStepPlan,
                                                    generate_primes_1mod)
    from matrix_fhe_tpu_torch.parallel.dist_ntt import DistFourStepNTT
    from matrix_fhe_tpu_torch.parallel.keyswitch import ShardedWTransform
    from matrix_fhe_tpu_torch.parallel.mesh import make_mesh
    from matrix_fhe_tpu_torch.parallel.pipeline import ShardedPipeline
    world = torch.distributed.get_world_size()
    coeff = make_mesh({"coeff": world}, "cuda")
    lanes = make_mesh({"tp": world}, "cuda")
    msgs = make_mesh({"dp": dp, "tp": tp}, "cuda")
    if torch.distributed.get_rank() != 0:
        return []
    torch.cuda.empty_cache()
    primes = generate_primes_1mod(PAR_NTT_L, 35, 2 * PAR_NTT_N)
    plan = FourStepPlan.make(PAR_NTT_N, primes)
    dn = DistFourStepNTT(plan, coeff, "coeff", device)
    st1, st2, tw = dn.stages.st["t1f"], dn.stages.st["t2f"], dn.stages.tw_f
    gen = torch.Generator(device="cuda").manual_seed(17)
    x1 = random_residues(primes, (PAR_NTT_B * plan.n2 // world, plan.n1), gen)
    x2 = random_residues(primes, (PAR_NTT_B * plan.n1 // world, plan.n2), gen)
    rows = [check_kernel(
        f"stage_tw (K10a, dist NTT stage 1 x twiddle, {list(x1.shape)}, "
        f"twiddle {list(tw.shape)})", "stage_tw",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:460",
        lambda: st1.kernel(x1, tw), lambda: st1.plain(x1, tw),
        [st1.table, x1, tw], stage_work(st1, x1))]
    rows[0]["paths"] = ("7_parallel",)
    rows.append(check_kernel(
        f"stage (K1, dist NTT stage 2, {list(x2.shape)})", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: st2.kernel(x2), lambda: st2.plain(x2), [st2.table, x2],
        stage_work(st2, x2)))
    del dn, x1, x2

    p = get_params("ref")
    W, n = p.phi, p.n
    rc = RelinContext(HEContext(p, ring="nega", device=device))
    qp = ShardedWTransform(rc.wt_qp, lanes, "tp")._fwd
    d_w = random_residues(rc.qp_moduli, (W, n * n), gen)
    rows.append(check_kernel(
        f"stage (K1, key switch's QP W-CRT forward on lanes 0-"
        f"{W // world - 1}, table {list(qp.table.shape)}, "
        f"{list(d_w.shape)})", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: qp.kernel(d_w), lambda: qp.plain(d_w), [qp.table, d_w],
        stage_work(qp, d_w)))
    del rc, qp, d_w
    torch.cuda.empty_cache()

    ctx = HEContext(p, device=device)
    sp = ShardedPipeline(ctx, msgs)
    k2, s_mont = ctx.xntt._mul_s, ctx.generate_secret_key().s_mont
    a_rows = sp._a_rows.reshape(len(p.moduli), -1, n)
    rows.append(check_kernel(
        f"ntt_mul_ntt (K2, pipeline rows {sp.rows.start}-{sp.rows.stop - 1}"
        f" of {n}, {list(a_rows.shape)})", "ntt_mul_ntt",
        "matrix_fhe_tpu_torch/csrc/ntt_mul_ntt.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1851",
        lambda: k2.kernel(a_rows, s_mont), lambda: k2.plain(a_rows, s_mont),
        [k2.fwd, k2.inv, a_rows, s_mont], ntt_mul_ntt_work(k2, a_rows)))
    return rows


# the kernels each sharded program must launch (its window's counts)
PAR_NEEDS = {"ntt": ("stage", "stage_tw"),
             "pipeline": ("stage", "ntt_mul_ntt", "inv_compose",
                          "fp_cmatmul"),
             "keyswitch": ("stage", "stage_tw")}


def parallel_rank(device, dp: int, tp: int, rows: bool) -> dict:
    """One rank of path 7: the dist NTT at N = 2^17 over every rank, the
    ref ShardedPipeline on dp x tp, the ref W-sharded multiply_relinearize
    over every rank, each held to its single-rank result on rank 0, each
    with the launches of its sharded calls alone; then, with `rows`, the
    kernel rows of parallel_rows (after the launches are taken)."""
    from matrix_fhe_tpu_torch.scripts import bench_dist as bd
    world = torch.distributed.get_world_size()
    out = {}
    for name, run in (
            ("ntt", lambda: bd.rank_dist_ntt(device, PAR_NTT_N, 35, PAR_NTT_L,
                                             PAR_NTT_B, iters=5)),
            ("pipeline", lambda: bd.rank_pipeline(device, "ref", dp, tp,
                                                  PAR_MSGS, 7, -4.0, 4.0)),
            ("keyswitch", lambda: bd.rank_keyswitch(device, "ref", world))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize(device)
        res["wall_s"] = time.perf_counter() - t0
        res.pop("out", None)
        res.pop("spectrum", None)
        out[name] = res
    if rows:
        out["rows"] = parallel_rows(device, dp, tp)
    return out


def parallel_path(ntt16_rate: float):
    """Path 7: parallel/ on the one card.  (b) four gloo ranks on cuda:0
    (parallel_rank: dist NTT, ref pipeline at dp 2 x tp 2, ref W-sharded
    key switch at tp 4), (c) the same programs in a one-rank nccl world,
    (d) scripts.bench_dist's card mode on four gloo ranks with the cost
    model anchored on path 2's NTT/s.  The path's launches are the
    sharded calls' (each program's own window, every rank's), and each
    program must launch its kernels (PAR_NEEDS; the limb-sharded NTT K5);
    any failed rank or check fails the script.  Returns (rows, summary,
    launches)."""
    from matrix_fhe_tpu_torch.parallel import launch
    from matrix_fhe_tpu_torch.scripts import bench_dist as bd

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    launches: dict = {}
    summary = {}
    rows = []
    for label, ranks, backend, dp, tp in (("gloo4", 4, "gloo", 2, 2),
                                          ("nccl1", 1, "nccl", 1, 1)):
        t0 = time.perf_counter()
        res = launch.run_world(parallel_rank, ranks, backend, "cuda", WORLD_S,
                               dp, tp, label == "gloo4")
        wall = time.perf_counter() - t0
        r0 = res[0]
        checks = {
            "dist NTT == single-device forward (stage route)":
                r0["ntt"]["equal_single"],
            "dist NTT == forward_plain": r0["ntt"]["equal_plain"],
            "dist NTT inverse exact": all(r["ntt"]["inverse_exact"]
                                          for r in res),
            "pipeline == roundtrip_batch": r0["pipeline"]["equal_unsharded"],
            f"pipeline err < {TOL}": (r0["pipeline"]["finite"]
                                      and r0["pipeline"]["err"] < TOL),
            "key switch == unsharded": r0["keyswitch"]["equal_unsharded"],
            "same keys on every rank": all(r["keyswitch"]["same_inputs"]
                                           for r in res),
            "noise < 2^25": r0["keyswitch"]["noise"] < 1 << 25}
        what = ("a validation, not a scaling figure" if ranks > 1
                else "the nccl wiring")
        log(f"[parallel] {label}: {ranks} {backend} rank(s) on one card "
            f"({what}), world wall {wall:.1f} s; checks "
            + ", ".join(f"{k}: {v}" for k, v in checks.items()))
        for prog, keys in (("ntt", ("fwd_ms", "inv_ms", "fwd_first_ms",
                                     "single_ms")),
                           ("pipeline", ("ms", "err")),
                           ("keyswitch", ("ms", "noise"))):
            log(f"[parallel] {label} {prog}: " + "; ".join(
                f"rank {i} block {r[prog]['block']} "
                + " ".join(f"{k} {r[prog][k]:.3f}" for k in keys
                           if k in r[prog])
                + f" wall {r[prog]['wall_s']:.1f} s, peak "
                f"{r[prog]['peak'] / 2**30:.3f} GiB" for i, r in enumerate(res)))
        if not all(checks.values()):
            raise AssertionError(f"path 7 {label}: a check failed: {checks}")
        by_prog = {}
        for prog, needs in PAR_NEEDS.items():
            got = by_prog[prog] = {}
            for r in res:
                for k, v in r[prog]["launches"].items():
                    got[k] = got.get(k, 0) + v
            log(f"[parallel] {label} {prog}: launches of the sharded calls "
                f"(all ranks) {got}")
            missing = [k for k in needs if got.get(k, 0) <= 0]
            if missing:
                raise AssertionError(
                    f"path 7 {label} {prog} launched no {missing}: {got}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        if "rows" in r0:
            rows += r0["rows"]
        summary[f"parallel_{label}"] = {
            "world_wall_s": wall, "ranks": ranks, "backend": backend,
            "ntt_fwd_ms": [r["ntt"]["fwd_ms"] for r in res],
            "ntt_inv_ms": [r["ntt"]["inv_ms"] for r in res],
            "ntt_fwd_first_ms": [r["ntt"]["fwd_first_ms"] for r in res],
            "ntt_single_ms": r0["ntt"]["single_ms"],
            "pipeline_ms": [r["pipeline"]["ms"] for r in res],
            "pipeline_err": r0["pipeline"]["err"],
            "keyswitch_ms": [r["keyswitch"]["ms"] for r in res],
            "keyswitch_noise": r0["keyswitch"]["noise"],
            "peak_bytes": {prog: [r[prog]["peak"] for r in res]
                           for prog in ("ntt", "pipeline", "keyswitch")},
            "launches": by_prog}

    t0 = time.perf_counter()
    bench = bd.card(4, "gloo", ntt16_rate, NVLINK_GBPS, IB_GBPS,
                    timeout_s=WORLD_S)
    if bench["launches"].get("four_step_fwd", 0) <= 0:
        raise AssertionError(f"bench_dist's limb-sharded NTT launched no K5: "
                             f"{bench['launches']}")
    for k, v in bench.pop("launches").items():
        launches[k] = launches.get(k, 0) + v
    log(f"[parallel] bench_dist card mode ({time.perf_counter() - t0:.1f} s, "
        f"{bench.get('note', '')}): " + json.dumps(bench))
    if not bench["ok"]:
        raise AssertionError("bench_dist card mode: a sharded NTT disagrees")
    summary["parallel_bench_dist"] = bench
    summary["parallel_parent_memory_held"] = held
    log(f"[parallel] launches over path 7 (the sharded calls on every rank "
        f"of the three worlds): {launches}")
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)
    return rows, summary, launches


# -- path 8: the entry points, each in a process of its own ---------------------

ENTRY_S = 600                   # one entry point's time limit
# (label, command after the interpreter, pass line, the kernels its own
# calls must launch -- each prints the launches of those calls alone, not
# of its set-up, keys, encryptions, oracles, baselines, fences or rank 0's
# unsharded references: the launch keys of K1 stage, K10a-tw stage_tw, K2
# ntt_mul_ntt, K3 inv_compose, K4 fp_cmatmul, K5 four_step_fwd, K6 cgemm,
# K7 gemm2x2)
ENTRY_POINTS = (
    ("main", ["-m", "matrix_fhe_tpu_torch.examples.main"], r"SUCCESS \(",
     ("stage", "ntt_mul_ntt", "inv_compose", "fp_cmatmul")),
    ("matmul", ["-m", "matrix_fhe_tpu_torch.examples.matmul"],
     r"\[matmul\] PASS$", ("cgemm", "ntt_mul_ntt", "stage", "fp_cmatmul")),
    ("matmul_gl2", ["-m", "matrix_fhe_tpu_torch.examples.matmul_gl2"],
     r"\[gl2-gemm\] OK$", ("gemm2x2", "ntt_mul_ntt", "stage", "fp_cmatmul")),
    ("relinearize", ["-m", "matrix_fhe_tpu_torch.examples.relinearize"],
     r"\[relin\] PASS$", ("stage_tw", "stage")),
    ("leveled", ["-m", "matrix_fhe_tpu_torch.examples.leveled"],
     r"\[leveled\] \|ct - oracle\| composed max = \d+ \(OK\)$",
     ("stage_tw", "stage", "ntt_mul_ntt")),
    ("bench", ["-m", "matrix_fhe_tpu_torch.scripts.bench"], r'^\{"metric": ',
     ("four_step_fwd", "stage", "ntt_mul_ntt", "inv_compose", "fp_cmatmul")),
    ("dryrun_multichip(4)", ["-m", "matrix_fhe_tpu_torch.entry", "--dryrun",
                             "4"], r"\[dryrun\] OK$",
     ("stage", "stage_tw", "ntt_mul_ntt", "inv_compose", "fp_cmatmul",
      "gemm2x2")),
)
# FourStepNTT's sizes held to its plain version: n1 != n2 takes the stage
# route (N = 2^13 is 64 x 128, 2^15 128 x 256, 2^17 256 x 512)
FOUR_STEP_LOGS, FOUR_STEP_L, FOUR_STEP_B = (13, 15, 17), 4, 2


def entry_point(label, args, pass_line, needs) -> dict:
    """Run one entry point as its own process from the repository root:
    exit code 0, its pass line, and a {"launches": ...} line that names
    every kernel in `needs`.  Returns its wall time, launches and, for the
    bench, its JSON line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=ENTRY_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines[-12:] + [ln for ln in proc.stderr.splitlines()
                               if ln.startswith("[bench]")]:
        log(f"[entry {label}] {line}")
    if proc.returncode != 0:
        log(f"[entry {label}] stderr: {proc.stderr[-4000:]}")
        raise AssertionError(f"{label} exited with {proc.returncode}")
    if not any(re.search(pass_line, line) for line in lines):
        raise AssertionError(f"{label}: no pass line /{pass_line}/")
    found = [json.loads(line)["launches"] for line in lines
             if line.startswith('{"launches": ')]
    if len(found) != 1:
        raise AssertionError(f"{label}: {len(found)} launches lines")
    launches = found[0]
    missing = [k for k in needs if launches.get(k, 0) <= 0]
    log(f"[entry {label}] exit 0 in {wall:.1f} s; launches {launches}")
    if missing:
        raise AssertionError(f"{label} launched no {missing}: {launches}")
    out = {"wall_s": wall, "launches": launches}
    if label == "bench":
        out["json"] = json.loads(next(line for line in lines
                                      if line.startswith('{"metric": ')))
    return out


def four_step_check(gen):
    """FourStepNTT.forward / inverse on the card at N = 2^13, 2^15, 2^17
    (L = 4 x 35 bits, B = 2), held to forward_plain / inverse_plain bit
    for bit, counted: the stage route, K10a-tw and K1, and no K5.  Then
    K10a-tw and K1 against their plain versions at the route's N = 2^17
    stage shapes.  Returns (rows, summary, launches)."""
    from matrix_fhe_tpu_torch.ops import _backend as be
    from matrix_fhe_tpu_torch.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                                    generate_primes_1mod)
    summary = {}
    objs = {}
    torch.cuda.synchronize()
    be.reset_launches()
    for lg in FOUR_STEP_LOGS:
        n = 1 << lg
        primes = generate_primes_1mod(FOUR_STEP_L, 35, 2 * n)
        ntt = objs[lg] = FourStepNTT(FourStepPlan.make(n, primes), "cuda")
        x = random_residues(primes, (FOUR_STEP_B, n), gen)
        spec = ntt.forward(x)
        back = ntt.inverse(spec)
        torch.cuda.synchronize()
        same = (torch.equal(spec, ntt.forward_plain(x))
                and torch.equal(back, ntt.inverse_plain(spec))
                and torch.equal(back, x))
        fwd_ms = cuda_ms(lambda: ntt.forward(x), 5)
        inv_ms = cuda_ms(lambda: ntt.inverse(spec), 5)
        plain_ms = cuda_ms(lambda: ntt.forward_plain(x), 2)
        summary[f"four_step_2^{lg}"] = {"fwd_ms": fwd_ms, "inv_ms": inv_ms,
                                        "fwd_plain_ms": plain_ms}
        log(f"[four-step] N = 2^{lg} ({ntt.plan.n1} x {ntt.plan.n2}), L = "
            f"{FOUR_STEP_L}, B = {FOUR_STEP_B}: forward {fwd_ms:.3f} ms, "
            f"inverse {inv_ms:.3f} ms, forward_plain {plain_ms:.3f} ms; "
            f"== forward_plain / inverse_plain, inverse exact: {same}")
        if not same:
            raise AssertionError(f"FourStepNTT at N = 2^{lg} on the card "
                                 "differs from its plain version")
    torch.cuda.synchronize()
    launches = dict(be.LAUNCHES)
    log(f"[four-step] launches (first calls and the timed ones): {launches}")
    if launches.get("four_step_fwd", 0) or launches.get("four_step_inv", 0):
        raise AssertionError(f"the stage route launched K5: {launches}")
    if launches.get("stage", 0) <= 0 or launches.get("stage_tw", 0) <= 0:
        raise AssertionError(f"the stage route launched no K1 / K10a-tw: "
                             f"{launches}")
    st = objs[FOUR_STEP_LOGS[-1]].stages
    p = st.plan
    st1, st2 = st.st["t1f"], st.st["t2f"]
    x1 = random_residues(p.moduli, (FOUR_STEP_B * p.n2, p.n1), gen)
    x2 = random_residues(p.moduli, (FOUR_STEP_B * p.n1, p.n2), gen)
    rows = [check_kernel(
        f"stage_tw (K10a, FourStepNTT stage route stage 1 x twiddle, N = "
        f"2^{FOUR_STEP_LOGS[-1]}, {list(x1.shape)}, twiddle "
        f"{list(st.tw_f.shape)})", "stage_tw",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:460",
        lambda: st1.kernel(x1, st.tw_f), lambda: st1.plain(x1, st.tw_f),
        [st1.table, x1, st.tw_f], stage_work(st1, x1))]
    rows[0]["paths"] = ("8_four_step",)
    rows.append(check_kernel(
        f"stage (K1, FourStepNTT stage route stage 2, N = "
        f"2^{FOUR_STEP_LOGS[-1]}, {list(x2.shape)})", "stage",
        "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:1633",
        lambda: st2.kernel(x2), lambda: st2.plain(x2), [st2.table, x2],
        stage_work(st2, x2)))
    for row in rows:
        row["launches"] = launches.get(row.pop("key"), 0)
    return rows, summary, launches


def entry_points_path(gen):
    """Path 8: each example at its JAX default preset, scripts.bench at its
    defaults and entry.dryrun_multichip(4), each as its own process (exit
    code 0, its pass line, the kernels it must launch); then FourStepNTT's
    stage route in process (four_step_check).  Returns (rows, summary,
    launches of the entry points, launches of the stage-route check)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary, launches = {}, {}
    for label, args, pass_line, needs in ENTRY_POINTS:
        res = entry_point(label, args, pass_line, needs)
        summary[f"entry_{label}_wall_s"] = res["wall_s"]
        summary[f"entry_{label}_launches"] = res["launches"]
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if "json" in res:
            summary["bench"] = res["json"]
            log("[bench] " + json.dumps(res["json"]))
    rows, ntt_summary, ntt_launches = four_step_check(gen)
    summary.update(ntt_summary)
    return rows, summary, launches, ntt_launches


def serialization_check(ctx, ct_re, ct_im, sk) -> dict:
    """A ref ciphertext (the pair's real part) and the secret key through
    utils.serialization: saved to a temporary directory, loaded onto the
    card, equal to the originals, and the pair decrypted and decoded with
    the loaded ciphertext and key bit for bit as with the originals."""
    import tempfile

    from matrix_fhe_tpu_torch.utils import serialization as ser

    p = ctx.params
    want = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f) for f in ("re.npz", "sk.npz")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ser.save_ciphertext(paths[0], ct_re, p)
        ser.save_secret_key(paths[1], sk, p)
        t1 = time.perf_counter()
        l_re = ser.load_ciphertext(paths[0], p)
        l_sk = ser.load_secret_key(paths[1], p)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = sum(os.path.getsize(f) for f in paths)
    got = ctx.decrypt_and_decode(l_re, ct_im, l_sk)
    same = all(torch.equal(a, b) for a, b in zip(
        (l_re.b, l_re.a, l_sk.s_mont), (ct_re.b, ct_re.a, sk.s_mont)))
    same = same and all(torch.equal(a, b) for a, b in zip(got, want))
    raw = nbytes([ct_re.b, ct_re.a, sk.s_mont])
    log(f"[serialize] ref ciphertext + secret key: {raw} B of residues "
        f"-> {size} B of .npz; save {t1 - t0:.3f} s, load onto the card "
        f"{t2 - t1:.3f} s; loaded objects decrypt and decode bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("serialized ref ciphertexts / key differ after load")
    return {"ref_serialize_save_s": t1 - t0, "ref_serialize_load_s": t2 - t1,
            "ref_serialize_bytes": size, "ref_serialize_raw_bytes": raw}


def w_vandermonde(p, q: int) -> np.ndarray:
    """The W-CRT forward matrix mod q, V[w][r] = eta^(exp_w r), built from
    the modulus and the preset's exponents alone: eta = g^((q-1)/p) for the
    smallest g >= 2 of exact order p = f1 f2 (HE.cu:119-133)."""
    f1, f2 = p.p_factors
    for g in range(2, q):
        eta = pow(g, (q - 1) // p.p, q)
        if (eta != 1 and pow(eta, p.p, q) == 1
                and pow(eta, p.p // f1, q) != 1 and pow(eta, p.p // f2, q) != 1):
            break
    v = np.empty((p.phi, p.phi), dtype=np.uint64)
    for w, e in enumerate(p.w_exponents):
        root, acc = pow(eta, int(e), q), 1
        for r in range(p.phi):
            v[w, r] = acc
            acc = acc * root % q
    return v


def golden_check(ctx) -> dict:
    """The independent C++ oracle (native/golden) against K1 on the card at
    every ref limb: the X-NTT polymul on a few lanes (forward, pointwise
    product, inverse) against the schoolbook product mod X^n - wrap, and
    the W-CRT forward on a few columns against the modular matvec on a
    Vandermonde built from the moduli alone (w_vandermonde)."""
    from matrix_fhe_tpu_torch.native import golden
    from matrix_fhe_tpu_torch.ops import modmath as mm

    if not golden.available():
        raise AssertionError("the golden oracle did not build (g++)")
    p = ctx.params
    L, W, n = len(p.moduli), p.phi, p.n
    lanes, cols = 4, 4
    rng = np.random.default_rng(17)
    a, b = (np.stack([rng.integers(0, q, (lanes, n), dtype=np.uint64)
                      for q in p.moduli]) for _ in range(2))
    x = np.stack([rng.integers(0, q, (W, cols), dtype=np.uint64)
                  for q in p.moduli])

    def dev(v):
        return torch.from_numpy(v.view(np.int64)).cuda()

    xn = ctx.xntt
    q = mm.moduli_col(p.moduli, 2, "cuda")
    prod = xn.inverse(mm.mul_mod(xn.forward(dev(a)), xn.forward(dev(b)), q))
    prod = prod.cpu().numpy().view(np.uint64)
    wfwd = ctx.wt.forward(dev(x)).cpu().numpy().view(np.uint64)
    bad = []
    for l, ql in enumerate(p.moduli):
        for r in range(lanes):
            want = golden.polymul_wrap(int(ql), xn.wrap_constant(l), a[l, r],
                                       b[l, r])
            if not (prod[l, r] == want).all():
                bad.append(("polymul", l, r))
        v = w_vandermonde(p, int(ql))
        for c in range(cols):
            if not (wfwd[l, :, c] == golden.mod_matvec(int(ql), v,
                                                      x[l, :, c])).all():
                bad.append(("matvec", l, c))
    log(f"[golden] K1 on the card against the C++ oracle at all {L} ref "
        f"limbs: X-NTT polymul on {lanes} lanes (wrap q - 1) and W-CRT "
        f"forward on {cols} columns, the matvec on a Vandermonde built here "
        f"from the moduli (not the port's table), bit for bit: {not bad}")
    if bad:
        raise AssertionError(f"K1 differs from the golden oracle: {bad[:4]}")
    return {"golden_limbs": L, "golden_lanes": lanes, "golden_columns": cols}


def surface_check(ctx) -> dict:
    """The encoder / W-CRT surface on the card: Encoder.encode and
    decode_lane_from_rns_eval on a few ref lanes (K4, error < 1e-4),
    WTransform.inverse_scaled (K1 on the scaled tables) against inverse()
    times M_l^-1 mod q_l, and the centered oracle at tiny1, whose
    forward_centered -> inverse_centered roundtrip is exact, bit for bit
    with the CPU."""
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.ops import modmath as mm
    from matrix_fhe_tpu_torch.ops.wcrt import WTransform

    p = ctx.params
    rng = np.random.default_rng(19)
    lanes = 4
    mr, mi = (torch.from_numpy(rng.uniform(-4, 4, (lanes, p.n, p.n))).cuda()
              for _ in range(2))
    rr, ri = ctx.encoder.encode(mr, mi)
    dr, di = ctx.encoder.decode_lane_from_rns_eval(rr, ri)
    lane_err = float(torch.hypot(dr - mr, di - mi).max())
    x = random_residues(p.moduli, (p.phi, 4), torch.Generator(
        device="cuda").manual_seed(19))
    crt_inv = mm.moduli_col([int(v) for v in ctx.tables.crt_inv], 2, "cuda")
    scaled_ok = torch.equal(ctx.wt.inverse_scaled(x),
                            mm.mul_mod(ctx.wt.inverse(x), crt_inv,
                                       mm.moduli_col(p.moduli, 2, "cuda")))
    p1 = get_params("tiny1")
    coeff = torch.from_numpy(((np.arange(p1.phi)[:, None, None]
                               + np.arange(p1.n)[None, None, :]
                               + np.arange(p1.n)[None, :, None]) % 17 - 8))
    outs = []
    for dev in ("cuda", "cpu"):
        wt1 = WTransform(p1, device=dev)
        ev = wt1.forward_centered(coeff.to(dev))
        outs.append((ev.cpu(), wt1.inverse_centered(ev).cpu()))
    centered_ok = (torch.equal(outs[0][1], coeff)
                   and all(torch.equal(a, b) for a, b in zip(*outs)))
    log(f"[surface] ref lane encode -> decode on {lanes} lanes (K4): max err "
        f"{lane_err:.3e}; inverse_scaled (K1 on K3's Stage) == inverse x "
        f"M_l^-1: "
        f"{scaled_ok}; tiny1 centered roundtrip exact, card == CPU: "
        f"{centered_ok}")
    if not (lane_err < TOL and scaled_ok and centered_ok):
        raise AssertionError("the encoder / W-CRT surface failed on the card")
    return {"ref_lane_encode_err": lane_err}


def profiler_check(ctx, re_t, im_t, sk) -> dict:
    """One ref roundtrip under utils.profiler.trace with an
    annotate("roundtrip") span: the Chrome trace must hold the span and a
    CUDA kernel event of K2 (ntt_mul_ntt_kernel)."""
    import tempfile

    from matrix_fhe_tpu_torch.utils import profiler

    with tempfile.TemporaryDirectory() as d:
        with profiler.trace(d):
            with profiler.annotate("roundtrip"):
                ctx.roundtrip(re_t, im_t, sk)
        (name,) = os.listdir(d)
        size = os.path.getsize(os.path.join(d, name))
        with open(os.path.join(d, name)) as f:
            events = json.load(f)["traceEvents"]
    span = any(e.get("name") == "roundtrip" for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2 = [e for e in kernels if "ntt_mul_ntt_kernel" in e.get("name", "")]
    log(f"[profiler] ref roundtrip trace: {size} B, {len(events)} events, "
        f"span 'roundtrip': {span}, {len(kernels)} CUDA kernel events, "
        f"{len(k2)} of K2 (ntt_mul_ntt_kernel)")
    if not (span and k2):
        raise AssertionError("the profiler trace lacks the roundtrip span or "
                             "a K2 kernel event")
    return {"ref_trace_bytes": size, "ref_trace_kernel_events": len(kernels)}


def gl2_conj_path(ctx, hm, rc, sk, X, gen):
    """Gl2Conj at ref on path 4's gl2 context, RelinContext (the preset's P,
    dnum 4) and secret key: the conjugation key, then encrypt X,
    conjugate, decrypt and decode, counted; error against conj(X) below
    1e-4; keygen and apply times; then a tiny conjugation on the card with
    a key made on the CPU against the CPU, and K10a's twiddle form against
    its plain version at the digit steps' shape (outside the counted run).
    Returns (row, summary, launches of the counted run, launches of one
    apply)."""
    from matrix_fhe_tpu_torch.config import get_params
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2, Gl2Context
    from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2Conj, HEMatmul2
    from matrix_fhe_tpu_torch.models.keyswitch import RelinContext, RelinKey
    from matrix_fhe_tpu_torch.ops import _backend as be

    xr, xi = (torch.from_numpy(v).cuda() for v in (X.real, X.imag))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    be.reset_launches()
    t0 = time.perf_counter()
    cj = Gl2Conj(hm, rc, sk, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ct = ctx.encrypt(ctx.encode(xr, xi), sk, gen)
    torch.cuda.synchronize()
    launches_before = dict(be.LAUNCHES)
    t1a = time.perf_counter()
    ct_c = cj.apply(ct)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    apply_launches = {k: v - launches_before.get(k, 0)
                      for k, v in be.LAUNCHES.items()
                      if v != launches_before.get(k, 0)}
    dr, di = ctx.decrypt_and_decode(ct_c, sk)
    torch.cuda.synchronize()
    launches = dict(be.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    key_bytes = nbytes(list(cj._ksk.b) + list(cj._ksk.a))
    got = dr.cpu().numpy() + 1j * di.cpu().numpy()
    err = float(np.abs(got - np.conj(X)).max())
    log(f"[conj] Gl2Conj at ref: key {key_bytes} B (dnum {rc.dnum}, "
        f"[{len(rc.qp_moduli)}, {ctx.params.phi}, {ctx.params.n}, "
        f"{2 * ctx.params.n}] a digit and component), first keygen "
        f"{1e3 * (t1 - t0):.1f} ms, first apply {1e3 * (t2 - t1a):.1f} ms; "
        f"max |dec - conj(X)| = {err:.3e} (limit {TOL}); "
        f"max_memory_allocated {peak} B, {peak - held} B above what was held "
        f"before; launches over keygen, encrypt, apply, decrypt+decode "
        f"{launches}; in one apply {apply_launches}")
    if got.shape != X.shape or not np.isfinite(got).all() or not err < TOL:
        raise AssertionError(f"ref gl2 conjugation err {err} >= {TOL}")

    keygen_ms = statistics.median(
        cuda_ms(lambda: Gl2Conj(hm, rc, sk, gen), warmup=False)
        for _ in range(3))
    apply_ms = statistics.median(cuda_ms(lambda: cj.apply(ct), warmup=False)
                                 for _ in range(3))
    log(f"[conj] keygen {keygen_ms:.3f} ms, apply {apply_ms:.3f} ms (median "
        f"of 3 after the first call, CUDA events); K1 {apply_launches.get('stage', 0)}, "
        f"stage_tw {apply_launches.get('stage_tw', 0)}, K2 "
        f"{apply_launches.get('ntt_mul_ntt', 0)} launches in one apply")
    del cj, ct, ct_c
    torch.cuda.empty_cache()

    # K10a's twiddle form at the digit steps' shape: the gl2 QP X-NTT
    # (2n = 128 points) fused with a key product, [Lqp, W n, 2n]
    qp, m = rc.qp_moduli, 2 * ctx.params.n
    fwd_x = rc.xntt_qp._fwd
    d = random_residues(qp, (ctx.params.phi * ctx.params.n, m), gen)
    tw = random_residues(qp, (ctx.params.phi * ctx.params.n, m), gen)
    row = check_kernel(
        f"stage_tw (K10a, gl2 QP X-NTT x twiddle, {m} points, {len(qp)} "
        f"limbs)", "stage_tw", "matrix_fhe_tpu_torch/csrc/stage.cu",
        "matrix_fhe_tpu/ops/pallas_ntt.py:460",
        lambda: fwd_x.kernel(d, tw), lambda: fwd_x.plain(d, tw),
        [fwd_x.table, d, tw], stage_work(fwd_x, d))
    row["launches"] = launches.get(row.pop("key"), 0)
    row["paths"] = ("4_gl2_conj",)
    del d, tw
    torch.cuda.empty_cache()

    # a tiny conjugation: key and ciphertext made on the CPU, applied on
    # the card and on the CPU's plain path, the same bits
    pt = get_params("tiny")
    cpu = Gl2Context(pt, device="cpu")
    hm_c = HEMatmul2(cpu)
    g = torch.Generator().manual_seed(5)
    sk_c = cpu.generate_secret_key(g)
    r2 = np.random.default_rng(5)
    ct_t = cpu.encrypt(cpu.encode(
        torch.from_numpy(r2.uniform(-1, 1, (pt.phi, pt.n, pt.n))),
        torch.from_numpy(r2.uniform(-1, 1, (pt.phi, pt.n, pt.n)))), sk_c, g)
    cj_c = Gl2Conj(hm_c, RelinContext(cpu), sk_c, g)
    want = cj_c.apply(ct_t)
    gpu = Gl2Context(pt, device="cuda")
    cj_g = Gl2Conj.from_key(HEMatmul2(gpu), RelinContext(gpu), RelinKey(
        *(tuple(k.cuda() for k in part) for part in cj_c._ksk)))
    got_t = cj_g.apply(Ciphertext2(*(t.cuda() for t in ct_t)))
    if not (torch.equal(got_t.b.cpu(), want.b)
            and torch.equal(got_t.a.cpu(), want.a)):
        raise AssertionError("tiny gl2 conjugation on the card differs from "
                             "the CPU path")
    log("[check] tiny gl2 conjugation: card == CPU plain path, bit for bit")
    summary = {"ref_conj_err": err, "ref_conj_keygen_ms": keygen_ms,
               "ref_conj_apply_ms": apply_ms, "ref_conj_key_bytes": key_bytes,
               "ref_conj_first_keygen_s": t1 - t0,
               "ref_conj_first_apply_s": t2 - t1a,
               "ref_conj_memory_above_held": peak - held,
               "ref_conj_apply_launches": apply_launches}
    return row, summary, launches, apply_launches


def finalize_rows(rows) -> None:
    """bound_ms (the larger of bytes over the memory rate and each type of
    operations over its peak; "imad" counts IMADs) and bound_by, for every
    row, and a [bound] line with its byte and operation bounds apart."""
    peaks = {"int8": INT8_OPS_PER_S, "int32": INT32_OPS_PER_S,
             "imad": IMAD_PER_S}
    for row in rows:
        t_bytes = row.pop("bytes") / HBM_BYTES_PER_S
        work = row.pop("work")
        t_work = {k: v / peaks[k] for k, v in work.items()}
        t_ops = max(t_work.values())
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row.setdefault("library_ms", None)
        log(f"[bound] {row['name']}: {row['ms']:.3f} ms; bytes "
            f"{1e3 * t_bytes:.3f} ms, "
            + ", ".join(f"{k} {1e3 * t:.3f} ms" for k, t in t_work.items()))


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

    t_run = time.perf_counter()
    walls = {}
    t0 = time.perf_counter()
    be.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    funcs = sass_functions()
    k5_imads = k5_imads_per_product(funcs)
    igmma = {name: tensor_core_ops(funcs, kernel) for name, kernel in (
        ("K1 stage_kernel (u8)", "stage_kernel"),
        ("K2 ntt_mul_ntt_kernel (u8)", "ntt_mul_ntt_kernel"),
        ("K4 fp_cmatmul_kernel (s8)", "fp_cmatmul_kernel"),
        ("K6 cgemm_kernel (u8)", "cgemm_kernel"),
        ("K7 gemm2x2_kernel (u8)", "gemm2x2_kernel"),
        ("K12 coissue_kernel<mxu> (s8)", "coissue_kernelILi1E"),
        ("K12 coissue_kernel<both> (s8)", "coissue_kernelILi3E"),
        ("K12 coissue_kernel<dep> (s8)", "coissue_kernelILi4E"))}
    log(f"[sass] K5 four_step_reg at R = 16: {k5_imads[64]:.2f} IMADs on "
        f"registers a Shoup product on 64-bit words, {k5_imads[32]:.2f} on "
        f"32-bit words; IGMMA (wgmma) instructions: "
        + ", ".join(f"{k} {v}" for k, v in igmma.items())
        + " (cuobjdump -sass)")
    t_path = time.perf_counter()

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
    # K3 is a split, K1's GEMM and a compose under keys of its own, K4 a
    # split and its GEMM
    for parts in (("inv_compose", "inv_compose_stage", "inv_compose_split"),
                  ("fp_cmatmul", "fp_cmatmul_split")):
        if len({launches.get(k, 0) for k in parts}) != 1:
            raise AssertionError(f"launches of {parts} differ: {launches}")
    for out in (dr, di, d2r, d2i):
        if out.shape != (p.phi, p.n, p.n) or not torch.isfinite(out).all():
            raise AssertionError("decoded output has the wrong shape or "
                                 "non-finite values")

    # -- roundtrip time and memory ------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    ctx.roundtrip(re_t, im_t, sk)
    torch.cuda.synchronize()
    times = [cuda_ms(lambda: ctx.roundtrip(re_t, im_t, sk), warmup=False)
             for _ in range(7)]
    rt_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    log(f"[perf] ref roundtrip median {rt_ms:.3f} ms over {len(times)} runs "
        f"(min {min(times):.3f}, max {max(times):.3f}); "
        f"max_memory_allocated {peak / 2**30:.3f} GiB (3.130 with the earlier "
        "64-bit K3 and K4 kernels)")

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
    walls["1_roundtrip"] = time.perf_counter() - t_path

    # -- path 1: the phase table, serialization, the oracle, a trace ----------
    from matrix_fhe_tpu_torch.scripts import rt_phases
    t0 = time.perf_counter()
    rtp = rt_phases.run("ref", 5)
    log(f"[rt-phases] sum of the phases {rtp['phase_sum_ms']:.3f} ms, fused "
        f"roundtrip {rtp['fused_ms']:.3f} ms, error {rtp['err']:.3e}")
    if not (np.isfinite(rtp["err"]) and rtp["err"] < TOL):
        raise AssertionError(f"rt_phases roundtrip err {rtp['err']} >= {TOL}")
    walls["1_rt_phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    extra = serialization_check(ctx, ct_re, ct_im, sk)
    walls["1_serialization"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    extra.update(golden_check(ctx))
    extra.update(surface_check(ctx))
    walls["1_golden"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    extra.update(profiler_check(ctx, re_t, im_t, sk))
    walls["1_profiler"] = time.perf_counter() - t0
    del ct_re, ct_im

    # -- path 2: the bench NTT (K5) ----------------------------------------
    summary = {"ref_roundtrip_ms": rt_ms, "ref_roundtrip_err": err_rt,
               "ref_step_api_err": err_steps, "max_memory_allocated": peak,
               "k5_imads_per_product": k5_imads, "rt_phases_ref": rtp}
    summary.update(extra)
    t_path = time.perf_counter()
    for bits in (35, 28):
        ntt_rows, ntt_summary = ntt_path(bits, gen, k5_imads)
        rows += ntt_rows
        summary.update(ntt_summary)
        torch.cuda.empty_cache()
    walls["2_ntt"] = time.perf_counter() - t_path

    # -- path 3: the homomorphic matrix product at ref (K6) -----------------
    t_path = time.perf_counter()
    mm_rows, mm_summary, mm_launches = matmul_path()
    rows += mm_rows
    summary.update(mm_summary)
    torch.cuda.empty_cache()
    walls["3_matmul"] = time.perf_counter() - t_path

    # -- path 4: the gl2 ciphertext GEMM at ref (K7, K2 at 2n = 128) --------
    t_path = time.perf_counter()
    gl2_rows, gl2_summary, gl2_launches, conj_launches = gl2_path()
    rows += gl2_rows
    summary.update(gl2_summary)
    torch.cuda.empty_cache()          # path 4's 15 GB of switch keys go
    walls["4_gl2"] = time.perf_counter() - t_path
    walls["4_gl2_conj"] = gl2_summary["ref_conj_wall_s"]

    # -- path 5: key switching and the leveled chain at ref (K10a) ----------
    t_path = time.perf_counter()
    ks_rows, ks_summary, ks_launches, off_path = leveled_path()
    for row in ks_rows:
        row["launches"] = ks_launches.get(row.pop("key"), 0)
    rows += ks_rows
    summary.update(ks_summary)
    walls["5_keyswitch"] = time.perf_counter() - t_path

    # -- path 5b: mid's key switch (dnum 1, 28-bit P), card == CPU -----------
    t_path = time.perf_counter()
    mid_rows, mid_summary, mid_launches = mid_keyswitch_path()
    for row in mid_rows:
        row["launch_key"] = row.pop("key")
        row["launches"] = mid_launches.get(row["launch_key"], 0)
    rows += mid_rows
    summary.update(mid_summary)
    walls["5b_mid_keyswitch"] = time.perf_counter() - t_path

    # -- the probes (K11, K12) ---------------------------------------------
    t_path = time.perf_counter()
    probe_rows, probe_summary = probe_path()
    rows += probe_rows
    summary.update(probe_summary)
    walls["6_probes"] = time.perf_counter() - t_path

    # -- path 7: parallel/ on a world of ranks sharing the card -------------
    t_path = time.perf_counter()
    par_rows, par_summary, par_launches = parallel_path(
        summary["ntt35_per_sec"])
    rows += par_rows
    summary.update(par_summary)
    walls["7_parallel"] = time.perf_counter() - t_path

    # -- path 8: the entry points, each its own process; FourStepNTT's stage
    # route (K10a-tw, K1) in process -----------------------------------------
    t_path = time.perf_counter()
    ep_rows, ep_summary, ep_launches, fs_launches = entry_points_path(gen)
    rows += ep_rows
    summary.update(ep_summary)
    walls["8_entry_points"] = time.perf_counter() - t_path

    for row in rows:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    # K2 runs in every encrypt and decrypt, K1 and K10a's twiddle form on
    # several paths: their launches on each path (K2: paths 1, 3 and 5 at
    # n = 64, path 4 and its conjugation at the gl2 ring's 128); a row that
    # names its paths (K10a-tw: the key switch's 64 points on path 5, the
    # conjugation's 128) carries only theirs
    by_path = (("1_roundtrip", launches), ("3_matmul", mm_launches),
               ("4_gl2", gl2_launches), ("4_gl2_conj", conj_launches),
               ("5_keyswitch", ks_launches), ("7_parallel", par_launches),
               ("8_entry_points", ep_launches), ("8_four_step", fs_launches))
    for key, prefix in (("ntt_mul_ntt", "ntt_mul_ntt"), ("stage", "stage (K1"),
                        ("stage_tw", "stage_tw (K10a")):
        counts = {path: c.get(key, 0) for path, c in by_path}
        log(f"[launches] {key} by path: {counts}")
        for row in rows:
            if row["name"].startswith(prefix):
                row["launches_by_path"] = {
                    path: counts[path] for path in row.pop("paths", counts)}
    # mid's rows: the mid phase, and of path 8 the two programs that switch
    # keys at mid (relinearize, leveled)
    mid_ep = {}
    for label in ("relinearize", "leveled"):
        for k, v in ep_summary[f"entry_{label}_launches"].items():
            mid_ep[k] = mid_ep.get(k, 0) + v
    for row in mid_rows:
        key = row.pop("launch_key")
        row["launches_by_path"] = {"5b_mid_keyswitch": mid_launches.get(key, 0),
                                   "8_entry_points": mid_ep.get(key, 0)}
    log(f"[launches] mid rows: 5b_mid_keyswitch {mid_launches}; "
        f"8_entry_points (relinearize + leveled) {mid_ep}")
    log(f"[bound] IMAD peak {IMAD_PER_S:.4e} /s (64 a clock on each of 132 "
        f"SMs at 1.98 GHz); K11 addmul measured "
        f"{probe_summary['k11_addmul_steps_per_s']:.4e} steps/s")
    finalize_rows(rows + [off_path])
    off_path.pop("key")
    log(f"[bound] {off_path['name']} (logged, not a path row): "
        + json.dumps(off_path))
    walls["total"] = time.perf_counter() - t_run
    summary["wall_s"] = walls
    log("[wall] " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    log("[summary] " + json.dumps(summary))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
