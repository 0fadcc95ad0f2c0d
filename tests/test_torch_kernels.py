"""Kernels K1-K4, K7, K10a's twiddle form, K11 and K12 of the PyTorch port
against the JAX package's Pallas kernels, and the methods of K1, K2, K3,
K4, K6 and K7's CUDA kernels transcribed to run on the CPU (K2's, K6's and
K7's with the kernels' Montgomery and Shoup arithmetic on uint64 words).

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode (SlicedStage, SlicedNttMulNtt,
SlicedInvCompose, ExactComplexMatmul, SlicedGemm2x2, PallasStage with a
twiddle, the co-issue probe of scripts/micro_coissue.py), on the same numpy
inputs; K11's kernel is a closure inside scripts/micro_vpu.py's main(), so
its twin is a numpy transcription of it.  Residues and fixed-point words must match bit for bit.  The
`cuda`-marked cases hold each CUDA kernel against its plain version and
skip without a GPU.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import REF_P_MODULI, generate_ntt_primes, get_params
from matrix_fhe_tpu.ops import ddfloat as jdd
from matrix_fhe_tpu.ops import fpmatmul as jfp
from matrix_fhe_tpu.ops import modmath as jmm
from matrix_fhe_tpu.ops import pallas_ntt as pn
from matrix_fhe_tpu.tables import build_tables
from matrix_fhe_tpu_torch.ops import _backend
from matrix_fhe_tpu_torch.ops.cgemm import Gemm2x2
from matrix_fhe_tpu_torch.ops import ddfloat as tdd
from matrix_fhe_tpu_torch.ops import fpmatmul as tfp
from matrix_fhe_tpu_torch.ops import modmath as tmm
from matrix_fhe_tpu_torch.ops import probes
from matrix_fhe_tpu_torch.ops.cuda_ntt import (WCRT_MAX_K, WCRT_MIN_K,
                                               XNTT_MAX_K, InvCompose,
                                               NttMulNtt, Stage, digit_count,
                                               plane_layout, slice_tables,
                                               takes_wcrt, takes_xntt)
from matrix_fhe_tpu_torch.ops.wcrt import scaled_inverse_tables

P = get_params("tiny")
T = build_tables(P)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def i64(x) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.uint64).view(np.int64).copy())


def u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def residues(rng, moduli, shape) -> np.ndarray:
    return np.stack([rng.integers(0, int(q), shape, dtype=np.uint64)
                     for q in moduli])


def jax_join(pair) -> np.ndarray:
    return np.asarray(pn.join_u64(*pair))


def jax_split(x):
    return pn.split_u64(jnp.asarray(x))


@pytest.fixture
def exact_exp2(monkeypatch):
    """XLA:CPU's exp2 is not exact at integer exponents (exp2(3.0) != 8.0
    there), while ExactComplexMatmul means exact powers of two ("the scale
    is exact in f64", fpmatmul.py); the port builds its powers of two from
    their bits.  Give the JAX reference an exact exp2 so that both compute
    the documented function (ROADMAP queue 3 records the difference)."""
    monkeypatch.setattr(jnp, "exp2", lambda e: jnp.ldexp(
        jnp.ones_like(e), e.astype(jnp.int32)))


# -- K1 -----------------------------------------------------------------------

@pytest.mark.parametrize("side", ["left", "right"])
def test_stage_matches_sliced_stage(side):
    rng = np.random.default_rng(1)
    if side == "left":            # W-CRT forward: table [L, W, W], data [L, W, M]
        table, data = T.w_fwd, residues(rng, P.moduli, (P.phi, 64))
    else:                         # X-NTT: table [L, n, n], data [L, rows, n]
        table, data = T.x_fwd_nega, residues(rng, P.moduli, (64, P.n))
    want = jax_join(pn.SlicedStage(table, P.moduli, side=side)(
        *jax_split(data)))
    got = Stage(table, P.moduli, side, "cpu")(i64(data))
    np.testing.assert_array_equal(u64(got), want)


@pytest.mark.parametrize("side", ["left", "right"])
def test_stage_wide_55bit_modulus(side):
    """K1 admits q < 2^56 like SlicedStage (pallas_ntt.py:1672): the ref
    preset's 55-bit P prime."""
    rng = np.random.default_rng(2)
    q = REF_P_MODULI[0]
    table = rng.integers(0, q, (1, 32, 32), dtype=np.uint64)
    data = rng.integers(0, q, (1, 32, 16) if side == "left" else (1, 16, 32),
                        dtype=np.uint64)
    want = jax_join(pn.SlicedStage(table, (q,), side=side)(*jax_split(data)))
    got = Stage(table, (q,), side, "cpu")(i64(data))
    np.testing.assert_array_equal(u64(got), want)


# -- K1's u8 digit-plane method, transcribed from csrc/stage.cu ----------------

# 45 and 35 bits (the ref chain), 55 and 40 (the ref P basis): 6, 5, 7, 5
# digits in one Stage
MIXED = (get_params("ref").moduli[0], get_params("ref").moduli[1],
         REF_P_MODULI[0], REF_P_MODULI[1])
# digit rows an s32 sum of u8 products holds exactly, in whole 128-byte
# tiles: 32,768 255^2 < 2^31 (csrc/stage.cu flushes at this interval)
FLUSH_ROWS = 32768


def _split_digits(data, moduli, batch, kp, kbs):
    """stage_split_kernel: x [Z, K, M] -> xs[z, m, c Kp + k] = byte c of
    x[z, k, m] for c < d_l (zero elsewhere; the kernel leaves the bytes it
    never reads unwritten)."""
    Z, K, M = data.shape
    b = data.contiguous().view(torch.uint8).reshape(Z, K, M, 8)
    xs = torch.zeros((Z, M, kbs), dtype=torch.uint8)
    for z in range(Z):
        for c in range(digit_count(moduli[z // batch])):
            xs[z, :, c * kp:c * kp + K] = b[z, :, :, c].T
    return xs


def _digit_plane_stage(st, data, flush_rows=FLUSH_ROWS, tile_w=16):
    """stage_kernel without its twiddle, in int64 on the CPU: the same table
    planes (slice_tables) and data digit rows, one u8 GEMM a table plane j
    over contraction chunks of at most `flush_rows` digit rows (each s32
    sum checked below 2^31), sum_j diag_j 2^(8 j) 2^-64 mod q a chunk (the
    planes carry 2^64 for the kernel's REDC), and the chunks summed mod
    q.  The planes are packed tight (Kp = K, tiles of `tile_w` table rows);
    the kernel's own layout (plane_layout) pads them with zero bytes."""
    L, W, K = st.table.shape
    left = st.side != "right"
    kp = K
    kbs = kp * (max(map(digit_count, st.moduli)) if left else 8)
    planes = slice_tables(st.table, st.moduli, st.side, kp, kbs, tile_w)
    if left:
        batch = data.shape[1] if st.side == "batched_left" else 1
        xs = _split_digits(data.reshape(-1, K, data.shape[-1]), st.moduli,
                           batch, kp, kbs)
    else:
        batch = 1
        xs = data.contiguous().view(torch.uint8)
    outs, peak = [], 0
    for z in range(xs.shape[0]):
        l = z // batch
        q, d = st.moduli[l], digit_count(st.moduli[l])
        kb = d * kp if left else 8 * kp
        a = xs[z, :, :kb].to(torch.int64)
        total = torch.zeros((a.shape[0], planes.shape[1] * tile_w),
                            dtype=torch.int64)
        for s in range(0, kb, flush_rows):
            e = min(kb, s + flush_rows)
            acc = torch.zeros_like(total)
            for j in reversed(range(d)):
                bj = planes[l, :, j, :, s:e].reshape(-1, e - s).to(torch.int64)
                diag = a[:, s:e] @ bj.T
                peak = max(peak, int(diag.max()))
                acc = (tmm.shl_mod(acc, 8, q) + diag) % q
            acc = tmm.mul_mod(acc, torch.tensor(pow(1 << 64, -1, q)),
                              torch.tensor(q))
            total = (total + acc) % q
        outs.append(total[:, :W])
    assert peak < 1 << 31, "an s32 plane sum would overflow"
    out = torch.stack(outs)
    if left:
        return out.transpose(1, 2).reshape(data.shape[:-2] + (W,
                                                            data.shape[-1]))
    return out


def _stage_case(side, k, fill, seed, moduli=MIXED, w=40, rows=24, batch=3):
    """A Stage of `side` over `moduli` with a [w, k] table, and its data
    (random residues, or every entry q - 1 with fill='max')."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if fill == "max":
            return np.stack([np.full(shape, q - 1, dtype=np.uint64)
                             for q in moduli])
        return residues(rng, moduli, shape)

    st = Stage(draw((w, k)), moduli, side, "cpu")
    shape = {"left": (k, rows), "right": (rows, k),
             "batched_left": (batch, k, rows)}[side]
    return st, i64(draw(shape))


@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("k", [64, 128, 512])
@pytest.mark.parametrize("side", ["left", "right", "batched_left"])
def test_digit_planes_match_plain(side, k, fill):
    """K1's method (u8 table planes pre-reduced per data digit, s32 plane
    GEMMs, one fold an output) equals Stage.plain, and so SlicedStage, on
    35-, 40-, 45- and 55-bit limbs in one Stage; with every residue and
    table entry q - 1 the s32 sums stay below 2^31 at the largest K."""
    st, data = _stage_case(side, k, fill, seed=30 + k)
    assert torch.equal(_digit_plane_stage(st, data), st.plain(data))


@pytest.mark.parametrize("side", ["left", "right"])
def test_digit_planes_flush_long_contractions(side):
    """A contraction past the s32 bound (33,025 digit rows) is summed in
    chunks of at most FLUSH_ROWS, each reduced, then added mod q: at K = 4800
    and the 55-bit prime's 7 digits the left side has 33,600 digit rows,
    the right side (8 slots) 38,400.  With every entry q - 1, and again in
    chunks of 256 rows on mixed widths, all agree with Stage.plain."""
    st, data = _stage_case(side, 4800, "max", seed=40,
                           moduli=REF_P_MODULI[:1], w=8, rows=4)
    assert 4800 * (7 if side == "left" else 8) > FLUSH_ROWS
    assert torch.equal(_digit_plane_stage(st, data), st.plain(data))
    st, data = _stage_case(side, 64, "random", seed=41)
    assert torch.equal(_digit_plane_stage(st, data, flush_rows=256),
                       st.plain(data))


def test_stage_takes_contractions_past_2_16():
    """The kernel flushes its s32 sums, so Stage is bounded only by its
    plain version (float64 digit sums, K < 2^19): SlicedStage's own bound
    (S < q 2^28) lets a 35-bit limb take K up to ~2^17, and so does Stage.
    K = 70,000 on one 35-bit limb: 350,080 digit rows, 11 flushes."""
    q35 = get_params("ref").moduli[1:2]
    st, data = _stage_case("left", 70000, "max", seed=46, moduli=q35, w=2,
                           rows=2)
    assert torch.equal(_digit_plane_stage(st, data), st.plain(data))
    with pytest.raises(ValueError, match="exceeds"):
        Stage(np.zeros((1, 1, 1 << 19), dtype=np.uint64), q35, "left", "cpu")


# -- K2 -----------------------------------------------------------------------

@pytest.mark.parametrize("rep", [1, P.n])
def test_ntt_mul_ntt_matches_sliced(rep):
    rng = np.random.default_rng(3)
    a = residues(rng, P.moduli, (P.phi * rep, P.n))
    s = residues(rng, P.moduli, (P.phi, P.n))
    k2 = pn.SlicedNttMulNtt(T.x_fwd_nega, T.x_inv_nega, P.moduli, rep=rep)
    want = jax_join(k2(*jax_split(a), *jax_split(s)))
    got = NttMulNtt(T.x_fwd_nega, T.x_inv_nega, P.moduli, "cpu")(i64(a),
                                                                  i64(s))
    np.testing.assert_array_equal(u64(got), want)


# -- the kernels' Montgomery arithmetic, transcribed (csrc/modarith.cuh) ------

def _umulhi(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """__umul64hi on uint64 arrays, exact, from 32-bit halves."""
    m32 = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    al, ah, bl, bh = a & m32, a >> s32, b & m32, b >> s32
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> s32) + (lh & m32) + (hl & m32)
    return hh + (lh >> s32) + (hl >> s32) + (mid >> s32)


def _redc(hi, lo, q: int) -> np.ndarray:
    """mont_redc: (hi 2^64 + lo) 2^-64 mod q for hi < q, canonical."""
    qinv_neg = np.uint64((-pow(q, -1, 1 << 64)) % (1 << 64))
    qq = np.uint64(q)
    with np.errstate(over="ignore"):
        m = lo * qinv_neg
        t = hi + _umulhi(m, np.full_like(m, qq)) + (lo != 0).astype(np.uint64)
    assert (hi < qq).all(), "REDC needs hi < q"
    return np.where(t >= qq, t - qq, t)


def _mont_mul(a, b, q: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        return _redc(_umulhi(a, b), a * b, q)


def _fold(diags) -> tuple:
    """fold: S = sum_j diag_j 2^(8 j) as (hi, lo) words, each diag_j an s32
    sum (checked below 2^31)."""
    lo = np.zeros(diags[0].shape, np.uint64)
    hi = np.zeros_like(lo)
    for j, dj in enumerate(diags):
        assert 0 <= dj.min() and dj.max() < 1 << 31, "an s32 sum overflows"
        a = dj.astype(np.uint64)
        tlo = a << np.uint64(8 * j)
        with np.errstate(over="ignore"):
            lo = lo + tlo
        hi = hi + (a >> np.uint64(64 - 8 * j) if j else 0) + (lo < tlo)
    return hi, lo


def _u8_gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A u8 digit GEMM's s32 sums as int64: float64 operands of digits <
    256, exact while a sum stays below 2^53 (every sum here is checked
    below 2^31 by _fold)."""
    return (a @ b).astype(np.int64)


# -- K1 / K10a's X-NTT route: csrc/xntt_stage.cu -------------------------------

@pytest.mark.parametrize("side,k,xntt", [
    ("right", 8, True), ("right", 64, True), ("right", XNTT_MAX_K, True),
    ("right", XNTT_MAX_K + 1, False), ("right", 256, False),
    ("right", 512, False), ("left", 64, False), ("batched_left", 64, False)])
def test_xntt_route_rule(side, k, xntt):
    """Stage.kernel's route, read from the table's shape alone: side 'right'
    at a contraction of at most XNTT_MAX_K terms (the X-NTT at n = 64, the
    gl2 ring's 128) launches csrc/xntt_stage.cu under stage_x / stage_tw_x;
    the left sides and the longer contractions (the dist NTT's 256-point
    stages, the four-step route's 256 and 512) csrc/stage.cu under their own
    keys.  K3's renamed Stage (side 'left') keeps its keys."""
    assert takes_xntt(side, k) is xntt
    st = Stage(np.zeros((1, 8, k), dtype=np.uint64), MIXED[:1], side, "cpu")
    want = {("right", True): ("stage_x", "stage_tw_x"),
            ("right", False): ("stage", "stage_tw"),
            ("batched_left", False): ("stage", "stage_tw_batched"),
            ("left", False): ("stage",)}[side, xntt]
    assert tuple(st.launch_key(tw) for tw in (False, True)[:len(want)]) == want
    k3 = Stage(np.zeros((1, 8, k), dtype=np.uint64), MIXED[:1], side, "cpu",
               keys=("inv_compose_stage", "inv_compose_split"))
    assert k3.launch_key(False) == ("stage_x" if xntt else "inv_compose_stage")


# -- K1's W-CRT route: csrc/wcrt_stage.cu ---------------------------------------

@pytest.mark.parametrize("side,k,key", [
    ("left", 512, "stage_w"), ("left", WCRT_MIN_K, "stage_w"),
    ("left", WCRT_MAX_K, "stage_w"), ("left", WCRT_MIN_K - 1, "stage"),
    ("left", WCRT_MAX_K + 1, "stage"), ("left", 64, "stage"),
    ("right", 64, "stage_x"), ("right", XNTT_MAX_K, "stage_x"),
    ("right", 256, "stage"), ("right", 512, "stage"),
    ("batched_left", 256, "stage"), ("batched_left", 512, "stage")])
def test_wcrt_route_rule(side, k, key):
    """Stage.kernel's routes, read from the table's side and contraction
    alone: side 'left' at WCRT_MIN_K to WCRT_MAX_K terms (every W-CRT over
    the 512 lanes, K3's scaled tables) launches csrc/wcrt_stage.cu under
    keys[0] + "_w" (stage_w; K3's Stage inv_compose_stage_w); side 'right'
    at most XNTT_MAX_K terms csrc/xntt_stage.cu (stage_x); the rest
    csrc/stage.cu under the general keys."""
    assert takes_wcrt(side, k) is (key == "stage_w")
    st = Stage(np.zeros((1, 8, k), dtype=np.uint64), MIXED[:1], side, "cpu")
    assert st.launch_key(False) == key
    k3 = Stage(np.zeros((1, 8, k), dtype=np.uint64), MIXED[:1], side, "cpu",
               keys=("inv_compose_stage", "inv_compose_split"))
    assert k3.launch_key(False) == {"stage_w": "inv_compose_stage_w",
                                    "stage": "inv_compose_stage"}.get(key, key)


CSRC = os.path.join(ROOT, "matrix_fhe_tpu_torch", "csrc")


@pytest.mark.parametrize("source", ["stage.cu", "xntt_stage.cu",
                                    "wcrt_stage.cu"])
def test_stage_kernel_names_count_in_the_roofline(source):
    """Every CUDA function of K1's routes that computes stage outputs is
    named so that fhebench's stage_roofline_pct counts its device time
    (events whose name holds stage_kernel or stage_split_kernel)."""
    import re
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\s*\(", text)
    assert names
    assert all("stage_kernel" in n or "stage_split_kernel" in n
               for n in names), names
    if source == "wcrt_stage.cu":
        assert names == ["wcrt_stage_kernel"]


# csrc/wcrt_stage.cu's constants: table rows a block, K-tile bytes, the
# shared memory a block may hold, its alignment and barriers
W_BW, W_BK, W_SMEM, W_ALIGN, W_BARRIERS = 32, 128, 232448, 1024, 128


def _wcrt_tile_rows(d: int) -> int:
    """Data rows of a block's tile: two m64 tiles a consumer warpgroup
    below 7 digits, one at 7."""
    return 256 if d <= 6 else 128


def _wcrt_stages(moduli) -> int:
    """mf_stage_w's ring: stages of the launch's largest tile (its data
    rows and its d table planes of 32 rows, 128 bytes each), at most 8."""
    need = max((_wcrt_tile_rows(d) + W_BW * d) * W_BK
               for d in set(map(digit_count, moduli)))
    return min(8, (W_SMEM - W_ALIGN - W_BARRIERS) // need)


def _wcrt_walk(moduli, m: int, w: int, blocks: int) -> np.ndarray:
    """csrc/wcrt_stage.cu's walk, transcribed: block b takes the units b,
    b + blocks, ... of the flattened (limb, row tile, table tile) order,
    each consumer warpgroup half of the tile's data rows.  Returns how
    often each output [L, W, M] is stored."""
    nj = -(-w // W_BW)
    seen = np.zeros((len(moduli), w, m), dtype=np.int8)
    for b in range(blocks):
        limb, base = 0, 0
        rows = _wcrt_tile_rows(digit_count(moduli[0]))
        count = -(-m // rows) * nj
        u = b
        while True:
            while u >= base + count and limb < len(moduli):
                base += count
                limb += 1
                if limb < len(moduli):
                    rows = _wcrt_tile_rows(digit_count(moduli[limb]))
                    count = -(-m // rows) * nj
            if limb == len(moduli):
                break
            v = u - base
            row0, w0 = (v // nj) * rows, (v % nj) * W_BW
            for cw in range(2):
                r0 = row0 + cw * rows // 2
                seen[limb, w0:w0 + W_BW, r0:r0 + rows // 2] += 1
            u += blocks
    return seen


@pytest.mark.parametrize("moduli,m,w,blocks", [
    ("ref14", 4096, 512, 132), ("mixed", 333, 40, 3), ("p55", 513, 72, 5),
    ("p28", 1000, 96, 1), ("ref11", 200, 40, 7), ("lev13", 1003, 512, 64)])
def test_wcrt_walk_stores_every_output_once(moduli, m, w, blocks):
    """The W-CRT kernel's persistent walk stores each output of every limb
    exactly once, at any block count, ragged M and W (a tile's rows and
    columns past them are computed and never stored) and limbs of 128- and
    256-row tiles mixed; the ring holds four stages at every digit mix of
    the cells."""
    mods = _xntt_moduli(moduli)
    assert (_wcrt_walk(mods, m, w, blocks) == 1).all()
    assert _wcrt_stages(mods) >= 4


def _fold_short(diags) -> tuple:
    """csrc/xntt_stage.cu's fold_short: plane sums below 2^26, the first
    five summed in one word (< 2^59), planes 5 and 6 as b 2^40."""
    a = [dj.astype(np.uint64) for dj in diags]
    assert all(x.max() < 1 << 26 for x in a), "a plane sum past 2^26"
    s = a[0].copy()
    for j in range(1, min(len(a), 5)):
        s = s + (a[j] << np.uint64(8 * j))
    if len(a) <= 5:
        return np.zeros_like(s), s
    b = a[5] + (a[6] << np.uint64(8) if len(a) > 6 else np.uint64(0))
    t = b << np.uint64(40)
    with np.errstate(over="ignore"):
        lo = s + t
    return (b >> np.uint64(24)) + (lo < t), lo


def _redc_2q(hi, lo, q: int) -> np.ndarray:
    """csrc/xntt_stage.cu's redc_2q: mont_redc without its last
    subtraction, a value below 2 q."""
    qinv_neg = np.uint64((-pow(q, -1, 1 << 64)) % (1 << 64))
    with np.errstate(over="ignore"):
        m = lo * qinv_neg
        t = hi + _umulhi(m, np.full_like(m, np.uint64(q))) + (lo != 0)
    assert (t < 2 * q).all()
    return t


# one modulus of each digit count 1..7 (2^8 - 5, 2^16 - 15, 2^24 - 3,
# 2^32 - 5, and the ref chain's 35-, 45- and P basis's 55-bit limbs)
XNTT_EPI_MODULI = (251, 65521, 16777213, 4294967291,
                   get_params("ref").moduli[1], get_params("ref").moduli[0],
                   REF_P_MODULI[0])


@pytest.mark.parametrize("q", XNTT_EPI_MODULI)
def test_xntt_epilogue_matches_general(q):
    """The X-NTT kernel's epilogue arithmetic, transcribed: fold_short of
    d plane sums below 2^26 (its longest contraction, 1,024 digit rows of
    255^2, at every sum for the edge) is fold's 128-bit value; REDC without
    its last subtraction, then the Montgomery product by the twiddle, is
    the general kernel's canonical REDC then product, bit for bit, at
    random and edge twiddles (0, 1, q - 1)."""
    d = digit_count(q)
    rng = np.random.default_rng(q % 1000)
    top = 1024 * 255 ** 2
    diags = [rng.integers(0, top + 1, size=4096) for _ in range(d)]
    for dj in diags:
        dj[:3] = top
    hi, lo = _fold_short(diags)
    want_hi, want_lo = _fold(diags)
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)
    tw = rng.integers(0, q, size=4096, dtype=np.uint64)
    tw[:3] = [0, 1, q - 1]
    np.testing.assert_array_equal(_mont_mul(_redc_2q(hi, lo, q), tw, q),
                                  _mont_mul(_redc(hi, lo, q), tw, q))


# -- K2's fused method, transcribed from csrc/ntt_mul_ntt.cu -------------------

def _fused_ntt_mul_ntt(k2, a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """ntt_mul_ntt_kernel on uint64 arrays a [L, R, n], s [L, W, n]: K1's
    side 'right' planes of both tables (slice_tables, 32-row tiles), the
    data's bytes as 8 digit slots a term, per 32-column tile d u8 GEMMs,
    the fold and one REDC an output, one Montgomery product by s, the
    spectrum's bytes as the inverse transform's digits, the inverse GEMMs,
    fold and REDC."""
    L, R, n = a.shape
    rep = R // s.shape[1]
    kbs = 8 * n
    fwd, inv = (slice_tables(t, k2.moduli, "right", n, kbs, 32).numpy()
                .astype(np.float64) for t in (k2.fwd, k2.inv))
    out = np.empty_like(a)
    for l, q in enumerate(k2.moduli):
        d = digit_count(q)

        def transform(x, planes):      # x [R, n] canonical -> [R, n]
            xb = x.view(np.uint8).reshape(R, kbs).astype(np.float64)
            tiles = [_redc(*_fold([_u8_gemm(xb, planes[l, jt, j].T)
                                   for j in range(d)]), q)
                     for jt in range(planes.shape[1])]
            return np.concatenate(tiles, axis=1)[:, :n]

        v = transform(a[l], fwd)
        u = _mont_mul(v, np.repeat(s[l], rep, axis=0), q)
        out[l] = transform(np.ascontiguousarray(u), inv)
    return out


def _k2_case(n, rep, fill, seed, moduli=MIXED, w=3):
    """A K2 over `moduli` with random n x n tables and its inputs a [L, w
    rep, n], s [L, w, n]; fill='max' sets tables and inputs to q - 1."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if fill == "max":
            return np.stack([np.full(shape, q - 1, dtype=np.uint64)
                             for q in moduli])
        return residues(rng, moduli, shape)

    k2 = NttMulNtt(draw((n, n)), draw((n, n)), moduli, "cpu")
    return k2, draw((w * rep, n)), draw((w, n))


@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("rep", [1, 64])
@pytest.mark.parametrize("n", [8, 16, 64, 128])
def test_fused_ntt_mul_ntt_matches_plain(n, rep, fill):
    """K2's fused method equals NttMulNtt.plain, the definition, on 35-,
    40-, 45- and 55-bit limbs in one call, at every X ring the presets use
    (n = 8, 16, 64, the gl2 ring's 128); exact, bit for bit."""
    k2, a, s = _k2_case(n, rep, fill, seed=50 + n + rep)
    want = u64(k2.plain(i64(a), i64(s)))
    np.testing.assert_array_equal(_fused_ntt_mul_ntt(k2, a, s), want)


@pytest.mark.parametrize("rep", [1, P.n])
def test_fused_ntt_mul_ntt_matches_sliced(rep):
    """At tiny, K2's fused method against SlicedNttMulNtt (interpret)."""
    rng = np.random.default_rng(3)
    a = residues(rng, P.moduli, (P.phi * rep, P.n))
    s = residues(rng, P.moduli, (P.phi, P.n))
    k2 = pn.SlicedNttMulNtt(T.x_fwd_nega, T.x_inv_nega, P.moduli, rep=rep)
    want = jax_join(k2(*jax_split(a), *jax_split(s)))
    port = NttMulNtt(T.x_fwd_nega, T.x_inv_nega, P.moduli, "cpu")
    np.testing.assert_array_equal(_fused_ntt_mul_ntt(port, a, s), want)


# -- K3 -----------------------------------------------------------------------

def test_inv_compose_matches_sliced():
    rng = np.random.default_rng(4)
    x = residues(rng, P.moduli, (P.phi, 2 * P.n * P.n))
    scaled = scaled_inverse_tables(T)
    acc_l, acc_h, kacc = pn.SlicedInvCompose(scaled, P.moduli, P.q_total)(
        *jax_split(x))
    acc, k = InvCompose(scaled, P.moduli, P.q_total, "cpu")(i64(x))
    np.testing.assert_array_equal(u64(acc), jax_join((acc_l, acc_h)))
    # the JAX kernel keeps k as an f32 sum; its rounding is the integer k
    want_k = np.round(np.asarray(kacc).astype(np.float64)).astype(np.int64)
    np.testing.assert_array_equal(k.numpy(), want_k)
    assert len(np.unique(want_k)) > 1


def test_scaled_inverse_tables_match_jax():
    from matrix_fhe_tpu.ops.wcrt import WTransform
    want = WTransform(P, T, use_pallas=False, fast_float=True)
    got = scaled_inverse_tables(T)
    rng = np.random.default_rng(5)
    x = residues(rng, P.moduli, (P.phi, 8))
    np.testing.assert_array_equal(
        np.asarray(want._inv_scaled(jnp.asarray(x))),
        u64(Stage(got, P.moduli, "left", "cpu")(i64(x))))


# -- K3's two-step method on the card: K1's GEMM, then the compose pass -------

def _compose_pass(r: torch.Tensor, moduli, big_q):
    """inv_compose_kernel (csrc/inv_compose.cu) in numpy: for each output, acc
    in wrapping uint64 and k as an f64 sum in limb order of r'_l / (double)
    q_l, rounded half to even."""
    rn = u64(r)
    acc = np.zeros(rn.shape[1:], dtype=np.uint64)
    kf = np.zeros(rn.shape[1:], dtype=np.float64)
    for l, q in enumerate(moduli):
        acc = acc + rn[l] * np.uint64((big_q // q) % (1 << 64))
        kf = kf + rn[l].astype(np.float64) / np.float64(float(q))
    return i64(acc), torch.from_numpy(np.rint(kf).astype(np.int64))


def _near_half_inputs(p, t, seed, m=24):
    """Eval residues x [L, W, m] whose r' = T' x (the scaled inverse) puts
    sum_l r'_l / q_l within 1e-9 of a half-integer in column 0: r'_l = V
    M_l^-1 mod q_l for V near Q / 2, so that the sum is V / Q plus an
    integer; the other columns are random.  Returns (x, r', V / Q)."""
    rng = np.random.default_rng(seed)
    big_q, W, L = p.q_total, p.phi, len(p.moduli)
    r = residues(rng, p.moduli, (W, m))
    cands = [(big_q - 1) // 2, (big_q + 1) // 2]
    cands += [big_q // 2 + s * int(big_q * f)
              for f in (1e-10, 3e-10, 9e-10) for s in (1, -1)]
    fracs = []
    for w in range(W):
        v = cands[w % len(cands)]
        for l, q in enumerate(p.moduli):
            r[l, w, 0] = v * pow(big_q // q, -1, q) % q
        fracs.append(v / big_q)
    # x = W-CRT forward of r'_l M_l: T'_l x_l = M_l^-1 W^-1 W r'_l M_l = r'_l
    m_l = [(big_q // q) % q for q in p.moduli]
    rm = tmm.mul_mod(i64(r), torch.tensor(m_l).reshape(L, 1, 1),
                     torch.tensor(p.moduli).reshape(L, 1, 1))
    x = Stage(t.w_fwd, p.moduli, "left", "cpu")(rm)
    return x, i64(r), np.array(fracs)


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_inv_compose_two_step_matches(preset):
    """K3 as it runs on the card: K1's Stage on the scaled inverse tables
    (Stage.plain, which the digit-plane tests hold to the kernel's method),
    then the compose pass, equals InvCompose.plain bit for bit, and
    SlicedInvCompose: acc bit for bit, k wherever the JAX kernel's f32 sum
    cannot move it.  Column 0 holds sums within 1e-9 of a half-integer (two
    of them within 1 / (2 Q)), so k's rounding in limb order is exercised."""
    p = get_params(preset)
    t = build_tables(p)
    scaled = scaled_inverse_tables(t)
    x, r_want, fracs = _near_half_inputs(p, t, seed=60)
    k3 = InvCompose(scaled, p.moduli, p.q_total, "cpu")
    assert k3._stage.keys == ("inv_compose_stage", "inv_compose_split")
    r = k3._stage.plain(x)
    assert torch.equal(r, r_want)
    acc, k = _compose_pass(r, p.moduli, p.q_total)
    want_acc, want_k = k3.plain(x)
    assert torch.equal(acc, want_acc) and torch.equal(k, want_k)
    assert np.all(np.abs(fracs - 0.5) < 1e-9)
    acc_l, acc_h, kacc = pn.SlicedInvCompose(scaled, p.moduli, p.q_total)(
        *jax_split(u64(x)))
    np.testing.assert_array_equal(u64(acc), jax_join((acc_l, acc_h)))
    jk = np.round(np.asarray(kacc).astype(np.float64)).astype(np.int64)
    total = sum(u64(r)[l].astype(np.float64) / float(q)
                for l, q in enumerate(p.moduli))
    far = np.abs(total - np.floor(total) - 0.5) > 1e-4
    assert not far[:, 0].any() and far.sum() > far.size // 2
    np.testing.assert_array_equal(k.numpy()[far], jk[far])
    assert np.abs(k.numpy() - jk).max() <= 1


# -- K4 -----------------------------------------------------------------------

def _pair_planes(x: np.ndarray):
    u = x.astype(np.int64).view(np.uint64)
    return (jnp.asarray((u & 0xFFFFFFFF).astype(np.uint32))[None],
            jnp.asarray((u >> 32).astype(np.uint32))[None])


def _words_equal(jax_words, port_words):
    for j, t in zip(jax_words, port_words):
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                      t.numpy())


@pytest.mark.parametrize("table", ["wdft", "enc_v_inv"])
def test_fp_cmatmul_words_match_pallas(table):
    """The exact integer core on the same integer inputs: sign + magnitude
    words bit-identical to _fp_cmatmul_kernel."""
    t = getattr(T, table)
    K, M = t.shape[1], 64
    rng = np.random.default_rng(6)
    xr = rng.integers(-(1 << 37), 1 << 37, (K, M))
    xi = rng.integers(-(1 << 37), 1 << 37, (K, M))
    jm = jfp.ExactComplexMatmul(t)
    outs = jm._call(M, 64)(*_pair_planes(xr), *_pair_planes(xi),
                           jm._tr[None], jm._ti[None], jm._ts[None])
    tm = tfp.ExactComplexMatmul(t, "cpu")
    assert tm.t_bits == jm.t_bits
    w_re, w_im = tfp.fp_cmatmul(tm.tr, tm.ti, torch.from_numpy(xr),
                                torch.from_numpy(xi))
    _words_equal([o[0] for o in outs], w_re + w_im)
    assert int(w_re[3].sum()) > 0 and int(w_re[3].sum()) < w_re[3].numel()


def test_fp_call_words_chain_matches(exact_exp2):
    """call_words -> call_words_w -> words_to_f64: words, e_scale and the
    f64 reconstruction bit-identical to the JAX chain."""
    rng = np.random.default_rng(7)
    xr = rng.uniform(-3, 3, (P.phi, 64))
    xi = rng.uniform(-3, 3, (P.phi, 64))
    jm = jfp.ExactComplexMatmul(T.wdft)
    tm = tfp.ExactComplexMatmul(T.wdft, "cpu")
    jw = jm.call_words(jnp.asarray(xr), jnp.asarray(xi))
    tw = tm.call_words(torch.from_numpy(xr), torch.from_numpy(xi))
    _words_equal(jw[0] + jw[1], tw[0] + tw[1])
    assert int(jw[2]) == int(tw[2])
    jw2 = jm.call_words_w(*jw)
    tw2 = tm.call_words_w(*tw)
    _words_equal(jw2[0] + jw2[1], tw2[0] + tw2[1])
    assert int(jw2[2]) == int(tw2[2])
    np.testing.assert_array_equal(
        np.asarray(jfp.ExactComplexMatmul.words_to_f64(jw2[0], jw2[2])),
        tfp.ExactComplexMatmul.words_to_f64(tw2[0], tw2[2]).numpy())


# -- K4's balanced s8 digit-plane method, transcribed from csrc/fp_cmatmul.cu --

K4_BOUND = 127 * 128 ** 4 // 2        # the JAX kernel's table budget


def _fold_words(diags):
    """fold + store_words of fp_cmatmul_kernel in numpy: sum_s D[s] 2^(8 s)
    as a signed 128-bit (hi, lo) with carries, then sign and 96-bit
    magnitude words."""
    hi = np.zeros(diags[0].shape, dtype=np.int64)
    lo = np.zeros(diags[0].shape, dtype=np.uint64)
    for s, d in enumerate(diags):
        d = d.numpy()
        if s == 0:
            plo, phi = d.astype(np.uint64), d >> 63
        elif 8 * s < 64:
            plo, phi = d.astype(np.uint64) << np.uint64(8 * s), d >> (64 - 8 * s)
        else:
            plo, phi = np.zeros_like(lo), d << (8 * s - 64)
        lo = lo + plo
        hi = hi + phi + (lo < plo)
    neg = hi < 0
    hu = hi.astype(np.uint64)
    mlo = np.where(neg, ~lo + np.uint64(1), lo)
    mhi = np.where(neg, ~hu + (lo == 0), hu)
    mask = np.uint64(0xFFFFFFFF)
    return tuple(torch.from_numpy(w.astype(np.int64)) for w in
                 (mlo & mask, mlo >> np.uint64(32), mhi & mask, neg))


def _digit_plane_cmatmul(tr, ti, xr, xi):
    """fp_split_kernel and fp_cmatmul_kernel in int64 on the CPU: the table
    planes (table_planes, padded to 32 rows and 128-byte rows as the
    kernel's layout), the data's balanced digits transposed to K-major
    planes [2, 5, M, Kp], one s8 GEMM a digit pair (i, j) into diagonal
    i + j (each s32 sum checked below 2^31), and the 128-bit fold."""
    W, K = tr.shape
    M = xr.shape[1]
    wp, kp = -(-W // 32) * 32, -(-K // 128) * 128
    tp = tfp.table_planes(tr, ti, wp, kp).to(torch.int64)
    xp = torch.zeros((2, tfp.K4_DIGITS, M, kp), dtype=torch.int64)
    for c, x in enumerate((xr, xi)):
        for j, d in enumerate(tfp.balanced_digits(x)):
            assert int(d.min()) >= -128 and int(d.max()) <= 127
            xp[c, j, :, :K] = d.T
    n_diag = 2 * tfp.K4_DIGITS - 1
    re = [torch.zeros((wp, M), dtype=torch.int64) for _ in range(n_diag)]
    im = [torch.zeros((wp, M), dtype=torch.int64) for _ in range(n_diag)]
    for i in range(tfp.K4_DIGITS):
        for j in range(tfp.K4_DIGITS):
            re[i + j] += tp[0, i] @ xp[0, j].T + tp[2, i] @ xp[1, j].T
            im[i + j] += tp[0, i] @ xp[1, j].T + tp[1, i] @ xp[0, j].T
    peak = max(int(d.abs().max()) for d in re + im)
    assert peak < 1 << 31, "an s32 diagonal sum would overflow"
    assert 2 * tfp.K4_DIGITS * K * (1 << 14) < 1 << 31
    return (_fold_words([d[:W] for d in re]),
            _fold_words([d[:W] for d in im]))


def _k4_case(case, rng):
    """(complex table, xr, xi) of one K4 case at M = 200: the small preset's
    W-DFT and sigma-inverse tables, or a table at K = 64 / 512 whose
    entries reach the JAX budget max(|tr|, |ti|, |tr + ti|) = 127 128^4 / 2
    (quantized at exactly 2^30, so that both packages take the same
    integers), each with data of +-2^37 in part."""
    if case in ("wdft", "enc_v_inv"):
        t = getattr(build_tables(get_params("small")), case)
    else:
        k = int(case[len("edge-K"):])
        b = K4_BOUND
        pats = np.array([(b, 0), (0, b), (-b, 0), (0, -b), (b, -b), (-b, b),
                         (b // 2, b // 2), (-(b // 2), -(b // 2))])
        pick = pats[rng.integers(0, len(pats), (40, k))]
        t = (pick[..., 0] + 1j * pick[..., 1]) * 2.0 ** -30
    K, M = t.shape[1], 200
    xs = []
    for _ in range(2):
        x = rng.integers(-(1 << 37), (1 << 37) + 1, (K, M))
        edge = rng.random((K, M)) < 0.3
        x[edge] = rng.choice([-(1 << 37), 1 << 37], edge.sum())
        xs.append(x)
    return t, xs[0], xs[1]


@pytest.mark.parametrize("case", ["wdft", "enc_v_inv", "edge-K64",
                                  "edge-K512"])
def test_k4_digit_planes_match(case):
    """K4's method on the card (balanced base-256 s8 digits of tr, ti, -ti
    and the data, four real products into two sets of 9 s32 diagonal sums,
    a 128-bit fold) equals fp_cmatmul_plain and the interpret-mode
    _fp_cmatmul_kernel bit for bit, at the domain's edges: data +-2^37 and
    tables at the budget, K = 64 and 512, M = 200."""
    rng = np.random.default_rng(61)
    t, xr, xi = _k4_case(case, rng)
    tm = tfp.ExactComplexMatmul(t, "cpu")
    jm = jfp.ExactComplexMatmul(t)
    assert tm.t_bits == jm.t_bits
    if case.startswith("edge"):
        assert tm.t_bits == 30
        assert int(torch.maximum(tm.tr.abs(), tm.ti.abs()).max()) == K4_BOUND
    xr_t, xi_t = torch.from_numpy(xr), torch.from_numpy(xi)
    got = _digit_plane_cmatmul(tm.tr, tm.ti, xr_t, xi_t)
    want = tfp.fp_cmatmul_plain(tm.tr, tm.ti, xr_t, xi_t)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    outs = jm._call(xr.shape[1], 40)(*_pair_planes(xr), *_pair_planes(xi),
                                     jm._tr[None], jm._ti[None], jm._ts[None])
    _words_equal([o[0] for o in outs], got[0] + got[1])
    assert 0 < int(got[0][3].sum()) < got[0][3].numel()


def test_k4_table_planes_domain():
    """table_planes cuts five balanced digits of tr, ti and -ti, in
    [-128, 127], that sum back to the table; a table past 2^39 raises."""
    rng = np.random.default_rng(62)
    tr = torch.from_numpy(rng.integers(-K4_BOUND, K4_BOUND + 1, (40, 70)))
    ti = torch.from_numpy(rng.integers(-K4_BOUND, K4_BOUND + 1, (40, 70)))
    planes = tfp.table_planes(tr, ti, 64, 128)
    assert planes.shape == (3, tfp.K4_DIGITS, 64, 128)
    for c, t in enumerate((tr, ti, -ti)):
        back = sum(planes[c, j, :40, :70].to(torch.int64) << (8 * j)
                   for j in range(tfp.K4_DIGITS))
        assert torch.equal(back, t)
    assert not planes[:, :, 40:].any() and not planes[:, :, :, 70:].any()
    with pytest.raises(ValueError, match="balanced"):
        tfp.table_planes(tr + (1 << 40), ti, 64, 128)


# -- K10a: the stage with its twiddle -------------------------------------------

def _twiddle_case(side, seed):
    """Two 35-bit limbs, K = 64: (table, data, twiddle) for one side."""
    rng = np.random.default_rng(seed)
    qs = generate_ntt_primes(2, 35, P.n, P.p)
    table = residues(rng, qs, (64, 64))
    if side == "right":     # D [L, R, K], twiddle rows repeating twice
        data, tw = residues(rng, qs, (256, 64)), residues(rng, qs, (128, 64))
    else:                   # D [L, B, K, M], twiddle [L, W, M]
        data, tw = residues(rng, qs, (3, 64, 128)), residues(rng, qs, (64, 128))
    return qs, table, data, tw


@pytest.mark.parametrize("side", ["right", "batched_left"])
def test_stage_twiddle_matches_pallas_stage(side):
    """K10a's twiddle form: PallasStage(T, qs, twiddle_mont=tw, side=side)
    in interpret mode, bit for bit (exact)."""
    qs, table, data, tw = _twiddle_case(side, 22)
    want = jax_join(pn.PallasStage(table, qs, twiddle_mont=tw, side=side,
                                   row_tile=128)(*jax_split(data)))
    got = Stage(table, qs, side, "cpu")(i64(data), twiddle_mont=i64(tw))
    np.testing.assert_array_equal(u64(got), want)
    assert len(np.unique(want)) > want.size // 2


def test_forward_mul_is_ntt_times_twiddle():
    """XNTT.forward_mul(x, tw) == NTT(x) * tw * 2^-64, exactly, and side
    'left' refuses a twiddle as PallasStage does."""
    from matrix_fhe_tpu_torch.ops.ntt import XNTT
    rng = np.random.default_rng(23)
    xn = XNTT(P, tables=T, device="cpu")
    x = i64(residues(rng, P.moduli, (P.phi, P.n, P.n)))
    tw = i64(residues(rng, P.moduli, (P.phi, P.n, P.n)))
    q = tmm.moduli_col(P.moduli, 3, "cpu")
    r_inv = tmm.moduli_col([pow(1 << 64, -1, int(m)) for m in P.moduli], 3,
                           "cpu")
    want = tmm.mul_mod(tmm.mul_mod(xn.forward(x), tw, q), r_inv, q)
    assert torch.equal(xn.forward_mul(x, tw), want)
    with pytest.raises(ValueError, match="left"):
        Stage(T.w_fwd, P.moduli, "left", "cpu")(
            x.reshape(len(P.moduli), P.phi, -1),
            twiddle_mont=tw.reshape(len(P.moduli), P.phi, -1))


# -- K11 and K12: the probes ------------------------------------------------------

def _numpy_micro_vpu(v: np.ndarray, kind: str, k: int) -> np.ndarray:
    """scripts/micro_vpu.py:28-48 (the body of its kern), in numpy u32."""
    v = v.astype(np.uint32)
    acc = v.copy()
    with np.errstate(over="ignore"):
        if kind == "addmul":
            for i in range(k):
                acc = acc * np.uint32(2654435761) + np.uint32(i | 1)
        elif kind == "shift":
            for i in range(k):
                acc = ((acc >> np.uint32(1 + (i % 5)))
                       | (acc << np.uint32(3))) & np.uint32(0x7FFFFFFF)
        elif kind == "cmpadd":
            c = v.copy()
            for i in range(k):
                s = acc + c
                cc = (s < c).astype(np.uint32)
                acc = s
                c = cc + np.uint32(i)
    return acc


@pytest.mark.parametrize("kind,k", [("copy", 0), ("addmul", 32),
                                    ("shift", 128), ("cmpadd", 48)])
def test_u32_chain_matches_micro_vpu(kind, k):
    """K11's plain version against the TPU probe's chain, bit for bit."""
    x = np.random.default_rng(24).integers(0, 1 << 32, (2, 8, 16, 16),
                                           dtype=np.uint64).astype(np.uint32)
    got = probes.u32_chain(torch.from_numpy(x.view(np.int32)), kind, k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  _numpy_micro_vpu(x, kind, k))


def _coissue_inputs(grid, seed):
    rng = np.random.default_rng(seed)
    n, k = 256, 1280
    return (rng.integers(-100, 100, (grid, 2, n, k), dtype=np.int8),
            rng.integers(-100, 100, (1, 2, k, n), dtype=np.int8),
            rng.integers(0, 1 << 32, (grid, n, n), dtype=np.uint32),
            rng.integers(0, 1 << 32, (grid, n, n), dtype=np.uint32))


@pytest.mark.parametrize("mode", ["dma", "mxu", "vpu", "both", "dep",
                                  "dma+mxu"])
def test_coissue_matches_micro_coissue(mode):
    """K12's plain version against scripts/micro_coissue.py's kernel
    (build(mode, reps=2, grid=2), interpret mode, traced in 32-bit mode as
    the script's pallas_call needs), bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "micro_coissue", os.path.join(ROOT, "scripts", "micro_coissue.py"))
    mc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mc)
    d8, t8, a, b = _coissue_inputs(2, 25)
    with jax.enable_x64(False):
        w32, wu = mc.build(mode, 2, 2)(*(jnp.asarray(v) for v in (d8, t8, a,
                                                                    b)))
    g32, gu = probes.coissue(torch.from_numpy(d8), torch.from_numpy(t8),
                             torch.from_numpy(a.view(np.int32)),
                             torch.from_numpy(b.view(np.int32)), mode, 2)
    np.testing.assert_array_equal(g32.numpy(), np.asarray(w32))
    np.testing.assert_array_equal(gu.numpy().view(np.uint32), np.asarray(wu))


# -- K7 -----------------------------------------------------------------------

def test_gemm2x2_plain_matches_sliced_interpret(monkeypatch):
    """K7's plain version against SlicedGemm2x2 (MFHE_GEMM2=sliced, in
    interpret mode on the CPU) on a 45 + 35-bit limb chain, which the JAX
    class runs as two limb runs."""
    from matrix_fhe_tpu.models.he2 import Gl2Context as JaxGl2Context
    from matrix_fhe_tpu.models.he_matmul2 import HEMatmul2 as JaxHEMatmul2

    monkeypatch.setenv("MFHE_GEMM2", "sliced")
    m45 = (generate_ntt_primes(1, 45, P.n, P.p)
           + generate_ntt_primes(2, 35, P.n, P.p))
    jp = dataclasses.replace(P, name="tiny45x2", moduli=m45)
    jhm = JaxHEMatmul2(JaxGl2Context(jp, use_pallas=False))
    rng = np.random.default_rng(18)
    ops = [residues(rng, m45, (jp.phi, jp.n, 2 * jp.n)) for _ in range(4)]
    want = jhm._gemm2x2(*(jnp.asarray(x) for x in ops))
    got = Gemm2x2(m45, jp.n, "cpu")(*(i64(x) for x in ops))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u64(g), np.asarray(w))


# -- K7's method, transcribed from csrc/gemm2x2.cu -----------------------------

def _shoup_mul(x, w: int, wp: int, q: int) -> np.ndarray:
    """shoup_mul: x w mod q from the pair (w, floor(w 2^64 / q))."""
    qq = np.uint64(q)
    with np.errstate(over="ignore"):
        r = x * np.uint64(w) - _umulhi(x, np.full_like(x, np.uint64(wp))) * qq
    assert (r < 2 * qq).all()
    return np.where(r >= qq, r - qq, r)


def _digit_plane_gemm2x2(g, u1, u2, v1, v2, flush_terms=4096):
    """gemm2x2_kernel on uint64 arrays [L, W, y, m]: per limb V_j
    pre-reduced per data digit c by a Shoup product with the kernel's pair
    (w_c, w_c'), w_c = scale 2^(8 c) 2^64 mod q, and cut into u8 planes,
    U_i's digits transposed (rows a, index c y + y'), d u8 GEMMs into s32
    sums over chunks of `flush_terms` terms, each folded, reduced by one
    REDC and summed mod q into E."""
    L, W, y, m = u1.shape
    vc = u64(g.vconsts)
    E = np.empty((4, L, W, m, m), np.uint64)
    for l, q in enumerate(g.moduli):
        d = digit_count(q)
        for i, u in enumerate((u1, u2)):
            for j, v in enumerate((v1, v2)):
                total = np.zeros((W, m, m), np.uint64)
                for y0 in range(0, y, flush_terms):
                    uc, vv = u[l, :, y0:y0 + flush_terms], v[l, :, y0:y0 + flush_terms]
                    ud = np.concatenate(        # [W, m, d yc]: A rows a
                        [((uc >> np.uint64(8 * c)) & np.uint64(255))
                         .transpose(0, 2, 1) for c in range(d)], axis=2)
                    vcs = [_shoup_mul(vv, int(vc[l, c, 0]), int(vc[l, c, 1]),
                                      q) for c in range(d)]
                    diags = []
                    for pj in range(d):         # B rows b, plane pj
                        bp = np.concatenate(
                            [((x >> np.uint64(8 * pj)) & np.uint64(255))
                             .transpose(0, 2, 1) for x in vcs], axis=2)
                        diags.append(_u8_gemm(ud.astype(np.float64),
                                              bp.astype(np.float64)
                                              .transpose(0, 2, 1)))
                    part = _redc(*_fold(diags), q)
                    total = (total + part) % np.uint64(q)
                E[2 * i + j, l] = total
    return E


def _k7_case(moduli, lanes, y, m, scale, fill, seed):
    rng = np.random.default_rng(seed)
    g = Gemm2x2(moduli, scale, "cpu")
    if fill == "max":
        ops = [np.stack([np.full((lanes, y, m), q - 1, dtype=np.uint64)
                         for q in moduli]) for _ in range(4)]
    else:
        ops = [residues(rng, moduli, (lanes, y, m)) for _ in range(4)]
    return g, ops


REF2 = get_params("ref").moduli[:2]           # 45 and 35 bits
K7_CASES = {
    "tiny": (P.moduli, P.phi, P.n, 2 * P.n, P.n, "random"),
    "ref-like": (REF2, 2, 64, 128, 64, "random"),
    "max-55": (REF_P_MODULI[:1] + REF2[:1], 2, 64, 128, 12345, "max"),
    "ragged": (MIXED, 3, 37, 29, 7, "random"),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_digit_planes_match_plain(case):
    """K7's method (V pre-reduced per digit with scale folded in, U's
    transposed digits, one REDC an output) equals Gemm2x2.plain, bit for
    bit: at tiny, at the ref gl2 shape y = 64, m = 128 on two limbs, with
    every entry q - 1 on a 55 + 45-bit chain, and at odd y and m on 35- to
    55-bit limbs."""
    g, ops = _k7_case(*K7_CASES[case], seed=60)
    want = g.plain(*(i64(x) for x in ops))
    got = _digit_plane_gemm2x2(g, *ops)
    for k in range(4):
        np.testing.assert_array_equal(got[k], u64(want[k]))


def test_k7_digit_planes_flush():
    """Contractions past one flush: y = 4100 terms at 7 digits, every entry
    q - 1 (28,672 digit rows a flush, the s32 sums checked), and chunks of
    16 terms on random data, equal Gemm2x2.plain."""
    for moduli, y, fill, flush in ((REF_P_MODULI[:1], 4100, "max", 4096),
                                   (MIXED, 70, "random", 16)):
        g, ops = _k7_case(moduli, 1, y, 6, 3, fill, seed=61)
        want = g.plain(*(i64(x) for x in ops))
        got = _digit_plane_gemm2x2(g, *ops, flush_terms=flush)
        for k in range(4):
            np.testing.assert_array_equal(got[k], u64(want[k]))


def test_k7_digit_planes_match_sliced_interpret(monkeypatch):
    """At tiny on a 45 + 35-bit chain, K7's method against SlicedGemm2x2
    (MFHE_GEMM2=sliced, interpret mode)."""
    from matrix_fhe_tpu.models.he2 import Gl2Context as JaxGl2Context
    from matrix_fhe_tpu.models.he_matmul2 import HEMatmul2 as JaxHEMatmul2

    monkeypatch.setenv("MFHE_GEMM2", "sliced")
    m45 = (generate_ntt_primes(1, 45, P.n, P.p)
           + generate_ntt_primes(2, 35, P.n, P.p))
    jp = dataclasses.replace(P, name="tiny45x2", moduli=m45)
    jhm = JaxHEMatmul2(JaxGl2Context(jp, use_pallas=False))
    rng = np.random.default_rng(19)
    ops = [residues(rng, m45, (jp.phi, jp.n, 2 * jp.n)) for _ in range(4)]
    want = jhm._gemm2x2(*(jnp.asarray(x) for x in ops))
    got = _digit_plane_gemm2x2(Gemm2x2(m45, jp.n, "cpu"), *ops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# -- K6's method, transcribed from csrc/cgemm.cu -------------------------------

def _digit_plane_cgemm(g, ar, ai, br, bi, flush_terms=4096):
    """cgemm_kernel on uint64 arrays A [L, W, R, T] and B [L, W, C, T]: per
    limb B pre-reduced per digit c of A by a Shoup product with the kernel's
    pair (w_c, w_c'), w_c = scale 2^(8 c) 2^64 mod q, and -Bi w_c mod q as
    q - (Bi w_c mod q) (checked equal to Bi's product with the pair of
    q - w_c); A's digits of Ar (h = 0) and Ai (h = 1) on the contraction
    index (c, h, t) against re's planes of Br^(c), -Bi^(c) and im's of
    Bi^(c), Br^(c); d u8 GEMMs into s32 sums over chunks of `flush_terms`
    contraction terms (h, t), each folded, reduced by one REDC and summed
    mod q.  Returns (re, im) [L, W, R, C]."""
    L, W, R, T = ar.shape
    C = br.shape[2]
    vc = u64(g.vconsts)
    out = np.empty((2, L, W, R, C), np.uint64)
    per = flush_terms // 2                      # terms t a flush
    for l, q in enumerate(g.moduli):
        d, qq = digit_count(q), np.uint64(q)
        total = np.zeros((2, W, R, C), np.uint64)
        for t0 in range(0, T, per):
            sl = slice(t0, t0 + per)

            def cut(x, c):                      # digit c of x, [W, rows, t]
                return (x >> np.uint64(8 * c)) & np.uint64(255)

            def plane(halves, j):               # B plane j, index (c, h, t)
                return np.concatenate([cut(halves[h][c], j) for c in range(d)
                                       for h in (0, 1)], axis=2)

            a_dig = np.concatenate([cut(x[l, :, :, sl], c) for c in range(d)
                                    for x in (ar, ai)], axis=2)
            brc, bic, neg = [], [], []
            for c in range(d):
                w, wp = int(vc[l, c, 0]), int(vc[l, c, 1])
                brc.append(_shoup_mul(br[l, :, :, sl], w, wp, q))
                bic.append(_shoup_mul(bi[l, :, :, sl], w, wp, q))
                neg.append(np.where(bic[-1] != 0, qq - bic[-1], 0)
                           .astype(np.uint64))
                qw = q - w
                np.testing.assert_array_equal(neg[-1], _shoup_mul(
                    bi[l, :, :, sl], qw, (qw << 64) // q, q))
            for k, halves in enumerate(((brc, neg), (bic, brc))):
                diags = []
                for j in range(d):
                    diags.append(_u8_gemm(a_dig.astype(np.float64),
                                          plane(halves, j).astype(np.float64)
                                          .transpose(0, 2, 1)))
                total[k] = (total[k] + _redc(*_fold(diags), q)) % qq
        out[:, l] = total
    return out


def _k6_case(moduli, lanes, n, scale, fill, seed):
    from matrix_fhe_tpu_torch.ops.cgemm import CGemm

    rng = np.random.default_rng(seed)
    g = CGemm(moduli, scale, "cpu")
    if fill == "max":
        ops = [np.stack([np.full((lanes, n, n), q - 1, dtype=np.uint64)
                         for q in moduli]) for _ in range(4)]
    else:
        ops = [residues(rng, moduli, (lanes, n, n)) for _ in range(4)]
    return g, ops


K6_CASES = {
    "tiny": (P.moduli, P.phi, P.n, P.n, "random"),
    "ref-like": (REF2, 2, 64, 64, "random"),
    "max-55": (REF_P_MODULI[:1] + REF2[:1], 2, 64, 12345, "max"),
    "ragged-37": (MIXED, 2, 37, 7, "random"),
    "ragged-70": (MIXED, 2, 70, 70, "random"),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_digit_planes_match_plain(case):
    """K6's method (B pre-reduced per digit of A with scale folded in, the
    subtraction as q - Bi^(c), A's digits of Ar and Ai on one contraction,
    one REDC an output) equals CGemm.plain, bit for bit: at tiny, at the ref
    trace shape n = 64 on two limbs, with every entry q - 1 on a 55 +
    45-bit chain, and at n = 37 and 70 on 35- to 55-bit limbs."""
    g, ops = _k6_case(*K6_CASES[case], seed=63)
    want = g.plain(*(i64(x) for x in ops))
    got = _digit_plane_cgemm(g, *ops)
    for k in range(2):
        np.testing.assert_array_equal(got[k], u64(want[k]))


def test_k6_digit_planes_flush():
    """Contractions past one flush: n = 70 in chunks of 16 terms (8 of t)
    on random data against CGemm.plain; and 3 x 3 outputs of t = 4,100
    terms (8,200 contraction terms, past 4,096) at 7 digits with every
    entry q - 1 (the largest s32 sums, checked) against Python integers."""
    g, ops = _k6_case(MIXED, 1, 70, 5, "random", seed=64)
    want = g.plain(*(i64(x) for x in ops))
    got = _digit_plane_cgemm(g, *ops, flush_terms=16)
    for k in range(2):
        np.testing.assert_array_equal(got[k], u64(want[k]))

    from matrix_fhe_tpu_torch.ops.cgemm import CGemm

    q, scale, t = REF_P_MODULI[0], 3, 4100
    g = CGemm((q,), scale, "cpu")
    ops = [np.full((1, 1, 3, t), q - 1, dtype=np.uint64) for _ in range(4)]
    got = _digit_plane_cgemm(g, *ops)
    re = scale * t * ((q - 1) ** 2 - (q - 1) ** 2) % q
    im = scale * t * 2 * (q - 1) ** 2 % q
    assert (got[0] == re).all() and (got[1] == im).all()


# -- exact helpers around the kernels ------------------------------------------

@pytest.mark.parametrize("sh", [0, 1, 7, 31, 32, 33, 45, 63, 64, 70])
def test_words_shr_round_matches(sh):
    rng = np.random.default_rng(8 + sh)
    m = [rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
         for _ in range(2)]
    m2 = rng.integers(0, 1 << 31, 256, dtype=np.uint64).astype(np.uint32)
    want = jdd.words_shr_round(jnp.asarray(m[0]), jnp.asarray(m[1]),
                               jnp.asarray(m2), jnp.uint32(sh))
    got = tdd.words_shr_round(*(torch.from_numpy(w.astype(np.int64))
                                for w in (m[0], m[1], m2)),
                              torch.tensor(sh))
    for j, t in zip(want, got):
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                      t.numpy())


def test_compose_tail_matches():
    rng = np.random.default_rng(9)
    acc = rng.integers(0, 1 << 64, 512, dtype=np.uint64)
    k = rng.integers(0, len(P.moduli), 512)
    acc_l, acc_h = jmm.pair_split(jnp.asarray(acc))
    want = jdd.compose_tail_from_partials(acc_l, acc_h,
                                          jnp.asarray(k, jnp.float32),
                                          P.q_total, P.delta)
    got = tdd.compose_tail_from_partials(i64(acc), torch.from_numpy(k),
                                         P.q_total, P.delta)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_mul_mod_and_umod64_exact():
    rng = np.random.default_rng(10)
    for q in (P.moduli[0], get_params("ref").moduli[0], REF_P_MODULI[0]):
        a = rng.integers(0, q, 1000, dtype=np.uint64)
        b = rng.integers(0, q, 1000, dtype=np.uint64)
        got = tmm.mul_mod(i64(a), i64(b), torch.tensor(q))
        want = [int(x) * int(y) % q for x, y in zip(a, b)]
        assert got.tolist() == want
        u = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)
        assert tmm.umod64(i64(u), torch.tensor(q)).tolist() == \
            [int(x) % q for x in u]


def test_to_mont_matches_jax():
    rng = np.random.default_rng(11)
    x = residues(rng, P.moduli, (P.phi, P.n))
    c = jmm.mont_consts_arrays(P.moduli, shape_suffix=(1, 1))
    want = jmm.to_mont(jnp.asarray(x), c["q"], c["qinv_neg"], c["r2"])
    np.testing.assert_array_equal(u64(tmm.to_mont(i64(x), P.moduli)),
                                  np.asarray(want))


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors."""
    st = Stage(T.w_fwd, P.moduli, "left", "cpu")
    with pytest.raises(ValueError):
        st(torch.empty((len(P.moduli), P.phi, 8), dtype=torch.int64,
                       device="meta"))
    with pytest.raises(ValueError):
        _backend.on_device(torch.zeros(1), torch.zeros(1, device="meta"))


# -- CUDA kernels against their plain versions (skip without a GPU) ----------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def _launched(name, fn):
    before = _backend.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _backend.LAUNCHES[name] == before + 1
    return out


def _launched_stage(key, st, fn):
    """K1 launched once under `key`, and its split pass once on the left
    sides (under the Stage's split key)."""
    split = _backend.LAUNCHES[st.keys[1]]
    out = _launched(key, fn)
    assert _backend.LAUNCHES[st.keys[1]] == split + (st.side != "right")
    return out


def _stage_checks(st, x, tw=None):
    """Stage.kernel on the card launched once under its route's key, equal
    to Stage.plain bit for bit; on the X-NTT and W-CRT routes also to the
    general kernel (Stage.general), their yardstick."""
    got = _launched_stage(st.launch_key(tw is not None), st,
                          lambda: st.kernel(x, tw))
    want = st.plain(x, tw)
    assert torch.equal(got.cpu(), want.cpu())
    k = st.table.shape[2]
    if takes_xntt(st.side, k) or takes_wcrt(st.side, k):
        assert torch.equal(st.general(x, tw).cpu(), want.cpu())


# the X-NTT route (csrc/xntt_stage.cu) at the cells' shapes, [L, 32768, 64]
# on mid's 4 Q limbs, mid's 10 QP limbs (six 28-bit P), ref's 11 Q, the
# leveled chain's 13 level-1 QP and ref's 14 QP limbs; gl2's 128 points on
# the 14 QP limbs (table K-tiles in the ring) and on 35-bit limbs (the
# planes resident); a ragged R (79 x 64 rows) on the mixed widths with
# every entry q - 1.  Twiddles: none, one row (as ctx._r2_tw), or every
# row (a key or a ciphertext).
XNTT_SHAPES = {"cell4": ("mid4", 64, 32768, "random"),
               "cell10": ("mid10", 64, 32768, "random"),
               "cell11": ("ref11", 64, 32768, "random"),
               "cell13": ("lev13", 64, 32768, "random"),
               "cell14": ("ref14", 64, 32768, "random"),
               "gl2K128": ("ref14", 128, 32768, "random"),
               "resK128": ("q35", 128, 8192, "random"),
               "ragged": ("mixed", 64, 5056, "max")}


def _xntt_moduli(name):
    ref = get_params("ref")
    p28 = generate_ntt_primes(6, 28, 64, 771)
    return {"mid4": ref.moduli[:4], "mid10": ref.moduli[:4] + p28,
            "ref11": ref.moduli, "ref10": ref.moduli[:10],
            "lev13": ref.moduli[:10] + REF_P_MODULI,
            "ref14": ref.moduli + REF_P_MODULI, "q35": ref.moduli[1:6],
            "p28": p28, "p55": REF_P_MODULI[:1] * 3, "mixed": MIXED}[name]


def _xntt_case(cuda, shape, twiddle):
    """(Stage, data, twiddle or None) of an XNTT_SHAPES case on the card."""
    name, n, rows, fill = XNTT_SHAPES[shape]
    moduli = _xntt_moduli(name)
    q = torch.tensor(moduli, dtype=torch.int64, device=cuda).reshape(-1, 1, 1)
    gen = torch.Generator(device=cuda).manual_seed(rows + n)

    def draw(r):
        if fill == "max":
            return (q - 1).expand(-1, r, n).contiguous()
        return torch.randint(0, 1 << 62, (len(moduli), r, n), generator=gen,
                             device=cuda) % q

    st = Stage(draw(n).cpu().numpy().view(np.uint64), moduli, "right", cuda)
    tw = {"none": None, "row": lambda: draw(1),
          "full": lambda: draw(rows)}[twiddle]
    return st, draw(rows), (tw() if tw else None)


# the W-CRT route (csrc/wcrt_stage.cu) at the cells' shapes, [L, 512, M]
# tables [L, 512, 512]: the key switch's QP W-CRT on ref's 14 QP, ref's 11
# Q, the leveled chain's 13 level-1 QP and mid's 10 QP limbs; gl2's QP
# W-CRT (M = 16384) and its rescale's [11 | 10, 512, 8192]; a ragged M
# (4096 + 77) with every entry q - 1 on the 14 QP limbs; 28-bit limbs alone
# (4 digits) and the 55-bit P prime alone (7 digits, 128-row tiles) at a
# ragged M and an odd count of 32-row table tiles (W = 96, 72)
WCRT_SHAPES = {"cell14": ("ref14", 512, 4096, "random"),
               "cell11": ("ref11", 512, 4096, "random"),
               "cell13": ("lev13", 512, 4096, "random"),
               "cell10": ("mid10", 512, 4096, "random"),
               "gl2": ("ref14", 512, 16384, "random"),
               "rescale11": ("ref11", 512, 8192, "random"),
               "rescale10": ("ref10", 512, 8192, "random"),
               "ragged": ("ref14", 512, 4173, "max"),
               "d4": ("p28", 96, 1000, "random"),
               "d7": ("p55", 72, 513, "max")}


def _wcrt_case(cuda, shape):
    """(Stage, data) of a WCRT_SHAPES case on the card."""
    name, w, m, fill = WCRT_SHAPES[shape]
    moduli = _xntt_moduli(name)
    q = torch.tensor(moduli, dtype=torch.int64, device=cuda).reshape(-1, 1, 1)
    gen = torch.Generator(device=cuda).manual_seed(m + w)

    def draw(r, c):
        if fill == "max":
            return (q - 1).expand(-1, r, c).contiguous()
        return torch.randint(0, 1 << 62, (len(moduli), r, c), generator=gen,
                             device=cuda) % q

    st = Stage(draw(w, 512).cpu().numpy().view(np.uint64), moduli, "left",
               cuda)
    return st, draw(512, m)


# sides x K x fill on the mixed 35/40/45/55-bit limbs, 40 table rows and 200
# data rows (neither a multiple of the block's 32 x 128; side 'left' at K >=
# 256 takes the W-CRT route); then contractions past the s32 bound on the
# 55-bit prime
STAGE_CASES = (["tiny", "small"]
               + [f"{side}-K{k}-{fill}"
                  for side in ("left", "right", "batched_left")
                  for k in (64, 128, 256, 512) for fill in ("random", "max")]
               + ["left-K4800-flush", "right-K4800-flush"]
               + [f"xntt-{shape}" for shape in XNTT_SHAPES]
               + [f"wcrt-{shape}" for shape in WCRT_SHAPES])


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGE_CASES)
def test_cuda_stage_matches_plain(cuda, case):
    if case in ("tiny", "small"):
        p = get_params(case)
        t = build_tables(p)
        rng = np.random.default_rng(12)
        wide = REF_P_MODULI[:1]           # the 55-bit P prime (q < 2^56)
        cases = (("left", t.w_fwd, p.moduli, (p.phi, p.n * p.n + 3)),
                 ("right", t.x_fwd_nega, p.moduli, (p.phi * 3, p.n)),
                 ("left", residues(rng, wide, (40, 40)), wide, (40, 70)),
                 ("right", residues(rng, wide, (40, 40)), wide, (70, 40)))
        for side, table, moduli, shape in cases:
            st = Stage(table, moduli, side, cuda)
            x = i64(residues(rng, moduli, shape)).to(cuda)
            _stage_checks(st, x)
        return
    if case.startswith("xntt-"):
        st, x, _ = _xntt_case(cuda, case[5:], "none")
        assert st.launch_key(False) == "stage_x"
        _stage_checks(st, x)
        return
    if case.startswith("wcrt-"):
        st, x = _wcrt_case(cuda, case[5:])
        assert st.launch_key(False) == "stage_w"
        _stage_checks(st, x)
        return
    side, k, fill = case.split("-")
    if fill == "flush":
        st, data = _stage_case(side, int(k[1:]), "max", seed=42,
                               moduli=REF_P_MODULI[:1], w=8, rows=4)
    else:
        st, data = _stage_case(side, int(k[1:]), fill, seed=43, rows=200)
    st = Stage(u64(st.table), st.moduli, side, cuda)
    _stage_checks(st, data.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
def test_cuda_stage_layout(cuda, side):
    """The digit-plane layout csrc/stage.cu reports (mf_stage_layout): the
    plane rows cover every limb's contraction in whole 128-byte tiles, a
    flush keeps the s32 sums exact, and the K = 4800 cases above flush."""
    slots = 8 if side == "right" else 7
    for k in (64, 65, 512, 4800):
        kp, kbs, tile_w, flush = plane_layout(k, MIXED, side)
        assert k <= kp and slots * kp <= kbs and kbs % 128 == 0
        assert flush % 128 == 0
        assert flush * 255 ** 2 < 1 << 31 and flush < 7 * 4800


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_cuda_ntt_mul_ntt_matches_plain(cuda, preset):
    p = get_params(preset)
    t = build_tables(p)
    rng = np.random.default_rng(13)
    k2 = NttMulNtt(t.x_fwd_nega, t.x_inv_nega, p.moduli, cuda)
    a = i64(residues(rng, p.moduli, (p.phi * p.n, p.n))).to(cuda)
    s = i64(residues(rng, p.moduli, (p.phi, p.n))).to(cuda)
    got = _launched("ntt_mul_ntt", lambda: k2(a, s))
    assert torch.equal(got.cpu(), k2.plain(a, s).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
def test_cuda_ntt_mul_ntt_wide_rings(cuda, n):
    """K2 at the ref X ring (n = 64) and the gl2 ring (n = 128) on a
    45 + 35-bit chain, rows not a multiple of the block's, rep = 64 as in
    the gl2 decrypt."""
    moduli = get_params("ref").moduli[:2]
    rng = np.random.default_rng(19)
    fwd, inv = (residues(rng, moduli, (n, n)) for _ in range(2))
    k2 = NttMulNtt(fwd, inv, moduli, cuda)
    W, rep = 5, 64
    a = i64(residues(rng, moduli, (W * rep, n))).to(cuda)
    s = i64(residues(rng, moduli, (W, n))).to(cuda)
    got = _launched("ntt_mul_ntt", lambda: k2(a, s))
    assert torch.equal(got.cpu(), k2.plain(a, s).cpu())


@pytest.mark.cuda
def test_cuda_ntt_mul_ntt_refuses_what_does_not_fit(cuda):
    """n = 256 needs a 512 KB table in one block's shared memory (227 KB at
    most): the wrapper raises before any launch."""
    moduli = get_params("ref").moduli[:1]
    rng = np.random.default_rng(20)
    fwd, inv = (residues(rng, moduli, (256, 256)) for _ in range(2))
    k2 = NttMulNtt(fwd, inv, moduli, cuda)
    a = i64(residues(rng, moduli, (8, 256))).to(cuda)
    s = i64(residues(rng, moduli, (2, 256))).to(cuda)
    before = _backend.LAUNCHES["ntt_mul_ntt"]
    with pytest.raises(ValueError, match="n = 256.*shared memory"):
        k2(a, s)
    assert _backend.LAUNCHES["ntt_mul_ntt"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("rep", [1, 64])
@pytest.mark.parametrize("n", [8, 16, 32, 64, 128])
def test_cuda_ntt_mul_ntt_every_ring(cuda, n, rep, fill):
    """K2 at every n the presets use (and 32): 35-, 40-, 45- and 55-bit
    limbs in one launch, R = 3 rep rows (ragged against the block's 128 or
    64), rep = 1 and 64, random and all-(q - 1) tables and inputs."""
    k2, a, s = _k2_case(n, rep, fill, seed=70 + n + rep)
    k2 = NttMulNtt(u64(k2.fwd), u64(k2.inv), k2.moduli, cuda)
    a, s = i64(a).to(cuda), i64(s).to(cuda)
    got = _launched("ntt_mul_ntt", lambda: k2(a, s))
    assert torch.equal(got.cpu(), k2.plain(a, s).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_cuda_inv_compose_matches_plain(cuda, preset):
    p = get_params(preset)
    t = build_tables(p)
    rng = np.random.default_rng(14)
    k3 = InvCompose(scaled_inverse_tables(t), p.moduli, p.q_total, cuda)
    x = i64(residues(rng, p.moduli, (p.phi, 2 * p.n * p.n))).to(cuda)
    got = _launched("inv_compose", lambda: k3(x))
    want = k3.plain(x)
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu(), want[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["wdft", "enc_v_inv"])
def test_cuda_fp_cmatmul_matches_plain(cuda, table):
    t = getattr(build_tables(get_params("small")), table)
    tm = tfp.ExactComplexMatmul(t, cuda)
    K, M = t.shape[1], 200
    gen = torch.Generator(device=cuda).manual_seed(15)
    xr, xi = (torch.randint(-(1 << 37), 1 << 37, (K, M), generator=gen,
                            device=cuda) for _ in range(2))
    got = _launched("fp_cmatmul",
                    lambda: tfp.fp_cmatmul(tm.tr, tm.ti, xr, xi))
    want = tfp.fp_cmatmul_plain(tm.tr, tm.ti, xr, xi)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "small", "ref"])
def test_cuda_inv_compose_own_keys_ragged(cuda, preset):
    """K3 at M = 2 n^2 + 3, no multiple of any tile ([11, 512, 8195] at ref),
    and (below ref) on sums within 1e-9 of a half-integer: equal to
    InvCompose.plain; its split, GEMM and compose launch once each under
    K3's own keys, and K1's keys do not move."""
    p = get_params(preset)
    t = build_tables(p)
    rng = np.random.default_rng(16)
    k3 = InvCompose(scaled_inverse_tables(t), p.moduli, p.q_total, cuda)
    xs = [i64(residues(rng, p.moduli, (p.phi, 2 * p.n * p.n + 3)))]
    if preset != "ref":
        xs.append(_near_half_inputs(p, t, seed=64)[0])
    gemm = k3._stage.launch_key(False)   # inv_compose_stage_w at ref's 512
    assert gemm == ("inv_compose_stage_w" if p.phi >= WCRT_MIN_K
                    else "inv_compose_stage")
    keys = ("inv_compose", gemm, "inv_compose_split", "stage", "stage_w",
            "stage_split")
    for x in xs:
        x = x.to(cuda)
        before = {k: _backend.LAUNCHES[k] for k in keys}
        got = k3(x)
        torch.cuda.synchronize()
        assert {k: _backend.LAUNCHES[k] - before[k] for k in keys} == {
            "inv_compose": 1, gemm: 1, "inv_compose_split": 1,
            "stage": 0, "stage_w": 0, "stage_split": 0}
        want = k3.plain(x)
        assert torch.equal(got[0].cpu(), want[0].cpu())
        assert torch.equal(got[1].cpu(), want[1].cpu())
        # the scaled tables' GEMM on its route == the general kernel
        assert torch.equal(k3._stage.kernel(x), k3._stage.general(x))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wdft-ref", "sigma-ref", "edge-K64",
                                  "edge-K512"])
def test_cuda_fp_cmatmul_path_shapes_and_edges(cuda, case):
    """K4 through ExactComplexMatmul's table planes at the ref roundtrip's
    two shapes, the W-DFT [512, 512] @ [512, 4096] and the sigma sandwich
    [64, 64] @ [64, 32768], and at the domain's edges (data +-2^37, tables
    at the budget, K = 64 and 512, M = 200): equal to fp_cmatmul_plain, one
    split pass and one GEMM a call."""
    rng = np.random.default_rng(63)
    if case.endswith("ref"):
        tables = build_tables(get_params("ref"))
        t, M = ((tables.wdft, 4096) if case == "wdft-ref"
                else (tables.enc_v_inv, 32768))
        xr, xi = (rng.integers(-(1 << 37), (1 << 37) + 1, (t.shape[1], M))
                  for _ in range(2))
        xr[0, :7] = 1 << 37
        xi[1, :7] = -(1 << 37)
    else:
        t, xr, xi = _k4_case(case, rng)
    tm = tfp.ExactComplexMatmul(t, cuda)
    xr, xi = torch.from_numpy(xr).to(cuda), torch.from_numpy(xi).to(cuda)
    split = _backend.LAUNCHES["fp_cmatmul_split"]
    got = _launched("fp_cmatmul", lambda: tm._matmul(xr, xi))
    assert _backend.LAUNCHES["fp_cmatmul_split"] == split + 1
    want = tfp.fp_cmatmul_plain(tm.tr, tm.ti, xr, xi)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_cuda_fp_cmatmul_refuses_long_contractions(cuda):
    """Past K = 13,107 an s32 diagonal sum could overflow: the wrapper
    raises before any launch."""
    tr = torch.zeros((1, 13108), dtype=torch.int64, device=cuda)
    x = torch.zeros((13108, 8), dtype=torch.int64, device=cuda)
    before = _backend.LAUNCHES["fp_cmatmul"]
    with pytest.raises(ValueError, match="exceeds"):
        tfp.fp_cmatmul_kernel(tr, tr, x, x)
    assert _backend.LAUNCHES["fp_cmatmul"] == before


# (bits, N, negacyclic, limbs, batch, fill): m = sqrt(N) from 2 to 4096; the
# register kernel at m = 4, 16, 64, 256 and the radix-2 loop at the others;
# moduli below 2^30 on the 32-bit route, the others on the 64-bit one
FOUR_STEP_CASES = [
    (35, 1024, True, 3, 5, "random"), (28, 4096, True, 3, 5, "random"),
    (35, 256, False, 3, 5, "random"), (23, 64, True, 3, 5, "random"),
    (23, 64, True, 3, 5, "max"),
    (35, 1 << 16, True, 2, 3, "random"), (28, 1 << 16, True, 2, 3, "random"),
    (30, 1 << 16, False, 2, 3, "random"), (55, 1 << 16, True, 2, 3, "random"),
    (55, 1 << 16, True, 2, 3, "max"), (28, 1 << 16, True, 2, 3, "max"),
    (35, 4, True, 3, 5, "random"), (28, 4, False, 3, 5, "max"),
    (30, 16, True, 3, 5, "random"), (55, 16, False, 3, 5, "max"),
    (35, 1 << 24, True, 1, 1, "random"), (28, 1 << 24, False, 1, 1, "max"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,n,nega,limbs,batch,fill", FOUR_STEP_CASES)
def test_cuda_four_step_ntt_matches_plain(cuda, bits, n, nega, limbs, batch,
                                          fill):
    from matrix_fhe_tpu_torch.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                                    generate_primes_1mod)
    rng = np.random.default_rng(16)
    moduli = generate_primes_1mod(limbs, bits, 2 * n)
    ntt = FourStepNTT(FourStepPlan.make(n, moduli, negacyclic=nega), cuda)
    assert ntt.word_bits == (32 if bits <= 30 else 64)
    if fill == "max":
        x = i64(np.stack([np.full((batch, n), q - 1, dtype=np.uint64)
                          for q in moduli])).to(cuda)
    else:
        x = i64(residues(rng, moduli, (batch, n))).to(cuda)
    fwd = _launched("four_step_fwd", lambda: ntt.forward(x))
    assert torch.equal(fwd, ntt.forward_plain(x))
    back = _launched("four_step_inv", lambda: ntt.inverse(fwd))
    assert torch.equal(back, ntt.inverse_plain(fwd))
    assert torch.equal(back, x)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "small"] + sorted(K6_CASES)
                         + ["flush"])
def test_cuda_cgemm_matches_plain(cuda, preset):
    """K6 at a preset's trace shape and at n = 70 with odd W on a 55 + 45 +
    35-bit chain; at the cases of test_k6_digit_planes_match_plain; and at
    n = 2,100 (4,200 contraction terms, past one flush of the s32 sums) with
    every entry q - 1 at 7 digits."""
    from matrix_fhe_tpu_torch.ops.cgemm import CGemm

    if preset not in ("tiny", "small"):
        spec = ((REF_P_MODULI[:1], 1, 2100, 3, "max") if preset == "flush"
                else K6_CASES[preset])
        g, ops = _k6_case(*spec, seed=65)
        gemm = CGemm(g.moduli, g.scale, cuda)
        ops = [i64(x).to(cuda) for x in ops]
        got = _launched("cgemm", lambda: gemm(*ops))
        want = gemm.plain(*ops)
        assert torch.equal(got[0].cpu(), want[0].cpu())
        assert torch.equal(got[1].cpu(), want[1].cpu())
        return
    p = get_params(preset)
    rng = np.random.default_rng(17)
    wide = REF_P_MODULI[:1] + get_params("ref").moduli[:2]   # 55, 45, 35 bits
    for moduli, lanes, n, scale in ((p.moduli, p.phi, p.n, p.n),
                                    (wide, 3, 70, 1234567)):
        gemm = CGemm(moduli, scale, cuda)
        ops = [i64(residues(rng, moduli, (lanes, n, n))).to(cuda)
               for _ in range(4)]
        got = _launched("cgemm", lambda: gemm(*ops))
        want = gemm.plain(*ops)
        assert torch.equal(got[0].cpu(), want[0].cpu())
        assert torch.equal(got[1].cpu(), want[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_cuda_gemm2x2_matches_plain(cuda, preset):
    """K7 at the gl2 tensor shape of a preset, and at m = 128 (the ref gl2
    ring) with odd W, y not a multiple of the tile depth and a 55 + 45-bit
    chain."""
    p = get_params(preset)
    rng = np.random.default_rng(21)
    wide = REF_P_MODULI[:1] + get_params("ref").moduli[:1]    # 55, 45 bits
    for moduli, lanes, y, m, scale in ((p.moduli, p.phi, p.n, 2 * p.n, p.n),
                                       (wide, 3, 37, 128, 64)):
        gemm = Gemm2x2(moduli, scale, cuda)
        ops = [i64(residues(rng, moduli, (lanes, y, m))).to(cuda)
               for _ in range(4)]
        got = _launched("gemm2x2", lambda: gemm(*ops))
        want = gemm.plain(*ops)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K7_CASES) + ["small", "flush"])
def test_cuda_gemm2x2_digit_plane_cases(cuda, case):
    """K7 at tiny, small and the ref gl2 shape (y = 64, m = 128), all-(q -
    1) entries with scale != 1 on a 55 + 45-bit chain, odd y and m on 35-
    to 55-bit limbs, and y = 4100 (past one flush of the s32 sums) with
    every entry q - 1 at 7 digits."""
    if case == "small":
        p = get_params("small")
        spec = (p.moduli, p.phi, p.n, 2 * p.n, p.n, "random")
    elif case == "flush":
        spec = (REF_P_MODULI[:1], 2, 4100, 40, 3, "max")
    else:
        spec = K7_CASES[case]
    g, ops = _k7_case(*spec, seed=62)
    g = Gemm2x2(g.moduli, g.scale, cuda)
    ops = [i64(x).to(cuda) for x in ops]
    got = _launched("gemm2x2", lambda: g(*ops))
    want = g.plain(*ops)
    for x, w in zip(got, want):
        assert torch.equal(x.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["right", "batched_left"]
                         + [f"{side}-K{k}-{fill}"
                            for side in ("right", "batched_left")
                            for k in (64, 128, 256, 512)
                            for fill in ("random", "max")]
                         + [f"xntt-{shape}-{tw}" for shape in XNTT_SHAPES
                            for tw in ("row", "full")])
def test_cuda_stage_twiddle_matches_plain(cuda, case):
    """K10a's twiddle form on the card: the PallasStage case, the 55-bit P
    prime with a one-row twiddle and rows that are not a multiple of the
    tile, the mixed 35/40/45/55-bit limbs at K = 64..512 with 200 rows
    (twiddle rows 40 on side 'right'), and the X-NTT route at the cells'
    shapes with a one-row and a full twiddle; each under its route's key,
    the X-NTT route also equal to the general kernel."""
    if case.startswith("xntt-"):
        shape, twiddle = case[5:].rsplit("-", 1)
        st, d, t = _xntt_case(cuda, shape, twiddle)
        assert st.launch_key(True) == "stage_tw_x"
        _stage_checks(st, d, t)
        return
    side = case.split("-")[0]
    if case == side:
        qs, table, data, tw = _twiddle_case(side, 26)
        st = Stage(table, qs, side, cuda)
        _stage_checks(st, i64(data).to(cuda), i64(tw).to(cuda))
        if side == "right":
            rng = np.random.default_rng(27)
            wide = REF_P_MODULI[:1]
            st = Stage(residues(rng, wide, (64, 64)), wide, side, cuda)
            _stage_checks(st, i64(residues(rng, wide, (70, 64))).to(cuda),
                          i64(residues(rng, wide, (1, 64))).to(cuda))
        return
    _, k, fill = case.split("-")
    st, data = _stage_case(side, int(k[1:]), fill, seed=44, rows=200)
    st = Stage(u64(st.table), st.moduli, side, cuda)
    rng = np.random.default_rng(45)
    tw_shape = (40, 40) if side == "right" else (40, 200)
    _stage_checks(st, data.to(cuda), i64(residues(rng, MIXED, tw_shape)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k", [("copy", 0), ("addmul", 32),
                                    ("shift", 128), ("cmpadd", 48)])
def test_cuda_u32_chain_matches_plain(cuda, kind, k):
    """K11 at [2, 8, 256, 256] and [4, 16, 256, 256]: one and two passes of
    the chains' grid-stride loop (2^20 16-byte vectors over at most
    132 x 16 blocks of 256), 256 and 1,024 of the copy's tiles of
    4 x 256 vectors."""
    gen = torch.Generator(device=cuda).manual_seed(28)
    for shape in ((2, 8, 256, 256), (4, 16, 256, 256)):
        x = torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                          dtype=torch.int32, device=cuda)
        got = _launched("micro_vpu", lambda: probes.u32_chain(x, kind, k))
        assert torch.equal(got, probes.u32_chain_plain(x, kind, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3,), (7, 1001), ((1 << 24) + 3,)])
def test_cuda_u32_copy_ragged(cuda, shape):
    """K11's copy on element counts that are not a multiple of 4 (the tail)
    nor of a tile (4 x 256 16-byte vectors), from less than one tile to
    4,096 of them, into a given output buffer; the chains refuse them."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    x = torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                      dtype=torch.int32, device=cuda)
    out = torch.full_like(x, 7)
    got = _launched("micro_vpu",
                    lambda: probes.u32_chain_kernel(x, "copy", 0, out=out))
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, x)
    with pytest.raises(ValueError, match="4n elements"):
        probes.u32_chain_kernel(x, "addmul", 32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dma", "mxu", "vpu", "both", "dep",
                                  "dma+mxu"])
def test_cuda_coissue_matches_plain(cuda, mode):
    """K12 at grid 4 and reps 2, and at K = 64 (fewer k-steps than the 32
    fragment elements) with three planes."""
    for grid, reps, k, planes in ((4, 2, 1280, 2), (2, 3, 64, 3)):
        gen = torch.Generator(device=cuda).manual_seed(29)
        d8, t8 = (torch.randint(-100, 100, shape, generator=gen,
                                dtype=torch.int8, device=cuda)
                  for shape in ((grid, planes, 256, k), (1, 2, k, 256)))
        a, b = (torch.randint(-(1 << 31), 1 << 31, (grid, 256, 256),
                              generator=gen, dtype=torch.int32, device=cuda)
                for _ in range(2))
        got = _launched("micro_coissue",
                        lambda: probes.coissue(d8, t8, a, b, mode, reps))
        want = probes.coissue_plain(d8, t8, a, b, mode, reps)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 2, 8])
@pytest.mark.parametrize("grid", [4, 64])
@pytest.mark.parametrize("mode", ["dma", "mxu", "vpu", "both", "dep",
                                  "dma+mxu"])
def test_cuda_coissue_grids_and_reps(cuda, mode, grid, reps):
    """K12 at the script's N = 256, K = 1280 on grids of 4 and 64 cells,
    reps 1, 2 and 8 over P = 3 planes of d8 (no reps count a multiple of
    P) and Pt = 2 of t8."""
    gen = torch.Generator(device=cuda).manual_seed(30 + reps)
    d8, t8 = (torch.randint(-100, 100, shape, generator=gen,
                            dtype=torch.int8, device=cuda)
              for shape in ((grid, 3, 256, 1280), (1, 2, 1280, 256)))
    a, b = (torch.randint(-(1 << 31), 1 << 31, (grid, 256, 256),
                          generator=gen, dtype=torch.int32, device=cuda)
            for _ in range(2))
    got = _launched("micro_coissue",
                    lambda: probes.coissue(d8, t8, a, b, mode, reps))
    want = probes.coissue_plain(d8, t8, a, b, mode, reps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
