"""Kernels K1-K3 and K10a: the exact modular-matmul stages of the HE path.

Counterpart of matrix_fhe_tpu/ops/pallas_ntt.py (SlicedStage and
PallasStage with its twiddle, SlicedNttMulNtt, SlicedInvCompose).  Each
class owns its tables as int64 tensors on one device; calling it on a CUDA
tensor launches the kernel in ``csrc/`` and on a CPU tensor runs the plain
PyTorch version, ``plain``, which is the same function (the CPU tests and
chip_smoke.py hold the two equal).  All limbs run in one launch.  K1,
K10a and K3's matmul run on the int8 tensor cores over u8 digit planes of
the table (``slice_tables``, built on the device at a Stage's first CUDA
call), K3's compose in a pass of its own; K2 runs two such GEMMs in one
launch with the spectrum in shared memory.  Side 'right' at a contraction
of at most XNTT_MAX_K terms (the X-NTT) has a kernel of its own
(``takes_xntt``), built for a short, byte-bound contraction, and so has
side 'left' at WCRT_MIN_K to WCRT_MAX_K terms (the W-CRT over 512 lanes,
``takes_wcrt``), built for a long, product-bound one.
The TPU's limb runs and u32 lo/hi planes do not exist here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _backend as be
from .modmath import kernel_consts, moduli_col, mul_mod, to_signed64
from .modmatmul import modmatmul

I64 = torch.int64
SMEM_LIMIT = 232448     # shared memory one block may hold on Hopper (227 KB)
XNTT_MAX_K = 128        # side 'right' contractions csrc/xntt_stage.cu takes
WCRT_MIN_K = 256        # side 'left' contractions csrc/wcrt_stage.cu takes,
WCRT_MAX_K = 4096       # whose s32 sums stay exact without a flush


def _as_i64(table_u64: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(table_u64, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def _bits(moduli: Sequence[int], k: int, k_max: int = 1 << 16) -> int:
    """Bit width of the moduli, checked against the kernels' exactness
    bounds: q < 2^56 and a contraction of k <= k_max terms (K2 and K3:
    2^16, so that a 128-bit sum of products < 2^112 cannot overflow)."""
    bits = max(int(q).bit_length() for q in moduli)
    if bits >= 56:
        raise ValueError("moduli must be < 2^56")
    if k > k_max:
        raise ValueError(f"contraction of {k} terms exceeds {k_max}")
    return bits


def digit_count(q: int) -> int:
    """u8 digits of a residue mod q: ceil(bits(q) / 8), at most 7."""
    return -(-int(q).bit_length() // 8)


def plane_layout(k: int, moduli: Sequence[int],
                 side: str) -> Tuple[int, int, int, int]:
    """(Kp, KBs, table rows a block, digit rows a flush) of K1's digit
    planes for a contraction of k terms, as csrc/stage.cu lays them out
    (mf_stage_layout).  Side 'right' reads the int64 data as bytes, 8 digit
    slots a term at index 8 x + c; the left sides hold d_l planes at index
    c Kp + x.  KBs is the byte length of a plane row."""
    layout = (ctypes.c_int * 4)()
    be.library().mf_stage_layout(k, max(map(digit_count, moduli)),
                                 int(side != "right"), layout)
    return tuple(layout)


def slice_tables(table: torch.Tensor, moduli: Sequence[int], side: str,
                 kp: int, kbs: int, tile_w: int) -> torch.Tensor:
    """K1's table planes, u8 [L, ceil(W / tile_w), Dmax, tile_w, kbs], on
    the table's device: plane j of table row w, contraction index of (c, x)
    (8 x + c on side 'right', c kp + x on the left sides), holds byte j of
    T^(c)[w, x] = T[w, x] 2^(8 c) 2^64 mod q (the method of the JAX
    _slice_tables with 8-bit unsigned digits; the factor 2^64 lets the
    kernel reduce each output with one Montgomery REDC).  c runs over the
    data's digit slots: 8 for side 'right', d_l for the left sides; every
    other byte is zero."""
    L, W, K = table.shape
    ds = [digit_count(q) for q in moduli]
    dmax, wt = max(ds), -(-W // tile_w)
    dev = table.device
    q = moduli_col(moduli, 2, dev)
    planes = torch.zeros((L, wt * tile_w, dmax, kbs), dtype=torch.uint8,
                         device=dev)
    for c in range(8 if side == "right" else dmax):
        tc = mul_mod(table, moduli_col(
            [pow(2, 8 * c + 64, int(m)) for m in moduli], 2, dev), q)
        if side != "right":
            live = torch.tensor([c < d for d in ds], device=dev)
            tc = torch.where(live.reshape(L, 1, 1), tc, 0)
        for j in range(dmax):
            byte = ((tc >> (8 * j)) & 255).to(torch.uint8)
            if side == "right":
                planes[:, :W, j, c:8 * K:8] = byte
            else:
                planes[:, :W, j, c * kp:c * kp + K] = byte
    return planes.reshape(L, wt, tile_w, dmax, kbs).transpose(2, 3).contiguous()


def takes_xntt(side: str, k: int) -> bool:
    """The route rule of Stage.kernel, read from the table's shape: side
    'right' with a contraction of at most XNTT_MAX_K terms (every X-NTT at
    n = 64, the gl2 ring's 128, four-step stages of those sizes) runs
    csrc/xntt_stage.cu; the left sides and longer contractions run
    csrc/stage.cu."""
    return side == "right" and k <= XNTT_MAX_K


def takes_wcrt(side: str, k: int) -> bool:
    """The other route rule of Stage.kernel: side 'left' with a contraction
    of WCRT_MIN_K to WCRT_MAX_K terms (the W-CRT over the 512 lanes, K3's
    GEMM on the scaled tables) runs csrc/wcrt_stage.cu, whose s32 sums stay
    exact without a flush up to WCRT_MAX_K terms at 7 digits; shorter and
    longer left contractions run csrc/stage.cu."""
    return side == "left" and WCRT_MIN_K <= k <= WCRT_MAX_K


class Stage:
    """K1 and K10a: one exact modular matmul stage per limb, canonical
    output, optionally times a per-output twiddle.

    side 'left':         out[l, w, m] = sum_r T[l, w, r] * D[l, r, m] mod q_l
                         (W-CRT; D [L, K, M])
    side 'right':        out[l, r, k] = sum_x D[l, r, x] * T[l, k, x] mod q_l
                         (X-NTT; D [L, R, K])
    side 'batched_left': out[l, b, w, m] = sum_r T[l, w, r] * D[l, b, r, m]
                         mod q_l (D [L, B, K, M]; the four-step stage shape)

    A call may pass `twiddle_mont` in the JAX storage form tw * 2^64 mod q
    (sides 'right' and 'batched_left', as PallasStage): the output is then
    multiplied by tw[l, r mod tw_rows, k] ('right', twiddle [L, tw_rows, W])
    or tw[l, w, m] ('batched_left', twiddle [L, W, M]) mod q, a Montgomery
    product in the kernel's epilogue (launch key "stage_tw", or
    "stage_tw_batched" for 'batched_left', which no path runs).  With a key or
    a ciphertext in storage form as the twiddle, this is the X-NTT fused
    with the pointwise ring product of the key switch.

    On the card the products are u8 digit-plane GEMMs on the int8 tensor
    cores (csrc/stage.cu); the left sides first split the data into
    transposed digit planes (launch key "stage_split").  Side 'right' at a
    contraction of at most XNTT_MAX_K terms runs the same arithmetic in
    csrc/xntt_stage.cu, a kernel for short contractions (launch keys
    "stage_x", "stage_tw_x"; `takes_xntt`), and side 'left' at WCRT_MIN_K
    to WCRT_MAX_K terms in csrc/wcrt_stage.cu, a kernel for long
    contractions (launch key keys[0] + "_w": "stage_w", K3's
    "inv_compose_stage_w"; `takes_wcrt`); `general` runs csrc/stage.cu on
    any call, the yardstick of both routes.  `keys` renames the launch keys
    of the plain GEMM and the split pass, for a Stage inside another
    kernel's function (K3).
    """

    def __init__(self, tables_u64: np.ndarray, moduli: Sequence[int],
                 side: str, device,
                 keys: Tuple[str, str] = ("stage", "stage_split")):
        if side not in ("left", "right", "batched_left"):
            raise ValueError("side must be 'left', 'right' or 'batched_left', "
                             f"not {side!r}")
        self.side = side
        self.keys = keys
        self.moduli = tuple(int(q) for q in moduli)
        # the kernel flushes its s32 sums, so any contraction runs; the
        # plain version's float64 digit sums are exact below 2^19 terms
        self.bits = _bits(self.moduli, tables_u64.shape[-1], (1 << 19) - 1)
        self.table = _as_i64(tables_u64, device)
        self.consts = kernel_consts(self.moduli, device)
        self.q = moduli_col(self.moduli, 2, device)
        self.r_inv = moduli_col(
            [pow(1 << 64, -1, q) for q in self.moduli], 2, device)
        # bit d set for each digit count d of the limbs (the W-CRT kernel
        # sizes its ring stages by them)
        self._digit_mask = sum(1 << d for d in set(map(digit_count,
                                                       self.moduli)))
        self._layout = self._planes = None   # at the first CUDA call

    def __call__(self, data: torch.Tensor,
                 twiddle_mont: torch.Tensor | None = None) -> torch.Tensor:
        extra = () if twiddle_mont is None else (twiddle_mont,)
        if be.on_device(data, self.table, *extra):
            return self.kernel(data, twiddle_mont)
        return self.plain(data, twiddle_mont)

    def _check_twiddle(self, tw: torch.Tensor, out_shape) -> int:
        """The twiddle's row count, after checking it against the output."""
        if self.side == "left":
            raise ValueError("side 'left' takes no twiddle (as PallasStage)")
        L, cols = out_shape[0], out_shape[-1]
        rows = out_shape[1] if self.side == "right" else out_shape[2]
        if tw.dim() != 3 or tw.shape[0] != L or tw.shape[2] != cols:
            raise ValueError(f"twiddle {tuple(tw.shape)} does not fit the "
                             f"output {tuple(out_shape)}")
        tw_rows = tw.shape[1]
        if self.side == "batched_left" and tw_rows != rows:
            raise ValueError(f"batched_left twiddle needs {rows} rows")
        if rows % tw_rows:
            raise ValueError(f"twiddle rows {tw_rows} do not divide {rows}")
        return tw_rows

    def plain(self, data: torch.Tensor,
              twiddle_mont: torch.Tensor | None = None) -> torch.Tensor:
        if self.side == "batched_left":
            out = modmatmul(self.table[:, None], data, self.q[..., None],
                            self.bits, "left")
        else:
            out = modmatmul(self.table, data, self.q, self.bits, self.side)
        if twiddle_mont is None:
            return out
        tw_rows = self._check_twiddle(twiddle_mont, out.shape)
        tw = mul_mod(twiddle_mont, self.r_inv, self.q)    # tw * 2^64 * 2^-64
        if self.side == "batched_left":
            return mul_mod(out, tw[:, None], self.q[..., None])
        L, R, W = out.shape
        return mul_mod(out.reshape(L, R // tw_rows, tw_rows, W), tw[:, None],
                       self.q[..., None]).reshape(out.shape)

    def launch_key(self, twiddle: bool) -> str:
        """The launch key a kernel call of this Stage counts under, with or
        without a twiddle."""
        route = self.route()
        if route == "x":
            return "stage_tw_x" if twiddle else "stage_x"
        if route == "w":
            return self.keys[0] + "_w"
        return self._general_key(twiddle)

    def route(self) -> str:
        """The kernel a call takes, from the table's side and contraction:
        "x" (csrc/xntt_stage.cu), "w" (csrc/wcrt_stage.cu) or "general"
        (csrc/stage.cu)."""
        k = self.table.shape[2]
        if takes_xntt(self.side, k):
            return "x"
        return "w" if takes_wcrt(self.side, k) else "general"

    def _general_key(self, twiddle: bool) -> str:
        if not twiddle:
            return self.keys[0]
        return "stage_tw" if self.side == "right" else "stage_tw_batched"

    def kernel(self, data: torch.Tensor,
               twiddle_mont: torch.Tensor | None = None) -> torch.Tensor:
        return self._launch(data, twiddle_mont, self.route())

    def general(self, data: torch.Tensor,
                twiddle_mont: torch.Tensor | None = None) -> torch.Tensor:
        """csrc/stage.cu on any call, the X-NTT and W-CRT kernels' calls
        included (launch keys as the other sides' and contractions'): the
        yardstick of both routes in the tests and chip_smoke.py."""
        return self._launch(data, twiddle_mont, "general")

    def _launch(self, data: torch.Tensor, twiddle_mont, route: str
                ) -> torch.Tensor:
        L, W, K = self.table.shape
        batch = 1
        if self.side == "left":
            M = data.shape[2] if data.dim() == 3 else -1
            be.check(data, "data", I64, (L, K, M))
            out = torch.empty((L, W, M), dtype=I64, device=data.device)
            rows = M
        elif self.side == "batched_left":
            batch, M = (data.shape[1], data.shape[3]) if data.dim() == 4 \
                else (-1, -1)
            be.check(data, "data", I64, (L, batch, K, M))
            out = torch.empty((L, batch, W, M), dtype=I64, device=data.device)
            rows = M
        else:
            R = data.shape[1] if data.dim() == 3 else -1
            be.check(data, "data", I64, (L, R, K))
            out = torch.empty((L, R, W), dtype=I64, device=data.device)
            rows = R
        tw, tw_rows = twiddle_mont, 1
        if tw is not None:
            tw_rows = self._check_twiddle(tw, out.shape)
            be.check(tw, "twiddle_mont", I64, tuple(tw.shape))
            if tw.data_ptr() % 16:      # read as 16-byte pairs
                tw = tw.clone()
        key = self._general_key(tw is not None) if route == "general" \
            else self.launch_key(tw is not None)
        kp, kbs = self._device_layout()
        left = self.side != "right"
        if left:    # the data's digit planes, transposed to K-major rows
            xs = self.split_digits(data)
            s_z, s_row = rows * kbs, kbs
        else:       # the int64 rows read as bytes: 16-byte aligned rows
            if kp != K:
                data = F.pad(data, (0, kp - K))
            if data.data_ptr() % 16:
                data = data.clone()
            xs, s_z, s_row = data, rows * 8 * kp, 8 * kp
        dmax = self._planes.shape[2]
        if route == "x":
            be.launch(key, "mf_stage_x", data.device, xs, self._planes, out,
                      self.consts, tw, L, rows, W, kp, tw_rows, kbs, dmax)
        elif route == "w":
            be.launch(key, "mf_stage_w", data.device, xs, self._planes, out,
                      self.consts, L, rows, W, kp, kbs, dmax, self._digit_mask)
        else:
            be.launch(key, "mf_stage", data.device, xs, self._planes, out,
                      self.consts, tw, L, batch, rows, W, kp, int(left),
                      tw_rows, s_z, s_row, kbs, dmax)
        return out

    def _device_layout(self) -> Tuple[int, int]:
        """(Kp, KBs), building the table planes at the first CUDA call."""
        if self._planes is None:
            self._layout = plane_layout(self.table.shape[2], self.moduli,
                                        self.side)
            self._planes = slice_tables(self.table, self.moduli, self.side,
                                        *self._layout[:3])
        return self._layout[:2]

    def split_digits(self, data: torch.Tensor) -> torch.Tensor:
        """The left sides' split pass alone (launch key keys[1]): the
        CUDA data [L, K, M] or [L, B, K, M] as K-major u8 digit rows
        [L B, M, KBs], d_l planes of Kp bytes each."""
        if self.side == "right":
            raise ValueError("side 'right' reads its data as it stands")
        L, _, K = self.table.shape
        rows = data.shape[-1]
        batch = data.shape[1] if self.side == "batched_left" else 1
        be.check(data, "data", I64, (L, K, rows) if self.side == "left"
                 else (L, batch, K, rows))
        kp, kbs = self._device_layout()
        z = L * batch
        xs = torch.empty((z, rows, kbs), dtype=torch.uint8, device=data.device)
        be.launch(self.keys[1], "mf_stage_split", data.device, data, xs,
                  self.consts, z, batch, K, rows, kp, kbs)
        return xs


class NttMulNtt:
    """K2: t = iNTT_X(NTT_X(a) (*) s) per limb.

    a [L, R, n] X-coefficient rows, s_mont [L, W, n] in storage form
    s * 2^64 mod q; row r uses key row r // (R // W).  Both tables follow
    the out = T @ in convention (fwd [k, x], inv [x, k]).  On the card both
    transforms are K1's u8 digit-plane GEMMs in one launch
    (csrc/ntt_mul_ntt.cu): the data read as its bytes, the forward table's
    planes, one Montgomery product by s in the epilogue into a spectrum
    tile in shared memory, the inverse table's planes.  The planes are
    K1's side 'right' layout (`slice_tables`), cut on the device at the
    first CUDA call.  The kernel takes even n up to 128 (the gl2 ring's
    2n); the wrapper refuses any other n before launching."""

    def __init__(self, fwd_u64: np.ndarray, inv_u64: np.ndarray,
                 moduli: Sequence[int], device):
        self.moduli = tuple(int(q) for q in moduli)
        self.bits = _bits(self.moduli, fwd_u64.shape[-1])
        self.fwd = _as_i64(fwd_u64, device)
        self.inv = _as_i64(inv_u64, device)
        self.consts = kernel_consts(self.moduli, device)
        self.q = moduli_col(self.moduli, 2, device)
        self.r_inv = moduli_col(
            [pow(1 << 64, -1, q) for q in self.moduli], 2, device)
        self._planes = None     # (fwd, inv, KBs), at the first CUDA call

    def __call__(self, a: torch.Tensor, s_mont: torch.Tensor) -> torch.Tensor:
        if be.on_device(a, s_mont, self.fwd):
            return self.kernel(a, s_mont)
        return self.plain(a, s_mont)

    def plain(self, a: torch.Tensor, s_mont: torch.Tensor) -> torch.Tensor:
        rep = a.shape[1] // s_mont.shape[1]
        v = modmatmul(self.fwd, a, self.q, self.bits, "right")
        s = mul_mod(s_mont, self.r_inv, self.q)          # s * 2^64 * 2^-64
        u = mul_mod(v, s.repeat_interleave(rep, dim=1), self.q)
        return modmatmul(self.inv, u, self.q, self.bits, "right")

    def planes(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(forward planes, inverse planes, KBs): K1's side 'right' digit
        planes of both tables, cut on the tables' device once."""
        if self._planes is None:
            n = self.fwd.shape[-1]
            kp, kbs, tile_w, _ = plane_layout(n, self.moduli, "right")
            self._planes = tuple(
                slice_tables(t, self.moduli, "right", kp, kbs, tile_w)
                for t in (self.fwd, self.inv)) + (kbs,)
        return self._planes

    def kernel(self, a: torch.Tensor, s_mont: torch.Tensor) -> torch.Tensor:
        L, n, _ = self.fwd.shape
        if be.library().mf_ntt_mul_ntt_smem(n) == 0:
            raise ValueError(
                f"K2 takes no ring of n = {n}: its spectrum tile (8 n bytes "
                f"a row) and its ring of table-plane tiles must fit the "
                f"shared memory of one block, at most {SMEM_LIMIT} B on "
                "Hopper, so n must be even and at most 128")
        R, W = a.shape[1], s_mont.shape[1]
        if R % W:
            raise ValueError(f"rows {R} not a multiple of key rows {W}")
        be.check(a, "a", I64, (L, R, n))
        be.check(s_mont, "s_mont", I64, (L, W, n))
        if a.data_ptr() % 16:
            a = a.clone()
        if s_mont.data_ptr() % 16:
            s_mont = s_mont.clone()
        fwd, inv, kbs = self.planes()
        out = torch.empty_like(a)
        be.launch("ntt_mul_ntt", "mf_ntt_mul_ntt", a.device, a, s_mont, fwd,
                  inv, self.consts, out, L, R, W, n, R // W, kbs,
                  fwd.shape[2])
        return out


class InvCompose:
    """K3: scaled W-CRT inverse fused with the CRT-compose partials.

    x [L, W, M] eval residues, tables [L, W, W] with M_l^-1 mod q_l folded
    in.  Returns (acc, k), both int64 [W, M]:
      acc = sum_l r'_l * (M_l mod 2^64) mod 2^64 (bit pattern),
      k   = round(sum_l r'_l / q_l)  (f64 sum in limb order, half-even).

    On the card r' = T' @ x mod q is K1's digit-plane GEMM on a Stage of
    the scaled tables (launch keys "inv_compose_split" and
    "inv_compose_stage", or "inv_compose_stage_w" on the W-CRT route, so
    that K1's own counts stay K1's), and a compose
    pass (csrc/inv_compose.cu, key "inv_compose") folds its L planes into
    acc and k; r' and the split planes are scratch, freed on return."""

    def __init__(self, scaled_u64: np.ndarray, moduli: Sequence[int],
                 big_q: int, device):
        self.moduli = tuple(int(q) for q in moduli)
        self.bits = _bits(self.moduli, scaled_u64.shape[-1])
        self._stage = Stage(scaled_u64, self.moduli, "left", device,
                            keys=("inv_compose_stage", "inv_compose_split"))
        self.table = self._stage.table
        self.consts = self._stage.consts
        self.q = self._stage.q
        self.m64 = [to_signed64(big_q // q) for q in self.moduli]
        self.m64_t = torch.tensor(self.m64, dtype=I64, device=device)

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if be.on_device(x, self.table):
            return self.kernel(x)
        return self.plain(x)

    def plain(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r = modmatmul(self.table, x, self.q, self.bits, "left")
        acc = torch.zeros(r.shape[1:], dtype=I64, device=x.device)
        kf = torch.zeros(r.shape[1:], dtype=torch.float64, device=x.device)
        for l, q in enumerate(self.moduli):
            acc = acc + r[l] * self.m64[l]               # wraps mod 2^64
            kf = kf + r[l].to(torch.float64) / float(q)
        return acc, torch.round(kf).to(I64)

    def kernel(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        L, W, K = self.table.shape
        M = x.shape[2] if x.dim() == 3 else -1
        be.check(x, "x", I64, (L, K, M))
        return self.compose(self._stage.kernel(x))   # r' is scratch

    def compose(self, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The compose pass alone (launch key "inv_compose"): the canonical
        CUDA residues r' [L, W, M] into (acc, k)."""
        if not be.on_device(r, self.table):
            raise ValueError("the compose pass runs on CUDA tensors only")
        L, W, _ = self.table.shape
        M = r.shape[2] if r.dim() == 3 else -1
        be.check(r, "r", I64, (L, W, M))
        acc = torch.empty((W, M), dtype=I64, device=r.device)
        k = torch.empty((W, M), dtype=I64, device=r.device)
        be.launch("inv_compose", "mf_inv_compose", r.device, r, self.consts,
                  self.m64_t, acc, k, L, W * M)
        return acc, k
