"""Ciphertext-in / ciphertext-out homomorphic GEMM on the gl2 double ring.

Counterpart of matrix_fhe_tpu/models/he_matmul2.py (HEMatmul2, Gl2Conj,
Gl2GemmRelin), which derives the scheme:

  1. sigma, full complex conjugation, is the ring automorphism
     (W -> W^-1, Y -> Y^-1, X -> X^-1): a lane flip and an exact integer
     coefficient permutation with signs;
  2. the trace contraction over Y is one modular GEMM per (limb, lane),
     T[x1, x2] = n * sum_y RY(u)[y, x1] * TW(v)[y, x2], with RY the Y-index
     reversal and TW the Y^n = X^n wrap twist; the four component products
     E00, E01, E10, E11 (keys 1, 1(x)s, ss(x)1, ss(x)s, ss = sigma(s)) are
     kernel K7 (ops/cgemm.Gemm2x2);
  3. two switch keys (targets ss(x)1 and ss(x)s, encrypted under 1(x)s)
     relinearize the tensor to a rank-1 pair (B, A) over the 2D tensor ring;
  4. the ring map rho (X1 -> Y) folds row y+n onto row y with an X^n twist,
     so (rho B, rho A) is a standard gl2 ciphertext of C = Y^H X,
     Delta^2-scaled.

The port relinearizes on one route, the JAX package's limb-chunked one:
QP limbs go through chunk-sized transform contexts, with the chunk bounds
of the JAX byte rule (one chunk while the full [Lqp, W, 2n, 2n] plane is at
most 1 GiB, else ~512 MiB chunks, aligned to the Q|P boundary) or
`chunk_limbs` limbs per chunk.  It never modifies its arguments.  Each
digit's basis extension to a chunk's limbs, and each ModDown with its
division, is one launch of csrc/base_conv.cu (ops/rns_ext.py); the JAX
package leaves them to XLA as plain jnp.  So are each digit's two key
products with their sums: on a CUDA tensor one launch of
csrc/gl2_key_products.cu (ops/key_products.py), whose REDC takes the keys'
storage factor 2^64 off each product; on a CPU tensor the plain twin,
_key_products_plain, with one 2^-64 factor for the sums.  The sigma
gathers are plain torch elementwise work, as in the JAX package (none of
it is a Pallas kernel there); the transforms run kernel K1.

Spans (utils/profiler.span): "gl2.tensor" around the tensor (the sigma
gathers, TW and K7) and "gl2.relin" around the relinearize, with, under
it, "gl2.relin_chunk" a QP chunk and in it "gl2.key_products" around each
digit's two key products and their sums (index: the digit) and, on the
CPU route, once more around the 2^-64 factor.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import _backend as be
from ..ops import modmath as mm
from ..ops.cgemm import Gemm2x2
from ..ops.key_products import KeyProducts
from ..ops.ntt import XNTT
from ..ops.wcrt import WTransform
from ..tables import build_tables
from ..utils.profiler import span
from . import rng as refrng
from .he2 import Ciphertext2, Gl2Context, SecretKey2
from .he_matmul import conj_flip_perm
from .keyswitch import RelinContext, RelinKey

I64 = torch.int64


class GemmTensor2(NamedTuple):
    """2D tensor-ring components [L, W, 2n, 2n] (W-eval, X1/X2-coeff);
    keys (1, 1(x)s, ss(x)1, ss(x)s)."""
    e00: torch.Tensor
    e01: torch.Tensor
    e10: torch.Tensor
    e11: torch.Tensor


class GemmRelinKey(NamedTuple):
    """Per-digit switch keys over QP, (W-eval, 2D X-NTT), storage form
    x * 2^64 mod q as in the JAX package: k1 encrypts g_i * (sigma(s) (x) 1),
    k2 encrypts g_i * (sigma(s) (x) s), both under (1 (x) s)."""
    b1: Tuple[torch.Tensor, ...]
    a1: Tuple[torch.Tensor, ...]
    b2: Tuple[torch.Tensor, ...]
    a2: Tuple[torch.Tensor, ...]


def _sigma_index_maps(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather indices and sign for the coefficient action of
    (Y -> Y^-1, X -> X^-1) on a [y, x] frame (y-dim n, x-dim 2n):
    out[y', x'] = sign[y', x'] * z[YI[y', x'], XI[y', x']].

    Monomial algebra (Y^n = X^n, X^{2n} = -1):
      Y^{-y} = -Y^{n-y} X^n (y >= 1);  X^{-x} = -X^{2n-x} (x >= 1).
    """
    m = 2 * n
    YI = np.zeros((n, m), dtype=np.int32)
    XI = np.zeros((n, m), dtype=np.int32)
    SG = np.zeros((n, m), dtype=np.int8)
    for yp in range(n):
        for xp in range(m):
            if yp == 0:
                y = 0
                if xp == 0:
                    x, s = 0, 1
                else:
                    x, s = m - xp, -1
            else:
                y = n - yp
                if xp == n:
                    x, s = 0, -1
                elif xp < n:
                    x, s = n - xp, -1       # x in [1, n]
                else:
                    x, s = 3 * n - xp, 1    # x in (n, 2n)
            YI[yp, xp] = y
            XI[yp, xp] = x
            SG[yp, xp] = s
    return YI, XI, SG


def _shift_xn(z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Multiply by X^n along the trailing axis (wrap X^{2n} = -1)."""
    m = z.shape[-1]
    n = m // 2
    rolled = torch.roll(z, n, dims=-1)
    low = torch.arange(m, device=z.device) < n
    return torch.where(low, mm.neg_mod(rolled, q), rolled)


class HEMatmul2:
    """Homomorphic C = Y^H @ X per packed lane, ciphertext in / out."""

    def __init__(self, ctx: Gl2Context):
        self.ctx = ctx
        p = ctx.params
        dev = ctx.device
        self.n = p.n
        self.m = 2 * p.n
        self._flip = torch.from_numpy(conj_flip_perm(p)).to(dev)
        YI, XI, SG = _sigma_index_maps(p.n)
        self._sYI = torch.from_numpy(YI.astype(np.int64)).to(dev)
        self._sXI = torch.from_numpy(XI.astype(np.int64)).to(dev)
        self._sNEG = torch.from_numpy(SG < 0).to(dev)
        # y-reversal for the trace pairing
        self._ry = torch.from_numpy((-np.arange(p.n)) % p.n).to(dev)
        self._row0 = (torch.arange(p.n, device=dev) == 0).reshape(1, 1, -1, 1)
        self._gemm = Gemm2x2(p.moduli, p.n, dev)

    # -- component maps ------------------------------------------------------

    def _sigma(self, z: torch.Tensor) -> torch.Tensor:
        """Full conjugation on a component [L, W, y, x]: W-lane flip and the
        (Y -> Y^-1, X -> X^-1) coefficient gather."""
        g = z.index_select(1, self._flip)[:, :, self._sYI, self._sXI]
        return torch.where(self._sNEG, mm.neg_mod(g, self.ctx._q4), g)

    def _tw(self, z: torch.Tensor) -> torch.Tensor:
        """TW: X^n twist on Y-rows >= 1 (the Y^n = X^n wrap of the trace
        pairing), identity on row 0."""
        return torch.where(self._row0, z, _shift_xn(z, self.ctx._q4))

    def _ry_map(self, z: torch.Tensor) -> torch.Tensor:
        return z.index_select(2, self._ry)

    def on_lanes(self, lanes: slice) -> "HEMatmul2":
        """This tensor for the W lanes `lanes` of its output: X's blocks
        hold those lanes and Y is whole, since sigma's lane flip reads Y's
        lanes flip[w] (parallel/gl2.py, every rank its block of lanes)."""
        view = copy.copy(self)
        view._flip = self._flip[lanes]
        return view

    def _gemm2x2(self, u1, u2, v1, v2):
        """The four tensor products e_ij = n * U_i^T @ V_j mod q: kernel
        K7 on the card, its plain version on the CPU."""
        return self._gemm(u1.contiguous(), u2.contiguous(), v1.contiguous(),
                          v2.contiguous())

    # -- the tensor op -------------------------------------------------------

    def tensor_fn(self, ctX: Ciphertext2, ctY: Ciphertext2) -> GemmTensor2:
        with span("gl2.tensor"):
            sy_b = self._ry_map(self._sigma(ctY.b))
            sy_a = self._ry_map(self._sigma(ctY.a))
            x_b = self._tw(ctX.b)
            x_a = self._tw(ctX.a)
            return GemmTensor2(*self._gemm2x2(sy_b, sy_a, x_b, x_a))

    matmul_tensor = tensor_fn

    # -- secret-side identities (tests, and the reference opening) -----------

    def _sigma_s_mont(self, sk: SecretKey2) -> torch.Tensor:
        """sigma(s) in (W-eval, X-NTT) storage form over Q: lane flip and
        NTT slot reversal (slot k evaluates at psi^(2k+1); negating the
        exponent maps k -> 2n-1-k)."""
        return sk.s_mont.index_select(1, self._flip).flip(-1)

    def _mul_x2(self, z, s_mont):
        return self.ctx.xntt.mul_s(z, s_mont)

    def _mul_x1(self, z, s_mont):
        return self.ctx.xntt.mul_s(z.transpose(-1, -2), s_mont).transpose(-1, -2)

    def decrypt_tensor_fn(self, tt: GemmTensor2, sk: SecretKey2
                          ) -> torch.Tensor:
        """Two-sided opening of the raw tensor and the rho repack -> packed
        plaintext [L, W, n, 2n]: the reference point of the key-switched
        path."""
        q = self.ctx._q4
        ss = self._sigma_s_mont(sk)
        top = mm.add_mod(tt.e00, self._mul_x2(tt.e01, sk.s_mont), q)
        bot = mm.add_mod(tt.e10, self._mul_x2(tt.e11, sk.s_mont), q)
        t = mm.add_mod(top, self._mul_x1(bot, ss), q)
        return self.repack_fn(t)

    # -- repack --------------------------------------------------------------

    def repack_fn(self, t: torch.Tensor) -> torch.Tensor:
        """rho: [L, W, 2n, 2n] tensor-ring element -> [L, W, n, 2n] packed
        frame: X1 -> Y, row y+n folds onto row y with an X^n twist."""
        q = self.ctx._q4
        lo, hi = t[:, :, :self.n], t[:, :, self.n:]
        return mm.add_mod(lo, _shift_xn(hi, q), q)


class Gl2Conj:
    """Homomorphic complex conjugation of every packed value.

    The joint automorphism sigma = (W -> W^-1, Y -> Y^-1, X -> X^-1) of
    the packing ring applied to both components, then ONE key switch from
    sigma(s) back to s.  sigma is not a composition of per-axis maps:
    X -> X^-1 fixing Y breaks Y^n = X^n (X-only Galois indices are
    k = 1 mod 4, XGaloisKeys), and Y -> Y^-1 fixing X likewise; only the
    joint inversion is an automorphism.  The switch key lives over the
    RelinContext's QP basis: one (b, a) pair of [Lqp, W, n, 2n] a digit.
    The key is drawn from a torch.Generator, so it differs from a JAX key;
    `from_key` takes a key made elsewhere (convert.gl2_conj)."""

    def __init__(self, hm: HEMatmul2, rc: RelinContext, sk: SecretKey2,
                 generator: torch.Generator):
        s_res = Gl2Context._ternary_residues(sk.s_sign, hm.ctx.params.moduli)
        self._init(hm, rc, rc.gen_switch_key(
            self._sigma_target(hm, rc, s_res), s_res, generator))

    @classmethod
    def from_key(cls, hm: HEMatmul2, rc: RelinContext,
                 ksk: RelinKey) -> "Gl2Conj":
        """Conjugation with a switch key made elsewhere (no keygen)."""
        self = cls.__new__(cls)
        self._init(hm, rc, ksk)
        return self

    def _init(self, hm, rc, ksk) -> None:
        self.hm = hm
        self.rc = rc
        self._ksk = ksk

    @staticmethod
    def sigma_s_hat(hm: HEMatmul2, rc: RelinContext, sk: SecretKey2
                    ) -> torch.Tensor:
        """The key's target sigma(s) in (W-eval, X-NTT) over QP,
        [Lqp, W, 2n]: the lane flip and the NTT slot reversal (slot k
        evaluates at psi^(2k+1) of the 2n-point gl2 transform; negating the
        exponent maps k -> 2n-1-k)."""
        return Gl2Conj._sigma_target(hm, rc, Gl2Context._ternary_residues(
            sk.s_sign, hm.ctx.params.moduli))

    @staticmethod
    def _sigma_target(hm: HEMatmul2, rc: RelinContext, s_res: torch.Tensor
                      ) -> torch.Tensor:
        return rc._lift_ternary(s_res).index_select(1, hm._flip).flip(-1)

    def apply(self, ct: Ciphertext2) -> Ciphertext2:
        """sigma(ct) re-keyed to s: a ciphertext of conj(X) under s."""
        tb = self.hm._sigma(ct.b)
        ta = self.hm._sigma(ct.a)
        kb, ka = self.rc.key_switch_d2(ta, self._ksk)
        return Ciphertext2(b=mm.add_mod(tb, kb, self.rc._q), a=ka)


class Gl2GemmRelin:
    """Switch keys and relinearization for GemmTensor2 -> standard gl2
    ciphertext, over RelinContext's gadget, base conversion and ModDown.

    `wt_map`, where given, maps every W-CRT of the relinearization (the Q
    basis' and each QP chunk's) to the transform it runs:
    parallel/gl2.py's W-sharded ones.  The keys come from a relinearizer
    without it (gen_keys transforms whole frames)."""

    def __init__(self, hm: HEMatmul2, rc: RelinContext | None = None,
                 chunk_limbs: Optional[int] = None,
                 wt_map: Optional[Callable] = None):
        self.hm = hm
        self.ctx = hm.ctx
        self.rc = rc or RelinContext(hm.ctx)
        self.chunk_limbs = chunk_limbs
        self._wt_map = wt_map
        self._wt_q = self._mapped(hm.ctx.wt)
        self._chunk_cache = {}
        self._products = {}
        # 2^-64 mod q: the plain key products leave a factor 2^64 (storage
        # form)
        self._r_inv = [pow(1 << 64, -1, q) for q in self.rc.qp_moduli]

    def _mapped(self, wt):
        return wt if self._wt_map is None else self._wt_map(wt)

    # -- 2D transforms -------------------------------------------------------

    @staticmethod
    def _ntt2d(z, xntt: XNTT):
        t = xntt.forward(z)
        return xntt.forward(t.transpose(-1, -2)).transpose(-1, -2)

    @staticmethod
    def _intt2d(z, xntt: XNTT):
        t = xntt.inverse(z)
        return xntt.inverse(t.transpose(-1, -2)).transpose(-1, -2)

    # -- limb chunking -------------------------------------------------------

    def _chunk_ctx(self, lo: int, hi: int):
        """(params, xntt, wt, q [Lc, 1, 1, 1]) over qp_moduli[lo:hi]."""
        rc = self.rc
        if (lo, hi) not in self._chunk_cache:
            dev = self.ctx.device
            if (lo, hi) == (0, len(rc.qp_moduli)):
                sub, xntt, wt = rc.ext_params, rc.xntt_qp, rc.wt_qp
            else:
                sub = dataclasses.replace(
                    rc.ext_params, name=f"{rc.ext_params.name}-c{lo}.{hi}",
                    moduli=rc.qp_moduli[lo:hi])
                t = build_tables(sub)
                xntt = XNTT(sub, ring=self.ctx.ring, tables=t, device=dev)
                wt = WTransform(sub, t, device=dev)
            self._chunk_cache[(lo, hi)] = (
                sub, xntt, self._mapped(wt), mm.moduli_col(sub.moduli, 3, dev))
        return self._chunk_cache[(lo, hi)]

    def _qp_chunks(self):
        """Limb-chunk bounds over QP, aligned to the Q|P boundary:
        `chunk_limbs` limbs a chunk, or (None) one chunk while the full QP
        plane is at most 1 GiB, else ~512 MiB chunks (the JAX byte rule)."""
        rc = self.rc
        Lqp = len(rc.qp_moduli)
        per_limb = rc.ext_params.phi * self.hm.m * self.hm.m * 8
        target = self.chunk_limbs or 0
        if target <= 0:
            if Lqp * per_limb <= (1 << 30):
                return [(0, Lqp)]
            target = max(1, (1 << 29) // per_limb)
        bounds = []
        for seg_lo, seg_hi in ((0, rc.L), (rc.L, Lqp)):
            lo = seg_lo
            while lo < seg_hi:
                bounds.append((lo, min(lo + target, seg_hi)))
                lo += target
        return bounds

    # -- key generation ------------------------------------------------------

    def gen_keys(self, sk: SecretKey2, generator: torch.Generator
                 ) -> GemmRelinKey:
        """Both switch keys for every digit.  Each (target, digit) pair
        draws its uniform `a` limb by limb over all of QP, then its noise,
        before any chunk is computed, so the keys do not depend on the
        chunking.  `a` is drawn in the (W-eval, 2D X-NTT) domain directly:
        the transform is a bijection per limb, as in the JAX package."""
        rc, dev = self.rc, self.ctx.device
        s_res = Gl2Context._ternary_residues(sk.s_sign, self.ctx.params.moduli)
        s_hat = rc._lift_ternary(s_res)                          # [Lqp, W, m]
        ss_hat = s_hat.index_select(1, self.hm._flip).flip(-1)
        m = self.hm.m
        frame = (rc.ext_params.phi, m, m)
        chunks = self._qp_chunks()
        outs = {"b1": [], "a1": [], "b2": [], "a2": []}
        for which, bk, ak in ((1, "b1", "a1"), (2, "b2", "a2")):
            for i in range(rc.dnum):
                a = refrng.fresh_uniform_a(generator, rc.ext_params, dev,
                                           shape=frame)
                e = refrng.fresh_gaussian_noise(generator, rc.ext_params, dev,
                                                shape=frame)
                g = rc._g_consts[i].astype(np.int64)
                b_key = torch.empty_like(a)
                a_key = torch.empty_like(a)
                for lo, hi in chunks:
                    b_key[lo:hi], a_key[lo:hi] = self._key_chunk(
                        which, lo, hi, a[lo:hi], e[lo:hi], s_hat[lo:hi],
                        ss_hat[lo:hi], g[lo:hi])
                del a, e
                outs[bk].append(b_key)
                outs[ak].append(a_key)
        return GemmRelinKey(b1=tuple(outs["b1"]), a1=tuple(outs["a1"]),
                            b2=tuple(outs["b2"]), a2=tuple(outs["a2"]))

    def _key_chunk(self, which, lo, hi, a, e, s_hat, ss_hat, g):
        """One (target, digit) key pair over QP limbs lo:hi, storage form:
        b = e - a (1(x)s) + g * target."""
        sub, xntt, wt, q = self._chunk_ctx(lo, hi)
        a_s = mm.mul_mod(a, s_hat[:, :, None, :], q)
        # the noise is small in the (W-coeff, X-coeff) integer domain
        e_hat = self._ntt2d(wt.forward(e), xntt)
        g_col = torch.from_numpy(g).to(q.device).reshape(-1, 1, 1, 1)
        if which == 1:
            # g * (sigma(s) (x) 1): broadcast along x2
            gt = mm.mul_mod(g_col, ss_hat[:, :, :, None], q)
        else:
            # g * (sigma(s) (x) s)
            gt = mm.mul_mod(g_col, mm.mul_mod(ss_hat[:, :, :, None],
                                              s_hat[:, :, None, :], q), q)
        b = mm.add_mod(mm.sub_mod(e_hat, a_s, q), gt, q)
        return mm.to_mont(b, sub.moduli), mm.to_mont(a, sub.moduli)

    # -- relinearize + repack ------------------------------------------------

    def relinearize(self, tt: GemmTensor2, ks: GemmRelinKey) -> Ciphertext2:
        """Switch the ss(x)1 and ss(x)s components to 1(x)s and repack:
        per component, the W-CRT inverse once, then every QP chunk: each
        digit's extension to the chunk's limbs, 2D NTT, key products summed
        over digits, 2D inverse NTT; then ModDown to Q.  The same bits as
        the JAX relinearize_fn for the same tt and keys."""
        with span("gl2.relin"):
            rc, ctx = self.rc, self.ctx
            Lqp = len(rc.qp_moduli)
            chunks = self._qp_chunks()
            outs = []
            for e_hi, b_keys, a_keys in ((tt.e10, ks.b1, ks.a1),
                                         (tt.e11, ks.b2, ks.a2)):
                wc = self._wt_q.inverse(e_hi)
                src = [wc[g[0]:g[-1] + 1] for g in rc.groups]  # consecutive
                shape = (Lqp,) + tuple(e_hi.shape[1:])
                k0 = torch.empty(shape, dtype=I64, device=e_hi.device)
                k1 = torch.empty(shape, dtype=I64, device=e_hi.device)
                for lo, hi in chunks:
                    k0[lo:hi], k1[lo:hi] = self._relin_chunk(
                        lo, hi, src, [b[lo:hi] for b in b_keys],
                        [a[lo:hi] for a in a_keys])
                del wc, src
                outs.append(self._wt_q.forward(rc._mod_down(k0)))
                del k0
                outs.append(self._wt_q.forward(rc._mod_down(k1)))
                del k1
            u0, u1, v0, v1 = outs
            q = ctx._q4
            b2d = mm.add_mod(tt.e00, mm.add_mod(u0, v0, q), q)
            a2d = mm.add_mod(tt.e01, mm.add_mod(u1, v1, q), q)
            return Ciphertext2(b=self.hm.repack_fn(b2d),
                               a=self.hm.repack_fn(a2d))

    def _relin_chunk(self, lo, hi, src, b_keys, a_keys):
        """All digits' key products for QP limbs lo:hi, back to
        (W-coeff, X-coeff): the chunk rows of the two accumulators.  On the
        card each digit's two products and their sums are one launch of
        csrc/gl2_key_products.cu (KeyProducts), in place; the 2^-64 of the
        keys' storage form rides its REDC.  On the CPU the plain twin
        sums in storage form and takes one 2^-64 off at the end."""
        rc = self.rc
        _, xntt, wt, q = self._chunk_ctx(lo, hi)
        on_card = be.on_device(q)
        products = (self._key_products(lo, hi, q.device) if on_card
                    else lambda *args: self._key_products_plain(*args, q))
        u0 = u1 = None
        with span("gl2.relin_chunk"):
            for i, x in enumerate(src):
                digit = rc._extenders[i].extend(x, dst_slice=(lo, hi))
                hat = self._ntt2d(wt.forward(digit), xntt)
                del digit
                with span("gl2.key_products", i):
                    u0, u1 = products(hat, b_keys[i], a_keys[i], u0, u1)
                del hat
            if not on_card:
                r_inv = mm.moduli_col(self._r_inv[lo:hi], 3, q.device)
                with span("gl2.key_products"):
                    u0, u1 = self._from_storage(u0, u1, q, r_inv)
            return (wt.inverse(self._intt2d(u0, xntt)),
                    wt.inverse(self._intt2d(u1, xntt)))

    def _key_products(self, lo, hi, device) -> KeyProducts:
        """The card's key products over QP limbs lo:hi."""
        if (lo, hi) not in self._products:
            self._products[(lo, hi)] = KeyProducts(self.rc.qp_moduli[lo:hi],
                                                   device)
        return self._products[(lo, hi)]

    @staticmethod
    def _key_products_plain(hat, kb, ka, u0, u1, q):
        """One digit's two key products summed into (u0, u1) (None on the
        first digit) by mm.mul_mod and mm.add_mod: KeyProducts' plain twin,
        whose sums keep the keys' storage factor 2^64 (_from_storage)."""
        tb = mm.mul_mod(hat, kb, q)
        u0 = tb if u0 is None else mm.add_mod(u0, tb, q)
        del tb
        ta = mm.mul_mod(hat, ka, q)
        u1 = ta if u1 is None else mm.add_mod(u1, ta, q)
        return u0, u1

    @staticmethod
    def _from_storage(u0, u1, q, r_inv):
        """The plain twin's sums times r_inv = 2^-64 mod q."""
        return mm.mul_mod(u0, r_inv, q), mm.mul_mod(u1, r_inv, q)

    # the JAX package's limb-chunked relinearization gives its fused
    # relinearize_fn's bits: the port's one route (chunked) serves under both
    relinearize_streamed = relinearize

    # -- the headline op -----------------------------------------------------

    def matmul(self, ctX: Ciphertext2, ctY: Ciphertext2, ks: GemmRelinKey
               ) -> Ciphertext2:
        """encrypt(X), encrypt(Y) -> standard ciphertext of Y^H X (per
        lane), Delta^2-scaled: decode with delta_override=Delta^2."""
        return self.relinearize(self.hm.matmul_tensor(ctX, ctY), ks)
