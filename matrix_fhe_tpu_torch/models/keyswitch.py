"""RNS-hybrid key switching, relinearization, rescale and Galois rotations.

Counterpart of matrix_fhe_tpu/models/keyswitch.py on int64 tensors:

  * gadget = CRT idempotent decomposition over consecutive limb groups G_i
    with prod(G_i) < P: digits are plain limb subsets D_i = [x]_{Q_i},
    extended to the full QP basis by the exact base conversion
    (ops/rns_ext.py);
  * switch keys (b_i, a_i) = (-a_i s + e_i + g_i t, a_i) over QP with
    g_i = P * (Q/Q_i) * ((Q/Q_i)^-1 mod Q_i) mod QP, in (W-eval, X-NTT) and
    the JAX storage form x * 2^64 mod q;
  * key switch: sum_i D_i (*) key_i over QP, then ModDown by P (exact
    centered division by the same base conversion);
  * multiply_relinearize, the Gaussian-pair product, W- and X-axis Galois
    rotations (one key per index, or the log-size FullGaloisKeys) and the
    true CKKS rescale by the last prime.

The port has one route for the switch: a front (the tensor product), one
step per digit that accumulates into the QP accumulators, and a finish
(ModDown).  JAX's fused and streamed multiplies give the same bits, so
this one route matches both; it never modifies its arguments.  Each digit
step's X-NTT and its product by a key are one launch of K10a (the stage
kernel with the key as its twiddle).  Each digit's basis extension is
one launch of csrc/base_conv.cu (ops/rns_ext.py), and so is each ModDown,
with its subtraction and product by P^-1 in the kernel's epilogue; the
rescale's division by the last prime is the same launch with one source
limb.  The JAX package leaves all of this to XLA as plain jnp (none of it
is a Pallas kernel there).  The accumulators' sums and the other products
are plain torch elementwise work.  Keys are drawn from a
torch.Generator, so they differ from JAX keys; convert.py carries JAX keys
across for the parity tests.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import GLParams, generate_ntt_primes
from ..ops import modmath as mm
from ..ops.ntt import XNTT
from ..ops.rns_ext import BasisExtender
from ..ops.wcrt import WTransform
from ..tables import build_tables
from ..utils.profiler import span
from . import rng as refrng
from .he import Ciphertext, HEContext


class RelinKey(NamedTuple):
    """Per-digit switch-key pairs, (W-eval, X-NTT) domain, storage form
    x * 2^64 mod q, [dnum] x [Lqp, W, y, x]."""
    b: Tuple[torch.Tensor, ...]
    a: Tuple[torch.Tensor, ...]


def _greedy_groups(q_moduli: Sequence[int], big_p: int
                   ) -> List[Tuple[int, ...]]:
    """Consecutive limb groups with product < P (the gadget digit bound)."""
    groups: List[Tuple[int, ...]] = []
    cur: List[int] = []
    prod = 1
    for l, q in enumerate(q_moduli):
        if cur and prod * q >= big_p:
            groups.append(tuple(cur))
            cur, prod = [], 1
        cur.append(l)
        prod *= q
    groups.append(tuple(cur))
    return groups


def _grid(bits: int) -> int:
    """Relative MXU MAC weight of one limb in the TPU stage kernels: the
    int8 digit grid is ceil(bits/7) digits a side."""
    d = -(-bits // 7)
    return d * d


def _default_p_moduli(params: GLParams) -> Tuple[int, ...]:
    """The key-switch extension basis P, chosen exactly as the JAX package
    chooses it (copied verbatim so that both packages use the same P).

    The cost model is the TPU's: dnum x (W-CRT + X-NTT over QP) with each
    limb weighted by its int8 digit grid ceil(bits/7)^2.  On the H100 the
    64-bit kernels cost the same at every width below 2^56, so this is not
    the best basis for the card; it is kept for parity and not re-ranked
    here.  Presets with explicit p_moduli keep them."""
    if params.p_moduli:
        return tuple(int(q) for q in params.p_moduli)
    qs = [int(q) for q in params.moduli]
    q_bits = [q.bit_length() for q in qs]
    q_cost = sum(_grid(b) for b in q_bits)
    widths = sorted({w for w in
                     (28, 35, 42, max(q_bits) - 1, *q_bits) if w >= 21})
    best = None
    for w in widths:
        try:
            cand = generate_ntt_primes(len(qs) + 6, w, params.n, params.p,
                                       below=True)
        except ValueError:
            continue
        pool = [q for q in cand if q not in qs]
        for k in range(2, min(len(pool), len(qs) + 3) + 1):
            ps = pool[:k]
            big_p = 1
            for q in ps:
                big_p *= q
            groups = _greedy_groups(qs, big_p)
            if any(_prod(qs[l] for l in g) >= big_p for g in groups):
                continue
            cost = len(groups) * (q_cost
                                  + sum(_grid(q.bit_length()) for q in ps))
            key = (cost, k, sum(q.bit_length() for q in ps))
            if best is None or key < best[0]:
                best = (key, tuple(ps))
    if best is None:
        raise ValueError("could not find a valid P basis")
    return best[1]


def _prod(it) -> int:
    out = 1
    for v in it:
        out *= v
    return out


def _cadd(x: Ciphertext, y: Ciphertext, q: torch.Tensor) -> Ciphertext:
    return Ciphertext(b=mm.add_mod(x.b, y.b, q), a=mm.add_mod(x.a, y.a, q))


def _csub(x: Ciphertext, y: Ciphertext, q: torch.Tensor) -> Ciphertext:
    return Ciphertext(b=mm.sub_mod(x.b, y.b, q), a=mm.sub_mod(x.a, y.a, q))


class RelinContext:
    """Key-switch machinery bound to one context of ring "nega" or "gl2"
    (HEContext or Gl2Context), on that context's device.

    p_moduli: None takes the preset's P (or the JAX package's search when
    the preset pins none), "auto" runs that search even when the preset
    pins a P, a sequence is the P basis itself (keyswitch.py:148-155)."""

    def __init__(self, ctx, p_moduli=None):
        if ctx.ring not in ("nega", "gl2"):
            # the folded GL ring wraps X-convolutions by i_q, a different
            # integer per modulus, so no integer ring underlies the limbs
            # and ModDown's slop times s is not limb-consistent
            raise ValueError("relinearization requires ring='nega' or 'gl2'")
        self.ctx = ctx
        p = ctx.params
        dev = ctx.device
        self.q_moduli = tuple(int(q) for q in p.moduli)
        if isinstance(p_moduli, str):
            if p_moduli != "auto":
                raise ValueError(f"p_moduli must be None, 'auto' or primes, "
                                 f"not {p_moduli!r}")
            self.p_moduli = _default_p_moduli(
                dataclasses.replace(p, p_moduli=()))
        elif p_moduli:
            self.p_moduli = tuple(int(q) for q in p_moduli)
        else:
            self.p_moduli = _default_p_moduli(p)
        self.qp_moduli = self.q_moduli + self.p_moduli
        self.L = len(self.q_moduli)
        self.big_p = _prod(self.p_moduli)
        groups = _greedy_groups(self.q_moduli, self.big_p)
        for g in groups:   # noise guarantee: P exceeds each group product
            gp = _prod(self.q_moduli[l] for l in g)
            if gp >= self.big_p:
                raise ValueError(
                    f"key-switch group product {gp} >= P {self.big_p}; "
                    "supply a larger p_moduli basis")
        self.groups = groups
        self.dnum = len(groups)
        # transforms over QP
        self.ext_params = dataclasses.replace(
            p, name=p.name + "-qp", moduli=self.qp_moduli, p_moduli=())
        ext_tables = build_tables(self.ext_params)
        self.xntt_qp = XNTT(self.ext_params, ring=ctx.ring, tables=ext_tables,
                            device=dev)
        self.wt_qp = WTransform(self.ext_params, ext_tables, device=dev)
        # per-group exact base conversion to the full QP basis
        self._extenders = [
            BasisExtender([self.q_moduli[l] for l in g], self.qp_moduli, dev)
            for g in groups]
        # ModDown: P -> Q conversion with the division by P (its P^-1 mod q)
        self._moddown = BasisExtender(self.p_moduli, self.q_moduli, dev)
        big_q = _prod(self.q_moduli)
        gs = []
        for g in groups:
            q_i = _prod(self.q_moduli[l] for l in g)
            q_tilde = big_q // q_i
            g_int = self.big_p * q_tilde * pow(q_tilde % q_i, -1, q_i)
            gs.append(np.array([g_int % r for r in self.qp_moduli],
                               dtype=np.uint64))
        self._g_consts = gs
        self._q = mm.moduli_col(self.q_moduli, 3, dev)
        self._qqp = mm.moduli_col(self.qp_moduli, 3, dev)
        # ciphertext frame [W, y_dim, x_dim]: gl2 doubles the X axis
        self.y_dim = p.n
        self.x_dim = getattr(ctx, "m", p.n)

    # -- key generation ------------------------------------------------------

    def _lift_ternary(self, s_coeff: torch.Tensor) -> torch.Tensor:
        """Ternary secret (per-limb residues [L, W, n], limb-consistent)
        -> X-NTT(W-CRT(s)) over the QP basis [Lqp, W, n]."""
        s0 = s_coeff[0]
        sign = torch.where(s0 == 0, 0, torch.where(s0 == 1, 1, -1))
        q = mm.moduli_col(self.qp_moduli, sign.dim(), sign.device)
        s_qp = torch.where(sign >= 0, sign, q + sign)
        return self.xntt_qp.forward(self.wt_qp.forward(s_qp))

    def gen_relin_key(self, s_coeff: torch.Tensor,
                      generator: torch.Generator) -> RelinKey:
        """Switching key for s^2 -> s (relinearization); s_coeff is the
        ternary secret as per-limb residues [L, W, n]."""
        s_hat = self._lift_ternary(s_coeff)
        s2_hat = mm.mul_mod(s_hat, s_hat, self._qqp[..., 0])
        return self.gen_switch_key(s2_hat, s_coeff, generator)

    def gen_switch_key(self, target_hat: torch.Tensor, s_coeff: torch.Tensor,
                       generator: torch.Generator) -> RelinKey:
        """Switching key encrypting `target` (a ring element in X-NTT x
        W-eval over QP, [Lqp, W, n] or [Lqp, W, y, n]) under the secret s:
        switching a component by it replaces a factor `target` by s.  Each
        digit draws its uniform `a` (in the X-NTT domain directly: the
        transform is a bijection per limb) and then its noise, in the order
        of the JAX package's key splits."""
        q = self._qqp
        s_hat = self._lift_ternary(s_coeff)
        if target_hat.dim() == 3:
            target_hat = target_hat[:, :, None, :]
        frame = (self.ext_params.phi, self.y_dim, self.x_dim)
        dev = self.ctx.device
        bs, as_ = [], []
        for i in range(self.dnum):
            a_hat = refrng.fresh_uniform_a(generator, self.ext_params, dev,
                                           shape=frame)
            e = refrng.fresh_gaussian_noise(generator, self.ext_params, dev,
                                            shape=frame)
            # the noise is small in the (W-coeff, X-coeff) integer domain
            e_hat = self.xntt_qp.forward(self.wt_qp.forward(e))
            a_s = mm.mul_mod(a_hat, s_hat[:, :, None, :], q)
            g = mm.moduli_col(self._g_consts[i].astype(np.int64).tolist(), 3,
                              dev)
            b = mm.add_mod(mm.sub_mod(e_hat, a_s, q),
                           mm.mul_mod(g, target_hat, q), q)
            bs.append(mm.to_mont(b, self.qp_moduli))
            as_.append(mm.to_mont(a_hat, self.qp_moduli))
        return RelinKey(b=tuple(bs), a=tuple(as_))

    # -- the switch: front, digit steps, finish -------------------------------

    def _mr_front(self, ct1: Ciphertext, ct2: Ciphertext):
        """The tensor product of two ciphertexts: (d0, d1) in X-coeff and
        d2 in (W-coeff, X-coeff), ready for the digit steps.  Every ring
        product is an X-NTT fused with the product by the other factor's
        transform in storage form (K10a)."""
        xn, q = self.ctx.xntt, self._q
        r2 = self.ctx._r2_tw
        with span("ks.front"):
            b1m = xn.forward_mul(ct1.b, r2)          # NTT(b1) * 2^64
            a1m = xn.forward_mul(ct1.a, r2)
            d0c = xn.inverse(xn.forward_mul(ct2.b, b1m))
            d1c = xn.inverse(mm.add_mod(xn.forward_mul(ct2.a, b1m),
                                        xn.forward_mul(ct2.b, a1m), q))
            d2wc = self.ctx.wt.inverse(xn.inverse(xn.forward_mul(ct2.a, a1m)))
            return d0c, d1c, d2wc

    def _digit_step(self, i: int, d_wc: torch.Tensor, key_b: torch.Tensor,
                    key_a: torch.Tensor, ksb: Optional[torch.Tensor],
                    ksa: Optional[torch.Tensor]):
        """Digit i of d (W-coeff, X-coeff over Q): extend its limb group to
        QP, W-CRT, then the X-NTT fused with each key product (K10a), summed
        into the accumulators (None starts them)."""
        g = self.groups[i]                        # groups are consecutive
        with span("ks.digit", i):
            digit = self._extenders[i].extend(d_wc[g[0]:g[-1] + 1])
            w = self.wt_qp.forward(digit)
            del digit
            tb = self.xntt_qp.forward_mul(w, key_b)
            ta = self.xntt_qp.forward_mul(w, key_a)
            q = self._qqp
            return (tb if ksb is None else mm.add_mod(ksb, tb, q),
                    ta if ksa is None else mm.add_mod(ksa, ta, q))

    def _switch_finish(self, ksb: torch.Tensor, ksa: torch.Tensor):
        """QP accumulators -> (kb, ka) over Q in (W-eval, X-coeff)."""
        out = []
        with span("ks.finish"):
            for acc in (ksb, ksa):
                acc_c = self.wt_qp.inverse(self.xntt_qp.inverse(acc))
                out.append(self.ctx.wt.forward(self._mod_down(acc_c)))
            return tuple(out)

    def _mr_finish(self, d0c, d1c, ksb, ksa) -> Ciphertext:
        kb, ka = self._switch_finish(ksb, ksa)
        return Ciphertext(b=mm.add_mod(d0c, kb, self._q),
                          a=mm.add_mod(d1c, ka, self._q))

    def key_switch_d2(self, d2_coeff: torch.Tensor, rlk: RelinKey
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """d2 (X-coeff, W-eval, [L, W, y, x]) -> rank-1 correction (kb, ka)
        mod Q in (X-coeff, W-eval), with kb + ka*s ~= d2*target.  The
        digits and ModDown run in the (W-coeff, X-coeff) domain, where the
        representative slop is small as integer coefficients."""
        d_wc = self.ctx.wt.inverse(d2_coeff)
        ksb = ksa = None
        for i in range(self.dnum):
            ksb, ksa = self._digit_step(i, d_wc, rlk.b[i], rlk.a[i], ksb, ksa)
        return self._switch_finish(ksb, ksa)

    def _mod_down(self, y_qp: torch.Tensor) -> torch.Tensor:
        """round(y / P) mod Q, exact centered division by the P basis
        ((W-coeff, X-coeff) domain input [Lqp, ...])."""
        with span("ks.mod_down"):
            return self._moddown.extend(y_qp[self.L:],
                                        dividend=y_qp[:self.L])

    # -- full homomorphic multiply --------------------------------------------

    def multiply_relinearize(self, ct1: Ciphertext, ct2: Ciphertext,
                             rlk: RelinKey) -> Ciphertext:
        """(ct1 * ct2) relinearized to a standard 2-component ciphertext,
        Delta^2-scaled (decode with delta_override): front, one step per
        digit, finish.  The same bits as the JAX fused and streamed
        multiplies."""
        with span("ks.multiply"):
            d0c, d1c, d2wc = self._mr_front(ct1, ct2)
            ksb = ksa = None
            for i in range(self.dnum):
                ksb, ksa = self._digit_step(i, d2wc, rlk.b[i], rlk.a[i],
                                            ksb, ksa)
            del d2wc
            return self._mr_finish(d0c, d1c, ksb, ksa)

    # the JAX package's digit-streamed multiply gives its fused one's bits:
    # the port's one route serves under both names
    multiply_relinearize_streamed = multiply_relinearize

    def multiply_relinearize_pair(self, re1: Ciphertext, im1: Ciphertext,
                                  re2: Ciphertext, im2: Ciphertext,
                                  rlk: RelinKey
                                  ) -> Tuple[Ciphertext, Ciphertext]:
        """Product of two packed Gaussian pairs (re + i*im) in
        Z[i][X, W]/(X^n+1, Phi_p(W)): 3-mult Karatsuba, P1 = r1 r2,
        P2 = i1 i2, P3 = (r1+i1)(r2+i2), out = (P1 - P2, P3 - P1 - P2),
        each product relinearized; Delta^2-scaled."""
        q = self._q
        p1 = self.multiply_relinearize(re1, re2, rlk)
        p2 = self.multiply_relinearize(im1, im2, rlk)
        p3 = self.multiply_relinearize(_cadd(re1, im1, q), _cadd(re2, im2, q),
                                       rlk)
        return _csub(p1, p2, q), _csub(_csub(p3, p1, q), p2, q)


# -- Galois rotations ----------------------------------------------------------

def w_automorphism_perm(params: GLParams, j: int) -> np.ndarray:
    """Lane permutation of the W-axis Galois automorphism W -> W^j (j a
    unit mod p): tau(x)[w] = x[perm[w]] with exp[perm[w]] = j * exp[w]."""
    if np.gcd(j, params.p) != 1:
        raise ValueError("automorphism index must be a unit mod p")
    exps = np.asarray(params.w_exponents)
    perm = np.empty(len(exps), dtype=np.int64)
    lookup = {int(e): i for i, e in enumerate(exps)}
    for w, e in enumerate(exps):
        perm[w] = lookup[(j * int(e)) % params.p]
    return perm


class GaloisKeys:
    """W-axis slot rotations: one switch key per automorphism index j."""

    def __init__(self, rc: RelinContext, s_coeff: torch.Tensor,
                 indices: Sequence[int], generator: torch.Generator):
        perms, keys = {}, {}
        s_hat = rc._lift_ternary(s_coeff)
        for j in indices:
            perms[j] = w_automorphism_perm(rc.ctx.params, j)
            tau_s = s_hat.index_select(
                1, torch.from_numpy(perms[j]).to(s_hat.device))
            keys[j] = rc.gen_switch_key(tau_s, s_coeff, generator)
        self._init(rc, perms, keys)

    @classmethod
    def from_keys(cls, rc: RelinContext, perms: Dict[int, np.ndarray],
                  keys: Dict[int, RelinKey]) -> "GaloisKeys":
        """Galois keys made elsewhere (convert.galois_keys), no keygen."""
        self = cls.__new__(cls)
        self._init(rc, perms, keys)
        return self

    def _init(self, rc, perms, keys) -> None:
        self.rc = rc
        dev = rc.ctx.device
        self._perms = {j: torch.tensor(np.asarray(p), dtype=torch.int64,
                                       device=dev)
                       for j, p in perms.items()}
        self._keys = dict(keys)

    def apply(self, ct: Ciphertext, j: int) -> Ciphertext:
        """tau_j(ct): the packed slots permuted, re-keyed back to s."""
        with span("ks.galois", j):
            perm = self._perms[j]
            tb = ct.b.index_select(1, perm)
            ta = ct.a.index_select(1, perm)
            kb, ka = self.rc.key_switch_d2(ta, self._keys[j])
            return Ciphertext(b=mm.add_mod(tb, kb, self.rc._q), a=ka)


class FullGaloisKeys:
    """Log-many keys covering every W-slot rotation: p = 3 q with q prime,
    so the rotation group (Z/p)^* is Z2 x Z_{q-1}; keys for
    T = CRT(2 mod 3, 1 mod q) and G^(2^k), G = CRT(1 mod 3, g mod q), give
    any rotation in at most 1 + popcount(e) key switches."""

    @staticmethod
    def group_tables(p: int):
        """(q, g, t_idx, g_idx, dlog) for the Z2 x Z_{q-1} decomposition."""
        q = p // 3
        if p != 3 * q:
            raise ValueError(f"packing modulus p={p} is not 3*q")
        fac = []
        m, d = q - 1, 2
        while d * d <= m:
            if m % d == 0:
                fac.append(d)
                while m % d == 0:
                    m //= d
            d += 1
        if m > 1:
            fac.append(m)
        g = next(c for c in range(2, q)
                 if all(pow(c, (q - 1) // f, q) != 1 for f in fac))
        inv3 = pow(3, -1, q)  # CRT lift: x == a mod 3, x == b mod q

        def crt(a3, bq):
            return (a3 + 3 * ((bq - a3) * inv3 % q)) % p

        t_idx = crt(2, 1)
        nbits = (q - 2).bit_length()
        g_idx = [crt(1, pow(g, 1 << k, q)) for k in range(nbits)]
        dlog = {pow(g, e, q): e for e in range(q - 1)}
        return q, g, t_idx, g_idx, dlog

    def __init__(self, rc: RelinContext, s_coeff: torch.Tensor,
                 generator: torch.Generator):
        self._init_tables(rc.ctx.params.p)
        self._gk = GaloisKeys(rc, s_coeff, self.indices, generator)

    @classmethod
    def from_keys(cls, rc: RelinContext,
                  keys: Dict[int, RelinKey]) -> "FullGaloisKeys":
        """Full Galois keys made elsewhere (convert.full_galois_keys)."""
        self = cls.__new__(cls)
        self._init_tables(rc.ctx.params.p)
        perms = {j: w_automorphism_perm(rc.ctx.params, j)
                 for j in self.indices}
        self._gk = GaloisKeys.from_keys(rc, perms, keys)
        return self

    def _init_tables(self, p: int) -> None:
        (self.q, self.g, self._t_idx, self._g_idx,
         self._dlog) = self.group_tables(p)
        self.p = p
        self.indices = [self._t_idx] + self._g_idx

    def decompose(self, j: int):
        """j (unit mod p) -> (t, e): j = T^t * G^e in the rotation group."""
        if np.gcd(j, self.p) != 1:
            raise ValueError("rotation index must be a unit mod p")
        t = 0 if j % 3 == 1 else 1
        e = self._dlog[j % self.q]
        return t, e

    def apply(self, ct: Ciphertext, j: int) -> Ciphertext:
        """tau_j(ct) as t + popcount(e) single-key switches (decompose)."""
        t, e = self.decompose(j)
        with span("ks.rotate", j):
            out = ct
            if t:
                out = self._gk.apply(out, self._t_idx)
            for k, idx in enumerate(self._g_idx):
                if (e >> k) & 1:
                    out = self._gk.apply(out, idx)
            return out

    def slot_sum(self, ct: Ciphertext) -> Ciphertext:
        """EvalSum: every W slot becomes the sum of all phi(p) slots, in
        1 + log2(q-1) rotate-and-add passes (q-1 a power of two)."""
        if (self.q - 1) & (self.q - 2):
            raise ValueError(
                f"slot_sum needs q-1 a power of two (q={self.q})")
        q = self._gk.rc._q
        out = ct
        for idx in self._g_idx:
            out = _cadd(out, self._gk.apply(out, idx), q)
        return _cadd(out, self._gk.apply(out, self._t_idx), q)


def x_automorphism_maps(x_dim: int, k: int):
    """Coefficient and NTT-slot actions of X -> X^k (k odd) on a negacyclic
    ring of dimension x_dim: (gather_idx, neg_mask as +-1, slot_perm) with
    out[x] = sg[x] * in[gi[x]] and tau(s)_hat[t] = s_hat[slot_perm[t]]."""
    if k % 2 == 0:
        raise ValueError("automorphism index must be odd")
    m2 = 2 * x_dim
    k = k % m2
    gi = np.zeros(x_dim, dtype=np.int64)
    sg = np.zeros(x_dim, dtype=np.int64)
    for j in range(x_dim):
        e = (j * k) % m2
        gi[e % x_dim] = j
        sg[e % x_dim] = -1 if e >= x_dim else 1
    perm = np.array([(((2 * t + 1) * k) % m2 - 1) // 2
                     for t in range(x_dim)], dtype=np.int64)
    return gi, sg, perm


class XGaloisKeys:
    """X-axis automorphisms X -> X^k (k odd), re-keyed to s.  On gl2's
    packed frames only k = 1 (mod 4) is a ring automorphism; conjugation
    there is the joint inversion, models/he_matmul2.Gl2Conj."""

    def __init__(self, rc: RelinContext, s_coeff: torch.Tensor,
                 indices: Sequence[int], generator: torch.Generator):
        if getattr(rc.ctx, "ring", None) == "gl2":
            bad = [k for k in indices if k % 4 != 1]
            if bad:
                raise ValueError(
                    f"X-automorphism indices {bad} are not ring automorphisms "
                    "on gl2 packed frames (need k == 1 mod 4); use "
                    "he_matmul2.Gl2Conj for conjugation")
        x_dim = int(s_coeff.shape[-1])
        s_hat = rc._lift_ternary(s_coeff)
        keys = {}
        for k in indices:
            perm = x_automorphism_maps(x_dim, k)[2]
            tau_s = s_hat.index_select(
                2, torch.from_numpy(perm).to(s_hat.device))
            keys[k] = rc.gen_switch_key(tau_s, s_coeff, generator)
        self._init(rc, x_dim, keys)

    @classmethod
    def from_keys(cls, rc: RelinContext, x_dim: int,
                  keys: Dict[int, RelinKey]) -> "XGaloisKeys":
        """X-axis Galois keys made elsewhere (convert.x_galois_keys)."""
        self = cls.__new__(cls)
        self._init(rc, x_dim, keys)
        return self

    def _init(self, rc, x_dim, keys) -> None:
        self.rc = rc
        self.x_dim = x_dim
        dev = rc.ctx.device
        self._maps = {}
        for k in keys:
            gi, sg, _ = x_automorphism_maps(x_dim, k)
            self._maps[k] = (torch.from_numpy(gi).to(dev),
                             torch.from_numpy(sg < 0).to(dev))
        self._keys = dict(keys)

    def apply(self, ct: Ciphertext, k: int) -> Ciphertext:
        """tau_k(ct) re-keyed to s."""
        gi, neg = self._maps[k]
        q = self.rc._q
        tb, ta = (torch.where(neg, mm.neg_mod(t, q), t)
                  for t in (ct.b.index_select(-1, gi),
                            ct.a.index_select(-1, gi)))
        kb, ka = self.rc.key_switch_d2(ta, self._keys[k])
        return Ciphertext(b=mm.add_mod(tb, kb, q), a=ka)


# -- rescale -------------------------------------------------------------------

class Rescaler:
    """True CKKS rescale: divide-and-round each component by the last prime
    and drop it from the chain (scale Delta^2 -> Delta^2 / q_last), by the
    same exact centered division as ModDown with a one-prime basis."""

    def __init__(self, moduli: Sequence[int], device):
        self.moduli = tuple(int(q) for q in moduli)
        if len(self.moduli) < 2:
            raise ValueError("rescale needs at least two moduli")
        self.q_last = self.moduli[-1]
        self.rest = self.moduli[:-1]
        self._ext = BasisExtender([self.q_last], self.rest, device)

    def rescale_component(self, y: torch.Tensor) -> torch.Tensor:
        """[L, W, y, x] in W-coeff -> [L-1, W, y, x] = round(y / q_last)
        mod the remaining chain."""
        return self._ext.extend(y[-1:], dividend=y[:-1])


_RESCALE_PARTS: "weakref.WeakKeyDictionary[HEContext, tuple]" = \
    weakref.WeakKeyDictionary()


def _rescale_pipeline(ctx):
    """The Rescaler and the reduced chain's WTransform, built once per
    context (an HEContext or a Gl2Context) and dropped with it."""
    if ctx not in _RESCALE_PARTS:
        p = ctx.params
        red = dataclasses.replace(p, name=p.name + "-resc",
                                  moduli=p.moduli[:-1], p_moduli=())
        _RESCALE_PARTS[ctx] = (
            Rescaler(p.moduli, ctx.device),
            WTransform(red, build_tables(red), device=ctx.device))
    return _RESCALE_PARTS[ctx]


def rescale_ciphertext(ctx, ct, rs: Optional[Rescaler] = None):
    """Drop the last modulus from a ciphertext, dividing by q_last in the
    W-coeff domain.  Either ring: an HEContext with a Ciphertext, or a
    Gl2Context with a Ciphertext2 (its W-CRT acts on the same limb-major
    [L, W, ...] layout); the result is of the input's type.  Without `rs`,
    the context's cached Rescaler and
    reduced-chain transform; with it, the reduced-chain transform through
    the full chain's tables (per-limb independence makes the zero-pad and
    slice exact), as the JAX package's explicit-Rescaler path."""
    with span("ks.rescale"):
        b_wc, a_wc = ctx.wt.inverse(ct.b), ctx.wt.inverse(ct.a)
        if rs is None:
            rs, wt_rest = _rescale_pipeline(ctx)
            return type(ct)(b=wt_rest.forward(rs.rescale_component(b_wc)),
                            a=wt_rest.forward(rs.rescale_component(a_wc)))
        out = []
        for y in (b_wc, a_wc):
            padded = torch.cat([rs.rescale_component(y),
                                torch.zeros_like(y[-1:])])
            out.append(ctx.wt.forward(padded)[:-1])
        return type(ct)(b=out[0], a=out[1])
