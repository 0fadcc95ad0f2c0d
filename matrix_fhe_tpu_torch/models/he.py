"""RLWE Matrix-FHE scheme core: keygen, encrypt, decrypt, roundtrip.

Counterpart of matrix_fhe_tpu/models/he.py on int64 tensors held on one
device:

  * generate_secret_key (HE.cu:1272-1307): ternary s in W-coeff -> W-CRT
    eval (K1) -> X-NTT (K1) -> storage form s * 2^64 mod q;
  * encrypt_pair (HE.cu:1455-1552): a in W-eval; t = iNTT_X(NTT_X(a) (*) s)
    (K2); b = m - t + e, one shared `a` for the re/im pair;
  * encrypt (single message) and decrypt: b + a*s (K2);
  * add_ciphertexts, multiply_ciphertexts_raw, multiply_plain (K1 and its
    twiddle form, K10a), add_plain;
  * decrypt_and_decode / roundtrip: the words-chained decode (K3, K4);
    roundtrip_batch, the roundtrip of a batch of messages.

The reference-parity randomness streams are constants of the parameter
set, so their W-eval forms are built once per context (he.py:295-325 in
the JAX package); a torch.Generator selects fresh randomness instead.
Layout is limb-major [L, W, n, n].
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GLParams, get_params
from ..ops import modmath as mm
from ..ops._backend import resolve_device
from ..ops.ntt import RING_NEGACYCLIC, XNTT
from ..ops.wcrt import WTransform
from ..tables import build_tables
from ..utils.profiler import span
from . import rng as refrng
from .batched_encoder import BatchedEncoder


class Ciphertext(NamedTuple):
    """(b, a) pair, W-CRT-eval / X-coeff domain, limb-major [L, W, n, n]."""
    b: torch.Tensor
    a: torch.Tensor


class SecretKey(NamedTuple):
    """s in X-NTT x W-eval domain, storage form s * 2^64 mod q, [L, W, n]."""
    s_mont: torch.Tensor


class HEContext:
    """All tables and transforms for one parameter set on one device."""

    def __init__(self, params: GLParams, ring: str = RING_NEGACYCLIC,
                 zero_noise: bool = False, device="cuda"):
        self.params = params
        self.ring = ring
        self.zero_noise = zero_noise
        self.device = resolve_device(device)
        self.tables = build_tables(params)
        self.wt = WTransform(params, self.tables, device=self.device)
        self.xntt = XNTT(params, ring=ring, tables=self.tables,
                         device=self.device)
        self.batched_encoder = BatchedEncoder(params, self.tables, self.wt,
                                              device=self.device)
        self.encoder = self.batched_encoder.encoder
        self._q4 = mm.moduli_col(params.moduli, 3, self.device)
        # 2^128 mod q as a one-row twiddle: forward_mul by it is the X-NTT
        # in storage form (x 2^64), the JAX to_mont after the transform
        self._r2_tw = mm.moduli_col(
            [mm.MontConsts.make(int(q)).r2 for q in params.moduli], 2,
            self.device).expand(-1, 1, params.n).contiguous()

    # -- key generation -------------------------------------------------------

    def generate_secret_key(self, generator: Optional[torch.Generator] = None
                            ) -> SecretKey:
        """Deterministic reference-parity key (HE.cu:1272-1307), or fresh
        key material drawn from `generator`."""
        if generator is None:
            s_coeff = refrng.ternary_secret(self.params, self.device)
        else:
            s_coeff = refrng.fresh_ternary_secret(generator, self.params,
                                                  self.device)
        s_ntt = self.xntt.forward(self.wt.forward(s_coeff))
        return SecretKey(mm.to_mont(s_ntt, self.params.moduli))

    # -- parity streams ---------------------------------------------------------

    @functools.cached_property
    def _parity_a_eval(self) -> torch.Tensor:
        return self.wt.forward(refrng.uniform_a(self.params, self.device))

    @functools.cached_property
    def _parity_e_eval(self) -> torch.Tensor:
        return self.wt.forward(refrng.gaussian_noise(self.params, self.device))

    # -- encrypt / decrypt ---------------------------------------------------------

    def _combine(self, m: torch.Tensor, t: torch.Tensor,
                 e_eval: Optional[torch.Tensor]) -> torch.Tensor:
        b = mm.sub_mod(m, t, self._q4)
        return b if e_eval is None else mm.add_mod(b, e_eval, self._q4)

    def encrypt_pair(self, m_re: torch.Tensor, m_im: torch.Tensor,
                     sk: SecretKey,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Ciphertext, Ciphertext]:
        """Encrypt a packed complex pair sharing one `a` (HE.cuh:91-92).
        Without a generator both halves carry the reference's one
        deterministic noise stream (HE.cu:1516-1517)."""
        with span("encrypt"):
            if generator is None:
                a_eval = self._parity_a_eval
                noises = (None, None) if self.zero_noise else \
                    (self._parity_e_eval,) * 2
            else:
                p, dev = self.params, self.device
                a_eval = self.wt.forward(
                    refrng.fresh_uniform_a(generator, p, dev))
                noises = (None, None) if self.zero_noise else tuple(
                    self.wt.forward(
                        refrng.fresh_gaussian_noise(generator, p, dev))
                    for _ in range(2))
            t = self.xntt.mul_s(a_eval, sk.s_mont)
            return tuple(Ciphertext(b=self._combine(m, t, e), a=a_eval)
                         for m, e in zip((m_re, m_im), noises))

    def encrypt(self, m: torch.Tensor, sk: SecretKey) -> Ciphertext:
        """Single-message encrypt (HE.cu:1370-1453) on the parity streams,
        so it is bit-exact with the JAX package: the messages of one
        circuit share the parity `a`, as they do there."""
        t = self.xntt.mul_s(self._parity_a_eval, sk.s_mont)
        e_eval = None if self.zero_noise else self._parity_e_eval
        return Ciphertext(b=self._combine(m, t, e_eval), a=self._parity_a_eval)

    def decrypt_to_eval(self, ct: Ciphertext, sk: SecretKey) -> torch.Tensor:
        """b + a*s in W-eval / X-coeff domain (HE.cu:1553-1601)."""
        return mm.add_mod(ct.b, self.xntt.mul_s(ct.a, sk.s_mont), self._q4)

    def decrypt_pair_to_eval(self, ct_re: Ciphertext, ct_im: Ciphertext,
                             sk: SecretKey) -> Tuple[torch.Tensor, torch.Tensor]:
        """b + a*s in W-eval / X-coeff domain for a pair sharing one `a`
        (a*s computed once)."""
        with span("decrypt"):
            t = self.xntt.mul_s(ct_re.a, sk.s_mont)
            return (mm.add_mod(ct_re.b, t, self._q4),
                    mm.add_mod(ct_im.b, t, self._q4))

    def decrypt_and_decode(self, ct_re: Ciphertext, ct_im: Ciphertext,
                           sk: SecretKey) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full decode to complex matrices [W, n, n] (HE.cu:1691-1708)."""
        ev_re, ev_im = self.decrypt_pair_to_eval(ct_re, ct_im, sk)
        return self.batched_encoder.decode_from_wntt_eval(ev_re, ev_im)

    # -- homomorphic ops (HE.cu:631-669, 1710-1740) -----------------------------

    def add_ciphertexts(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """Pointwise addition (add_ct_kernel, HE.cu:631-644)."""
        return Ciphertext(b=mm.add_mod(ct1.b, ct2.b, self._q4),
                          a=mm.add_mod(ct1.a, ct2.a, self._q4))

    def multiply_ciphertexts_raw(self, ct1: Ciphertext, ct2: Ciphertext):
        """Tensor product (d0, d1, d2) = (b1b2, b1a2+a1b2, a1a2), pointwise
        on the stored components as the reference's mul_tensor_kernel
        (HE.cu:647-669); no relinearization."""
        q = self._q4
        return (mm.mul_mod(ct1.b, ct2.b, q),
                mm.add_mod(mm.mul_mod(ct1.b, ct2.a, q),
                           mm.mul_mod(ct1.a, ct2.b, q), q),
                mm.mul_mod(ct1.a, ct2.a, q))

    def multiply_plain(self, ct: Ciphertext, m: torch.Tensor) -> Ciphertext:
        """Exact ring product with a plaintext m in the stored layout
        (W-eval, X-coeff): no key, no fresh noise, the scales multiply.
        Each component is one X-NTT fused with the product by NTT(m) in
        storage form (K10a's twiddle) and one inverse X-NTT."""
        xn = self.xntt
        hat_m = xn.forward_mul(m, self._r2_tw)
        return Ciphertext(b=xn.inverse(xn.forward_mul(ct.b, hat_m)),
                          a=xn.inverse(xn.forward_mul(ct.a, hat_m)))

    def add_plain(self, ct: Ciphertext, m: torch.Tensor) -> Ciphertext:
        """ct + plaintext m (stored layout, at the ciphertext's scale)."""
        return Ciphertext(b=mm.add_mod(ct.b, m, self._q4), a=ct.a)

    def roundtrip(self, m_re: torch.Tensor, m_im: torch.Tensor,
                  sk: SecretKey) -> Tuple[torch.Tensor, torch.Tensor]:
        """encode -> encrypt -> decrypt -> decode (src/main.cu:31-157), with
        t = a*s shared by encrypt and decrypt as in the JAX
        _roundtrip_pair_fn."""
        pr, pi = self.batched_encoder.encode_to_wntt_eval(m_re, m_im)
        t = self.xntt.mul_s(self._parity_a_eval, sk.s_mont)
        return self.batched_encoder.decode_from_wntt_eval(
            *self._roundtrip_combine(pr, pi, t))

    def roundtrip_batch(self, m_re: torch.Tensor, m_im: torch.Tensor,
                        sk: SecretKey) -> Tuple[torch.Tensor, torch.Tensor]:
        """roundtrip over a batch [B, W, n, n] -> [B, W, n, n] pair, the
        counterpart of jax.vmap(roundtrip_fn, in_axes=(0, 0, None)): every
        message takes the same parity a and e, and the fixed-point
        exponents of each message are its own, as under vmap.  One message
        at a time; t = a*s is computed once for the batch."""
        if m_re.shape != m_im.shape or m_re.dim() != 4:
            raise ValueError(f"batch pair {tuple(m_re.shape)} / "
                             f"{tuple(m_im.shape)} is not [B, W, n, n]")
        t = self.xntt.mul_s(self._parity_a_eval, sk.s_mont)
        be = self.batched_encoder
        outs = [be.decode_from_wntt_eval(*self._roundtrip_combine(
            *be.encode_to_wntt_eval(m_re[b], m_im[b]), t))
            for b in range(m_re.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def _roundtrip_combine(self, pr: torch.Tensor, pi: torch.Tensor,
                           t: torch.Tensor, rows: slice = slice(None)
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The roundtrip's elementwise middle: b = m - t + e (encrypt on the
        parity streams) and ev = b + t (decrypt), given t = a*s; `rows`
        selects the matrix rows y of e that pr, pi and t hold."""
        e_eval = None if self.zero_noise else self._parity_e_eval[:, :, rows]
        return tuple(mm.add_mod(self._combine(m, t, e_eval), t, self._q4)
                     for m in (pr, pi))


@functools.lru_cache(maxsize=None)
def _cached_context(params_name: str, ring: str, zero_noise: bool,
                    device: torch.device) -> HEContext:
    return HEContext(get_params(params_name), ring=ring,
                     zero_noise=zero_noise, device=device)


def init_he_backend(params_name: str = "ref", ring: str = RING_NEGACYCLIC,
                    zero_noise: bool = False, device="cuda") -> HEContext:
    """Reference-style singleton constructor (init_he_backend, HE.cu:318),
    one context per (preset, ring, zero_noise, device)."""
    return _cached_context(params_name, ring, zero_noise,
                           resolve_device(device))
