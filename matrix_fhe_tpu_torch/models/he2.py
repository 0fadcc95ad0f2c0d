"""HE over the integral double form of the GL ring ("gl2").

Counterpart of matrix_fhe_tpu/models/he2.py.  The GL ring Z[i][X]/(X^n - i)
is isomorphic over the integers to the negacyclic ring of doubled degree,

    Z[i][X]/(X^n - i)  ~=  D := Z[X]/(X^{2n} + 1),     i |-> X^n,

with a Gaussian coefficient a + b*i landing in integer slots j and n+j
(tables.build_gl2_x_tables).  In D every coefficient is a plain integer, so
key switching applies to GL-packed data; this module is the scheme core for
that form.  A plaintext is one integer array [L, W, n, 2n] (W-eval,
X2-coeff) whose complex X-coefficients c = a + i*b occupy x-slots j (re)
and n+j (im): the re/im ciphertext pair of the folded scheme becomes one
ciphertext of the same total size.

  * keys: a ternary sign pattern [W, 2n] from a torch.Generator -> W-CRT
    (K1) -> 2n-point X-NTT (K1) -> storage form s * 2^64 mod q;
  * encode: the XY sandwich and the W-IDFT on the fixed-point route (K4,
    each half reconstructed to f64), llround(c * Delta) -> RNS -> W-CRT;
  * encrypt / decrypt: t = iNTT_X(NTT_X(a) (*) s) at 2n = 128 points (K2);
  * decode: W-CRT inverse (K1), the exact big-int compose / delta (never
    K3: Delta^2-scaled products pass 2^63), W-DFT and XY sandwich (K4).

Randomness is fresh only: there is no reference bitstream for this ring.
Layout is limb-major [L, W, y, 2n].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import GLParams
from ..ops import modmath as mm
from ..ops.ntt import RING_GL2, XNTT
from ..ops.wcrt import WTransform
from ..tables import build_tables
from . import rng as refrng
from .encoder import Encoder
from ..ops._backend import resolve_device

I64 = torch.int64


class Ciphertext2(NamedTuple):
    """(b, a), W-CRT-eval / X2-coeff domain, [L, W, y, 2n]."""
    b: torch.Tensor
    a: torch.Tensor


class SecretKey2(NamedTuple):
    s_mont: torch.Tensor   # [L, W, 2n] X2-NTT x W-eval, storage form s * 2^64
    s_sign: torch.Tensor   # [W, 2n] int8 ternary pattern (for switch keys)


class Gl2Context:
    """Transforms and pipelines for gl2-ring HE on one parameter set and
    one device."""

    def __init__(self, params: GLParams, device="cuda"):
        self.params = params
        self.ring = RING_GL2
        self.device = resolve_device(device)
        self.tables = build_tables(params)
        self.wt = WTransform(params, self.tables, device=self.device)
        self.xntt = XNTT(params, ring=RING_GL2, tables=self.tables,
                         device=self.device)
        self.encoder = Encoder(params, self.tables, device=self.device)
        self._q4 = mm.moduli_col(params.moduli, 3, self.device)
        self.m = 2 * params.n  # X-axis ring dimension of D

    # -- key generation ------------------------------------------------------

    def generate_secret_key(self, generator: torch.Generator) -> SecretKey2:
        p = self.params
        sign = torch.randint(0, 3, (p.phi, self.m), generator=generator,
                             dtype=I64, device=generator.device) - 1
        return self.secret_key(sign)

    def secret_key(self, sign: torch.Tensor) -> SecretKey2:
        """The SecretKey2 of a ternary sign pattern [W, 2n] in {-1, 0, 1}
        over this context's limbs: a pattern is limb-consistent, so the
        key of a limb prefix is the prefix of the key."""
        p = self.params
        if tuple(sign.shape) != (p.phi, self.m) or \
                bool((sign.abs() > 1).any()):
            raise ValueError(f"sign must be ternary [{p.phi}, {self.m}]")
        sign = sign.to(torch.int8).to(self.device)
        s_res = self._ternary_residues(sign, p.moduli)
        s_ntt = self.xntt.forward(self.wt.forward(s_res))
        return SecretKey2(mm.to_mont(s_ntt, p.moduli), sign)

    @staticmethod
    def _ternary_residues(sign: torch.Tensor, moduli) -> torch.Tensor:
        """[W, m] int8 in {-1, 0, 1} -> per-limb residues [L, W, m]."""
        s = sign.to(I64)[None]
        q = mm.moduli_col(moduli, 2, sign.device)
        return torch.where(s < 0, q + s, s).expand(
            (len(moduli),) + tuple(sign.shape)).contiguous()

    # -- encode / decode -----------------------------------------------------

    def encode(self, m_re: torch.Tensor, m_im: torch.Tensor) -> torch.Tensor:
        """[W, n, n] complex pair -> packed plaintext [L, W, n, 2n] in
        (W-eval, X2-coeff): the batched encode with the re/im split
        replaced by the i = X^n slot packing."""
        xr, xi = self.encoder.idft2_exact(m_re, m_im)   # per-lane XY-IDFT
        cr, ci = self.wt.dft_inverse_pair(xr, xi)        # complex W-IDFT
        rr, ri = self.encoder.quantize(cr, ci)           # llround(c Delta) mod q
        return self.wt.forward(torch.cat([rr, ri], dim=-1))   # [L, W, n, 2n]

    def decode(self, ev: torch.Tensor, delta_override: float | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[L, W, y, 2n] (W-eval, X2-coeff) -> complex [W, y, n] pair,
        divided by delta_override instead of Delta when one is given."""
        n = self.params.n
        delta = self.params.delta if delta_override is None else delta_override
        f = self.encoder._composer.compose_to_float(self.wt.inverse(ev), delta)
        er, ei = self.wt.dft_forward_pair(f[..., :n], f[..., n:])
        return self.encoder.dft2_exact(er, ei)

    # -- encrypt / decrypt ---------------------------------------------------

    def encrypt(self, m: torch.Tensor, sk: SecretKey2,
                generator: torch.Generator) -> Ciphertext2:
        """m: [L, W, y, 2n] W-eval packed plaintext; fresh `a` and noise
        from `generator` (uniform limb by limb, then the Gaussian)."""
        p = self.params
        frame = (p.phi, m.shape[2], self.m)
        a = refrng.fresh_uniform_a(generator, p, self.device, shape=frame)
        e = refrng.fresh_gaussian_noise(generator, p, self.device, shape=frame)
        return self._encrypt_from(m, sk, a, e)

    def _encrypt_from(self, m: torch.Tensor, sk: SecretKey2,
                      a_coeff: torch.Tensor, e_coeff: torch.Tensor
                      ) -> Ciphertext2:
        """encrypt on given randomness: a and e as W-coeff residues."""
        a_eval = self.wt.forward(a_coeff)
        t = self.xntt.mul_s(a_eval, sk.s_mont)
        b = mm.sub_mod(m, t, self._q4)
        b = mm.add_mod(b, self.wt.forward(e_coeff), self._q4)
        return Ciphertext2(b=b, a=a_eval)

    def decrypt_to_eval(self, ct: Ciphertext2, sk: SecretKey2) -> torch.Tensor:
        return mm.add_mod(ct.b, self.xntt.mul_s(ct.a, sk.s_mont), self._q4)

    def decrypt_and_decode(self, ct: Ciphertext2, sk: SecretKey2,
                           delta_override: float | None = None):
        return self.decode(self.decrypt_to_eval(ct, sk),
                           delta_override=delta_override)
