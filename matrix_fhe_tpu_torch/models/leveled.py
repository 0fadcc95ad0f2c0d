"""Leveled CKKS context chain: automatic level and scale bookkeeping.

Counterpart of matrix_fhe_tpu/models/leveled.py.  One object owns the
per-level parameter sets (the last prime dropped at each level), the
per-level HEContext, RelinContext and switch keys, all derived from ONE
ternary secret, and a `LeveledCt` wrapper carrying (level, scale), so that
multiply, rescale, rotate and add compose without manual modulus
bookkeeping.  Messages are limb-consistent ring elements in W-eval layout
(what HEContext.encrypt takes); scales multiply under multiplication and
divide by the dropped prime under rescale; callers decode at `lct.scale`.

The secret is the reference-parity one, as in the JAX chain, unless the
caller gives its own signed ternary secret [W, n]: then every level's
keys and the secret key are made from that one.  Per-level keys come
from torch.Generators seeded from one seed, folded per use the
way the JAX chain folds its key: the level for the relinearization key
(leveled.py:104 there), (level + 1) * 1000 + j for the Galois key of j
(:111), (level + 1) * 7919 for the full Galois set (:167).  The keys differ
from the JAX package's; convert.leveled_keys installs JAX keys instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..config import GLParams
from ..ops import modmath as mm
from ..ops._backend import resolve_device
from .he import Ciphertext, HEContext, SecretKey
from . import rng as refrng
from .keyswitch import (FullGaloisKeys, GaloisKeys, RelinContext,
                        rescale_ciphertext)


class LeveledCt(NamedTuple):
    """A ciphertext annotated with its chain position and plaintext scale."""
    ct: Ciphertext
    level: int
    scale: float


def _fold(seed: int, tag: int) -> int:
    """A generator seed for one use of the chain's seed."""
    return (seed * 1_000_003 + tag) % (1 << 63)


def fold_generator(seed: int, tag: int, device) -> torch.Generator:
    """The generator of one use of a chain's seed, on `device`."""
    return torch.Generator(device=device).manual_seed(_fold(seed, tag))


def level_params(base: GLParams, level: int) -> GLParams:
    """The parameter set of a chain's `level`: `base` with its last
    `level` primes dropped (the chain of either ring)."""
    depth = len(base.moduli) - 1
    if not 0 <= level <= depth:
        raise ValueError(f"level {level} outside chain [0, {depth}]")
    if level == 0:
        return base
    return dataclasses.replace(base, name=f"{base.name}-lvl{level}",
                               moduli=base.moduli[:len(base.moduli) - level])


class LeveledChain:
    """The leveled context tower over one base parameter set, on one
    device."""

    def __init__(self, params: GLParams, ring: str = "nega", seed: int = 0,
                 p_moduli: Optional[Sequence[int]] = None, device="cuda",
                 secret: Optional[torch.Tensor] = None):
        if ring != "nega":
            # gl2 leveling is Gl2Chain (models/leveled2.py); the folded GL
            # ring admits no key switching at all
            raise ValueError("LeveledChain supports ring='nega'; the gl2 "
                             "ring's chain is Gl2Chain")
        self.base = params
        self.ring = ring
        self.device = resolve_device(device)
        self.depth = len(params.moduli) - 1  # deepest usable level index
        self.seed = int(seed)
        self._p_moduli = p_moduli
        self._ctx = {}
        self._rc = {}
        self._rlk = {}
        self._gk = {}
        if secret is None:
            self._s_coeff0 = refrng.ternary_secret(params, self.device)
        else:
            if tuple(secret.shape) != (params.phi, params.n) or \
                    bool((secret.abs() > 1).any()):
                raise ValueError(f"secret must be ternary [{params.phi}, "
                                 f"{params.n}]")
            self._s_coeff0 = refrng._residues(
                secret.to(self.device, torch.int64), params)
        self._sk0 = None

    def _generator(self, tag: int) -> torch.Generator:
        return fold_generator(self.seed, tag, self.device)

    # -- context tower --------------------------------------------------------

    def limbs_at(self, level: int) -> int:
        return len(self.base.moduli) - level

    def params_at(self, level: int) -> GLParams:
        return level_params(self.base, level)

    def ctx(self, level: int) -> HEContext:
        if level not in self._ctx:
            self._ctx[level] = HEContext(self.params_at(level), ring=self.ring,
                                         device=self.device)
        return self._ctx[level]

    def sk(self, level: int) -> SecretKey:
        """The one secret, restricted to the level's limb prefix (the
        ternary pattern is limb-consistent, so slicing is exact)."""
        if self._sk0 is None:
            c0 = self.ctx(0)
            self._sk0 = SecretKey(mm.to_mont(
                c0.xntt.forward(c0.wt.forward(self._s_coeff0)),
                self.base.moduli))
        return SecretKey(s_mont=self._sk0.s_mont[:self.limbs_at(level)])

    def rc(self, level: int) -> RelinContext:
        if level not in self._rc:
            self._rc[level] = RelinContext(self.ctx(level),
                                           p_moduli=self._p_moduli)
        return self._rc[level]

    def rlk(self, level: int):
        if level not in self._rlk:
            self._rlk[level] = self.rc(level).gen_relin_key(
                self._s_coeff0[:self.limbs_at(level)], self._generator(level))
        return self._rlk[level]

    def galois(self, level: int, j: int) -> GaloisKeys:
        if (level, j) not in self._gk:
            self._gk[(level, j)] = GaloisKeys(
                self.rc(level), self._s_coeff0[:self.limbs_at(level)], [j],
                self._generator((level + 1) * 1000 + j))
        return self._gk[(level, j)]

    def full_galois(self, level: int) -> FullGaloisKeys:
        """The shared log-size rotation key set of a level (~10 keys cover
        every unit rotation)."""
        k = ("full", level)
        if k not in self._gk:
            self._gk[k] = FullGaloisKeys(
                self.rc(level), self._s_coeff0[:self.limbs_at(level)],
                self._generator((level + 1) * 7919))
        return self._gk[k]

    # -- leveled operations -----------------------------------------------------

    def encrypt(self, m_eval: torch.Tensor, level: int = 0,
                scale: Optional[float] = None) -> LeveledCt:
        """m_eval: limb-consistent message in W-eval layout for `level`'s
        limb count ([L_level, W, y, x])."""
        ct = self.ctx(level).encrypt(m_eval, self.sk(level))
        return LeveledCt(ct, level,
                         float(self.base.delta) if scale is None else scale)

    def multiply(self, a: LeveledCt, b: LeveledCt) -> LeveledCt:
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}: mod_switch first")
        ct = self.rc(a.level).multiply_relinearize(a.ct, b.ct,
                                                   self.rlk(a.level))
        return LeveledCt(ct, a.level, a.scale * b.scale)

    def rescale(self, a: LeveledCt) -> LeveledCt:
        if a.level >= self.depth:
            raise ValueError("chain exhausted: no prime left to drop")
        q_last = int(self.params_at(a.level).moduli[-1])
        ct = rescale_ciphertext(self.ctx(a.level), a.ct)
        return LeveledCt(ct, a.level + 1, a.scale / q_last)

    def mod_switch(self, a: LeveledCt, level: int) -> LeveledCt:
        """Drop limbs without rescaling (exact for centered values below
        the reduced modulus; scale unchanged)."""
        if level < a.level:
            raise ValueError("cannot switch to a larger modulus")
        self.params_at(level)  # range-check the target level
        k = self.limbs_at(level)
        return LeveledCt(Ciphertext(b=a.ct.b[:k], a=a.ct.a[:k]),
                         level, a.scale)

    def add(self, a: LeveledCt, b: LeveledCt) -> LeveledCt:
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}: mod_switch first")
        if abs(a.scale - b.scale) > 1e-6 * a.scale:
            raise ValueError(
                f"scale mismatch {a.scale} vs {b.scale}: rescale first")
        return LeveledCt(self.ctx(a.level).add_ciphertexts(a.ct, b.ct),
                         a.level, a.scale)

    def rotate(self, a: LeveledCt, j: int, full: bool = False) -> LeveledCt:
        """tau_j; full=True uses the shared log-size key set (more hops)
        instead of one stored key per index."""
        gk = self.full_galois(a.level) if full else self.galois(a.level, j)
        return LeveledCt(gk.apply(a.ct, j), a.level, a.scale)

    def multiply_plain(self, a: LeveledCt, m: torch.Tensor,
                       m_scale: float) -> LeveledCt:
        """Exact plaintext multiply (no keys, no fresh noise)."""
        return LeveledCt(self.ctx(a.level).multiply_plain(a.ct, m),
                         a.level, a.scale * m_scale)

    def add_plain(self, a: LeveledCt, m: torch.Tensor) -> LeveledCt:
        """ct + plaintext (the plaintext must be encoded at a.scale)."""
        return LeveledCt(self.ctx(a.level).add_plain(a.ct, m),
                         a.level, a.scale)

    def decrypt_to_eval(self, a: LeveledCt) -> torch.Tensor:
        return self.ctx(a.level).decrypt_to_eval(a.ct, self.sk(a.level))

    # -- complex (Gaussian-pair) messages ----------------------------------------
    #
    # A packed complex message is a ciphertext pair (re, im) sharing one `a`
    # (encrypt_pair, HE.cu:1455); multiply_complex is the Gaussian-ring
    # product (RelinContext.multiply_relinearize_pair).

    def encrypt_complex(self, m_re: torch.Tensor, m_im: torch.Tensor,
                        level: int = 0, scale: Optional[float] = None):
        ct_re, ct_im = self.ctx(level).encrypt_pair(m_re, m_im, self.sk(level))
        s = float(self.base.delta) if scale is None else scale
        return (LeveledCt(ct_re, level, s), LeveledCt(ct_im, level, s))

    @staticmethod
    def _check_pair(pair) -> None:
        ar, ai = pair
        if ar.level != ai.level:
            raise ValueError(
                f"pair halves at different levels ({ar.level}, {ai.level})")
        if abs(ar.scale - ai.scale) > 1e-6 * ar.scale:
            raise ValueError(
                f"pair halves at different scales ({ar.scale}, {ai.scale})")

    def multiply_complex(self, a_pair, b_pair):
        self._check_pair(a_pair)
        self._check_pair(b_pair)
        (ar, ai), (br, bi) = a_pair, b_pair
        if ar.level != br.level:
            raise ValueError("level mismatch across the pairs")
        outr, outi = self.rc(ar.level).multiply_relinearize_pair(
            ar.ct, ai.ct, br.ct, bi.ct, self.rlk(ar.level))
        s = ar.scale * br.scale
        return (LeveledCt(outr, ar.level, s), LeveledCt(outi, ar.level, s))

    def rescale_pair(self, pair):
        return (self.rescale(pair[0]), self.rescale(pair[1]))

    def decrypt_decode_complex(self, pair):
        """Decode a pair to complex matrices at its scale (each half
        decrypts independently)."""
        self._check_pair(pair)
        ar, ai = pair
        ctx = self.ctx(ar.level)
        sk = self.sk(ar.level)
        return ctx.batched_encoder.decode_from_wntt_eval(
            ctx.decrypt_to_eval(ar.ct, sk), ctx.decrypt_to_eval(ai.ct, sk),
            delta_override=ar.scale)
