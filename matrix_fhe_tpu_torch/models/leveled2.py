"""Leveled chain on the gl2 double ring: encrypted GEMMs whose products
are multiplied again.

The gl2 sibling of LeveledChain (models/leveled.py).  The JAX package has
no such tower: its he2.py says the leveled apparatus applies to gl2, but
it has no gl2 rescale.  One object owns, per level (the last prime
dropped at each), a Gl2Context, its HEMatmul2, RelinContext and
Gl2GemmRelin, and the level's GEMM switch keys, all from ONE ternary sign
pattern [W, 2n].  A LeveledCt carries a Ciphertext2 with its (level,
scale):

  * matmul(x, y): Y^H X per lane, Gl2GemmRelin.matmul with the level's
    keys; both operands at one level; the scales multiply;
  * rescale(ct): keyswitch.rescale_ciphertext, the negacyclic chain's own
    rescale: per component the W-CRT inverse, Rescaler's exact division
    by the last prime (one base_conv launch on the card) and the reduced
    chain's W-CRT forward; the scale divides by that prime;
  * decrypt_decode(ct): the complex matrices at the ciphertext's scale.

The GEMM keys of a level are made on first use from a torch.Generator
seeded from the chain's seed folded by the level, as LeveledChain folds
its relinearization keys (set_gemm_keys installs keys made elsewhere,
another device's chain over the same secret).  A CUDA tensor takes the
kernels, a CPU tensor the plain twins.

Spans (utils/profiler.span): "gl2.step" (index: the level) around each
matmul, with the GEMM's "gl2.tensor" and "gl2.relin" under it, and
"gl2.rescale" around a rescale (rescale_ciphertext's "ks.rescale" under
it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import GLParams
from ..ops._backend import resolve_device
from ..utils.profiler import span
from .he2 import Gl2Context, SecretKey2
from .he_matmul2 import GemmRelinKey, Gl2GemmRelin, HEMatmul2
from .keyswitch import RelinContext, rescale_ciphertext
from .leveled import LeveledCt, fold_generator, level_params


class Gl2Chain:
    """The gl2 leveled tower over one base parameter set, on one device.

    `secret` is the signed ternary pattern [W, 2n] every level's keys come
    from; without one it is drawn from the chain's seed."""

    def __init__(self, params: GLParams, seed: int = 0,
                 p_moduli: Optional[Sequence[int]] = None, device="cuda",
                 secret: Optional[torch.Tensor] = None):
        self.base = params
        self.device = resolve_device(device)
        self.depth = len(params.moduli) - 1  # deepest usable level index
        self.seed = int(seed)
        self._p_moduli = p_moduli
        self._ctx = {}
        self._gemm = {}
        self._keys = {}
        c0 = self.ctx(0)
        self._sk = {0: c0.generate_secret_key(self._generator(-1))
                    if secret is None else c0.secret_key(secret)}

    def _generator(self, tag: int) -> torch.Generator:
        return fold_generator(self.seed, tag, self.device)

    # -- context tower --------------------------------------------------------

    def params_at(self, level: int) -> GLParams:
        return level_params(self.base, level)

    def ctx(self, level: int) -> Gl2Context:
        if level not in self._ctx:
            self._ctx[level] = Gl2Context(self.params_at(level),
                                          device=self.device)
        return self._ctx[level]

    def sk(self, level: int) -> SecretKey2:
        """The one sign pattern's key over the level's limb prefix."""
        if level not in self._sk:
            self._sk[level] = self.ctx(level).secret_key(self._sk[0].s_sign)
        return self._sk[level]

    def gemm(self, level: int) -> Gl2GemmRelin:
        """The level's GEMM: HEMatmul2 and Gl2GemmRelin over the level's
        RelinContext."""
        if level not in self._gemm:
            ctx = self.ctx(level)
            self._gemm[level] = Gl2GemmRelin(
                HEMatmul2(ctx), RelinContext(ctx, p_moduli=self._p_moduli))
        return self._gemm[level]

    def gemm_keys(self, level: int) -> GemmRelinKey:
        if level not in self._keys:
            self._keys[level] = self.gemm(level).gen_keys(
                self.sk(level), self._generator(level))
        return self._keys[level]

    def set_gemm_keys(self, level: int, keys: GemmRelinKey) -> None:
        """Take `keys`, made over the same secret (by another device's
        chain, say), as the level's GEMM switch keys, on this device."""
        self._keys[level] = GemmRelinKey(*(tuple(t.to(self.device)
                                                 for t in part)
                                           for part in keys))

    # -- leveled operations -----------------------------------------------------

    def encrypt(self, m_re: torch.Tensor, m_im: torch.Tensor,
                generator: torch.Generator, level: int = 0) -> LeveledCt:
        """Complex [W, n, n] matrices -> a ciphertext at `level`, scale
        Delta, with fresh randomness from `generator`."""
        ctx = self.ctx(level)
        ct = ctx.encrypt(ctx.encode(m_re, m_im), self.sk(level), generator)
        return LeveledCt(ct, level, float(self.base.delta))

    def matmul(self, x: LeveledCt, y: LeveledCt) -> LeveledCt:
        """Y^H X per lane at the operands' level."""
        if x.level != y.level:
            raise ValueError(f"level mismatch {x.level} != {y.level}: the "
                             "GEMM takes both operands at one level")
        gr, keys = self.gemm(x.level), self.gemm_keys(x.level)
        with span("gl2.step", x.level):
            ct = gr.matmul(x.ct, y.ct, keys)
        return LeveledCt(ct, x.level, x.scale * y.scale)

    def rescale(self, a: LeveledCt) -> LeveledCt:
        if a.level >= self.depth:
            raise ValueError("chain exhausted: no prime left to drop")
        q_last = int(self.params_at(a.level).moduli[-1])
        with span("gl2.rescale"):
            ct = rescale_ciphertext(self.ctx(a.level), a.ct)
        return LeveledCt(ct, a.level + 1, a.scale / q_last)

    def decrypt_decode(self, a: LeveledCt):
        """The complex [W, n, n] pair a ciphertext holds, at its scale."""
        return self.ctx(a.level).decrypt_and_decode(
            a.ct, self.sk(a.level), delta_override=a.scale)
