"""The gl2 relinearize's key products on the card.

For digit i of models/he_matmul2.Gl2GemmRelin._relin_chunk over a chunk
of QP limbs, KeyProducts updates both accumulators in one launch of
csrc/gl2_key_products.cu (launch key gl2_key_products):

    u0 <- (u0 + hat kb_i 2^-64) mod q,    u1 <- (u1 + hat ka_i 2^-64) mod q

by Montgomery's REDC with R = 2^64.  The switch keys are in their storage
form k 2^64 mod q, so each product is hat k mod q exactly, and the sums
need no 2^-64 factor afterwards.  On the first digit (no accumulators yet)
it allocates them and writes them without reading.  hat is digit i's 2D
spectrum, either contiguous or as Gl2GemmRelin._ntt2d leaves it
(transposed in its last two axes); the kernel reads either in place.

A CUDA tensor launches the kernel or raises; there is no plain route
here.  The plain twin, for CPU tensors, is
Gl2GemmRelin._key_products_plain (modmath.mul_mod and add_mod, the sums
in storage form, one 2^-64 factor at the end), whose bits these are.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _backend as be
from .modmath import kernel_consts

I64 = torch.int64
MAX_BITS = 56       # q < 2^56: the REDC's operands and sums stay in 64 bits


class KeyProducts:
    """One digit's two switch-key products, summed in place, over the
    limbs `moduli` (each odd and below 2^56), constants on `device`."""

    def __init__(self, moduli: Sequence[int], device):
        self.moduli = tuple(int(q) for q in moduli)
        for q in self.moduli:
            if q % 2 == 0 or not 1 < q < 1 << MAX_BITS:
                raise ValueError(f"gl2_key_products takes odd moduli below "
                                 f"2^{MAX_BITS}, not {q}")
        self._consts = kernel_consts(self.moduli, device)

    def __call__(self, hat: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
                 u0: Optional[torch.Tensor] = None,
                 u1: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u0 + hat kb 2^-64, u1 + hat ka 2^-64) mod q, updated in place;
        u0 = u1 = None on the first digit."""
        if (u0 is None) != (u1 is None):
            raise ValueError("gl2_key_products: give both accumulators or "
                             "neither")
        first = u0 is None
        accs = () if first else (u0, u1)
        on_card = be.on_device(hat, kb, ka, self._consts, *accs)
        shape = tuple(kb.shape)
        if len(shape) != 4 or shape[0] != len(self.moduli) \
                or shape[2] != shape[3]:
            raise ValueError(f"kb: shape {shape}, expected "
                             f"[{len(self.moduli)}, lanes, m, m]")
        if shape[3] % 2:
            raise ValueError(f"gl2_key_products takes an even m, not "
                             f"{shape[3]}")
        if hat.dtype != I64:
            raise TypeError(f"hat: dtype {hat.dtype}, expected {I64}")
        if tuple(hat.shape) != shape:
            raise ValueError(f"hat: shape {tuple(hat.shape)}, expected "
                             f"{shape}")
        if hat.is_contiguous():
            transposed = 0
        elif hat.transpose(-1, -2).is_contiguous():
            transposed = 1
        else:
            raise ValueError("hat: neither contiguous nor transposed in its "
                             "last two axes")
        for name, t in (("kb", kb), ("ka", ka), ("u0", u0), ("u1", u1)):
            if t is not None:
                be.check(t, name, I64, shape)
        for name, t in (("hat", hat), ("kb", kb), ("ka", ka), ("u0", u0),
                        ("u1", u1)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name}: not 16-byte aligned")
        if not on_card:
            raise ValueError("gl2_key_products runs on CUDA tensors; the "
                             "CPU route is Gl2GemmRelin._key_products_plain")
        if first:
            u0 = torch.empty(shape, dtype=I64, device=kb.device)
            u1 = torch.empty(shape, dtype=I64, device=kb.device)
        be.launch("gl2_key_products", "mf_gl2_key_products", kb.device, hat,
                  kb, ka, u0, u1, self._consts, shape[0], shape[1], shape[2],
                  transposed, int(first))
        return u0, u1
