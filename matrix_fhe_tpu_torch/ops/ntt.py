"""X-axis NTT (degree-n polynomial axis) as exact modular matmuls.

Counterpart of matrix_fhe_tpu/ops/ntt.py (XNTT) on int64 residues.  A full
X transform is one batched [rows, n] @ [n, n]^T modular matmul per limb
(kernel K1, side "right"), and mul_s is the fused
iNTT_X(NTT_X(a) (*) s) of encrypt and decrypt (kernel K2).  The "gl2"
ring is the GL ring's integral double form Z[X]/(X^{2n}+1), a 2n-point
transform with the same kernels.  forward_mul fuses the forward transform
with a pointwise product in storage form (kernel K10a's twiddle).  The
TPU's 128-lane block-diagonal packing has no counterpart: it only filled
the TPU's vector lanes.  wrap_constant and apply_gl_perm are the
reference's ring constant and slot permutation, for tests and oracles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GLParams
from ..tables import GLTables, build_gl2_x_tables, build_tables
from .cuda_ntt import NttMulNtt, Stage

RING_NEGACYCLIC = "nega"  # X^n + 1 (production / phantom parity ring)
RING_GL = "gl"            # X^n = psi4n^n (= +-i) GL twist ring
RING_GL2 = "gl2"          # the GL ring's integral double form X^{2n} + 1


class XNTT:
    """Forward/inverse length-n (gl2: 2n) transform along the trailing axis
    of [L, ..., n] int64 residues, batched over everything else."""

    def __init__(self, params: GLParams, ring: str = RING_NEGACYCLIC,
                 tables: GLTables | None = None, *, device):
        t = tables or build_tables(params)
        if ring == RING_NEGACYCLIC:
            fwd, inv = t.x_fwd_nega, t.x_inv_nega
        elif ring == RING_GL:
            fwd, inv = t.x_fwd_gl, t.x_inv_gl
        elif ring == RING_GL2:
            fwd, inv = build_gl2_x_tables(t)
        else:
            raise ValueError(f"unknown ring {ring!r}")
        self.params = params
        self.ring = ring
        self._psi4n = tuple(int(v) for v in t.psi4n)
        self._fwd = Stage(fwd, params.moduli, "right", device)
        self._inv = Stage(inv, params.moduli, "right", device)
        self._mul_s = NttMulNtt(fwd, inv, params.moduli, device)

    @staticmethod
    def _apply(stage: Stage, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        return stage(flat).reshape(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(self._fwd, x)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(self._inv, x)

    def forward_mul(self, x: torch.Tensor, tw_mont: torch.Tensor
                    ) -> torch.Tensor:
        """NTT_X(x) (*) tw pointwise in one launch (K10a's twiddle): x
        [L, ..., n] X-coefficients, tw_mont [L, ..., n] in the X-NTT domain
        and storage form tw * 2^64 mod q, whose rows repeat over x's rows
        (one row [L, 1, n] broadcasts over all of them)."""
        L, n = x.shape[0], x.shape[-1]
        flat = x.reshape(L, -1, n).contiguous()
        tw = tw_mont.reshape(L, -1, n).contiguous()
        return self._fwd(flat, twiddle_mont=tw).reshape(x.shape)

    def mul_s(self, a: torch.Tensor, s_mont: torch.Tensor) -> torch.Tensor:
        """t = iNTT_X(NTT_X(a) (*) s): a [L, W, ..., n] X-coefficients,
        s_mont [L, W, n] in X-NTT domain and storage form s * 2^64 mod q,
        broadcast over the axes between W and n."""
        L, n = a.shape[0], a.shape[-1]
        rows = a.reshape(L, -1, n).contiguous()
        return self._mul_s(rows, s_mont.contiguous()).reshape(a.shape)

    def wrap_constant(self, limb: int) -> int:
        """The X^n wraparound constant of this ring mod q_limb: q - 1 for
        negacyclic and for gl2 (X^{2n} = -1, a double-degree negacyclic
        ring), psi4n^n for GL (test_custom_ntt_roundtrip.cu:260-261)."""
        q = int(self.params.moduli[limb])
        if self.ring in (RING_NEGACYCLIC, RING_GL2):
            return q - 1
        return pow(self._psi4n[limb], self.params.n, q)


def apply_gl_perm(x: torch.Tensor, perm) -> torch.Tensor:
    """Permute the trailing axis: out[..., perm[j]] = x[..., j].

    Mirrors gl_perm_kernel (ntt_core.cu:258-269); pass tables.gl_perm for
    the forward 5^j-orbit -> bit-reversed mapping and tables.gl_inv_perm to
    undo it (apply_gl_perm wrapper, ntt_core.cu:433-441)."""
    p = np.asarray(perm)
    gather = np.empty_like(p, dtype=np.int64)
    gather[p] = np.arange(p.size)          # out[..., i] = x[..., gather[i]]
    return x.index_select(-1, torch.from_numpy(gather).to(x.device))
