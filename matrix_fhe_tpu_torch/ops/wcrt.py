"""W-axis transforms: mod-q W-CRT and the complex W-DFT words entry points.

Counterpart of matrix_fhe_tpu/ops/wcrt.py (WTransform) on the port's one
route: the W-CRT forward and inverse are kernel K1 (side "left"), the
scaled W-CRT inverse fused with the CRT compose is kernel K3, and the
512-point complex W-DFT / IDFT run as exact fixed-point matmuls on words
(kernel K4).  The inverse and the exact big-int composer serve the
Delta^2-scaled decode of homomorphic products.

Layout is limb-major [L, W, ...] as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GLParams
from ..tables import GLTables, build_tables
from .crt import CRTComposer
from .cuda_ntt import InvCompose, Stage
from .ddfloat import compose_tail_from_partials
from .fpmatmul import ExactComplexMatmul
from .modmath import moduli_col, mul_mod


def scaled_inverse_tables(tables: GLTables) -> np.ndarray:
    """W-CRT inverse tables with M_l^-1 mod q_l folded in, [L, W, W]."""
    moduli = tables.params.moduli
    w_inv = torch.from_numpy(tables.w_inv.view(np.int64))
    crt_inv = torch.from_numpy(tables.crt_inv.view(np.int64)).reshape(-1, 1, 1)
    scaled = mul_mod(w_inv, crt_inv, moduli_col(moduli, 2, "cpu"))
    return scaled.numpy().view(np.uint64)


class WTransform:
    """Forward W-CRT over all RNS limbs, the fused scaled inverse +
    compose, and the fixed-point W-DFT words transforms."""

    def __init__(self, params: GLParams, tables: GLTables | None = None, *,
                 device):
        t = tables or build_tables(params)
        self.params = params
        self._fwd = Stage(t.w_fwd, params.moduli, "left", device)
        self._inv = Stage(t.w_inv, params.moduli, "left", device)
        self.composer = CRTComposer(t)
        self.big_q = params.q_total
        self._inv_compose = InvCompose(scaled_inverse_tables(t),
                                       params.moduli, self.big_q, device)
        self._fp_dft = ExactComplexMatmul(t.wdft, device)
        self._fp_idft = ExactComplexMatmul(t.wdft_inv, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[L, W, ...] coeff -> eval (out[w] = sum_r V[w, r] x[r])."""
        L, W = x.shape[0], x.shape[1]
        return self._fwd(x.reshape(L, W, -1).contiguous()).reshape(x.shape)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """[L, W, ...] eval -> coeff (out[r] = sum_w V^-1[r, w] x[w])."""
        L, W = x.shape[0], x.shape[1]
        return self._inv(x.reshape(L, W, -1).contiguous()).reshape(x.shape)

    def inverse_scaled_compose(self, x: torch.Tensor,
                               delta: float) -> torch.Tensor:
        """Eval residues [L, W, ...] -> centered CRT compose / delta, f64
        [W, ...] (the W-CRT inverse and the compose in one kernel)."""
        L, W = x.shape[0], x.shape[1]
        acc, k = self._inv_compose(x.reshape(L, W, -1).contiguous())
        out = compose_tail_from_partials(acc, k, self.big_q, delta)
        return out.reshape(x.shape[1:])

    def dft_inverse_words_w(self, words_re, words_im, e_scale):
        """W-IDFT chained on upstream fixed-point words ([W, M] planes)."""
        return self._fp_idft.call_words_w(words_re, words_im, e_scale)

    def dft_forward_pair(self, re: torch.Tensor, im: torch.Tensor):
        """W-DFT of an f64 pair [W, ...] coeff -> eval, reconstructed to f64
        (ExactComplexMatmul.__call__, the JAX fixed-point route)."""
        W = re.shape[0]
        yr, yi = self._fp_dft(re.reshape(W, -1).to(torch.float64),
                              im.reshape(W, -1).to(torch.float64))
        return yr.reshape(re.shape), yi.reshape(re.shape)

    def dft_inverse_pair(self, re: torch.Tensor, im: torch.Tensor):
        """W-IDFT of an f64 pair [W, ...] eval -> coeff, reconstructed to
        f64 (the JAX dft_inverse_pair on its fixed-point route)."""
        W = re.shape[0]
        yr, yi = self._fp_idft(re.reshape(W, -1).to(torch.float64),
                               im.reshape(W, -1).to(torch.float64))
        return yr.reshape(re.shape), yi.reshape(re.shape)

    def dft_forward_words(self, re: torch.Tensor, im: torch.Tensor):
        """W-DFT of an f64 pair [W, ...] as fixed-point words [W, M]."""
        W = re.shape[0]
        return self._fp_dft.call_words(re.reshape(W, -1), im.reshape(W, -1))
