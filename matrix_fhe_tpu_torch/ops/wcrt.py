"""W-axis transforms: mod-q W-CRT and the complex W-DFT words entry points.

Counterpart of matrix_fhe_tpu/ops/wcrt.py (WTransform) on the port's one
route: the W-CRT forward and inverse are kernel K1 (side "left"), the
scaled W-CRT inverse fused with the CRT compose is kernel K3, and the
512-point complex W-DFT / IDFT run as exact fixed-point matmuls on words
(kernel K4).  The inverse and the exact big-int composer serve the
Delta^2-scaled decode of homomorphic products.  The scaled inverse alone
(inverse_scaled) is K1 on K3's scaled tables, and the reference's centered
int64 oracle (forward_centered, inverse_centered) runs K1 with the exact
compose.

Layout is limb-major [L, W, ...] as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import GLParams
from ..tables import GLTables, build_tables
from .crt import CRTComposer, centered_i64_to_rns
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

    def inverse_scaled(self, x: torch.Tensor) -> torch.Tensor:
        """inverse() with outputs pre-multiplied by M_l^-1 mod q_l: K1 on
        K3's scaled tables, InvCompose's own Stage, so its launches count
        under K3's keys (inv_compose_stage or, at 256 lanes and more,
        inv_compose_stage_w; inv_compose_split)."""
        L, W = x.shape[0], x.shape[1]
        return self._inv_compose._stage(x.reshape(L, W, -1).contiguous()
                                        ).reshape(x.shape)

    # -- centered-integer path (test oracles; HE.cu:1029-1114) ----------------

    def forward_centered(self, x_centered: torch.Tensor) -> torch.Tensor:
        """int64 [W, ...] coeff -> centered int64 eval via all limbs and the
        exact CRT compose (wntt_forward_centered_kernel, HE.cu:1029-1081),
        including its int64 saturation (he_big_to_i64_checked,
        HE.cu:904-915).

        Fidelity note (as in the JAX package): per-limb eta roots are
        searched independently (HE.cu:119-133), so the composed evaluation
        is a ~Q-sized integer whenever there is more than one limb; the
        reference kernel then saturates to INT64_MAX / MIN, which breaks
        the limb-0 congruence inverse_centered relies on.  The centered
        roundtrip is exactly invertible only when Q < 2^63 (the one-limb
        "tiny1" preset); the saturation is reproduced either way."""
        rns = centered_i64_to_rns(x_centered, self.params.moduli)
        return self.composer.compose_centered_i64(self.forward(rns))

    @functools.cached_property
    def _inv0(self) -> Stage:
        """The W-CRT inverse of limb 0 alone (K1)."""
        t = self._inv.table[:1]
        return Stage(t.cpu().numpy().view(np.uint64), self.params.moduli[:1],
                     "left", t.device)

    def inverse_centered(self, x_centered: torch.Tensor) -> torch.Tensor:
        """int64 [W, ...] eval -> centered int64 coeff using limb 0 only
        (wntt_inverse_centered_kernel, HE.cu:1083-1114)."""
        q0 = int(self.params.moduli[0])
        m = torch.remainder(x_centered, q0)
        ev = self._inv0(m.reshape(1, x_centered.shape[0], -1).contiguous()
                        ).reshape(x_centered.shape)
        return torch.where(ev > q0 >> 1, ev - q0, ev)

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

    def dft_inverse_words(self, re: torch.Tensor, im: torch.Tensor):
        """W-IDFT of an f64 pair [W, ...] eval as fixed-point words [W, M]
        (dft_inverse_pair before its reconstruction to f64)."""
        W = re.shape[0]
        return self._fp_idft.call_words(re.reshape(W, -1).to(torch.float64),
                                        im.reshape(W, -1).to(torch.float64))

    def dft_forward_words(self, re: torch.Tensor, im: torch.Tensor):
        """W-DFT of an f64 pair [W, ...] as fixed-point words [W, M]."""
        W = re.shape[0]
        return self._fp_dft.call_words(re.reshape(W, -1), im.reshape(W, -1))
