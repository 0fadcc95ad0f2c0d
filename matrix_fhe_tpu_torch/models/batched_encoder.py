"""Batched encoder: W complex matrices <-> W-CRT-eval packed plaintext.

Counterpart of matrix_fhe_tpu/models/batched_encoder.py on int64 residues,
with the JAX package's fast route as the only route (encode_pair /
decode_pair there):

  encode: XY-IDFT sandwich (K4) -> W-IDFT (K4) -> quantize on the words
          -> mod-q W-CRT forward (K1); for a Delta that is not a power of
          two, the sandwich and the W-IDFT reconstruct f64 and the quantize
          is llround(c Delta) mod q, as encode_pair there
  decode: scaled W-CRT inverse fused with the CRT compose (K3) -> W-DFT
          (K4) -> XY-DFT sandwich (K4) -> one f64 reconstruction
  decode with delta_override (Delta^2-scaled homomorphic products, whose
          values pass 2^63 where K3's mod-2^64 compose cannot follow):
          W-CRT inverse (K1) -> exact big-int compose / delta -> W-DFT (K4)
          -> XY-DFT sandwich (K4), as batched_encoder.py:56-78 there

Layout is limb-major [L, W, n, n].
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import GLParams
from ..ops.wcrt import WTransform
from ..tables import GLTables, build_tables
from ..utils.profiler import span
from .encoder import Encoder


class BatchedEncoder:
    def __init__(self, params: GLParams, tables: GLTables | None = None,
                 wt: WTransform | None = None, *, device):
        t = tables or build_tables(params)
        self.params = params
        self.encoder = Encoder(params, t, device=device)
        self.wt = wt or WTransform(params, t, device=device)

    def encode_to_wcoeff(self, m_re: torch.Tensor, m_im: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[W, n, n] f64 pair -> ([L, W, n, n], [L, W, n, n]) int64 in the
        W-coefficient domain, the encode before its W-CRT forward: on the
        words when Delta is a power of two, else by llround(c Delta) mod q
        after the f64 sandwich and W-IDFT (encode_pair there).  Each step
        here depends on every matrix row y (the XY-IDFT contracts them, the
        fixed-point exponents are maxima over the whole message); the
        W-CRT forward after it takes each row alone."""
        if not self.encoder.words_route:
            with span("encode.sandwich"):
                xr, xi = self.encoder.idft2_exact(m_re, m_im)
            with span("encode.widft"):
                fr, fi = self.wt.dft_inverse_pair(xr, xi)
            with span("encode.quantize"):
                return self.encoder.quantize(fr, fi)
        W = m_re.shape[0]
        with span("encode.sandwich"):
            wr, wi, e = self.encoder.idft2_words(m_re, m_im)
        flat_r = tuple(w.reshape(W, -1) for w in wr)
        flat_i = tuple(w.reshape(W, -1) for w in wi)
        with span("encode.widft"):
            wr2, wi2, e2 = self.wt.dft_inverse_words_w(flat_r, flat_i, e)
        with span("encode.quantize"):
            rr, ri = self.encoder.quantize_words(wr2, wi2, e2)
        shape = (rr.shape[0],) + tuple(m_re.shape)
        return rr.reshape(shape), ri.reshape(shape)

    def encode_to_wntt_eval(self, m_re: torch.Tensor, m_im: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[W, n, n] f64 pair -> ([L, W, n, n], [L, W, n, n]) int64:
        encode_to_wcoeff, then the W-CRT forward (K1)."""
        with span("encode"):
            rr, ri = self.encode_to_wcoeff(m_re, m_im)
            with span("encode.wcrt"):
                return self.wt.forward(rr), self.wt.forward(ri)

    def decode_from_wntt_eval(self, ev_re: torch.Tensor, ev_im: torch.Tensor,
                              delta_override: float | None = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inverse of encode_to_wntt_eval: [L, W, n, n] int64 pair ->
        [W, n, n] f64 pair, divided by delta_override instead of Delta when
        one is given."""
        with span("decode"):
            if delta_override is None:
                return self.decode_composed(self.compose_pair(ev_re, ev_im))
            with span("decode.wcrt_inverse"):
                wr, wi = self.wt.inverse(ev_re), self.wt.inverse(ev_im)
            with span("decode.compose_exact"):
                fr, fi = self.encoder.dequantize_exact_delta(wr, wi,
                                                             delta_override)
            del wr, wi
            with span("decode.wdft"):
                xr, xi = self.wt.dft_forward_pair(fr, fi)
            with span("decode.sandwich"):
                return self.encoder.dft2_exact(xr, xi)

    def compose_pair(self, ev_re: torch.Tensor, ev_im: torch.Tensor
                     ) -> torch.Tensor:
        """The decode's first step, K3: [L, W, ...] int64 pair -> the
        centered CRT compose / Delta, f64 [W, 2, ...] (re, im), element by
        element of the trailing axes."""
        with span("decode.compose"):
            both = torch.stack([ev_re, ev_im], dim=2)
            return self.wt.inverse_scaled_compose(both, self.params.delta)

    def decode_composed(self, f2: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rest of the decode: W-DFT and XY-DFT (K4) of compose_pair's
        [W, 2, n, n] -> [W, n, n] f64 pair.  It depends on every matrix row
        y, as the encode's first steps do."""
        fr, fi = f2[:, 0], f2[:, 1]
        with span("decode.wdft"):
            wr, wi, e = self.wt.dft_forward_words(fr, fi)
        wr = tuple(w.reshape(fr.shape) for w in wr)
        wi = tuple(w.reshape(fr.shape) for w in wi)
        with span("decode.sandwich"):
            return self.encoder.dft2_words_in(wr, wi, e)

    def unpack_eval(self, ev_re: torch.Tensor, ev_im: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Identity passthrough (unpack_eval_p17 degenerated to a copy,
        batched_encoder.cu:230-243)."""
        return ev_re, ev_im

    # the JAX package's names for its fast route
    encode_pair = encode_to_wntt_eval
    decode_pair = decode_from_wntt_eval
