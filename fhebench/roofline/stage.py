"""Work of one call of the stage kernel (K1, and K10a with a twiddle):
out[l] = T[l] x D[l] mod q_l, an exact modular matmul a limb.

Operations are the u8 digit products of the digit-plane method, counted
from the shapes and the moduli alone: 2 x outputs x (d_l K) x d_l a limb,
d_l = ceil(bits(q_l) / 8) the digits of a residue, K the contraction.
The count is the function's, whatever kernel computes it.  Bytes count
each int64 input (data, table, twiddle) read once and the output written
once.
"""

from __future__ import annotations

from typing import Sequence

from . import peaks


def digits(q: int) -> int:
    return -(-int(q).bit_length() // 8)


def work(moduli: Sequence[int], table_shape, data_elems: int,
         out_elems: int, twiddle_elems: int = 0) -> dict:
    """{"int8": digit products, "bytes": bytes} of one call; table_shape
    is [L, W, K]."""
    L, W, K = table_shape
    outs = out_elems // L                       # outputs of one limb
    int8 = sum(2 * outs * digits(q) * K * digits(q) for q in moduli)
    nbytes = 8 * (data_elems + out_elems + L * W * K + twiddle_elems)
    return {"int8": int8, "bytes": nbytes}


def bound_s(call: dict) -> float:
    """The least time the card could take for one recorded call."""
    w = work(call["moduli"], call["table"], call["data_elems"],
             call["out_elems"], call.get("twiddle_elems", 0))
    return max(w["bytes"] / peaks.HBM_BYTES_PER_S,
               w["int8"] / peaks.INT8_OPS_PER_S)
