"""Large-N negacyclic NTT via the four-step (Bailey) factorization.

Counterpart of matrix_fhe_tpu/ops/ntt_large.py (FourStepNTT) on int64
residues.  N = n1 * n2 and, on [L, B, N] with x[i1 * n2 + i2]:

    twist:   x *= psi^i                      (negacyclic only, psi^N = -1)
    stage 1: y[i2, k1] = sum_i1 x[i1, i2] w1^(i1 k1)   (cyclic DFT_n1)
    twiddle: y[i2, k1] *= w_N^(i2 k1)
    stage 2: z[k1, k2] = sum_i2 y[i2, k1] w2^(i2 k2)   (cyclic DFT_n2)

The forward output is in four-step order, out[k1 * n2 + k2]; the inverse
consumes that order and returns natural order.  The roots come from the
smallest primitive root of each modulus, as in the JAX package, so the
spectra are the same integers.

On a CUDA tensor, kernel K5 (csrc/four_step_ntt.cu) computes the whole
forward or inverse of a plan with n1 == n2, with Shoup products on 64-bit
words, or on 32-bit words when every modulus is below 2^30 (`word_bits`);
a plan with n1 != n2 (N = 2^13, 2^15, 2^17, ...) takes the stage route,
FourStepStages: K10a's twiddle form for stage 1 and its twiddle, K1 for
stage 2, the twist and the inverse's post-scale by mul_mod.  The same
stages are one rank's part of the coefficient-sharded transform
(parallel/dist_ntt.py).  A CPU tensor takes the plain version, which
follows the JAX stages as exact float64-digit modular matmuls
(ops/modmatmul.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..config import generate_primes_1mod  # noqa: F401  (the JAX module's export)
from . import _backend as be
from .cuda_ntt import Stage
from .modmath import moduli_col, mul_mod, powers, to_mont
from .modmatmul import modmatmul

I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class FourStepPlan:
    n: int
    n1: int
    n2: int
    moduli: Tuple[int, ...]
    negacyclic: bool = True

    @staticmethod
    def make(n: int, moduli: Sequence[int], negacyclic: bool = True,
             n1: int | None = None) -> "FourStepPlan":
        if n & (n - 1):
            raise ValueError("N must be a power of two")
        if n1 is None:
            half = n.bit_length() - 1
            n1 = 1 << (half // 2)
        return FourStepPlan(n=n, n1=n1, n2=n // n1,
                            moduli=tuple(int(q) for q in moduli),
                            negacyclic=negacyclic)


def _find_generator(q: int) -> int:
    """Smallest primitive root mod prime q (exact factorization of q-1)."""
    phi = q - 1
    fac = _factorize(phi)
    for g in range(2, 1 << 20):
        if all(pow(g, phi // f, q) != 1 for f in fac):
            return g
    raise ValueError("no generator found")


@functools.lru_cache(maxsize=None)
def _factorize(x: int) -> Tuple[int, ...]:
    fs = []
    d = 2
    while d * d <= x:
        if x % d == 0:
            fs.append(d)
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        fs.append(x)
    return tuple(fs)


def _limb_tables(plan: FourStepPlan, q: int) -> Dict[str, np.ndarray]:
    """One limb's tables (canonical, not Montgomery), as uint64 arrays."""
    n, n1, n2 = plan.n, plan.n1, plan.n2
    order = 2 * n if plan.negacyclic else n
    if (q - 1) % order:
        raise ValueError(f"modulus {q} lacks order-{order} root")
    g = _find_generator(q)
    pw = powers(pow(g, (q - 1) // n, q), n, q)       # w_N^e, e < N
    a1, a2 = np.arange(n1), np.arange(n2)
    out = {
        # stage tables t[k, i] = w^(+-k i); w1 = w_N^n2, w2 = w_N^n1
        "t1f": pw[(np.outer(a1, a1) % n1) * n2],
        "t1i": pw[((-np.outer(a1, a1)) % n1) * n2],
        "t2f": pw[(np.outer(a2, a2) % n2) * n1],
        "t2i": pw[((-np.outer(a2, a2)) % n2) * n1],
        # twiddles at [k1, i2]: w_N^(+-i2 k1)
        "tw_f": pw[np.outer(a1, a2) % n],
        "tw_i": pw[(-np.outer(a1, a2)) % n],
    }
    n_inv = pow(n, -1, q)
    if plan.negacyclic:
        ps = powers(pow(g, (q - 1) // (2 * n), q), n, q)   # psi^i, i < N
        # psi^-i = psi^(2N - i) = -psi^(N - i) for i >= 1
        ps_inv = np.concatenate([np.array([1], dtype=object),
                                 (q - ps[:0:-1]) % q])
        out["twist_f"] = ps
        out["post_i"] = ps_inv * n_inv % q
    else:
        out["post_i"] = np.full(n, n_inv, dtype=object)
    return {k: v.astype(np.uint64) for k, v in out.items()}


class FourStepNTT:
    """Batched forward/inverse NTT over [L, B, N] int64 residues on one
    device (tables live there)."""

    def __init__(self, plan: FourStepPlan, device="cuda",
                 words: int | None = None):
        """`words` is K5's word width: None takes the one the moduli call
        for (`word_bits`); 64 puts a plan of narrow moduli on the wide
        route, to compare the two."""
        self.plan = plan
        self.device = be.resolve_device(device)
        self.bits = max(int(q).bit_length() for q in plan.moduli)
        if self.bits >= 56:
            raise ValueError("moduli must be < 2^56")
        route = word_bits(plan.moduli)
        if words not in (None, 64, route):
            raise ValueError(f"K5 cannot take {words}-bit words for moduli "
                             f"of {self.bits} bits")
        self._words = words or route
        per_limb = [_limb_tables(plan, q) for q in plan.moduli]
        tabs = {k: np.stack([t[k] for t in per_limb]) for k in per_limb[0]}
        self._t = {k: torch.from_numpy(v.view(np.int64)).to(self.device)
                   for k, v in tabs.items()}
        self._q3 = moduli_col(plan.moduli, 2, self.device)
        self._q4 = moduli_col(plan.moduli, 3, self.device)

    @property
    def word_bits(self) -> int:
        """K5's route, fixed with its tables when the object is made."""
        return self._words

    # -- dispatch ----------------------------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[L, B, N] -> four-step-order spectrum [L, B, N]: K5 on a CUDA
        tensor when n1 == n2, else the stage route (K10a-tw, K1)."""
        if not be.on_device(x, self._q3):
            return self.forward_plain(x)
        if self.plan.n1 == self.plan.n2:
            return self.forward_kernel(x)
        return self.forward_stages(x)

    def inverse(self, xf: torch.Tensor) -> torch.Tensor:
        """Four-step-order spectrum -> [L, B, N] natural-order coefficients:
        K5 on a CUDA tensor when n1 == n2, else the stage route (K1)."""
        if not be.on_device(xf, self._q3):
            return self.inverse_plain(xf)
        if self.plan.n1 == self.plan.n2:
            return self.inverse_kernel(xf)
        return self.inverse_stages(xf)

    def pointwise_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Spectral pointwise product (order-independent)."""
        return mul_mod(a, b, self._q3)

    # -- plain version: the JAX stages -------------------------------------------

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        p, t = self.plan, self._t
        L, B = x.shape[0], x.shape[1]
        n1, n2 = p.n1, p.n2
        if p.negacyclic:
            x = mul_mod(x, t["twist_f"][:, None, :], self._q3)
        x = x.reshape(L, B, n1, n2).transpose(1, 2).reshape(L, n1, B * n2)
        y = modmatmul(t["t1f"], x, self._q3, self.bits, "left")  # [L, k1, (B, i2)]
        y = mul_mod(y.reshape(L, n1, B, n2), t["tw_f"].reshape(L, n1, 1, n2),
                    self._q4)
        z = modmatmul(t["t2f"], y.reshape(L, n1 * B, n2), self._q3, self.bits,
                      "right")                                   # [L, (k1, B), k2]
        return z.reshape(L, n1, B, n2).transpose(1, 2).reshape(L, B, p.n)

    def inverse_plain(self, xf: torch.Tensor) -> torch.Tensor:
        p, t = self.plan, self._t
        L, B = xf.shape[0], xf.shape[1]
        n1, n2 = p.n1, p.n2
        y = modmatmul(t["t2i"], xf.reshape(L, B * n1, n2), self._q3,
                      self.bits, "right")                        # [L, (B, k1), i2]
        y = mul_mod(y.reshape(L, B, n1, n2), t["tw_i"].reshape(L, 1, n1, n2),
                    self._q4)
        y = y.transpose(1, 2).reshape(L, n1, B * n2)              # [L, k1, (B, i2)]
        w = modmatmul(t["t1i"], y, self._q3, self.bits, "left")   # [L, i1, (B, i2)]
        x = w.reshape(L, n1, B, n2).transpose(1, 2).reshape(L, B, p.n)
        return mul_mod(x, t["post_i"][:, None, :], self._q3)      # n^-1 psi^-i

    # -- the stage route: K10a's twiddle form and K1 ------------------------------

    @functools.cached_property
    def stages(self) -> "FourStepStages":
        """The transform as two K1 stages on this object's device (tables
        built at first use)."""
        return FourStepStages(self.plan, self._t, self.device)

    def forward_stages(self, x: torch.Tensor) -> torch.Tensor:
        """forward by the stage route; on a CPU tensor the stages' plain
        versions, the same integers as forward_plain."""
        p = self.plan
        L, B = x.shape[0], x.shape[1]
        return self.stages.forward(x.reshape(L, B, p.n1, p.n2)).reshape(
            L, B, p.n)

    def inverse_stages(self, xf: torch.Tensor) -> torch.Tensor:
        """inverse by the stage route (see forward_stages)."""
        p = self.plan
        L, B = xf.shape[0], xf.shape[1]
        return self.stages.inverse(xf.reshape(L, B, p.n1, p.n2)).reshape(
            L, B, p.n)

    # -- kernel K5 ---------------------------------------------------------------

    @functools.cached_property
    def _kernel_tables(self) -> Dict[str, torch.Tensor]:
        """The kernel's tables as Shoup pairs on its route (`shoup_pairs`):
        the DFT roots w_m^(+-e), e < m, the element-wise products and the
        moduli."""
        p = self.plan
        if p.n1 != p.n2:
            raise ValueError(f"kernel K5 needs n1 == n2 (plan {p.n1} x {p.n2})")
        # row 1 of the stage tables: w1^(+-e), e < m
        tabs = {"roots_f": self._t["t1f"][:, 1], "roots_i": self._t["t1i"][:, 1],
                "tw_f": self._t["tw_f"], "tw_i": self._t["tw_i"],
                "post_i": self._t["post_i"]}
        if p.negacyclic:
            tabs["twist_f"] = self._t["twist_f"]
        out = {k: shoup_pairs(v, p.moduli, self.word_bits).to(self.device)
               for k, v in tabs.items()}
        out["moduli"] = torch.tensor(p.moduli, dtype=I64, device=self.device)
        return out

    def _launch(self, name: str, x: torch.Tensor, col_first: bool,
                pass_a, pass_b) -> torch.Tensor:
        p = self.plan
        k = self._kernel_tables
        L, B = len(p.moduli), (x.shape[1] if x.dim() == 3 else -1)
        be.check(x, "x", I64, (L, B, p.n))
        if B > 65535:
            raise ValueError(f"batch {B} exceeds the kernel grid (65535)")
        out = torch.empty_like(x)
        be.launch(name, "mf_four_step", x.device, x, out, k["moduli"], L, B,
                  p.n1, int(col_first), self.word_bits, *pass_a, *pass_b)
        return out

    def forward_kernel(self, x: torch.Tensor) -> torch.Tensor:
        k = self._kernel_tables
        # pass A: columns, psi^i before the DFT, w_N^(i2 k1) after; pass B: rows
        return self._launch("four_step_fwd", x, True,
                            (k["roots_f"], k.get("twist_f"), k["tw_f"]),
                            (k["roots_f"], None, None))

    def inverse_kernel(self, xf: torch.Tensor) -> torch.Tensor:
        k = self._kernel_tables
        # pass A: rows, w_N^-(i2 k1) after; pass B: columns, n^-1 psi^-i after
        return self._launch("four_step_inv", xf, False,
                            (k["roots_i"], None, k["tw_i"]),
                            (k["roots_i"], None, k["post_i"]))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _local_exchange(y: torch.Tensor) -> torch.Tensor:
    """The exchange of a one-rank transform: [L, B, a, 1, b] -> [1, L, B,
    a, b], no communication."""
    return y.permute(3, 0, 1, 2, 4).contiguous()


class FourStepStages:
    """The four-step transform as two exact modular-matmul stages, for
    rank r of d ranks that split the coefficients (d = 1: the whole
    transform on one device).  With N = n1 n2 and the [n1, n2] view
    x[i1, i2] = x[i1 n2 + i2], the rank holds the columns
    i2 in [r n2/d, (r + 1) n2/d):

      forward, on [L, B, n1, n2/d]:
        twist     x *= psi^(i1 n2 + i2)         (negacyclic only, mul_mod)
        stage 1   y[i2, k1] = sum_i1 x[i1, i2] w1^(i1 k1), times the
                  twiddle w_N^(i2 k1): one launch of K10a's twiddle form
                  (Stage side 'right' on the [L, B n2/d, n1] rows)
        exchange  k1 blocks out, i2 blocks in (`exchange`)
        stage 2   z[k1, k2] = sum_i2 y[i2, k1] w2^(i2 k2): K1 on the
                  [L, B n1/d, n2] rows
      giving the k1 rows [L, B, n1/d, n2] of the four-step-order spectrum;

      inverse, on those rows: K1 (stage 2's inverse), the twiddle
      w_N^-(i2 k1) by mul_mod, the exchange back, K1 (stage 1's inverse)
      and n^-1 psi^-i by mul_mod, back to [L, B, n1, n2/d] natural-order
      coefficients.

    `exchange` maps [L, B, a, d, b], block j of axis 3 going to rank j, to
    [d, L, B, a, b] with block j from rank j; None is d = 1's identity.
    `tables` are FourStepNTT's canonical tables (any device), so the
    spectrum is the same integers as forward_plain's.  A CPU tensor runs
    the stages' plain versions, a CUDA tensor the kernels."""

    def __init__(self, plan: FourStepPlan, tables: Dict[str, torch.Tensor],
                 device, d: int = 1, r: int = 0, exchange=None):
        if plan.n1 % d or plan.n2 % d:
            raise ValueError(f"n1 = {plan.n1} and n2 = {plan.n2} must be "
                             f"divisible by {d} ranks")
        if exchange is None and d != 1:
            raise ValueError("a transform over several ranks needs an exchange")
        self.plan, self.d = plan, d
        self._exchange = exchange or _local_exchange
        n1, n2 = plan.n1, plan.n2
        c, r1 = n2 // d, n1 // d
        cols, krows = slice(r * c, (r + 1) * c), slice(r * r1, (r + 1) * r1)
        L, q = len(plan.moduli), plan.moduli
        self.st = {k: Stage(_u64(tables[k]), q, "right", device)
                   for k in ("t1f", "t2f", "t1i", "t2i")}
        # stage 1's twiddle at [i2 local, k1], in storage form tw * 2^64
        tw_f = tables["tw_f"][:, :, cols].transpose(1, 2).contiguous()
        self.tw_f = to_mont(tw_f.cpu(), q).to(device)
        self._tw_i = tables["tw_i"][:, krows, :].reshape(L, 1, r1, n2).to(
            device)

        def local_cols(v):          # [L, N] -> [L, 1, n1, n2/d] on the device
            return v.reshape(L, 1, n1, n2)[..., cols].contiguous().to(device)

        self._twist = local_cols(tables["twist_f"]) if plan.negacyclic \
            else None
        self._post = local_cols(tables["post_i"])
        self._q4 = moduli_col(q, 3, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """i2 columns [L, B, n1, n2/d] -> k1 rows [L, B, n1/d, n2] of the
        four-step-order spectrum."""
        p, d = self.plan, self.d
        L, B = x.shape[0], x.shape[1]
        c, r1 = p.n2 // d, p.n1 // d
        if tuple(x.shape) != (L, B, p.n1, c):
            raise ValueError(f"block {tuple(x.shape)} is not [L, B, "
                             f"{p.n1}, {c}]")
        if self._twist is not None:
            x = mul_mod(x, self._twist, self._q4)
        rows = x.transpose(2, 3).reshape(L, B * c, p.n1).contiguous()
        y = self.st["t1f"](rows, twiddle_mont=self.tw_f)   # [L, (B, i2), k1]
        y = self._exchange(y.reshape(L, B, c, d, r1))      # [j, L, B, i2, k1]
        y = y.permute(1, 2, 4, 0, 3).reshape(L, B * r1, p.n2)
        return self.st["t2f"](y.contiguous()).reshape(L, B, r1, p.n2)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """k1 rows [L, B, n1/d, n2] of the spectrum -> i2 columns
        [L, B, n1, n2/d] of natural-order coefficients."""
        p, d = self.plan, self.d
        L, B = z.shape[0], z.shape[1]
        c, r1 = p.n2 // d, p.n1 // d
        if tuple(z.shape) != (L, B, r1, p.n2):
            raise ValueError(f"block {tuple(z.shape)} is not [L, B, "
                             f"{r1}, {p.n2}]")
        y = self.st["t2i"](z.reshape(L, B * r1, p.n2).contiguous())
        y = mul_mod(y.reshape(L, B, r1, p.n2), self._tw_i, self._q4)
        y = self._exchange(y.reshape(L, B, r1, d, c))      # [j, L, B, k1, i2]
        y = y.permute(1, 2, 4, 0, 3).reshape(L, B * c, p.n1)
        w = self.st["t1i"](y.contiguous())                 # [L, (B, i2), i1]
        w = w.reshape(L, B, c, p.n1).transpose(2, 3)
        return mul_mod(w, self._post, self._q4)


def word_bits(moduli: Sequence[int]) -> int:
    """K5's route: 32-bit words when every modulus is below 2^30 (so the
    lazy range 4q fits), else 64-bit words (q < 2^56)."""
    return 32 if max(int(q) for q in moduli) < 1 << 30 else 64


def shoup_pairs(table: torch.Tensor, moduli: Sequence[int], bits: int
                ) -> torch.Tensor:
    """A canonical [L, ...] table as K5's Shoup pairs, int64 on the CPU: on
    the 64-bit route [L, ..., 2] (w, floor(w 2^64 / q)), on the 32-bit
    route [L, ...] holding w | floor(w 2^32 / q) << 32.  w' is exact: a long
    division one byte at a time, where r 2^8 < q 2^8 < 2^64 (q < 2^56)
    never leaves uint64."""
    w = table.cpu().numpy().view(np.uint64)
    q = np.asarray(moduli, dtype=np.uint64).reshape((-1,) + (1,) * (w.ndim - 1))
    r, wp = w.copy(), np.zeros(w.shape, dtype=np.uint64)
    for _ in range(bits // 8):
        r = r << np.uint64(8)
        d = r // q
        r = r - d * q
        wp = (wp << np.uint64(8)) | d
    if bits == 64:
        pairs = np.stack([w, wp], axis=-1)
    else:
        pairs = w | (wp << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(pairs).view(np.int64))
