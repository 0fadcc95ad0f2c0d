"""The controls and the planted faults of the comparison that decides
`correct`, each run through the whole harness (not by the benchmark's own
runs):

    python -m fhebench.control --workload ref.relin --mode control \
        --seeds 11,12,13 --seconds 5

prints one line of readings a seed ({"seed", "mode", "correct", "checks"}).
--mode sound runs the program as it is, so one process reads a dozen seeds.

Controls (the program with a lower-precision step in place):
  relin      the key switch's modular products (modmath.mul_mod and the
             base conversion's) computed in float64, the precision below
             the configuration's exact 64-bit words;
  roundtrip  the Encoder's encode and decode replaced by the reference's
             codec in complex64 (float32), below the stated float64;
  matmul     the Delta^2 decode's transforms replaced by the reference's
             codec in complex64, after the program's exact compose.
Faults: "unchanged" (a step returns its input), "half" (half of the 512
lanes left out), "altered" (one value of the answer changed where it is
produced); a run on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from unittest import mock

import torch

W_AXIS = 1      # the lane axis of [L, W, y, x] residues
OUT_W_AXIS = 0  # the lane axis of decoded [W, n, n] matrices


def _fmul(a, b, q):
    """a * b mod q through a float64 product: wrong in the low bits."""
    r = torch.remainder(a.to(torch.float64) * b.to(torch.float64),
                        q.to(torch.float64))
    return r.to(torch.int64).clamp(min=0) % q


@contextlib.contextmanager
def relin_control():
    from matrix_fhe_tpu_torch.ops import modmath, rns_ext
    with mock.patch.object(modmath, "mul_mod", _fmul), \
            mock.patch.object(rns_ext, "mul_mod", _fmul):
        yield


def _codec32(cfg, device, delta):
    from .reference.scheme import Codec
    return Codec(cfg["n"], cfg["p"], delta, device, dtype=torch.complex64)


@contextlib.contextmanager
def roundtrip_control(cfg):
    from matrix_fhe_tpu_torch.models.batched_encoder import BatchedEncoder
    from matrix_fhe_tpu_torch.models.rng import llround

    def encode(be, m_re, m_im):
        codec = _codec32(cfg, m_re.device, 2.0 ** cfg["delta_bits"])
        cr, ci = codec.encode(m_re, m_im)
        q = torch.tensor(cfg["moduli"], dtype=torch.int64,
                         device=m_re.device).reshape(-1, 1, 1, 1)
        return tuple(llround(c.to(torch.float64))[None] % q for c in (cr, ci))

    def decode(be, f2):
        return tuple(t.to(torch.float64) for t in
                     _codec32(cfg, f2.device, 1.0).decode(f2[:, 0], f2[:, 1]))

    with mock.patch.object(BatchedEncoder, "encode_to_wcoeff", encode), \
            mock.patch.object(BatchedEncoder, "decode_composed", decode):
        yield


@contextlib.contextmanager
def matmul_control(cfg):
    from matrix_fhe_tpu_torch.models.batched_encoder import BatchedEncoder
    orig = BatchedEncoder.decode_from_wntt_eval

    def decode(be, ev_re, ev_im, delta_override=None):
        if delta_override is None:
            return orig(be, ev_re, ev_im)
        fr, fi = be.encoder.dequantize_exact_delta(
            be.wt.inverse(ev_re), be.wt.inverse(ev_im), delta_override)
        return tuple(t.to(torch.float64) for t in
                     _codec32(cfg, fr.device, 1.0).decode(fr, fi))

    with mock.patch.object(BatchedEncoder, "decode_from_wntt_eval", decode):
        yield


def _half(x: torch.Tensor, axis: int) -> torch.Tensor:
    x = x.clone()
    x.narrow(axis, x.shape[axis] // 2, x.shape[axis] - x.shape[axis] // 2
             ).zero_()
    return x


def _bump(x: torch.Tensor, by) -> torch.Tensor:
    x = x.contiguous().clone()
    x.view(-1)[0] += by
    return x


@contextlib.contextmanager
def relin_fault(fault: str):
    from matrix_fhe_tpu_torch import Ciphertext, RelinContext
    orig = RelinContext.multiply_relinearize

    def mr(rc, ct1, ct2, rlk):
        if fault == "unchanged":
            return ct1
        ct = orig(rc, ct1, ct2, rlk)
        if fault == "half":
            return Ciphertext(_half(ct.b, W_AXIS), _half(ct.a, W_AXIS))
        q0 = int(rc.q_moduli[0])
        b = _bump(ct.b, 1)
        b.view(-1)[0] %= q0
        return Ciphertext(b, ct.a)

    with mock.patch.object(RelinContext, "multiply_relinearize", mr):
        yield


@contextlib.contextmanager
def _decoded_fault(cls, name, fault):
    """A decode whose answer loses half its lanes or one value."""
    orig = getattr(cls, name)

    def f(self, *args, **kw):
        out = orig(self, *args, **kw)
        if fault == "half":
            return tuple(_half(o, OUT_W_AXIS) for o in out)
        return (_bump(out[0], 1e-3), out[1])

    with mock.patch.object(cls, name, f):
        yield


def roundtrip_fault(fault: str):
    from matrix_fhe_tpu_torch import HEContext
    from matrix_fhe_tpu_torch.models.batched_encoder import BatchedEncoder
    if fault == "unchanged":      # decrypt returns b, its input, as it is
        return mock.patch.object(
            HEContext, "decrypt_pair_to_eval",
            lambda ctx, ct_re, ct_im, sk: (ct_re.b, ct_im.b))
    return _decoded_fault(BatchedEncoder, "decode_from_wntt_eval", fault)


def matmul_fault(fault: str):
    from matrix_fhe_tpu_torch import HEMatmul
    if fault == "unchanged":      # the decrypt leaves the tensor's E0 as is
        def decrypt_fn(hm, tt, sk):
            return tt.e0_re.transpose(-1, -2), tt.e0_im.transpose(-1, -2)
        return mock.patch.object(HEMatmul, "decrypt_fn", decrypt_fn)
    return _decoded_fault(HEMatmul, "decrypt_and_decode", fault)


FAULTS = ("unchanged", "half", "altered")


def patch(kind: str, mode: str, cfg: dict):
    """The context in which a run of `kind` is the control or a fault."""
    if mode == "sound":
        return contextlib.nullcontext()
    if mode == "control":
        return {"relin": lambda: relin_control(),
                "roundtrip": lambda: roundtrip_control(cfg),
                "matmul": lambda: matmul_control(cfg)}[kind]()
    if mode in FAULTS:
        return {"relin": relin_fault, "roundtrip": roundtrip_fault,
                "matmul": matmul_fault}[kind](mode)
    raise ValueError(f"unknown mode {mode!r}")


def run(workload, mode, seed, seconds, device="cuda", cfg=None,
        traffic=None) -> dict:
    from .run import cell, run_cell
    t_start = time.perf_counter()
    _, _, cfg_file, traffic_file = cell(workload)
    cfg, traffic = cfg or cfg_file, traffic or traffic_file
    with patch(traffic["kind"], mode, cfg):
        res = run_cell(workload, seed, seconds, False, device=device,
                       cfg=cfg, traffic=traffic, t_start=t_start)
    return {"seed": seed, "mode": mode, "correct": res["correct"],
            "checks": res["checks"], "metrics": res["metrics"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="control",
                    choices=("sound", "control") + FAULTS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fhebench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(args.workload, args.mode, seed, args.seconds)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
