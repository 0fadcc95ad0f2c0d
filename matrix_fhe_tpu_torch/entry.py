"""The top-level entry points of __graft_entry__.py, on the port.

    python -m matrix_fhe_tpu_torch.entry [--device cpu]
    python -m matrix_fhe_tpu_torch.entry --dryrun N [--device cpu]

Counterpart of __graft_entry__.py in the JAX package:

  entry()              (fn, args): fn(*args) is the flagship roundtrip
                       (encode -> encrypt -> decrypt -> decode) at the mid
                       preset (n = 64, phi = 512, 4 limbs) on the card, on
                       the reference binary's input pattern.  The command
                       runs it once and checks its error (< 1e-4).
  dryrun_multichip(n)  the JAX dryrun's four programs at the tiny preset on
                       a world of n ranks (parallel.launch.run_world, gloo:
                       ranks share the card, or the CPU with
                       device="cpu"), each with the JAX dryrun's check:
                       the dp x tp sharded roundtrip (error < 1.0), the
                       coefficient-sharded NTT at N = 1024 on 2 limbs
                       (inverse(forward(x)) == x), the W-sharded
                       multiply_relinearize (bit for bit with the
                       unsharded one) and the W-sharded gl2 GEMM with its
                       relinearization (relative error < 0.01); beside
                       them the sharded roundtrip equals roundtrip_batch,
                       the dist NTT's spectrum FourStepNTT.forward and the
                       gl2 GEMM Gl2GemmRelin.matmul, bit for bit.  A
                       failing check or rank fails the world.

Both run on the card ("cuda") unless given device="cpu"; without CUDA
they raise.  The command prints {"launches": {...}}: the kernels that the
roundtrip launched, or the dryrun's sharded calls summed over the ranks
(not their set-up, keys, encryptions or rank 0's unsharded references).
"""

from __future__ import annotations

import argparse
import collections
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import get_params
from .examples import print_launches
from .examples.main import message
from .models import rng as refrng
from .models.he import HEContext, SecretKey
from .models.he2 import Gl2Context
from .models.he_matmul2 import Gl2GemmRelin, HEMatmul2
from .models.keyswitch import RelinContext
from .ops import _backend as be
from .ops._backend import Launches
from .ops.ntt_large import FourStepNTT, FourStepPlan, generate_primes_1mod
from .parallel import launch
from .parallel import mesh as meshlib
from .parallel.dist_ntt import DistFourStepNTT
from .parallel.gl2 import ShardedGl2Gemm
from .parallel.keyswitch import ShardedKeySwitch
from .scripts.bench_dist import rank_pipeline
from .utils.timing import clock, sync

ENTRY_PRESET = "mid"
ENTRY_TOL = 1e-4
DRYRUN_PRESET = "tiny"
DRYRUN_NTT_N, DRYRUN_NTT_LIMBS = 1024, 2
WORLD_S = 600.0


def entry(device="cuda"):
    """(fn, args): fn(m_re, m_im, s_mont) -> the decoded (re, im) of the
    mid roundtrip; args are the reference input pattern and the parity
    secret key, on `device`."""
    p = get_params(ENTRY_PRESET)
    ctx = HEContext(p, device=device)
    sk = ctx.generate_secret_key()
    re, im = message(p)

    def fn(m_re, m_im, s_mont):
        return ctx.roundtrip(m_re, m_im, SecretKey(s_mont))

    return fn, (torch.from_numpy(re).to(ctx.device),
                torch.from_numpy(im).to(ctx.device), sk.s_mont)


# -- the dryrun -----------------------------------------------------------------

def _lane_mesh(device, phi: int):
    """The W-sharded programs' mesh: tp = gcd(world, phi) blocks of lanes,
    replicated over the rest of the world."""
    world = dist.get_world_size()
    tp = math.gcd(world, phi)
    return meshlib.make_mesh({"rep": world // tp, "tp": tp}, device.type), tp


def _dist_ntt(device) -> dict:
    """The coefficient-sharded NTT over every rank, N = 1024 on 2 limbs,
    x = arange(2 N) mod q a limb (2 polynomials): the inverse gives x back
    on every rank; rank 0 holds the spectrum to FourStepNTT.forward."""
    n, limbs = DRYRUN_NTT_N, DRYRUN_NTT_LIMBS
    primes = generate_primes_1mod(limbs, 35, 2 * n)
    plan = FourStepPlan.make(n, primes)
    mesh = meshlib.make_mesh({"coeff": dist.get_world_size()}, device.type)
    dn = DistFourStepNTT(plan, mesh, "coeff", device)
    x = torch.from_numpy(np.stack(
        [np.arange(2 * n, dtype=np.int64).reshape(2, n) % q for q in primes])
    ).to(device)
    x4 = x.reshape(limbs, 2, plan.n1, plan.n2)
    xl = meshlib.shard(x4, mesh, (None, None, None, "coeff"))
    own = Launches()
    with own:
        z = dn.forward(xl)
        back = dn.inverse(z)
    back = meshlib.gather(back, mesh, (None, None, None, "coeff"))
    spectrum = meshlib.gather(z, mesh, (None, None, "coeff", None))
    out = {"exact": bool(torch.equal(back, x4)), "launches": own.counts()}
    if dist.get_rank() == 0:
        want = FourStepNTT(plan, device).forward(x)
        out["equal_single"] = bool(torch.equal(spectrum.reshape(want.shape),
                                               want))
    return out


def _keyswitch(device, p, c: np.ndarray) -> dict:
    """The W-sharded multiply_relinearize of ct1 * ct1, ct1 the parity
    encryption of the W-CRT of c's residues; rank 0 holds the gathered
    product to the unsharded one."""
    ctx = HEContext(p, ring="nega", device=device)
    rc = RelinContext(ctx)
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(refrng.ternary_secret(p, device),
                           torch.Generator(device=device).manual_seed(5))
    coeffs = torch.from_numpy(np.stack([c % int(q) for q in p.moduli]))
    ct1 = ctx.encrypt(ctx.wt.forward(coeffs.to(device)), sk)
    mesh, tp = _lane_mesh(device, p.phi)
    ks = ShardedKeySwitch(rc, mesh, "tp")
    c1, rlk_l = ks.shard(ct1), ks.shard_key(rlk)
    own = Launches()
    with own:
        got = ks.multiply_relinearize(c1, c1, rlk_l)
    got = ks.gather(got)
    out = {"tp": tp, "dnum": rc.dnum, "launches": own.counts(),
           "p_bits": [int(q).bit_length() for q in rc.p_moduli]}
    if dist.get_rank() == 0:
        want = rc.multiply_relinearize(ct1, ct1, rlk)
        out["equal_unsharded"] = bool(torch.equal(got.b, want.b)
                                      and torch.equal(got.a, want.a))
    return out


def _gl2(device, p, re: np.ndarray, im: np.ndarray) -> dict:
    """The W-sharded gl2 GEMM of X = 64 (re + i im) with itself and its
    relinearization (ShardedGl2Gemm); rank 0 holds the gathered output to
    Gl2GemmRelin.matmul and the Delta^2 decode to X^H X."""
    g2 = Gl2Context(p, device=device)
    gr = Gl2GemmRelin(HEMatmul2(g2))

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    sk = g2.generate_secret_key(gen(1))
    gre, gim = 64.0 * re, 64.0 * im
    ctX = g2.encrypt(g2.encode(torch.from_numpy(gre).to(device),
                               torch.from_numpy(gim).to(device)), sk, gen(2))
    ks = gr.gen_keys(sk, gen(9))
    mesh, tp = _lane_mesh(device, p.phi)
    sg = ShardedGl2Gemm(gr, mesh, "tp")
    ctXl, ks_l = sg.shard(ctX), sg.shard_key(ks)
    own = Launches()
    with own:
        got = sg.matmul(ctXl, ctXl, ks_l)
    got = sg.gather(got)
    out = {"tp": tp, "launches": own.counts()}
    if dist.get_rank() == 0:
        want = gr.matmul(ctX, ctX, ks)
        out["equal_unsharded"] = bool(torch.equal(got.b, want.b)
                                      and torch.equal(got.a, want.a))
        dr, di = g2.decrypt_and_decode(got, sk,
                                       delta_override=float(p.delta) ** 2)
        X = gre + 1j * gim
        C = np.conj(np.swapaxes(X, -1, -2)) @ X
        err = float(np.hypot(dr.cpu().numpy() - C.real,
                             di.cpu().numpy() - C.imag).max())
        out.update(err=err, rel=err / float(np.abs(C).max()))
    return out


def dryrun_rank(device, n_devices: int) -> dict:
    """One rank of dryrun_multichip: the four programs, each timed, and
    the kernel launches of their sharded calls, summed."""
    p = get_params(DRYRUN_PRESET)
    shape = meshlib.factor_mesh(n_devices)
    if shape["tp"] > p.n:                 # tp shards the n matrix rows
        shape = {"dp": n_devices // p.n, "tp": p.n}
    batch = max(shape["dp"], 2)
    rng = np.random.default_rng(0)
    re = rng.uniform(-2, 2, size=(batch, p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, size=(batch, p.phi, p.n, p.n))
    c = rng.integers(0, 1 << 12, size=(p.phi, p.n, p.n))
    programs = {"pipeline": lambda: rank_pipeline(
        device, DRYRUN_PRESET, shape["dp"], shape["tp"], batch, 0, -2.0, 2.0)}
    if 1 < n_devices <= 32 and n_devices & (n_devices - 1) == 0:
        programs["ntt"] = lambda: _dist_ntt(device)
    programs["keyswitch"] = lambda: _keyswitch(device, p, c)
    programs["gl2"] = lambda: _gl2(device, p, re[0], im[0])
    out = {"mesh": shape}
    launches = collections.Counter()
    for name, program in programs.items():
        t0 = clock(device)
        res = out[name] = program()
        res["wall_s"] = clock(device) - t0
        launches.update(res.pop("launches"))
    out["pipeline"].pop("out", None)
    out["launches"] = dict(sorted(launches.items()))
    return out


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = WORLD_S) -> dict:
    """The dryrun on a world of n_devices gloo ranks; raises when a rank
    fails or a check does not hold.  Returns rank 0's results, the checks
    and the launches summed over the ranks."""
    dev = be.resolve_device(device)
    t0 = time.perf_counter()
    res = launch.run_world(dryrun_rank, n_devices, "gloo", str(dev),
                           timeout_s, n_devices)
    r0 = res[0]
    pl, ks, g = r0["pipeline"], r0["keyswitch"], r0["gl2"]
    checks = {"sharded roundtrip err < 1.0": bool(pl["finite"]
                                                  and pl["err"] < 1.0),
              "sharded roundtrip == roundtrip_batch": pl["equal_unsharded"],
              "W-sharded multiply == unsharded": ks["equal_unsharded"],
              "W-sharded gl2 GEMM == Gl2GemmRelin.matmul": g["equal_unsharded"],
              "gl2 rel err < 0.01": bool(np.isfinite(g["rel"])
                                         and g["rel"] < 0.01)}
    print(f"[dryrun] dp x tp sharded roundtrip ok (mesh {r0['mesh']}, "
          f"err {pl['err']:.2e})")
    if "ntt" in r0:
        checks["dist NTT inverse exact"] = all(r["ntt"]["exact"] for r in res)
        checks["dist NTT == FourStepNTT.forward"] = r0["ntt"]["equal_single"]
        print("[dryrun] coeff-sharded dist NTT (all_to_all) bit-exact")
    print(f"[dryrun] W-sharded relinearized multiply bit-exact (dnum="
          f"{ks['dnum']}, P widths {ks['p_bits']}, tp {ks['tp']})")
    print(f"[dryrun] W-sharded gl2 ct-in/ct-out GEMM ok (rel err "
          f"{g['rel']:.2e}, abs {g['err']:.2e}, tp {g['tp']})")
    launches: dict = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out = {"ranks": n_devices, "device": str(dev), "checks": checks,
           "wall_s": time.perf_counter() - t0,
           "program_wall_s": {k: [r[k]["wall_s"] for r in res]
                              for k in ("pipeline", "ntt", "keyswitch", "gl2")
                              if k in r0},
           "ok": all(checks.values()), "launches": launches}
    if not out["ok"]:
        raise RuntimeError(f"dryrun_multichip({n_devices}): a check failed: "
                           f"{checks}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="dryrun_multichip(N) instead of entry()")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        res = dryrun_multichip(args.dryrun, args.device)
        print(f"[dryrun] {args.dryrun} ranks: world wall "
              f"{res['wall_s']:.1f}s; program walls (s, by rank) "
              f"{res['program_wall_s']}")
        print_launches(res["launches"])
        print(f"[dryrun] {'OK' if res['ok'] else 'FAIL'}")
        return 0 if res["ok"] else 1
    t0 = time.perf_counter()
    fn, fargs = entry(args.device)
    m_re, m_im, _ = fargs
    own = Launches()
    with own:
        dr, di = fn(*fargs)
    sync(m_re.device)
    err = float(torch.hypot(dr - m_re, di - m_im).max())
    ok = bool(np.isfinite(err) and err < ENTRY_TOL)
    print(f"[entry] {ENTRY_PRESET} roundtrip on {m_re.device}: max err "
          f"{err:.3e} (limit {ENTRY_TOL:g}), {time.perf_counter() - t0:.1f}s "
          f"with the context")
    print_launches(own.counts())
    print(f"[entry] {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
