"""The sharded programs on a world of ranks: validation and NTT figures.

    python3 -m matrix_fhe_tpu_torch.scripts.bench_dist --multiprocess N
    python3 -m matrix_fhe_tpu_torch.scripts.bench_dist --backend gloo|nccl \\
        --ntt16-rate R --ici-gbps G --dcn-gbps G [--ranks 4] [--quick]

Counterpart of bench_dist.py in the JAX package.  Each program here is a
rank function, fn(device, ...), that launch.run_world runs on every rank:

  * --multiprocess N (CPU, gloo): N processes; dp over the processes on a
    hybrid mesh (each checks its block of the batch-sharded NTT against
    the whole transform), then a coeff axis spanning every process, so
    DistFourStepNTT's all_to_all crosses process boundaries; the inverse
    must give the input back (bench_dist.py:32-80 there).
  * card mode (default): the limb-sharded NTT at N = 2^16, L = 16, B = 8
    (each rank runs K5 on its L/d limbs) and the coefficient-sharded NTT
    at N = 2^17, L = 4, B = 2 (DistFourStepNTT: K10a's twiddle form, K1,
    one all_to_all each way), each held to the single-device transform
    (FourStepNTT.forward: K5 at N = 2^16; at N = 2^17, 256 x 512, which K5
    does not take, the stage route), then the cost model for two hosts
    (cost_model_inputs).  With several ranks on
    one card (gloo) the times validate the sharded programs and measure
    no scaling.  --quick shrinks the shapes for a CPU run.

rank_pipeline and rank_keyswitch drive ShardedPipeline and the W-sharded
multiply_relinearize the same way (chip_smoke.py path 7, the tests).
Each program returns the kernel launches of its sharded calls alone
("launches"), not those of key generation, encryption or the reference.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import generate_primes_1mod, get_params
from ..models import rng as refrng
from ..models.he import Ciphertext, HEContext
from ..models.keyswitch import RelinContext, RelinKey
from ..ops import _backend as be
from ..ops._backend import Launches
from ..ops.ntt_large import FourStepNTT, FourStepPlan
from ..parallel import launch
from ..parallel import mesh as meshlib
from ..parallel import multihost as mh
from ..parallel.dist_ntt import DistFourStepNTT
from ..parallel.keyswitch import ShardedKeySwitch
from ..parallel.pipeline import ShardedPipeline
from ..utils.debug import relin_noise
from ..utils.timing import sync

ONE_CARD_NOTE = ("ranks sharing one card: a validation of the sharded "
                 "programs, not a scaling figure")
KEY_SEED, MSG_SEED = 5, 9       # rank_keyswitch's keys and messages
BENCH_ITERS = 5                 # card mode's timed calls


def ntt_input(moduli, batch: int, n: int, seed: int) -> np.ndarray:
    """[L, B, N] uint64 residues, one limb after another from one
    default_rng(seed) stream (the JAX script's input)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=(batch, n), dtype=np.uint64)
                     for q in moduli])


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64)).to(device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, iters: int = 1, together: bool = True):
    """(result, mean ms a call, ms of the first call) on the host clock:
    `iters` warm-up calls, the first of them timed (a collective's first
    runs on a new shape are slower), then `iters` timed calls, the card
    synchronized at both ends.  `together` starts the timed calls on all
    ranks at once (a barrier); else this rank times alone."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    first = 1e3 * (time.perf_counter() - t0)
    for _ in range(iters - 1):
        out = fn()
    sync(device)
    if together:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(device)
    return out, 1e3 * (time.perf_counter() - t0) / iters, first


def _peak(device) -> int | None:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None


# -- the rank programs ----------------------------------------------------------

def rank_dist_ntt(device, n: int, bits: int, limbs: int, batch: int,
                  negacyclic: bool = True, seed: int = 0,
                  iters: int = 1) -> dict:
    """DistFourStepNTT over every rank (axis 'coeff'): forward and inverse
    of the i2-sharded input, both gathered.  Rank 0 returns the gathered
    spectrum, whether it equals the single-device FourStepNTT.forward
    (K5, or the stage route where n1 != n2; on the CPU the plain version)
    and that call's time, and whether it equals forward_plain, the
    independent reference."""
    primes = generate_primes_1mod(limbs, bits, 2 * n)
    plan = FourStepPlan.make(n, primes, negacyclic=negacyclic)
    mesh = meshlib.make_mesh({"coeff": dist.get_world_size()}, device.type)
    dn = DistFourStepNTT(plan, mesh, "coeff", device)
    x = _t(ntt_input(primes, batch, n, seed), device)
    x4 = x.reshape(limbs, batch, plan.n1, plan.n2)
    xl = meshlib.shard(x4, mesh, (None, None, None, "coeff"))
    own = Launches()
    with own:
        z, fwd_ms, fwd_first = _timed(lambda: dn.forward(xl), device, iters)
        back, inv_ms, _ = _timed(lambda: dn.inverse(z), device, iters)
    spectrum = meshlib.gather(z, mesh, (None, None, "coeff", None))
    back = meshlib.gather(back, mesh, (None, None, None, "coeff"))
    out = {"fwd_ms": fwd_ms, "inv_ms": inv_ms, "fwd_first_ms": fwd_first,
           "inverse_exact": bool(torch.equal(back, x4)),
           "block": list(xl.shape), "peak": _peak(device),
           "launches": own.counts()}
    if dist.get_rank() == 0:
        out["spectrum"] = spectrum.reshape(limbs, batch, n)
        single = FourStepNTT(plan, device)
        want, out["single_ms"], _ = _timed(
            lambda: single.forward(x), device, together=False)
        out["equal_single"] = bool(torch.equal(out["spectrum"], want))
        out["equal_plain"] = bool(torch.equal(out["spectrum"],
                                              single.forward_plain(x)))
    return out


def rank_pipeline(device, preset: str, dp: int, tp: int, batch: int,
                  seed: int, lo: float, hi: float) -> dict:
    """ShardedPipeline on a dp x tp mesh over a batch of messages from
    default_rng(seed).uniform(lo, hi) (real parts, then imaginary).  Rank
    0 returns the gathered output, whether it equals
    HEContext.roundtrip_batch on one rank bit for bit, and the max error."""
    p = get_params(preset)
    ctx = HEContext(p, device=device)
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(seed)
    shape = (batch, p.phi, p.n, p.n)
    re = torch.from_numpy(rng.uniform(lo, hi, size=shape)).to(device)
    im = torch.from_numpy(rng.uniform(lo, hi, size=shape)).to(device)
    mesh = meshlib.make_mesh({"dp": dp, "tp": tp}, device.type)
    sp = ShardedPipeline(ctx, mesh)
    re_l, im_l = sp.shard(re), sp.shard(im)
    own = Launches()
    with own:
        (dr, di), ms, _ = _timed(lambda: sp.roundtrip(re_l, im_l, sk),
                                 device)
    out = {"ms": ms, "block": list(re_l.shape), "peak": _peak(device),
           "launches": own.counts()}
    dr, di = sp.gather(dr), sp.gather(di)
    if dist.get_rank() == 0:
        out["out"] = (dr, di)
        out["err"] = float(torch.hypot(dr - re, di - im).max())
        out["finite"] = bool(torch.isfinite(dr).all() and
                             torch.isfinite(di).all())
        wr, wi = ctx.roundtrip_batch(re, im, sk)
        out["equal_unsharded"] = bool(torch.equal(dr, wr)
                                      and torch.equal(di, wi))
    return out


def _checksum(tensors) -> torch.Tensor:
    """One int64 over the given tensors (wrapping sums of position-weighted
    residues): ranks that hold different tensors differ in it, but for
    a collision."""
    total = torch.zeros((), dtype=torch.int64, device=tensors[0].device)
    for i, t in enumerate(tensors):
        w = torch.arange(1, t.numel() + 1, dtype=torch.int64, device=t.device)
        total = total + (i + 1) * (t.reshape(-1) * w).sum()
    return total.reshape(1)


def rank_keyswitch(device, preset: str, tp: int, inputs=None) -> dict:
    """The W-sharded multiply_relinearize over tp ranks (ring 'nega', the
    preset's P).  Without `inputs` every rank makes the secret and
    relinearization keys (generator seeded KEY_SEED) and encrypts two
    messages of default_rng(MSG_SEED) integers < 2^30, as chip_smoke.py's
    path 5; an all_gather of a checksum shows the ranks made the same
    keys and ciphertexts.  `inputs` = (rlk, ct1, ct2) carries keys and
    ciphertexts made elsewhere.  Rank 0 returns the gathered product,
    whether it equals the unsharded product bit for bit and (own keys)
    the relinearization noise at limb 0."""
    p = get_params(preset)
    ctx = HEContext(p, ring="nega", device=device)
    rc = RelinContext(ctx)
    sk = None
    if inputs is None:
        sk = ctx.generate_secret_key()
        gen = torch.Generator(device=device).manual_seed(KEY_SEED)
        rlk = rc.gen_relin_key(refrng.ternary_secret(p, device), gen)
        rng = np.random.default_rng(MSG_SEED)
        ms = [torch.from_numpy(np.stack(
            [rng.integers(0, 1 << 30, size=(p.phi, p.n, p.n))
             for _ in p.moduli])).to(device) for _ in range(2)]
        ct1, ct2 = (ctx.encrypt(m, sk) for m in ms)
    else:
        rlk, ct1, ct2 = inputs
        rlk = RelinKey(*(tuple(k.to(device) for k in ks) for ks in rlk))
        ct1, ct2 = (Ciphertext(*(c.to(device) for c in ct)) for ct in (ct1, ct2))
    sums = _checksum(list(rlk.b) + list(rlk.a) + list(ct1) + list(ct2))
    every = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
    dist.all_gather(every, sums)
    mesh = meshlib.make_mesh({"tp": tp}, device.type)
    ks = ShardedKeySwitch(rc, mesh, "tp")
    rlk_l = ks.shard_key(rlk)
    c1, c2 = ks.shard(ct1), ks.shard(ct2)
    if dist.get_rank() != 0:
        del rlk                                   # only the lanes stay
    own = Launches()
    with own:
        got, ms_, _ = _timed(lambda: ks.multiply_relinearize(c1, c2, rlk_l),
                             device)
    out = {"ms": ms_, "block": list(c1.b.shape), "peak": _peak(device),
           "launches": own.counts(),
           "same_inputs": all(torch.equal(s, sums) for s in every)}
    got = ks.gather(got)
    if dist.get_rank() == 0:
        out["out"] = got
        want = rc.multiply_relinearize(ct1, ct2, rlk)
        out["equal_unsharded"] = bool(torch.equal(got.b, want.b)
                                      and torch.equal(got.a, want.a))
        if sk is not None:
            out["noise"] = relin_noise(ctx, got, ct1, ct2, sk)
    return out


def rank_multihost(device, dcn: int, ici: int, n: int = 1 << 12,
                   limbs: int = 3, batch: int = 4, seed: int = 0) -> dict:
    """The --multiprocess program: dp over a hybrid mesh (dcn 'dp' x ici
    'coeff'), each rank checking its blocks of the batch-sharded NTT
    (global_from_host_data, local_shards) against the whole transform;
    then a 'coeff' axis spanning every rank, so the dist NTT's all_to_all
    crosses the processes, and its inverse."""
    primes = generate_primes_1mod(limbs, 35, 2 * n)
    plan = FourStepPlan.make(n, primes)
    ntt = FourStepNTT(plan, device)
    x_np = ntt_input(primes, batch, n, seed)
    want = ntt.forward(_t(x_np, device))

    mesh = mh.hybrid_mesh({"dp": dcn}, {"coeff": ici}, device.type)
    spec = (None, "dp", None)
    yl = ntt.forward(mh.global_from_host_data(x_np, mesh, spec))
    dp_ok = all(torch.equal(data, want[idx])
                for idx, data in mh.local_shards(yl, mesh, spec, want.shape))

    flat = meshlib.make_mesh({"coeff": dist.get_world_size()}, device.type)
    dn = DistFourStepNTT(plan, flat, "coeff", device)
    x4 = x_np.reshape(limbs, batch, plan.n1, plan.n2)
    in_spec, out_spec = (None, None, None, "coeff"), (None, None, "coeff", None)
    zl = dn.forward(mh.global_from_host_data(x4, flat, in_spec))
    want4 = want.reshape(x4.shape)
    coeff_ok = all(torch.equal(data, want4[idx]) for idx, data in
                   mh.local_shards(zl, flat, out_spec, want4.shape))
    x4t = _t(x4, device)
    back_ok = all(torch.equal(data, x4t[idx]) for idx, data in
                  mh.local_shards(dn.inverse(zl), flat, in_spec, x4.shape))
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "dp_ok": dp_ok, "coeff_ok": coeff_ok, "inverse_ok": back_ok}


def rank_bench(device, quick: bool = False) -> dict:
    """Card mode on every rank: the limb-sharded NTT (rank r runs K5 on
    its L/d limbs; rank 0 also times the whole on its own, the others
    waiting) and the coefficient-sharded N = 2^17 NTT; each held to the
    single-device result.  Returns this rank's times and the launches of
    its sharded calls."""
    d, rank = dist.get_world_size(), dist.get_rank()
    n, limbs, batch = (1 << 12, 8, 8) if quick else (1 << 16, 16, 8)
    if limbs % d:
        raise ValueError(f"{d} ranks do not divide {limbs} limbs")
    primes = generate_primes_1mod(limbs, 35, 2 * n)
    x = _t(ntt_input(primes, batch, n, 0), device)
    mesh = meshlib.make_mesh({"limb": d}, device.type)
    mine = meshlib.block_index(x.shape, mesh, ("limb",))[0]
    local = FourStepNTT(FourStepPlan.make(n, primes[mine]), device)
    xl = x[mine].contiguous()
    own = Launches()
    with own:
        yl, t_shard, _ = _timed(lambda: local.forward(xl), device,
                                BENCH_ITERS)
    y = meshlib.gather(yl, mesh, ("limb",))
    out = {"rank": rank, "limb_sharded_ms": t_shard}
    if rank == 0:
        whole = FourStepNTT(FourStepPlan.make(n, primes), device)
        want, out["limb_single_ms"], _ = _timed(
            lambda: whole.forward(x), device, BENCH_ITERS, together=False)
        out["limb_equal"] = bool(torch.equal(y, want))
        del whole, want
    dist.barrier()
    del x, xl, yl, y, local

    res = rank_dist_ntt(device, 1 << 13 if quick else 1 << 17, 35, 4, 2,
                        seed=1, iters=BENCH_ITERS)
    out.update({"coeff_fwd_ms": res["fwd_ms"], "coeff_inv_ms": res["inv_ms"],
                "coeff_inverse_exact": res["inverse_exact"],
                "peak": _peak(device)})
    if rank == 0:
        out["coeff_single_ms"] = res["single_ms"]
        out["coeff_equal"] = res["equal_single"] and res["equal_plain"]
    out["launches"] = dict(collections.Counter(own.counts())
                           + collections.Counter(res["launches"]))
    return out


# -- the cost model -------------------------------------------------------------

def cost_model_inputs(plan, d: int, hosts: int = 2, *, ntt16_rate: float,
                      ici_gbps: float, dcn_gbps: float) -> dict:
    """2-host scaling cost model for the coeff-sharded four-step NTT (the
    JAX bench_dist.cost_model_inputs, with no default figure): the exact
    byte counts of the one all_to_all stage exchange per (poly, limb) and
    the projected 2-host efficiency at the given link rates.  `ntt16_rate`
    is a measured single-device N = 2^16 NTT/s (on the card,
    chip_smoke.py path 2's), `ici_gbps` the per-device one-way all_to_all
    rate within a host and `dcn_gbps` the per-host rate across hosts, both
    in GB/s and both assumptions the caller names."""
    N = plan.n
    rate16 = float(ntt16_rate)
    # per-poly MAC scaling vs the N=2^16 (256x256) anchor: N*(n1+n2)
    mac_ratio = (N * (plan.n1 + plan.n2)) / ((1 << 16) * 512)
    t_poly = mac_ratio / rate16                       # serial seconds/poly
    ici_bw = float(ici_gbps) * 1e9
    dcn_bw = float(dcn_gbps) * 1e9

    # one all_to_all of the [n1, n2]-tile, 8 B/coeff
    bytes_total = 8 * N * (d - 1) // d                # all devices, per poly-limb
    bytes_per_dev = bytes_total // d                  # each device sends this
    # one-way cross-DCN bytes per poly-limb: 1/hosts of the pairs cross
    bytes_dcn_oneway = 8 * N // (2 * hosts)

    t_comp_dev = t_poly / d                           # per poly-limb, per device
    t_ici = bytes_per_dev / ici_bw
    t_dcn = bytes_dcn_oneway / dcn_bw / (hosts / 2)   # per-host NIC serializes
    t_comm = max(t_ici, t_dcn)
    t_comp_host = t_poly / hosts
    eff_serial = t_comp_dev / (t_comp_dev + t_comm)
    eff_pipelined = t_comp_dev / max(t_comp_dev, t_comm)

    def _eff_at(gbps: float) -> tuple[float, float]:
        tc = max(t_ici, bytes_dcn_oneway / (gbps * 1e9) / (hosts / 2))
        return (t_comp_dev / (t_comp_dev + tc),
                t_comp_dev / max(t_comp_dev, tc))

    sensitivity = [
        {"dcn_gbps": g,
         "eff_serial": round(_eff_at(g)[0], 3),
         "eff_pipelined": round(_eff_at(g)[1], 3)}
        for g in (5, 10, 25, 50, 100, 200, 400)]
    dcn_rate = bytes_dcn_oneway / (hosts / 2)
    xover_pipe = dcn_rate / (t_comp_dev / 0.85) / 1e9
    xover_serial = dcn_rate / (t_comp_dev * (1 / 0.85 - 1)) / 1e9
    ici_ok_85 = t_ici <= t_comp_dev / 0.85

    return {
        "config": {"N": N, "n1": plan.n1, "n2": plan.n2, "devices": d,
                   "hosts": hosts},
        "anchor_ntt16_per_sec": rate16,
        "assumed_ici_gbps": ici_bw / 1e9,
        "assumed_dcn_gbps": dcn_bw / 1e9,
        "per_poly_limb": {
            "a2a_bytes_per_device": bytes_per_dev,
            "a2a_bytes_total": bytes_total,
            "dcn_bytes_oneway": bytes_dcn_oneway,
            "compute_us_per_device": round(t_comp_dev * 1e6, 2),
            "compute_us_per_host": round(t_comp_host * 1e6, 2),
            "ici_us": round(t_ici * 1e6, 2),
            "dcn_us": round(t_dcn * 1e6, 2),
        },
        "projected_efficiency_no_overlap": round(eff_serial, 3),
        "projected_efficiency_limb_pipelined": round(eff_pipelined, 3),
        "comm_bound": t_comm > t_comp_dev,
        "dcn_sensitivity": sensitivity,
        "dcn_crossover_gbps_85pct_pipelined": (
            round(xover_pipe, 1) if ici_ok_85 else None),
        "dcn_crossover_gbps_85pct_serial": round(xover_serial, 1),
        "crossover_note": ("min per-host DCN bandwidth at which the coeff-"
                           "sharded form clears 85% 2-host efficiency; "
                           "pipelined crossover is None when the ICI "
                           "assumption alone already caps below 85%"),
        "note": ("limb/batch sharding is zero-comm (100% efficiency) "
                 "whenever independent work B*L >= devices — the "
                 "throughput config; coeff-sharding is the single-"
                 "transform latency tool and needs the all_to_all "
                 "pipelined across independent limbs to clear 85%"),
    }


# -- entry points -------------------------------------------------------------

def multiprocess(nproc: int, timeout_s: float = 300.0) -> dict:
    """--multiprocess: CPU gloo validation over `nproc` processes."""
    res = launch.run_world(rank_multihost, nproc, "gloo", "cpu", timeout_s,
                           nproc, 1)
    ok = all(r["dp_ok"] and r["coeff_ok"] and r["inverse_ok"] for r in res)
    return {"mode": "multiprocess-cpu-validation", "processes": nproc,
            "ok": ok, "ranks": res}


def card(ranks: int, backend: str, ntt16_rate: float, ici_gbps: float,
         dcn_gbps: float, quick: bool = False, device: str = "cuda",
         timeout_s: float = 600.0) -> dict:
    """Card mode: rank_bench on a world of `ranks` and the cost model."""
    dev = be.resolve_device(device)
    res = launch.run_world(rank_bench, ranks, backend, str(dev), timeout_s,
                           quick)
    r0 = res[0]
    ok = (r0["limb_equal"] and r0["coeff_equal"]
          and all(r["coeff_inverse_exact"] for r in res))
    n = 1 << 13 if quick else 1 << 17
    plan2 = FourStepPlan.make(n, generate_primes_1mod(4, 35, 2 * n))
    launches: dict = {}
    for r in res:
        for k, v in r.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
    out = {"mode": f"{ranks} {backend} ranks on {dev.type}", "ranks": ranks,
           "backend": backend, "ok": ok, "quick": quick,
           "limb_sharded_ntt": {
               "t1_ms": r0["limb_single_ms"],
               f"t{ranks}_ms": max(r["limb_sharded_ms"] for r in res)},
           "coeff_sharded_ntt": {
               "n": n, "single_ms": r0["coeff_single_ms"],
               f"t{ranks}_fwd_ms": max(r["coeff_fwd_ms"] for r in res),
               f"t{ranks}_inv_ms": max(r["coeff_inv_ms"] for r in res)},
           "peak_per_rank": [r["peak"] for r in res],
           "launches": launches,
           "cost_model": cost_model_inputs(
               plan2, ranks, ntt16_rate=ntt16_rate, ici_gbps=ici_gbps,
               dcn_gbps=dcn_gbps)}
    if dev.type == "cuda" and ranks > 1 and backend == "gloo":
        out["note"] = f"{ranks} {ONE_CARD_NOTE}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multiprocess", type=int, default=None, metavar="N")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=mh.BACKENDS,
                    help="named by the caller: gloo (ranks may share a "
                         "card) or nccl (one card a rank)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ntt16-rate", type=float,
                    help="measured single-card N = 2^16 NTT/s")
    ap.add_argument("--ici-gbps", type=float,
                    help="assumed per-device all_to_all GB/s within a host")
    ap.add_argument("--dcn-gbps", type=float,
                    help="assumed per-host GB/s across hosts")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if args.multiprocess is not None:
        out = multiprocess(args.multiprocess)
    else:
        missing = [k for k in ("backend", "ntt16_rate", "ici_gbps",
                               "dcn_gbps")
                   if getattr(args, k) is None]
        if missing:
            ap.error("card mode needs --" + ", --".join(
                m.replace("_", "-") for m in missing))
        out = card(args.ranks, args.backend, args.ntt16_rate, args.ici_gbps,
                   args.dcn_gbps, args.quick, args.device)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
