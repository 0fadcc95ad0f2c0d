"""The port's parallel/ (torch.distributed) against the JAX package's.

Each sharded program runs in a world of CPU ranks on gloo
(launch.run_world, one process a rank), once a module, in a fixture that
returns the ranks' results; each check is a test of its own.  On the CPU
every kernel runs its plain version.  Residues are held bit for bit (the
dist NTT against JAX's FourStepNTT and DistFourStepNTT on the 8 virtual
devices, the W-sharded multiply_relinearize against JAX's on the same
keys), the sharded roundtrip bit for bit against the port's unsharded
HEContext.roundtrip_batch and within 1e-9 of JAX's ShardedPipeline.
"""

import collections
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bench_dist as jax_bench_dist
import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import keyswitch as jks
from matrix_fhe_tpu.models import rng as jrng
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu.ops import ntt_large as jntt
from matrix_fhe_tpu.parallel import mesh as jmesh
from matrix_fhe_tpu.parallel.dist_ntt import DistFourStepNTT as JaxDistNTT
from matrix_fhe_tpu.parallel.pipeline import ShardedPipeline as JaxPipeline
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import rng as trng
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.models.keyswitch import RelinContext
from matrix_fhe_tpu_torch.ops import _backend as be
from matrix_fhe_tpu_torch.ops.cuda_ntt import NttMulNtt, Stage
from matrix_fhe_tpu_torch.ops.ntt_large import FourStepPlan, generate_primes_1mod
from matrix_fhe_tpu_torch.parallel import launch, mesh as tmesh, multihost
from matrix_fhe_tpu_torch.parallel.dist_ntt import DistFourStepNTT
from matrix_fhe_tpu_torch.scripts import bench_dist

WORLD_S = 120          # a world's time limit: well inside the suite's


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# -- rank helpers of the failure tests (spawned ranks import them) ------------

def _fail_on(device, bad_rank):
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} gives up")
    dist.barrier()            # the others wait for it in a collective


def _hang(device):
    if dist.get_rank() == 0:
        dist.barrier()        # no other rank ever joins
    time.sleep(600)


def _env_seen(device):
    return (dist.get_rank(), dist.get_world_size(),
            os.environ["MFHE_PROC_ID"], os.environ["MFHE_NUM_PROCS"],
            os.environ["MFHE_COORDINATOR"].startswith("file://"),
            torch.get_num_threads())


# -- the mesh helpers -----------------------------------------------------------

def test_factor_mesh():
    assert tmesh.factor_mesh(8) == {"dp": 2, "tp": 4}
    assert tmesh.factor_mesh(1) == {"dp": 1, "tp": 1}
    assert tmesh.factor_mesh(7) == {"dp": 1, "tp": 7}
    for n in (1, 2, 6, 7, 8, 12):
        assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n)


def test_specs_match_the_jax_shardings():
    mesh = jmesh.make_mesh({"dp": 2, "tp": 4})
    assert tuple(jmesh.msg_sharding(mesh).spec) == tmesh.msg_spec
    assert tuple(jmesh.packed_sharding(mesh).spec) == tmesh.packed_spec
    assert tuple(jmesh.replicated(mesh).spec) == tmesh.replicated


@pytest.fixture
def one_rank_group(tmp_path, monkeypatch):
    """This process as a world of one gloo rank, from the MFHE_* env."""
    monkeypatch.setenv("MFHE_COORDINATOR", f"file://{tmp_path}/rendezvous")
    monkeypatch.setenv("MFHE_NUM_PROCS", "1")
    monkeypatch.setenv("MFHE_PROC_ID", "0")
    assert multihost.init_distributed(backend="gloo") is False
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_init_distributed_reads_the_env(one_rank_group):
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_rank() == 0


def test_init_distributed_single_process_does_nothing(monkeypatch):
    for k in ("MFHE_COORDINATOR", "MFHE_NUM_PROCS", "MFHE_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed(backend="gloo") is False
    assert not dist.is_initialized()


def test_make_mesh_refuses_a_small_world(one_rank_group):
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        tmesh.make_mesh({"dp": 1, "tp": 2}, "cpu")
    m = tmesh.make_mesh({"dp": 1, "tp": 1}, "cpu")
    x = torch.arange(12).reshape(3, 4)
    assert torch.equal(tmesh.gather(tmesh.shard(x, m, ("dp", "tp")), m,
                                    ("dp", "tp")), x)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_mesh({"tp": 1}, "cpu")


@pytest.mark.parametrize("backend", ["mpi", "nccl"])
def test_backend_is_named_and_checked(backend, monkeypatch):
    """The caller names the backend; nccl refuses more ranks on a host
    than cards (two ranks on one card), before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="backend must be" if backend == "mpi"
                       else "nccl needs one card a rank"):
        launch.run_world(_env_seen, 2, backend, "cuda", WORLD_S)


def _cards(monkeypatch, n, **env):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("cards, env, backend, device, rank, world, want", [
    (4, {"LOCAL_WORLD_SIZE": "4"}, "nccl", "cuda", 5, 8, "cuda:1"),
    (4, {"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"}, "nccl", "cuda", 5, 8,
     "cuda:3"),
    (4, {}, "nccl", "cuda", 2, 4, "cuda:2"),
    (2, {}, "gloo", "cuda", 0, 4, "cuda:0"),
    (2, {}, "gloo", "cuda", 3, 4, "cuda:1"),
    (2, {"LOCAL_WORLD_SIZE": "2"}, "gloo", "cuda", 2, 4, "cuda:0"),
    (1, {}, "gloo", "cuda", 3, 4, "cuda:0"),
    (2, {}, "gloo", "cuda:1", 0, 4, "cuda:1"),
    (0, {}, "gloo", "cpu", 3, 4, "cpu"),
], ids=["nccl-2hosts", "nccl-local-rank", "nccl-1host", "gloo-spread-0",
        "gloo-spread-3", "gloo-2hosts", "gloo-one-card", "gloo-named-card",
        "gloo-cpu"])
def test_rank_device_takes_the_local_rank(monkeypatch, cards, env, backend,
                                          device, rank, world, want):
    """A rank's card comes from its rank on its host (LOCAL_RANK /
    LOCAL_WORLD_SIZE, else one host), never from its global rank: under
    nccl cuda:<local rank>, under gloo a bare "cuda" spread over the
    cards."""
    _cards(monkeypatch, cards, **env)
    multihost.check_backend(backend, world)
    assert multihost.rank_device(device, backend, rank, world) == \
        torch.device(want)


def test_nccl_across_hosts_needs_the_local_world(monkeypatch, tmp_path):
    """Eight nccl ranks on four-card hosts: without LOCAL_WORLD_SIZE every
    rank counts as this host's, so init_distributed's MFHE_* route
    refuses before joining; with it, the layout is accepted; and nccl
    never takes a CPU device."""
    _cards(monkeypatch, 4, MFHE_COORDINATOR=f"file://{tmp_path}/rdv",
           MFHE_NUM_PROCS="8", MFHE_PROC_ID="5")
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE unset"):
        multihost.init_distributed(backend="nccl")
    assert not dist.is_initialized()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    multihost.check_backend("nccl", 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multihost.rank_device("cpu", "nccl", 0, 8)


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (nccl)")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="nccl needs one card a rank"):
        launch.run_world(_env_seen, n + 1, "nccl", "cuda", WORLD_S)


def test_dist_ntt_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    plan = FourStepPlan.make(64, generate_primes_1mod(1, 35, 128))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistFourStepNTT(plan, None)


# -- the world itself ----------------------------------------------------------

def test_world_ranks_join_from_the_env():
    got = launch.run_world(_env_seen, 3, "gloo", "cpu", WORLD_S)
    assert got == [(r, 3, str(r), "3", True, 1) for r in range(3)]


def test_a_failing_rank_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)rank 2 of 4.*ValueError: "
                       r"rank 2 gives up"):
        launch.run_world(_fail_on, 4, "gloo", "cpu", WORLD_S, 2)
    assert time.monotonic() - t0 < WORLD_S / 2      # the waiters were killed


def test_a_hung_rank_is_killed_at_the_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        launch.run_world(_hang, 2, "gloo", "cpu", 5)
    assert time.monotonic() - t0 < 30


# -- the coefficient-sharded NTT ----------------------------------------------

N_DIST, BITS_DIST = 1024, 35


@pytest.fixture(scope="module", params=[True, False],
                ids=["negacyclic", "cyclic"])
def dist_ntt(request):
    nega = request.param
    res = launch.run_world(bench_dist.rank_dist_ntt, 4, "gloo", "cpu",
                           WORLD_S, N_DIST, BITS_DIST, 2, 2, nega, 0)
    primes = jntt.generate_primes_1mod(2, BITS_DIST, 2 * N_DIST)
    x = bench_dist.ntt_input(primes, 2, N_DIST, 0)
    return nega, primes, x, res


def test_dist_ntt_matches_jax_four_step(dist_ntt):
    nega, primes, x, res = dist_ntt
    assert tuple(primes) == generate_primes_1mod(2, BITS_DIST, 2 * N_DIST)
    plan = jntt.FourStepPlan.make(N_DIST, primes, negacyclic=nega)
    want = np.asarray(jntt.FourStepNTT(plan).forward(jnp.asarray(x)))
    np.testing.assert_array_equal(_u64(res[0]["spectrum"]), want)
    assert res[0]["equal_single"]            # the port's own FourStepNTT


def test_dist_ntt_matches_jax_dist_ntt(dist_ntt):
    nega, primes, x, res = dist_ntt
    plan = jntt.FourStepPlan.make(N_DIST, primes, negacyclic=nega)
    jd = JaxDistNTT(plan, jmesh.make_mesh({"coeff": 8}), use_pallas=False)
    want = np.asarray(jd.forward(jnp.asarray(x)))
    np.testing.assert_array_equal(_u64(res[0]["spectrum"]), want)


def test_dist_ntt_inverse_is_exact(dist_ntt):
    _, _, _, res = dist_ntt
    assert all(r["inverse_exact"] for r in res)
    assert [r["block"] for r in res] == [[2, 2, 32, 8]] * 4


def test_dist_ntt_refuses_an_axis_that_does_not_divide():
    # N = 8 is 2 x 4: four ranks do not divide n1
    with pytest.raises(RuntimeError, match="n1 and n2 must be divisible"):
        launch.run_world(bench_dist.rank_dist_ntt, 4, "gloo", "cpu", WORLD_S,
                         8, 35, 1, 1)


# -- the batched and the sharded roundtrip ---------------------------------------

def test_roundtrip_batch_matches_jax_vmap():
    p, jp = get_params("tiny"), jax_params("tiny")
    rng = np.random.default_rng(21)
    re = rng.uniform(-2, 2, size=(4, p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, size=(4, p.phi, p.n, p.n))
    ctx = HEContext(p, device="cpu")
    dr, di = ctx.roundtrip_batch(torch.from_numpy(re), torch.from_numpy(im),
                                 ctx.generate_secret_key())
    jctx = JaxContext(jp)
    f = jax.jit(jax.vmap(jctx.roundtrip_fn, in_axes=(0, 0, None)))
    wr, wi = f(jnp.asarray(re), jnp.asarray(im), jctx.generate_secret_key())
    np.testing.assert_allclose(dr.numpy(), np.asarray(wr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(di.numpy(), np.asarray(wi), rtol=0, atol=1e-9)
    for b in (0, 3):          # each message as its own roundtrip
        one = ctx.roundtrip(torch.from_numpy(re[b]), torch.from_numpy(im[b]),
                            ctx.generate_secret_key())
        assert torch.equal(one[0], dr[b]) and torch.equal(one[1], di[b])


@pytest.fixture(scope="module")
def sharded_pipeline():
    res = launch.run_world(bench_dist.rank_pipeline, 4, "gloo", "cpu",
                           WORLD_S, "tiny", 2, 2, 4, 21, -2.0, 2.0)
    rng = np.random.default_rng(21)
    shape = (4,) + (get_params("tiny").phi,) + (get_params("tiny").n,) * 2
    re, im = rng.uniform(-2, 2, size=shape), rng.uniform(-2, 2, size=shape)
    return re, im, res


def test_sharded_pipeline_matches_unsharded_bit_for_bit(sharded_pipeline):
    re, im, res = sharded_pipeline
    assert res[0]["equal_unsharded"]
    ctx = HEContext(get_params("tiny"), device="cpu")
    wr, wi = ctx.roundtrip_batch(torch.from_numpy(re), torch.from_numpy(im),
                                 ctx.generate_secret_key())
    assert torch.equal(res[0]["out"][0], wr)
    assert torch.equal(res[0]["out"][1], wi)
    assert [r["block"] for r in res] == [[2, 8, 4, 8]] * 4


def test_sharded_pipeline_matches_jax(sharded_pipeline):
    re, im, res = sharded_pipeline
    jctx = JaxContext(jax_params("tiny"))
    sp = JaxPipeline(jctx, jmesh.make_mesh({"dp": 2, "tp": 4}))
    wr, wi = sp.roundtrip(jnp.asarray(re), jnp.asarray(im),
                          jctx.generate_secret_key())
    np.testing.assert_allclose(res[0]["out"][0].numpy(), np.asarray(wr),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(res[0]["out"][1].numpy(), np.asarray(wi),
                               rtol=0, atol=1e-9)
    assert res[0]["finite"] and res[0]["err"] < 0.5


# -- the W-sharded key switch -----------------------------------------------------

def _coeffs(p, seed, bits=14):
    """A limb-consistent small-coefficient element, W-coeff residues."""
    c = np.random.default_rng(seed).integers(0, 1 << bits, (p.phi, p.n, p.n))
    return np.stack([(c % int(q)).astype(np.uint64) for q in p.moduli])


@pytest.fixture(scope="module")
def sharded_keyswitch():
    jp = jax_params("tiny")
    jctx = JaxContext(jp, ring="nega")
    jrc = jks.RelinContext(jctx)
    jsk = jctx.generate_secret_key()
    jrlk = jrc.gen_relin_key(jnp.asarray(jrng.ternary_secret(jp)),
                             jax.random.key(5))
    jct, jct2 = (jctx.encrypt(jctx.wt.forward(jnp.asarray(_coeffs(jp, s))),
                              jsk) for s in (1, 2))
    want = jrc.multiply_relinearize(jct, jct2, jrlk)
    inputs = (convert.relin_key(jrlk), convert.ciphertext(jct),
              convert.ciphertext(jct2))
    res = launch.run_world(bench_dist.rank_keyswitch, 4, "gloo", "cpu",
                           WORLD_S, "tiny", 4, inputs)
    return want, res


def test_sharded_keyswitch_matches_jax(sharded_keyswitch):
    want, res = sharded_keyswitch
    got = res[0]["out"]
    np.testing.assert_array_equal(_u64(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(_u64(got.a), np.asarray(want.a))


def test_sharded_keyswitch_matches_unsharded(sharded_keyswitch):
    _, res = sharded_keyswitch
    assert res[0]["equal_unsharded"]
    assert all(r["same_inputs"] for r in res)
    W = get_params("tiny").phi
    assert [r["block"][1] for r in res] == [W // 4] * 4


def test_sharded_keyswitch_own_keys_noise():
    """Every rank makes the keys from one seed (the checksums agree) and
    the sharded product decrypts within the relinearization noise bound
    of tests/test_keyswitch.py."""
    res = launch.run_world(bench_dist.rank_keyswitch, 2, "gloo", "cpu",
                           WORLD_S, "tiny", 2)
    assert all(r["same_inputs"] for r in res)
    assert res[0]["equal_unsharded"]
    assert 0 <= res[0]["noise"] < 1 << 25


# -- multi-host plumbing and the cost model -----------------------------------

@pytest.fixture(scope="module")
def multihost_world():
    return launch.run_world(bench_dist.rank_multihost, 4, "gloo", "cpu",
                            WORLD_S, 2, 2)


@pytest.mark.parametrize("check", ["dp_ok", "coeff_ok", "inverse_ok"])
def test_hybrid_mesh_and_cross_process_all_to_all(multihost_world, check):
    assert [r["rank"] for r in multihost_world] == [0, 1, 2, 3]
    assert all(r[check] for r in multihost_world)


def test_global_from_host_data_and_local_shards(one_rank_group):
    m = multihost.hybrid_mesh({"dp": 1}, {"coeff": 1}, "cpu")
    full = np.arange(24, dtype=np.uint64).reshape(2, 3, 4)
    blk = multihost.global_from_host_data(full, m, (None, "dp", "coeff"))
    ((idx, data),) = multihost.local_shards(blk, m, (None, "dp", "coeff"),
                                            full.shape)
    np.testing.assert_array_equal(_u64(data), full[idx])
    assert data.dtype == torch.int64 and tuple(data.shape) == full.shape


def test_multiprocess_cli_mode():
    out = bench_dist.multiprocess(2, timeout_s=WORLD_S)
    assert out["ok"] and out["processes"] == 2


@pytest.mark.parametrize("d", [4, 8])
def test_cost_model_matches_jax(d, monkeypatch):
    plan = FourStepPlan.make(1 << 17, generate_primes_1mod(2, 35, 1 << 18),
                             n1=512)
    monkeypatch.setenv("MFHE_ICI_GBPS", "450")
    monkeypatch.setenv("MFHE_DCN_GBPS", "50")
    want = jax_bench_dist.cost_model_inputs(plan, d,
                                            measured_ntt16_rate=1.05e6)
    got = bench_dist.cost_model_inputs(plan, d, ntt16_rate=1.05e6,
                                       ici_gbps=450, dcn_gbps=50)
    # the port's anchor is always the caller's figure: no flag says so
    assert want.pop("anchor_is_measured") is True
    assert got == want


def test_card_mode_on_cpu_ranks():
    """bench_dist's card mode at --quick shapes on four CPU ranks: both
    sharded NTTs equal the single-rank transform."""
    out = bench_dist.card(4, "gloo", 1.05e6, 450, 50, quick=True,
                          device="cpu", timeout_s=WORLD_S)
    assert out["ok"] and out["ranks"] == 4 and "note" not in out
    plan = FourStepPlan.make(1 << 13, generate_primes_1mod(4, 35, 1 << 14))
    assert out["cost_model"] == bench_dist.cost_model_inputs(
        plan, 4, ntt16_rate=1.05e6, ici_gbps=450, dcn_gbps=50)


def test_card_mode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_dist.card(4, "gloo", 1.05e6, 450, 50)


def test_card_mode_cli_needs_the_backend(capsys):
    with pytest.raises(SystemExit):
        bench_dist.main(["--ntt16-rate", "1e6", "--ici-gbps", "450",
                         "--dcn-gbps", "50"])
    assert "--backend" in capsys.readouterr().err


def test_cost_model_has_no_default_figures():
    plan = FourStepPlan.make(1 << 17, generate_primes_1mod(1, 35, 1 << 18))
    with pytest.raises(TypeError):
        bench_dist.cost_model_inputs(plan, 4)


# -- the launch windows -----------------------------------------------------------

@pytest.fixture
def counted_calls(monkeypatch):
    """K1 / K10a-tw / K2 wrapper calls counted on the CPU under the keys
    their kernels count launches by on the card."""
    stage_call, k2_call = Stage.__call__, NttMulNtt.__call__

    def stage(self, data, twiddle_mont=None):
        be.LAUNCHES[self.launch_key(twiddle_mont is not None)] += 1
        return stage_call(self, data, twiddle_mont)

    def k2(self, a, s_mont):
        be.LAUNCHES["ntt_mul_ntt"] += 1
        return k2_call(self, a, s_mont)

    monkeypatch.setattr(Stage, "__call__", stage)
    monkeypatch.setattr(NttMulNtt, "__call__", k2)
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())


def test_dist_ntt_launches_are_its_sharded_calls(one_rank_group,
                                                 counted_calls):
    """A warm-up and a timed call each way: stage 1 x twiddle and stage 2
    forward, the two inverse stages; the reference adds none.  At N = 1024
    both stages contract 32 terms: the X-NTT route's keys."""
    res = bench_dist.rank_dist_ntt(torch.device("cpu"), N_DIST, BITS_DIST,
                                   2, 2)
    assert res["equal_single"] and res["inverse_exact"]
    assert res["launches"] == {"stage_tw_x": 2, "stage_x": 6}


def test_keyswitch_launches_leave_out_the_reference(one_rank_group,
                                                    counted_calls):
    """The key switch's window holds its two sharded calls (warm-up and
    timed: twice one multiply_relinearize's launches) and not rank 0's
    unsharded reference, which the run also makes."""
    p = get_params("tiny")
    ctx = HEContext(p, ring="nega", device="cpu")
    rc = RelinContext(ctx)
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(trng.ternary_secret(p, "cpu"),
                           torch.Generator().manual_seed(5))
    ct1, ct2 = (ctx.encrypt(torch.from_numpy(_coeffs(p, s).view(np.int64)),
                            sk) for s in (1, 2))
    before = collections.Counter(be.LAUNCHES)
    rc.multiply_relinearize(ct1, ct2, rlk)
    one = collections.Counter(be.LAUNCHES) - before
    assert one["stage"] > 0 and one["stage_tw_x"] > 0
    before = collections.Counter(be.LAUNCHES)
    res = bench_dist.rank_keyswitch(torch.device("cpu"), "tiny", 1,
                                    (rlk, ct1, ct2))
    run = collections.Counter(be.LAUNCHES) - before
    assert res["equal_unsharded"]
    assert res["launches"] == {k: 2 * v for k, v in one.items()}
    assert all(run[k] - res["launches"][k] >= v for k, v in one.items())
