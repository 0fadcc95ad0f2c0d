"""The launches line of the port's entry points holds their own calls.

Each example, the bench and the dryrun's programs print the kernel
launches of the program's own calls (ops._backend.Launches), not those of
its set-up, keys, encryptions, oracles, baselines, fences or rank 0's
unsharded references.  On the CPU no kernel launches, so here the kernel
wrappers' calls are counted under the keys their kernels count launches by
on the card, and each program's own calls are counted apart by wrapping
them: the line must equal the latter, while the run as a whole launches
more.
"""

import collections

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_workers  # noqa: F401
from matrix_fhe_tpu_torch import entry
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.examples import (leveled, main, matmul, matmul_gl2,
                                           relinearize)
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.models.he2 import Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin
from matrix_fhe_tpu_torch.models.keyswitch import RelinContext
from matrix_fhe_tpu_torch.models.leveled import LeveledChain
from matrix_fhe_tpu_torch.ops import _backend as be
from matrix_fhe_tpu_torch.ops.cgemm import Gemm2x2
from matrix_fhe_tpu_torch.ops.cuda_ntt import NttMulNtt, Stage
from matrix_fhe_tpu_torch.ops.ntt_large import FourStepNTT
from matrix_fhe_tpu_torch.parallel import multihost
from matrix_fhe_tpu_torch.parallel.dist_ntt import DistFourStepNTT
from matrix_fhe_tpu_torch.parallel.gl2 import ShardedGl2Gemm
from matrix_fhe_tpu_torch.parallel.keyswitch import ShardedKeySwitch
from matrix_fhe_tpu_torch.scripts import bench

CPU = torch.device("cpu")


@pytest.fixture
def counted(monkeypatch):
    """The kernel wrappers' calls counted in be.LAUNCHES on the CPU (K1,
    K10a-tw, K2, K7, K5 forward and inverse), and own(owner, *names):
    those methods' launches also summed into the returned Counter, a
    nested call once."""
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter())

    def counting(owner, name, key_of):
        fn = getattr(owner, name)

        def call(*args, **kwargs):
            be.LAUNCHES[key_of(*args, **kwargs)] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(owner, name, call)

    counting(Stage, "__call__", lambda self, data, twiddle_mont=None:
             self.launch_key(twiddle_mont is not None))
    counting(NttMulNtt, "__call__", lambda *a: "ntt_mul_ntt")
    counting(Gemm2x2, "__call__", lambda *a: "gemm2x2")
    counting(FourStepNTT, "forward", lambda *a: "four_step_fwd")
    counting(FourStepNTT, "inverse", lambda *a: "four_step_inv")

    counts = collections.Counter()
    depth = [0]

    def own(owner, *names):
        for name in names:
            fn = getattr(owner, name)

            def call(*args, _fn=fn, **kwargs):
                before = collections.Counter(be.LAUNCHES)
                depth[0] += 1
                try:
                    return _fn(*args, **kwargs)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:
                        counts.update(be.LAUNCHES - before)
            monkeypatch.setattr(owner, name, call)
        return counts

    return own


# (module, [(owner, method names)] of the program's own calls)
EXAMPLES = {
    "main": (main, [(main, ("steps",))]),
    "matmul": (matmul, [(matmul, ("product",))]),
    "matmul_gl2": (matmul_gl2, [(Gl2GemmRelin, ("matmul",)),
                                (Gl2Context, ("decrypt_and_decode",))]),
    "relinearize": (relinearize, [(RelinContext, ("multiply_relinearize",))]),
    "leveled": (leveled, [(LeveledChain, ("multiply", "rescale", "mod_switch",
                                          "rotate", "decrypt_to_eval"))]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_launches_are_its_own_calls(counted, name):
    mod, owned = EXAMPLES[name]
    for owner, names in owned:
        own = counted(owner, *names)
    res = mod.run("tiny", device="cpu")
    assert res["ok"], res
    assert own and res["launches"] == dict(own)
    total = be.LAUNCHES
    assert all(total[k] >= v for k, v in own.items())
    assert sum(total.values()) > sum(own.values())     # set-up and checks


def test_bench_launches_are_its_timed_calls(counted, monkeypatch):
    """The timed forward chains (two of --iters at 35 bits, two of
    max(10, iters / 2) at 28) and the ref gate's roundtrips; not the
    fences' forward and inverse, nor the gate's keys."""
    monkeypatch.setattr(bench, "NTT_N", 4096)
    monkeypatch.setattr(bench, "NTT_L", 2)
    monkeypatch.setattr(bench, "GATE_PRESET", "tiny")
    own = counted(HEContext, "roundtrip")
    res = bench.run(batch=2, iters=2, device="cpu")
    assert own["stage"] > 0 and own["ntt_mul_ntt"] > 0
    assert res["launches"] == dict(sorted(
        (own + collections.Counter(four_step_fwd=2 * 2 + 2 * 10)).items()))
    assert be.LAUNCHES["four_step_inv"] == 2         # the fences


@pytest.fixture
def one_rank(tmp_path, monkeypatch):
    """This process as a world of one gloo rank."""
    monkeypatch.setenv("MFHE_COORDINATOR", f"file://{tmp_path}/rendezvous")
    monkeypatch.setenv("MFHE_NUM_PROCS", "1")
    monkeypatch.setenv("MFHE_PROC_ID", "0")
    assert multihost.init_distributed(backend="gloo") is False
    try:
        yield
    finally:
        dist.destroy_process_group()


def _program(name):
    p = get_params(entry.DRYRUN_PRESET)
    rng = np.random.default_rng(0)
    shape = (p.phi, p.n, p.n)
    return {"ntt": lambda: entry._dist_ntt(CPU),
            "keyswitch": lambda: entry._keyswitch(
                CPU, p, rng.integers(0, 1 << 12, size=shape)),
            "gl2": lambda: entry._gl2(CPU, p, rng.uniform(-2, 2, shape),
                                      rng.uniform(-2, 2, shape))}[name]


@pytest.mark.parametrize("name,owner,names", [
    ("ntt", DistFourStepNTT, ("forward", "inverse")),
    ("keyswitch", ShardedKeySwitch, ("multiply_relinearize",)),
    ("gl2", ShardedGl2Gemm, ("matmul",))])
def test_dryrun_launches_are_its_sharded_calls(one_rank, counted, name,
                                               owner, names):
    """Each dryrun program's launches are its sharded calls'; the keys,
    the encryptions and rank 0's unsharded reference launch besides."""
    own = counted(owner, *names)
    res = _program(name)()
    assert own and res["launches"] == dict(own)
    assert sum(be.LAUNCHES.values()) > sum(own.values())
    assert res.get("equal_single", res.get("equal_unsharded"))


def test_launches_sums_its_blocks(monkeypatch):
    monkeypatch.setattr(be, "LAUNCHES", collections.Counter(stage=3))
    own = be.Launches()
    with own:
        be.LAUNCHES["stage"] += 2
    be.LAUNCHES["stage_tw"] += 5                     # outside: not counted
    with own:
        be.LAUNCHES.update(stage_tw=1, gemm2x2=4)
    assert own.counts() == {"gemm2x2": 4, "stage": 2, "stage_tw": 1}
