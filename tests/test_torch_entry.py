"""The port's top-level entry points (matrix_fhe_tpu_torch.entry) on the CPU.

dryrun_multichip(n) runs the JAX dryrun's four programs at tiny on a
world of n gloo CPU ranks, each with the JAX dryrun's check and, beside
it, bit-for-bit equality with the unsharded program (ShardedGl2Gemm with
Gl2GemmRelin.matmul among them); ShardedGl2Gemm is also held directly on
two different ciphertexts.  The port's Gl2GemmRelin.matmul equals the JAX
package's on converted keys (tests/test_torch_gl2_relin.py).  entry() is
the mid roundtrip's (fn, args).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu_torch import entry
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.he2 import Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin, HEMatmul2
from matrix_fhe_tpu_torch.parallel import launch
from matrix_fhe_tpu_torch.parallel import mesh as meshlib
from matrix_fhe_tpu_torch.parallel.gl2 import ShardedGl2Gemm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(ranks):
    """Every check holds: roundtrip error < 1.0 and == roundtrip_batch,
    the dist NTT exact and == FourStepNTT.forward, the W-sharded multiply
    == unsharded, the W-sharded gl2 GEMM == Gl2GemmRelin.matmul and its
    relative error < 0.01; no kernel launched on the CPU."""
    res = entry.dryrun_multichip(ranks, device="cpu", timeout_s=300)
    assert res["ok"] and all(res["checks"].values()), res["checks"]
    assert len(res["checks"]) == 7
    assert res["ranks"] == ranks and res["launches"] == {}
    assert set(res["program_wall_s"]) == {"pipeline", "ntt", "keyswitch",
                                          "gl2"}


def _gl2_rank(device, ks, ctX, ctY) -> dict:
    """One rank: ShardedGl2Gemm at tiny on the given keys and ciphertexts,
    gathered."""
    gr = Gl2GemmRelin(HEMatmul2(Gl2Context(get_params("tiny"),
                                           device=device)))
    mesh = meshlib.make_mesh({"tp": torch.distributed.get_world_size()},
                             device.type)
    sg = ShardedGl2Gemm(gr, mesh, "tp")
    out = sg.matmul(sg.shard(ctX), sg.shard(ctY), sg.shard_key(ks))
    return {"lanes": (sg.lanes.start, sg.lanes.stop), "out": sg.gather(out)}


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_gl2_gemm_equals_the_unsharded(ranks):
    """ShardedGl2Gemm of two different ciphertexts (the dryrun squares
    one), so Y's lanes cross the ranks in sigma's lane flip: every rank's
    gathered standard ciphertext equals Gl2GemmRelin.matmul bit for bit."""
    p = get_params("tiny")
    gr = Gl2GemmRelin(HEMatmul2(Gl2Context(p, device="cpu")))
    gen = torch.Generator().manual_seed(6)
    sk = gr.ctx.generate_secret_key(gen)
    rng = np.random.default_rng(4)
    cts = [gr.ctx.encrypt(gr.ctx.encode(
        torch.from_numpy(rng.uniform(-1, 1, (p.phi, p.n, p.n))),
        torch.from_numpy(rng.uniform(-1, 1, (p.phi, p.n, p.n)))), sk, gen)
        for _ in range(2)]
    ks = gr.gen_keys(sk, gen)
    want = gr.matmul(*cts, ks)
    res = launch.run_world(_gl2_rank, ranks, "gloo", "cpu", 300, ks, *cts)
    w = p.phi // ranks
    assert [r["lanes"] for r in res] == [(i * w, (i + 1) * w)
                                        for i in range(ranks)]
    for r in res:
        assert torch.equal(r["out"].b, want.b)
        assert torch.equal(r["out"].a, want.a)


def test_entry_is_the_mid_roundtrip():
    """entry(device="cpu"): fn(*args) decodes the reference input pattern
    at mid within 1e-4 (the flagship contract)."""
    fn, (re, im, s_mont) = entry.entry(device="cpu")
    p = get_params("mid")
    assert re.shape == im.shape == (p.phi, p.n, p.n)
    assert s_mont.shape == (len(p.moduli), p.phi, p.n)
    dr, di = fn(re, im, s_mont)
    assert float(torch.hypot(dr - re, di - im).max()) < 1e-4


def test_dryrun_command_needs_the_card():
    """python -m matrix_fhe_tpu_torch.entry --dryrun 2 without --device
    cpu exits nonzero on a host without CUDA, before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run([sys.executable, "-m", "matrix_fhe_tpu_torch.entry",
                           "--dryrun", "2"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "[dryrun] OK" not in proc.stdout
