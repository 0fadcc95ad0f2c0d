"""Port randomness (matrix_fhe_tpu_torch.models.rng) against the JAX streams.

The reference-parity streams are pure functions of position and must match
the JAX package's integers exactly.  The Gaussian stream goes through f64
log/cos/sqrt, which PyTorch and XLA may round differently by an ulp; the
test still compares exactly (an ulp moves the rounded integer only at a
half-integer), over the full W x n x n stream of the 512-lane presets.
"""

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import rng as jrng
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import rng as trng


def _u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("preset", ["tiny", "small", "mid"])
def test_uniform_a_matches(preset):
    """tiny (30-bit q) and small/mid (35/45-bit q) take different JAX code
    paths (u64 modulo vs the u32-pair Barrett)."""
    got = trng.uniform_a(get_params(preset), "cpu")
    np.testing.assert_array_equal(_u64(got),
                                  np.asarray(jrng.uniform_a(jax_params(preset))))


@pytest.mark.parametrize("preset", ["tiny", "small", "mid"])
def test_ternary_secret_matches(preset):
    got = trng.ternary_secret(get_params(preset), "cpu")
    np.testing.assert_array_equal(
        _u64(got), np.asarray(jrng.ternary_secret(jax_params(preset))))


@pytest.mark.parametrize("preset", ["tiny", "small", "mid"])
def test_gaussian_noise_matches(preset):
    """mid has the ref preset's W=512, n=64: the whole ref noise stream."""
    got = _u64(trng.gaussian_noise(get_params(preset), "cpu"))
    want = np.asarray(jrng.gaussian_noise(jax_params(preset)))
    np.testing.assert_array_equal(got, want)


def test_fresh_streams_are_valid_and_seeded():
    p = get_params("small")
    q = np.array(p.moduli, dtype=np.int64).reshape(-1, 1, 1, 1)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (trng.fresh_uniform_a(g, p, "cpu"),
                trng.fresh_ternary_secret(g, p, "cpu"),
                trng.fresh_gaussian_noise(g, p, "cpu"))

    a, s, e = draw(5)
    a2, s2, e2 = draw(5)
    assert torch.equal(a, a2) and torch.equal(s, s2) and torch.equal(e, e2)
    assert not torch.equal(a, draw(6)[0])
    assert a.shape == (p.num_limbs, p.phi, p.n, p.n)
    assert ((a.numpy() >= 0) & (a.numpy() < q)).all()
    # ternary: {0, 1, q-1}, the same integer in every limb
    centered = np.where(s.numpy() > q[..., 0] // 2, s.numpy() - q[..., 0],
                        s.numpy())
    assert set(np.unique(centered)) == {-1, 0, 1}
    assert (centered == centered[:1]).all()
    ce = np.where(e.numpy() > q // 2, e.numpy() - q, e.numpy())
    assert (ce == ce[:1]).all()
    assert abs(ce[0].std() - p.sigma) < 0.2
