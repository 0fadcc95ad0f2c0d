"""Port tables and parameters (matrix_fhe_tpu_torch) against the JAX package.

Every GLTables field must equal the JAX one for tiny/small/mid, and the ref
preset must match the reference's config.h limb for limb.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.tables import build_tables as jax_tables
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import (REF_P_MODULI, REF_RNS_MODULI,
                                         get_params, list_params)
from matrix_fhe_tpu_torch.native import tablegen
from matrix_fhe_tpu_torch.tables import (build_tables, cyclotomic_two_primes,
                                         lagrange_inverse_mod,
                                         vandermonde_mod)

PARAM_FIELDS = ("name", "n", "p", "moduli", "delta", "p_moduli", "sigma",
                "phi", "p_factors", "num_limbs", "w_exponents", "q_total")


@pytest.mark.parametrize("preset", sorted(set(list_params())))
def test_params_equal(preset):
    mine, ref = get_params(preset), jax_params(preset)
    for f in PARAM_FIELDS:
        assert getattr(mine, f) == getattr(ref, f), f


@pytest.mark.parametrize("preset", ["tiny", "small", "mid"])
def test_every_table_field_equal(preset):
    mine, ref = build_tables(get_params(preset)), jax_tables(jax_params(preset))
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(mine)]
    for name in names:
        if name == "params":
            continue
        a, b = getattr(mine, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert ([dataclasses.astuple(c) for c in mine.mont]
            == [dataclasses.astuple(c) for c in ref.mont])


def test_ref_params_match_config_h():
    """config.h:7-52: n=64, p=771=3*257, phi=512, 1x45-bit + 10x35-bit
    limbs == 1 mod lcm(4n, p), Delta=2^35, three reserved P primes."""
    p = get_params("ref")
    assert (p.n, p.p, p.phi, p.num_limbs) == (64, 771, 512, 11)
    assert p.delta == 2.0 ** 35
    assert p.moduli == REF_RNS_MODULI == jax_params("ref").moduli
    assert p.p_moduli == REF_P_MODULI
    assert [q.bit_length() for q in p.moduli] == [45] + [35] * 10
    for q in p.moduli:
        assert (q - 1) % 197376 == 0
    assert p.w_exponents == jax_params("ref").w_exponents


def test_native_tablegen_matches_python_oracle():
    """The ctypes binding of the JAX package's tablegen.cpp agrees with the
    pure-Python Vandermonde / Lagrange code (the oracle)."""
    if not tablegen.available():
        pytest.skip("no C++ compiler: the Python tables are in use")
    p = get_params("small")
    q = p.moduli[1]
    master = cyclotomic_two_primes(p.p, *p.p_factors)
    eta = build_tables(p).eta[1]
    roots = [pow(eta, e, q) for e in p.w_exponents]
    v, vi = tablegen.wcrt_tables(q, roots, master)
    np.testing.assert_array_equal(v, vandermonde_mod(roots, q))
    np.testing.assert_array_equal(vi, lagrange_inverse_mod(roots, master, q))


def test_convert_tables_every_field():
    """convert.tables turns each package's GLTables into the same tensors."""
    mine = convert.tables(build_tables(get_params("tiny")))
    ref = convert.tables(jax_tables(jax_params("tiny")))
    assert mine.keys() == ref.keys()
    for name, v in ref.items():
        if name == "params":
            continue
        if isinstance(v, torch.Tensor):
            assert torch.equal(mine[name], v), name
        else:
            assert mine[name] == v, name
