"""Key / ciphertext serialization (checkpoint-resume).

Counterpart of matrix_fhe_tpu/utils/serialization.py, in the same file
format: a compressed .npz container with the same keys, residues written
as uint64 (a view of the port's canonical int64 residues, all below 2^56)
and a params fingerprint (sha256 of the same JSON), so a checkpoint written
by either package loads into either one, and a restored object is
guaranteed to match its context.  Switching and rotation keys live over a
RelinContext's QP basis and are fingerprinted against its ext_params (the
Q chain AND the P basis): a key restored into a context with a different
P basis is garbage, not just mismatched.

Keys load onto the device of `rc.ctx`; ciphertexts, secret keys and
matmul tensors onto an explicit `device` ("cuda" unless asked).
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..config import GLParams
from ..convert import residues
from ..models.he import Ciphertext, SecretKey
from ..ops._backend import resolve_device


def params_fingerprint(p: GLParams) -> str:
    blob = json.dumps({
        "n": p.n, "p": p.p, "moduli": [int(q) for q in p.moduli],
        "delta": p.delta,
    }, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _u64(x: torch.Tensor) -> np.ndarray:
    """Canonical int64 residues -> the uint64 array of the file format."""
    return np.ascontiguousarray(x.detach().cpu().numpy()).view(np.uint64)


def _check(z, params: GLParams) -> None:
    fp = str(z["fp"])
    want = params_fingerprint(params)
    if fp != want:
        raise ValueError(
            f"checkpoint was written for params {fp}, context has {want}")


def save_ciphertext(path: str, ct: Ciphertext, params: GLParams) -> None:
    np.savez_compressed(path, b=_u64(ct.b), a=_u64(ct.a),
                        fp=params_fingerprint(params))


def load_ciphertext(path: str, params: GLParams, device="cuda") -> Ciphertext:
    dev = resolve_device(device)
    z = np.load(path)
    _check(z, params)
    return Ciphertext(b=residues(z["b"], dev), a=residues(z["a"], dev))


def save_secret_key(path: str, sk: SecretKey, params: GLParams) -> None:
    np.savez_compressed(path, s_mont=_u64(sk.s_mont),
                        fp=params_fingerprint(params))


def load_secret_key(path: str, params: GLParams, device="cuda") -> SecretKey:
    dev = resolve_device(device)
    z = np.load(path)
    _check(z, params)
    return SecretKey(s_mont=residues(z["s_mont"], dev))


def save_matmul_tensor(path: str, tt, params: GLParams) -> None:
    """Checkpoint a homomorphic-GEMM tensor (models/he_matmul.MatmulTensor):
    the rank-2 object a server ships back for two-sided-key decryption."""
    np.savez_compressed(path, fp=params_fingerprint(params),
                        **{k: _u64(v) for k, v in tt._asdict().items()})


def load_matmul_tensor(path: str, params: GLParams, device="cuda"):
    from ..models.he_matmul import MatmulTensor
    dev = resolve_device(device)
    z = np.load(path)
    _check(z, params)
    return MatmulTensor(**{k: residues(z[k], dev)
                           for k in MatmulTensor._fields})


# -- switching / rotation keys (models/keyswitch.py) -------------------------

def _pack_relin(rk, prefix: str = "") -> dict:
    arrs = {f"{prefix}dnum": np.asarray(len(rk.b))}
    for i, (b, a) in enumerate(zip(rk.b, rk.a)):
        arrs[f"{prefix}b{i}"] = _u64(b)
        arrs[f"{prefix}a{i}"] = _u64(a)
    return arrs


def _unpack_relin(z, device, prefix: str = ""):
    from ..models.keyswitch import RelinKey
    d = int(z[f"{prefix}dnum"])
    return RelinKey(
        b=tuple(residues(z[f"{prefix}b{i}"], device) for i in range(d)),
        a=tuple(residues(z[f"{prefix}a{i}"], device) for i in range(d)))


def save_relin_key(path: str, rk, rc) -> None:
    """Checkpoint a switching key (RelinKey: dnum (b, a) digit pairs)."""
    np.savez_compressed(path, fp=params_fingerprint(rc.ext_params),
                        **_pack_relin(rk))


def load_relin_key(path: str, rc):
    z = np.load(path)
    _check(z, rc.ext_params)
    return _unpack_relin(z, rc.ctx.device)


def save_galois_keys(path: str, gk, _kind: str | None = None) -> None:
    """Checkpoint a GaloisKeys / XGaloisKeys set: only the per-index
    switching keys travel; permutation and sign tables are pure functions
    of the parameter set and are re-derived on load.  The file carries a
    kind tag ("w" / "x") so loading with the wrong-axis loader raises
    instead of silently building wrong rotation keys.  A FullGaloisKeys
    goes to save_full_galois_keys."""
    from ..models.keyswitch import FullGaloisKeys, XGaloisKeys
    if isinstance(gk, FullGaloisKeys) and _kind is None:
        save_full_galois_keys(path, gk)
        return
    kind = _kind or ("x" if isinstance(gk, XGaloisKeys) else "w")
    arrs = {"idx": np.asarray(sorted(gk._keys)), "kind": np.asarray(kind)}
    for j in sorted(gk._keys):
        arrs.update(_pack_relin(gk._keys[j], prefix=f"k{j}_"))
    np.savez_compressed(path, fp=params_fingerprint(gk.rc.ext_params),
                        **arrs)


def _load_key_dict(path: str, rc, kind: str) -> dict:
    z = np.load(path)
    _check(z, rc.ext_params)
    got = str(z["kind"]) if "kind" in z else kind
    if got != kind:
        loader = {"x": "load_x_galois_keys", "w": "load_galois_keys",
                  "w-full": "load_full_galois_keys"}.get(got, "?")
        raise ValueError(
            f"checkpoint holds {got!r}-kind Galois keys; use {loader}")
    return {int(j): _unpack_relin(z, rc.ctx.device, prefix=f"k{int(j)}_")
            for j in z["idx"]}


def load_galois_keys(path: str, rc):
    """Restore a W-axis GaloisKeys set into `rc` (no key generation)."""
    from ..models.keyswitch import GaloisKeys, w_automorphism_perm
    keys = _load_key_dict(path, rc, "w")
    perms = {j: w_automorphism_perm(rc.ctx.params, j) for j in keys}
    return GaloisKeys.from_keys(rc, perms, keys)


def save_full_galois_keys(path: str, fk) -> None:
    """Checkpoint a FullGaloisKeys set (the inner generator-tower keys;
    group tables are a pure function of p and rebuild on load).  Tagged
    'w-full' so the plain-GaloisKeys loader rejects it and vice versa."""
    save_galois_keys(path, fk._gk, _kind="w-full")


def load_full_galois_keys(path: str, rc):
    from ..models.keyswitch import FullGaloisKeys
    return FullGaloisKeys.from_keys(rc, _load_key_dict(path, rc, "w-full"))


def load_x_galois_keys(path: str, rc):
    """Restore an X-axis XGaloisKeys set into `rc`."""
    from ..models.keyswitch import XGaloisKeys
    return XGaloisKeys.from_keys(rc, rc.x_dim, _load_key_dict(path, rc, "x"))
