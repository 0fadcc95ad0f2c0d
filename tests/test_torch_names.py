"""Every public name of the JAX package has a counterpart in the port.

Each module of matrix_fhe_tpu/ and the module of the same path under
matrix_fhe_tpu_torch/ are read with `ast`, never imported.  A public name
of a JAX module is a top-level function or class, or a method of a public
class, whose name has no leading underscore.  Its counterpart in the port
module is a top-level def, class, assignment or import (a re-export such
as ntt_large's generate_primes_1mod), or, for a method, a method of the
class of the same name, a class-level assignment (an alias such as
RelinContext.multiply_relinearize_streamed) or a `self.x =` attribute.

A JAX name without one must stand in EXCLUDED with its reason: the routes
and switches that exist because of the TPU (u32 word pairs, split-f32
matmuls, the int8 digit grid, Pallas and jit wrappers, NamedSharding) and
one function that is broken in the JAX package.  An entry that is no
longer needed (the name has left JAX or has a counterpart) fails too, so
the table stays exact.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "matrix_fhe_tpu")
PORT_PKG = os.path.join(ROOT, "matrix_fhe_tpu_torch")

U32_PAIR = ("u32-pair route: the TPU has no 64-bit integer lanes, so JAX "
            "carries words as (lo, hi) u32 planes; the port's words are "
            "int64 tensors")
U64_CAST = ("uint64 cast helper: the port holds residues in int64 tensors "
            "(ops/modmath.to_signed64, moduli_col)")
MONT = ("Montgomery product on u32 halves: the port multiplies mod q "
        "exactly (ops/modmath.mul_mod) and keeps only the storage form "
        "(to_mont)")
HOST_POW = "wraps Python's pow(x, e, q) / pow(x, -1, q), which the port calls"
F64_CONV = ("f64 <-> u32 / u64 conversion workaround of the TPU (a direct "
            "f64 -> uint32 convert clamps at 2^31 there); torch converts "
            "int64 and float64 directly")
SPLIT_F32 = ("split-f32 matmul: the TPU's MXU has no f64; the port's "
             "W-DFT runs the fixed-point route (ExactComplexMatmul, K4)")
SWITCH = ("TPU switch or *_default: chooses between the JAX package's "
          "routes; the port has one route (a CPU tensor takes the plain "
          "twin, a CUDA tensor the kernel)")
TWO_PASS = ("the unfused decode compose of JAX's non-Pallas route; the "
            "port composes through WTransform.inverse_scaled_compose (K3 "
            "and its plain twin) and ddfloat.compose_tail_from_partials")
INT8_GRID = ("the TPU's 7-bit int8 digit grid and its limb runs; the port's "
             "plain matmul splits 16-bit digits on float64 "
             "(ops/modmatmul.modmatmul) and K1 its own u8 digit planes "
             "(ops/cuda_ntt.Stage)")
JIT = ("jit wrapper (*_fn): torch has no trace to cache; the method "
       "itself is the counterpart")
SHARDING = ("jax.sharding.NamedSharding helper: the port keeps its specs "
            "as tuples of mesh axis names (parallel/mesh.msg_spec)")

EXCLUDED = {
    "ops/_backend.py": {
        "force_tpu_path": SWITCH,
        "pallas_interpret_default": SWITCH,
        "tpu_kernels_default": SWITCH,
    },
    "ops/ddfloat.py": {
        "fast_float_default": SWITCH,
        "dd_transforms_default": SWITCH,
        "dd_matmul": SPLIT_F32,
        "dd_cmatmul": SPLIT_F32,
        "f64_to_u32_exact": F64_CONV,
        "f64_mod_to_pair": U32_PAIR,
        "f64_mod_to_u64": F64_CONV,
        "u64_pair_f64": F64_CONV,
        "compose_scaled_to_float": TWO_PASS,
        "compose_scaled_pair_to_float": U32_PAIR,
    },
    "ops/fpmatmul.py": {"fp_transforms_default": SWITCH},
    "ops/gint.py": {
        "to_complex": ("raises AttributeError in the JAX package and has no "
                       "caller (ROADMAP.md section 3)"),
    },
    "ops/modmath.py": {
        "to_u64": U64_CAST,
        "u64c": U64_CAST,
        "mulhi64": MONT,
        "mont_mul": MONT,
        "from_mont": MONT,
        "mont_consts_arrays": MONT,
        "host_pow_mod": HOST_POW,
        "host_inv_mod": HOST_POW,
        "pair_split": U32_PAIR,
        "pair_join": U32_PAIR,
        "pair_add_mod": U32_PAIR,
        "pair_sub_mod": U32_PAIR,
        "pair_consts": U32_PAIR,
    },
    "ops/modmatmul.py": {
        "BatchedModTransform": INT8_GRID,
        "limb_runs": INT8_GRID,
        "chunk_decompose": INT8_GRID,
        "chunked_dot_combine": INT8_GRID,
        "modmatmul_chunked": INT8_GRID,
        "num_chunks": INT8_GRID,
        "pow2r_table": INT8_GRID,
    },
    "ops/ntt.py": {"XNTT.mul_s_pair": U32_PAIR},
    "ops/wcrt.py": {
        "WTransform.forward_pair": U32_PAIR,
        "WTransform.inverse_scaled_pair": U32_PAIR,
        "WTransform.inverse_scaled_compose_pair": U32_PAIR,
        "WTransform.dft_words_available": SWITCH,
    },
    "models/encoder.py": {
        "Encoder.quantize_pair": U32_PAIR,
        "Encoder.words_available": SWITCH,
    },
    "models/he.py": {"HEContext.roundtrip_fn": JIT},
    "models/he2.py": {
        "Gl2Context.decode_fn": JIT,
        "Gl2Context.decrypt_to_eval_fn": JIT,
        "Gl2Context.encode_fn": JIT,
        "Gl2Context.encrypt_fn": JIT,
    },
    "models/he_matmul2.py": {"Gl2GemmRelin.relinearize_fn": JIT},
    "models/rng.py": {"uniform_a_pair": U32_PAIR},
    "parallel/mesh.py": {
        "msg_sharding": SHARDING,
        "packed_sharding": SHARDING,
    },
}

# JAX modules with no port module of their path
EXCLUDED_MODULES = {
    "ops/pallas_ntt.py": ("the Pallas TPU kernels K1-K3, K5, K8, K10a-d; "
                          "their Hopper kernels are csrc/stage.cu, "
                          "ntt_mul_ntt.cu, inv_compose.cu, four_step_ntt.cu "
                          "behind ops/cuda_ntt.py and ops/ntt_large.py"),
    "ops/pallas_cgemm.py": ("the Pallas TPU kernels K6, K7; their Hopper "
                            "kernels are csrc/cgemm.cu, gemm2x2.cu behind "
                            "ops/cgemm.py"),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_names(source: str) -> set:
    """Public top-level functions and classes, and the public methods of
    public classes ("Class.method")."""
    out = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            out.update(f"{node.name}.{b.name}" for b in node.body
                       if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and _public(b.name))
    return out


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        return [node.target]
    return []


def port_names(source: str) -> set:
    """Every name a JAX name may find its counterpart under: top-level
    defs, classes, assignments and imports; each class's methods,
    class-level assignments and `self.x =` attributes."""
    out = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in node.names)
        out.update(t.id for t in _targets(node) if isinstance(t, ast.Name))
        if not isinstance(node, ast.ClassDef):
            continue
        for b in node.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(f"{node.name}.{b.name}")
            out.update(f"{node.name}.{t.id}" for t in _targets(b)
                       if isinstance(t, ast.Name))
        for b in ast.walk(node):
            out.update(f"{node.name}.{t.attr}" for t in _targets(b)
                       if isinstance(t, ast.Attribute)
                       and isinstance(t.value, ast.Name)
                       and t.value.id == "self")
    return out


def _modules() -> list:
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _read(pkg: str, rel: str) -> str:
    with open(os.path.join(pkg, rel), encoding="utf-8") as f:
        return f.read()


MODULES = _modules()


def test_every_jax_module_has_a_port_module():
    missing = [m for m in MODULES
               if not os.path.exists(os.path.join(PORT_PKG, m))
               and m not in EXCLUDED_MODULES]
    assert not missing, f"JAX modules with no port module: {missing}"
    for m in EXCLUDED_MODULES:
        assert m in MODULES, f"{m} has left the JAX package"
        assert not os.path.exists(os.path.join(PORT_PKG, m)), m
    assert set(EXCLUDED) <= set(MODULES)


@pytest.mark.parametrize("module", [m for m in MODULES
                                    if m not in EXCLUDED_MODULES])
def test_every_public_name_has_a_counterpart(module):
    names = jax_names(_read(JAX_PKG, module))
    have = port_names(_read(PORT_PKG, module))
    excluded = EXCLUDED.get(module, {})
    missing = sorted(n for n in names if n not in have and n not in excluded)
    assert not missing, (f"{module}: public JAX names with no port "
                         f"counterpart and no listed exclusion: {missing}")
    stale = sorted(n for n in excluded if n not in names or n in have)
    assert not stale, f"{module}: exclusions no longer needed: {stale}"
    assert all(len(r) > 20 for r in excluded.values())


def test_counterparts_count_aliases_attributes_and_reexports():
    """The counterpart rules themselves, on a made-up module pair."""
    jax_src = (
        "import numpy as np\n"
        "def f(): pass\n"
        "def _private(): pass\n"
        "def reexported(): pass\n"
        "class C:\n"
        "    def m(self): pass\n"
        "    def alias(self): pass\n"
        "    def attr(self): pass\n"
        "    def gone(self): pass\n"
        "    def _hidden(self): pass\n"
        "class _P:\n"
        "    def x(self): pass\n")
    port_src = (
        "from .config import reexported  # noqa: F401\n"
        "def f(): pass\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self.attr = 1\n"
        "    def m(self): pass\n"
        "    alias = m\n")
    names = jax_names(jax_src)
    assert names == {"f", "reexported", "C", "C.m", "C.alias", "C.attr",
                     "C.gone"}
    assert sorted(names - port_names(port_src)) == ["C.gone"]
