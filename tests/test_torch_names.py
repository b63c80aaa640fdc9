"""Name parity between the two packages, read with `ast` (neither is
imported): every public function, class, class method or class-level
name, and module-level assignment that a module of rabbitsalign_tpu/
defines has a counterpart of the same name in the port's module of the
same path, which may define it or import it (a re-export). A name or
module is public when no part of it starts with "_". The exemptions are
listed below, each with its reason; nothing else may be missing."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "rabbitsalign_tpu"
PORT_PKG = ROOT / "rabbitsalign_tpu_torch"

# the XLA and Pallas twins of the port's kernels and their plain versions
TWIN_MODULES = {
    "ops/sw_pallas.py": "the Pallas forward and int16 probe; csrc/sw_forward.cu and "
                        "csrc/int16_probe.cu (ops/sw_cuda.py, ops/int16_probe.py) replace it",
    "ops/tb_pallas.py": "the Pallas traceback; csrc/sw_traceback.cu (ops/tb_cuda.py) replaces it",
    "ops/sw_jax.py": "the lax.scan forward; ops/sw_cuda.py:sw_forward_plain replaces it",
    "ops/traceback.py": "the XLA traceback; ops/tb_cuda.py:sw_traceback_plain replaces it",
    "ops/extend_portable.py": "the lax.scan extend for CPU meshes; the port's extend entry "
                              "points take their plain versions for CPU tensors",
}
NAMES = {
    ("native/__init__.py", "load_seednam"):
        "renamed load_engine, which raises where the JAX function returns None",
    ("pipeline/native_pipeline.py", "prewarm_extend_programs"):
        "renamed prewarm_device: CUDA kernels need no compile a shape",
    ("ops/chain_device.py", "NEG1"): "a jnp int32 constant; torch takes Python ints",
    ("ops/front_device.py", "I32MAX"): "a jnp int32 constant; torch takes Python ints",
    ("ops/seed_device.py", "U64"): "the jnp uint64 dtype; the port carries uint64 as int64 bits",
}


def _assigned(target):
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


def _names(path: Path, with_imports: bool) -> set:
    """The public names `path` defines at module and class level (and,
    with `with_imports`, those it imports), class members as
    "Class.member"."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out.add(f"{node.name}.{sub.name}")
                    elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                        out.update(f"{node.name}.{n}" for t in targets for n in _assigned(t))
        elif isinstance(node, ast.Assign):
            out.update(n for t in node.targets for n in _assigned(t))
        elif isinstance(node, ast.AnnAssign):
            out.update(_assigned(node.target))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not any(part.startswith("_") for part in n.split("."))}


def _modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_exemptions_name_real_gaps():
    """Every exemption is a name the JAX package defines and the port
    lacks, so the list cannot outlive its reason."""
    for rel in TWIN_MODULES:
        assert (JAX_PKG / rel).is_file() and not (PORT_PKG / rel).exists(), rel
    for rel, name in NAMES:
        assert name in _names(JAX_PKG / rel, False), (rel, name)
        assert name not in _names(PORT_PKG / rel, True), (rel, name)


@pytest.mark.parametrize("rel", _modules())
def test_port_has_every_public_name(rel):
    if rel in TWIN_MODULES:
        assert not (PORT_PKG / rel).exists(), f"{rel} is exempt as a twin but the port has it"
        return
    assert (PORT_PKG / rel).is_file(), f"the port has no {rel}"
    missing = _names(JAX_PKG / rel, False) - _names(PORT_PKG / rel, True)
    missing -= {name for (r, name) in NAMES if r == rel}
    assert not missing, f"the port's {rel} lacks {sorted(missing)}"
