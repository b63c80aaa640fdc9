"""The port imports torch and never jax or rabbitsalign_tpu: every module
imports with jax blocked, and no source line imports either."""

import re
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1] / "rabbitsalign_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "rabbitsalign_tpu_torch.ops.sw_cuda" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rabbitsalign_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'rabbitsalign_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_source_imports_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+rabbitsalign_tpu\b"
                     r"|from\s+rabbitsalign_tpu\b|from\s+rabbitsalign_tpu\.)")
    hits = [f"{p}:{i}: {line.strip()}"
            for p in PKG.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if bad.match(line)]
    assert not hits, hits
