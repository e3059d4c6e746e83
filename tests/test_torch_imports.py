"""warp_transducer_tpu_torch stands alone: no module of it imports JAX, its
relatives, or anything of the JAX package warp_transducer_tpu (which it
keeps its own copies of), and it imports with JAX made unimportable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "warp_transducer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "warp_transducer_tpu"}
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_found():
    assert (PKG / "ops" / "rnnt.py") in SOURCES and len(SOURCES) >= 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    # The exact module name: the port's own name starts with the JAX package's.
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'warp_transducer_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import warp_transducer_tpu_torch as W\n"
        "import warp_transducer_tpu_torch.ops.cuda.build\n"
        "import torch\n"
        "a = torch.zeros(1, 2, 3, 4)\n"
        "c = W.rnnt_loss(a, torch.ones(1, 2, dtype=torch.int32),\n"
        "                torch.tensor([2]), torch.tensor([2]), reduction='none')\n"
        "assert torch.isfinite(c).all()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
