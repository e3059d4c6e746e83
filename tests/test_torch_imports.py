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
    assert len(SOURCES) >= 10
    for module in ("rnnt", "simple", "pruned", "band", "cuda/band", "cuda/ranges", "fused_joint",
                   "pruned_fused", "cuda/joint"):
        assert (PKG / "ops" / f"{module}.py") in SOURCES, module
    for module in ("models/transducer", "utils/convert"):
        assert (PKG / f"{module}.py") in SOURCES, module


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
        "import warp_transducer_tpu_torch.ops.cuda.band, warp_transducer_tpu_torch.ops.cuda.ranges\n"
        "am, lm, lab = torch.zeros(1, 3, 4), torch.zeros(1, 2, 4), torch.ones(1, 1, dtype=torch.int32)\n"
        "il, ll = torch.tensor([3]), torch.tensor([1])\n"
        "loss, r = W.rnnt_loss_simple(am, lm, lab, il, ll, prune_range=2)\n"
        "assert torch.equal(r, W.rnnt_prune_ranges(am, lm, lab, il, ll, 2))\n"
        "p = W.rnnt_loss_pruned(am[:, :, None] + W.gather_banded(lm, r, 2), r, lab, il, ll)\n"
        "assert torch.isfinite(loss) and torch.isfinite(p)\n"
        "import warp_transducer_tpu_torch.ops.cuda.joint\n"
        "from warp_transducer_tpu_torch.models import Joint, TransducerConfig\n"
        "from warp_transducer_tpu_torch.utils.convert import joint_state_dict_from_flax\n"
        "e, q, Wt, b = torch.zeros(1, 3, 5), torch.zeros(1, 2, 5), torch.zeros(5, 4), torch.zeros(4)\n"
        "f = W.rnnt_loss_fused_joint(e, q, Wt, b, lab, il, ll)\n"
        "pf = W.rnnt_loss_pruned_fused(e, q, Wt, b, r, lab, il, ll, 2)\n"
        "j = Joint(TransducerConfig(vocab_size=4, encoder_dim=5, prediction_dim=5, joint_dim=5,\n"
        "                           dtype=torch.float32))\n"
        "j.load_state_dict(joint_state_dict_from_flax(\n"
        "    {n: {'kernel': w.detach().numpy().T, 'bias': c.detach().numpy()} for n, (w, c) in\n"
        "     zip(('Dense_0', 'Dense_1', 'Dense_2'), ((l.weight, l.bias) for l in\n"
        "         (j.enc_proj, j.pred_proj, j.out_proj)))}))\n"
        "jl = j.fused_loss(e, q, lab, il, ll)\n"
        "assert all(torch.isfinite(x) for x in (f, pf, jl))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
