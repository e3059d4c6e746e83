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
                   "pruned_fused", "cuda/joint", "window", "multiblank", "tdt", "cuda/window",
                   "multiblank_fused", "tdt_fused", "alignment"):
        assert (PKG / "ops" / f"{module}.py") in SOURCES, module
    for module in ("models/transducer", "models/decoding", "utils/convert",
                   "bindings/torch_binding", "parallel/sharding"):
        assert (PKG / f"{module}.py") in SOURCES, module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    # The exact module name: the port's own name starts with the JAX package's.
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


_BLOCK_JAX = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'flax', 'optax', 'warp_transducer_tpu'):\n"
    "    sys.modules[name] = None\n"
)


def _run_with_jax_blocked(code):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX + code + "print('ok')\n"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_imports_with_jax_blocked():
    code = (
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
        "                           dtype=torch.float32), device='cpu')\n"
        "j.load_state_dict(joint_state_dict_from_flax(\n"
        "    {n: {'kernel': w.detach().numpy().T, 'bias': c.detach().numpy()} for n, (w, c) in\n"
        "     zip(('Dense_0', 'Dense_1', 'Dense_2'), ((l.weight, l.bias) for l in\n"
        "         (j.enc_proj, j.pred_proj, j.out_proj)))}))\n"
        "jl = j.fused_loss(e, q, lab, il, ll)\n"
        "assert all(torch.isfinite(x) for x in (f, pf, jl))\n"
    )
    _run_with_jax_blocked(code)


_DURATION_ARC_SETUP = (
    "import torch\n"
    "import warp_transducer_tpu_torch as W\n"
    "g = torch.Generator().manual_seed(0)\n"
    "a = torch.randn(2, 6, 3, 7, generator=g, requires_grad=True)\n"
    "d = torch.randn(2, 6, 3, 3, generator=g, requires_grad=True)\n"
    "lab, il, ll = torch.tensor([[1, 2], [3, 1]], dtype=torch.int32), torch.tensor([6, 4]), "
    "torch.tensor([2, 1])\n"
)
_DURATION_ARC_CASES = {
    "multiblank": (
        "c = W.rnnt_loss_multiblank(a, lab, il, ll, (2, 4), sigma=0.05, reduction='none')\n"
        "c.sum().backward()\n"
        "assert torch.isfinite(c).all() and torch.isfinite(a.grad).all() and a.grad.any()\n"),
    "multiblank_k0_is_rnnt_loss": (
        "c = W.rnnt_loss_multiblank(a, lab, il, ll, (), reduction='none')\n"
        "assert torch.allclose(c, W.rnnt_loss(a, lab, il, ll, reduction='none'), rtol=1e-5)\n"),
    "tdt": (
        "c = W.rnnt_loss_tdt(a, d, lab, il, ll, (0, 1, 2), fastemit_lambda=0.1)\n"
        "c.backward()\n"
        "assert torch.isfinite(c) and a.grad.any() and d.grad.any()\n"),
    "tdt_without_d0_and_infeasible": (
        # T_b = 6: two labels and the last blank, 2 frames each; T_b = 5: no path
        "c = W.rnnt_loss_tdt(a, d[..., :1], lab, torch.tensor([6, 5]), ll, (2,),\n"
        "                    reduction='none')\n"
        "c.sum().backward()\n"
        "assert c[0] < 1e29 and c[1] > 1e29 and torch.isfinite(a.grad).all()\n"
        "assert a.grad[0].any() and not a.grad[1].any() and not d.grad[1].any()\n"),
    "kernel_wrappers_on_cpu_tensors": (
        "from warp_transducer_tpu_torch.ops import window\n"
        "from warp_transducer_tpu_torch.ops.cuda import launches, prep, window as kwindow\n"
        "p = prep.prepare(a.detach(), lab, 0, False, extra_cols=(5, 6))\n"
        "r = kwindow.forward_backward(p.lpb, p.lpe, p.extras, window.multiblank_arcs((2, 4)),\n"
        "                             il, ll)\n"
        "assert p.extras.shape == (2, 6, 3, 2) and torch.isfinite(r.ll_forward).all()\n"
        "assert launches['window_stream'] == 0 and launches['prep'] == 0\n"),
}


@pytest.mark.parametrize("case", _DURATION_ARC_CASES)
def test_duration_arc_losses_with_jax_blocked(case):
    _run_with_jax_blocked(_DURATION_ARC_SETUP + _DURATION_ARC_CASES[case])


_FUSED_DURATION_SETUP = (
    "import torch\n"
    "import warp_transducer_tpu_torch as W\n"
    "g = torch.Generator().manual_seed(0)\n"
    "leaves = [torch.randn(s, generator=g).mul(0.5).requires_grad_(True) for s in\n"
    "          ((2, 6, 5), (2, 3, 5), (5, 7), (7,), (5, 3), (3,))]\n"
    "lab, il, ll = torch.tensor([[1, 2], [3, 1]], dtype=torch.int32), torch.tensor([6, 4]), "
    "torch.tensor([2, 1])\n"
)
_FUSED_DURATION_CASES = {
    "multiblank_fused_joint": (
        "c = W.rnnt_loss_multiblank_fused_joint(*leaves[:4], lab, il, ll, (2, 4), sigma=0.05,\n"
        "                                       reduction='none')\n"
        "c.sum().backward()\n"
        "assert torch.isfinite(c).all()\n"
        "assert all(torch.isfinite(x.grad).all() and x.grad.any() for x in leaves[:4])\n"
        "e, p, Wt, b = (x.detach() for x in leaves[:4])\n"
        "acts = torch.tanh(e[:, :, None] + p[:, None]) @ Wt + b\n"
        "u = W.rnnt_loss_multiblank(acts, lab, il, ll, (2, 4), sigma=0.05, reduction='none')\n"
        "assert torch.allclose(c, u, rtol=1e-5)\n"),
    "tdt_fused_joint": (
        "c = W.rnnt_loss_tdt_fused_joint(*leaves, lab, il, ll, (0, 1, 2), fastemit_lambda=0.1,\n"
        "                                reduction='none')\n"
        "c.sum().backward()\n"
        "assert torch.isfinite(c).all()\n"
        "assert all(torch.isfinite(x.grad).all() and x.grad.any() for x in leaves)\n"
        "e, p, Wt, b, Wd, bd = (x.detach() for x in leaves)\n"
        "h = torch.tanh(e[:, :, None] + p[:, None])\n"
        "u = W.rnnt_loss_tdt(h @ Wt + b, h @ Wd + bd, lab, il, ll, (0, 1, 2),\n"
        "                    fastemit_lambda=0.1, reduction='none')\n"
        "assert torch.allclose(c, u, rtol=1e-5)\n"),
    "joint_with_duration_head": (
        "from warp_transducer_tpu_torch.models import Joint, TransducerConfig\n"
        "from warp_transducer_tpu_torch.ops.cuda import launches\n"
        "j = Joint(TransducerConfig(vocab_size=7, encoder_dim=5, prediction_dim=5, joint_dim=5,\n"
        "                           dtype=torch.float32, tdt_durations=(0, 1, 2)),\n"
        "          device='cpu')\n"
        "e, p = leaves[0].detach(), leaves[1].detach()\n"
        "a = j.tdt_fused_loss(e, p, lab, il, ll)\n"
        "m = j.multiblank_fused_loss(e, p, lab, il, ll, (2, 4))\n"
        "(a + m).backward()\n"
        "assert torch.isfinite(a) and torch.isfinite(m) and j.dur_proj.weight.grad.any()\n"
        "assert not any(launches.values())\n"),
}


@pytest.mark.parametrize("case", _FUSED_DURATION_CASES)
def test_fused_duration_arc_losses_with_jax_blocked(case):
    _run_with_jax_blocked(_FUSED_DURATION_SETUP + _FUSED_DURATION_CASES[case])


def test_model_and_binding_with_jax_blocked():
    code = (
        "import torch\n"
        "from warp_transducer_tpu_torch.bindings import torch_binding as tb\n"
        "from warp_transducer_tpu_torch.models import transducer as tm\n"
        "from warp_transducer_tpu_torch.utils.convert import transducer_state_dict_from_flax\n"
        "cfg = tm.TransducerConfig(vocab_size=6, encoder_dim=8, encoder_layers=1, encoder_heads=2,\n"
        "                          conv_kernel=2, prediction_dim=8, joint_dim=8, input_dim=3,\n"
        "                          dtype=torch.float32)\n"
        "model = tm.Transducer(cfg, device='cpu')\n"
        "opt = torch.optim.Adam(model.parameters(), lr=1e-3)\n"
        "batch = {'feats': torch.randn(2, 5, 3), 'feat_lengths': torch.tensor([5, 4]),\n"
        "         'labels': torch.tensor([[1, 2], [3, 0]]), 'label_lengths': torch.tensor([2, 1])}\n"
        "loss = tm.make_fused_train_step(model, opt)(batch)\n"
        "acts = model(batch['feats'], batch['feat_lengths'], batch['labels']).detach()\n"
        "i32 = [batch[k].int() for k in ('labels', 'feat_lengths', 'label_lengths')]\n"
        "b = tb.RNNTLoss(reduction='sum')(acts.contiguous(), *i32)\n"
        "assert torch.isfinite(loss) and b.shape == (1,)\n"
    )
    _run_with_jax_blocked(code)


def test_decoders_and_alignments_with_jax_blocked():
    code = (
        "import torch\n"
        "import warp_transducer_tpu_torch as W\n"
        "from warp_transducer_tpu_torch.models import (TransducerConfig, Transducer,\n"
        "                                              beam_search_decode, greedy_decode)\n"
        "cfg = TransducerConfig(vocab_size=6, encoder_dim=8, encoder_layers=1, encoder_heads=2,\n"
        "                       conv_kernel=2, prediction_dim=8, joint_dim=8, input_dim=3,\n"
        "                       dtype=torch.float32)\n"
        "model = Transducer(cfg, device='cpu')\n"
        "feats, fl = torch.randn(2, 5, 3), torch.tensor([5, 4])\n"
        "tokens, n = greedy_decode(model, feats, fl, max_symbols=4)\n"
        "bt, bn, bs = beam_search_decode(model, feats, fl, max_symbols=4, beam=2)\n"
        "labels = bt[:, 0, :4].contiguous()\n"
        "acts = model(feats, fl, labels).detach().contiguous()\n"
        "out = W.rnnt_viterbi_align(acts, labels, fl, bn[:, 0])\n"
        "assert tokens.shape == (2, 4) and bs.shape == (2, 2)\n"
        "assert (out.score <= -W.rnnt_score(acts, labels, fl, bn[:, 0]) + 1e-4).all()\n"
    )
    _run_with_jax_blocked(code)


def test_parallel_with_jax_blocked(tmp_path):
    code = (
        "import torch, torch.distributed as dist\n"
        "import warp_transducer_tpu_torch as W\n"
        "from warp_transducer_tpu_torch import parallel as P\n"
        f"P.initialize_distributed(init_method='file://{tmp_path / 'store'}', world_size=1, rank=0)\n"
        "mesh = P.make_mesh('cpu')\n"
        "a = torch.randn(2, 4, 3, 5, requires_grad=True)\n"
        "lab, il, ll = torch.ones(2, 2, dtype=torch.int32), torch.tensor([4, 3]), torch.tensor([2, 1])\n"
        "c = P.data_parallel_rnnt_loss(a, lab, il, ll, mesh)\n"
        "c.backward()\n"
        "assert torch.equal(c, W.rnnt_loss(a, lab, il, ll)) and a.grad.any()\n"
        "dist.destroy_process_group()\n"
    )
    _run_with_jax_blocked(code)


@pytest.mark.parametrize("tree", ["checkout", "installed", "installed_xdg"])
def test_kernel_build_directory(tree, tmp_path, monkeypatch):
    """Where the CUDA library is built, decided without a compiler: a
    checkout (the package's parent holds pyproject.toml) builds into its own
    build/torch_kernels; an installed copy (the parent is site-packages)
    into the per-user cache, $XDG_CACHE_HOME or ~/.cache."""
    from warp_transducer_tpu_torch.ops.cuda import build

    parent = tmp_path / ("repo" if tree == "checkout" else "site-packages")
    pkg = parent / "warp_transducer_tpu_torch"
    pkg.mkdir(parents=True)
    if tree == "checkout":
        (parent / "pyproject.toml").write_text("[project]\nname = 'x'\n")
    home, xdg = tmp_path / "home", tmp_path / "xdg"
    monkeypatch.setattr(build, "_PKG", pkg)
    monkeypatch.setenv("HOME", str(home))
    if tree == "installed_xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(xdg))
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    want = {"checkout": parent / "build" / "torch_kernels",
            "installed": home / ".cache" / "warp_transducer_tpu_torch" / "torch_kernels",
            "installed_xdg": xdg / "warp_transducer_tpu_torch" / "torch_kernels"}[tree]
    assert build.build_root() == want
    assert not (parent / "build").exists() or tree == "checkout"


def test_repository_builds_into_its_own_build_directory():
    from warp_transducer_tpu_torch.ops.cuda import build
    assert build.build_root() == REPO / "build" / "torch_kernels"
