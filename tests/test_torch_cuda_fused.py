"""The fused joint kernels (csrc/joint_prep.cu, joint_grad.cu) against their
plain PyTorch versions (ops/fused_joint.py), and the fused and pruned-fused
losses and the Joint module through them, on the card, at small shapes.

Every test here needs a CUDA device; without one each skips (the ``dev``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_fused.py --noconftest``
(tests/conftest.py imports JAX).

Tolerances. Prep: rtol 1e-5 / atol 1e-5 — the kernel's online (max, sum-exp)
and its tiled f32 sums over H against the plain two-pass logsumexp and the
library's product, ~1e-6 relative. Gradients by relative norm error: f32
1e-4 (the sums over rows and over V are taken in another order, de and dp
with atomics), bf16 2e-2 (h and g are rounded to bf16 after sums taken in
different orders, so single elements may round to neighbouring bf16 values).
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import (rnnt_loss, rnnt_loss_fused_joint, rnnt_loss_pruned,
                                       rnnt_loss_pruned_fused, rnnt_loss_simple)
from warp_transducer_tpu_torch.models import Joint, TransducerConfig
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import fused_joint, gradients, lattice, pruned_fused
from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
from warp_transducer_tpu_torch.utils.convert import joint_state_dict_from_flax

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(B, T, U, V, H, seed=0, dtype=torch.float32, device="cpu", blank=0):
    rng = np.random.default_rng(seed)
    e = torch.tensor(rng.standard_normal((B, T, H)) * 0.5, dtype=dtype, device=device)
    p = torch.tensor(rng.standard_normal((B, U, H)) * 0.5, dtype=dtype, device=device)
    W = torch.tensor(rng.standard_normal((H, V)) / np.sqrt(H), dtype=dtype, device=device)
    bias = torch.tensor(rng.standard_normal(V) * 0.1, dtype=torch.float32, device=device)
    labels = rng.integers(0, V - 1, (B, max(U - 1, 1)))
    labels = torch.tensor(labels + (labels >= blank), dtype=torch.int32, device=device)
    il = rng.integers(1, T + 1, B)
    ll = rng.integers(0, U, B)
    il[0], ll[0] = T, U - 1
    to = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return e, p, W, bias, labels, to(il), to(ll)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


SHAPES = [(3, 37, 9, 1003, 200, 1002), (2, 5, 3, 7, 8, 0), (2, 9, 70, 40, 16, 3),
          (2, 6, 4, 130, 300, 129), (1, 5, 3, 20, 600, 0)]
IDS = ["awkward", "tiny", "long_labels", "H300", "H600"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,U,V,H,blank", SHAPES, ids=IDS)
def test_joint_prep_kernel(dev, B, T, U, V, H, blank, dtype):
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, dtype=dtype, device=dev, blank=blank)
    labels[0, 0] = blank  # a label equal to blank
    got = kjoint.fused_prep(e, p, W, bias, labels, il, ll, blank)
    torch.cuda.synchronize()
    want = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, blank)
    for name in ("lpb", "lpe", "denom"):
        assert getattr(got, name).dtype == torch.float32
        torch.testing.assert_close(getattr(got, name), getattr(want, name), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,U,V,H,blank", SHAPES, ids=IDS)
def test_joint_grad_kernels(dev, B, T, U, V, H, blank, dtype):
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=1, dtype=dtype, device=dev,
                                             blank=blank)
    labels[0, 0] = blank
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, blank)
    res = lattice.forward_backward(pr.lpb, pr.lpe, il, ll)
    scale = torch.linspace(0.5, 1.5, B, device=dev)
    fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas, res.ll_forward, il, ll,
                                    scale, 0.1)
    got = kjoint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, blank)
    torch.cuda.synchronize()
    want = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, blank)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w, like in zip(("de", "dp", "dW", "db"), got, want, (e, p, W, bias)):
        assert g.dtype == like.dtype and g.shape == like.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    # Frames and labels beyond an utterance's lengths get exactly zero.
    for b in range(B):
        assert torch.count_nonzero(got[0][b, int(il[b]):]) == 0
        assert torch.count_nonzero(got[1][b, int(ll[b]) + 1:]) == 0


def _fused_step(e, p, W, bias, labels, il, ll, **kw):
    leaves = [x.clone().requires_grad_(True) for x in (e, p, W, bias)]
    costs = rnnt_loss_fused_joint(*leaves, labels, il, ll, reduction="none", **kw)
    costs.sum().backward()
    return costs.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("kw", [{}, {"blank": 5}, {"fastemit_lambda": 0.3},
                                {"delay_penalty": 0.2}],
                         ids=["plain", "blank5", "fastemit", "delay"])
def test_fused_main_path_launches_each_kernel(dev, kw):
    e, p, W, bias, labels, il, ll = _problem(4, 21, 7, 150, 48, seed=2, device=dev,
                                             blank=kw.get("blank", 0))
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # the main path never waits on the card
    try:
        costs, grads = _fused_step(e, p, W, bias, labels, il, ll, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert K.launches == dict.fromkeys(K.launches, 0) | {
        "joint_prep": 1, "wavefront": 1, "joint_grad": 2}
    K.reset_launches()
    ref_costs, ref_grads = _fused_step(e, p, W, bias, labels, il, ll, implementation="torch",
                                       **kw)
    assert K.launches == dict.fromkeys(K.launches, 0)
    torch.testing.assert_close(costs, ref_costs, **F32)
    for g, w in zip(grads, ref_grads):
        assert _rel(g, w) <= 1e-4
    # and against the unfused composition
    leaves = [x.clone().requires_grad_(True) for x in (e, p, W, bias)]
    acts = torch.tanh(leaves[0][:, :, None] + leaves[1][:, None]) @ leaves[2] + leaves[3]
    dense = rnnt_loss(acts, labels, il, ll, reduction="none", **kw)
    dense.sum().backward()
    torch.testing.assert_close(costs, dense.detach(), **F32)
    for g, x in zip(grads, leaves):
        assert _rel(g, x.grad) <= 1e-4


def test_pruned_fused_both_routes_on_card(dev, monkeypatch):
    B, T, U, V, H, S = 4, 30, 9, 40, 24, 4
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=3, device=dev)
    il = torch.tensor([30, 25, 20, 28], dtype=torch.int32, device=dev)
    ll = torch.tensor([8, 6, 5, 7], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    am = torch.tensor(rng.standard_normal((B, T, V)), dtype=torch.float32, device=dev)
    lm = torch.tensor(rng.standard_normal((B, U, V)), dtype=torch.float32, device=dev)
    _, ranges = rnnt_loss_simple(am, lm, labels, il, ll, prune_range=S)

    def step(**kw):
        leaves = [x.clone().requires_grad_(True) for x in (e, p, W, bias)]
        costs = rnnt_loss_pruned_fused(*leaves, ranges, labels, il, ll, S, reduction="none", **kw)
        costs.sum().backward()
        return costs.detach(), [x.grad for x in leaves]

    out = {}
    for route, mb in (("materialise", 4096), ("sweep", 0)):
        monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", mb)
        K.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out[route] = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert K.launches["band_stream"] == 1
        assert K.launches["band_prep"] == K.launches["band_grad"] == (route == "materialise")
        ref = step(implementation="torch")
        torch.testing.assert_close(out[route][0], ref[0], **F32)
        for g, w in zip(out[route][1], ref[1]):
            assert _rel(g, w) <= 1e-4
    torch.testing.assert_close(out["sweep"][0], out["materialise"][0], **F32)
    for g, w in zip(out["sweep"][1], out["materialise"][1]):
        assert _rel(g, w) <= 1e-4


def test_joint_module_on_card(dev):
    cfg = TransducerConfig(vocab_size=60, encoder_dim=20, prediction_dim=12, joint_dim=32,
                           dtype=torch.float32)
    rng = np.random.default_rng(4)
    tree = {name: {"kernel": rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i),
                   "bias": rng.standard_normal(o).astype(np.float32) * 0.1}
            for name, i, o in (("Dense_0", 20, 32), ("Dense_1", 12, 32), ("Dense_2", 32, 60))}
    joint = Joint(cfg, device=dev)
    joint.load_state_dict(joint_state_dict_from_flax(tree))
    B, T, U = 3, 11, 6
    enc = torch.tensor(rng.standard_normal((B, T, 20)), dtype=torch.float32, device=dev)
    pred = torch.tensor(rng.standard_normal((B, U, 12)), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.integers(1, 60, (B, U - 1)), dtype=torch.int32, device=dev)
    il = torch.tensor([11, 9, 6], dtype=torch.int32, device=dev)
    ll = torch.tensor([5, 3, 4], dtype=torch.int32, device=dev)
    K.reset_launches()
    loss = joint.fused_loss(enc, pred, labels, il, ll, reduction="sum")
    loss.backward()
    assert K.launches["joint_prep"] == 1 and K.launches["joint_grad"] == 2
    fused = {n: q.grad.clone() for n, q in joint.named_parameters()}
    joint.zero_grad()
    dense = rnnt_loss(joint(enc, pred), labels, il, ll, reduction="sum")
    dense.backward()
    torch.testing.assert_close(loss.detach(), dense.detach(), **F32)
    for n, q in joint.named_parameters():
        assert _rel(fused[n], q.grad) <= 1e-4, n


def test_wrapper_refusals(dev):
    e, p, W, bias, labels, il, ll = _problem(2, 5, 3, 7, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, implementation="cuda")
    e, p, W, bias, labels, il, ll = _problem(2, 5, 3, 7, 8, device=dev)
    with pytest.raises(ValueError, match="W must be contiguous"):
        kjoint.fused_prep(e, p, W.t().contiguous().t(), bias, labels, il, ll, 0)
    with pytest.raises(ValueError, match="dtype"):
        kjoint.fused_prep(e.double(), p, W, bias, labels, il, ll, 0)
    with pytest.raises(ValueError, match="blank"):
        kjoint.fused_prep(e, p, W, bias, labels, il, ll, 7)
    big = _problem(1, 2, 2, 4, 1100, device=dev)
    with pytest.raises(ValueError, match="H=1100 exceeds"):
        kjoint.fused_prep(*big, 0)
    pr = fused_joint.fused_prep(*big, 0)
    fields = gradients.Coefficients(pr.lpb, pr.lpb, pr.lpb)
    with pytest.raises(ValueError, match="H=1100 exceeds"):
        kjoint.fused_grad(*big, pr.denom, fields, 0)


def test_pruned_band_matches_rnnt_loss_pruned_on_card(dev, monkeypatch):
    """The sweep against ``rnnt_loss_pruned`` on a band formed by hand."""
    from warp_transducer_tpu_torch import gather_banded
    B, T, U, V, H, S = 3, 12, 8, 33, 16, 3
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=5, device=dev)
    rng = np.random.default_rng(5)
    steps = rng.integers(0, S, (B, T))
    steps[:, 0] = 0
    ranges = np.minimum(np.cumsum(steps, 1), np.maximum(ll.cpu().numpy()[:, None] + 1 - S, 0))
    ranges = torch.tensor(ranges, dtype=torch.int32, device=dev)
    monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", 0)
    got = rnnt_loss_pruned_fused(e, p, W, bias, ranges, labels, il, ll, S, reduction="none")
    acts = torch.tanh(e[:, :, None] + gather_banded(p, ranges, S)) @ W + bias
    want = rnnt_loss_pruned(acts, ranges, labels, il, ll, reduction="none")
    torch.testing.assert_close(got, want, **F32)
