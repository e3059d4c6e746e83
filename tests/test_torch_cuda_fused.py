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


# The tile edges of the wgmma engine: 128-row tiles that the valid rows do
# not fill, 128-column tiles of V and of H that V and H do not fill (H and V
# padded to multiples of 128 in every operand), k-slices of 64 (bf16) or 32
# (f32) columns, V odd or even (W's layout copies any alignment); the
# widths across the old engine's passes: 1100 and 2000, 1280, 2048 (the
# wide phase's width), 4096 and 6000.
SHAPES = [(3, 37, 9, 1003, 200, 1002), (2, 5, 3, 7, 8, 0), (2, 9, 70, 40, 16, 3),
          (2, 6, 4, 130, 300, 129), (1, 5, 3, 20, 600, 0), (2, 7, 5, 67, 520, 66),
          (1, 3, 5, 61, 1024, 0), (3, 11, 3, 72, 64, 71), (2, 13, 6, 200, 256, 5),
          (2, 5, 3, 130, 1100, 129), (1, 4, 3, 61, 1280, 0), (2, 5, 4, 200, 2000, 5),
          (2, 7, 5, 300, 2048, 0), (1, 3, 3, 72, 4096, 71), (1, 3, 3, 40, 6000, 0)]
IDS = ["awkward", "tiny", "long_labels", "H300", "H600", "H520", "H1024", "V72", "V200_H256",
       "H1100", "H1280", "H2000", "H2048", "H4096", "H6000"]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dW_db_bit_equal_across_calls(dev, dtype):
    """dW and db are sums of partials in a fixed order: two calls give the
    same bits (de and dp go through atomics and need not)."""
    B, T, U, V, H, blank = 4, 23, 7, 333, 256, 0
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=6, dtype=dtype, device=dev)
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, blank)
    res = lattice.forward_backward(pr.lpb, pr.lpe, il, ll)
    fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
    runs = [kjoint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, blank)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][2], runs[1][2]) and torch.equal(runs[0][3], runs[1][3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [256, 2048])
def test_dW_db_bit_equal_across_calls_at_any_h(dev, H, dtype):
    """The same at the fused shape's width and above 1024, where the column
    kernel's blocks own passes of dW and the first pass's db."""
    B, T, U, V, blank = 3, 9, 5, 300, 0
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=11, dtype=dtype, device=dev)
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, blank)
    res = lattice.forward_backward(pr.lpb, pr.lpe, il, ll)
    fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
    runs = [kjoint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, blank)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][2], runs[1][2]) and torch.equal(runs[0][3], runs[1][3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [200, 1100])
def test_joint_grad_chunk_by_chunk(dev, H, dtype, monkeypatch):
    """The gradient runs a chunk of rows at a time (the row launch writes
    the chunk's h, hᵀ, g, gᵀ and dh, the column launch adds the chunk into
    dW and db). With the chunk cut to one 128-row tile, many chunks give
    what one chunk gives, within the kernels' tolerance of the plain
    version; also at H = 1100, whose products stream 9 (f32: 36) k-slices."""
    B, T, U, V, blank = 3, 19, 6, 300, 0
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=10, dtype=dtype, device=dev)
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, blank)
    res = lattice.forward_backward(pr.lpb, pr.lpe, il, ll)
    fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
    args = (e, p, W, bias, labels, il, ll, pr.denom, fields, blank)
    K.reset_launches()
    whole = kjoint.fused_grad(*args)
    assert K.launches["joint_grad"] == 2
    monkeypatch.setattr(kjoint, "_CHUNK_MB", 0)  # one row tile a chunk
    K.reset_launches()
    chunked = kjoint.fused_grad(*args)
    torch.cuda.synchronize()
    assert K.launches["joint_grad"] == 2 * -(-(B * T * U) // kjoint.JOINT_TILE)
    want = fused_joint.fused_grad(*args)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b, w in zip(("de", "dp", "dW", "db"), chunked, whole, want):
        assert _rel(a, b) <= tol and _rel(a, w) <= tol, (name, _rel(a, b), _rel(a, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_label_term_subtracted_before_rounding(dev, dtype):
    """Fields with coef = 1 and ce = exp(lpe), the label's own probability,
    on the rows that have a label (zero elsewhere), on logits where the
    label takes almost all of it: g at the label column is a cancellation,
    ~0 in f32, while every other g is ~3e-4. A kernel that rounded
    coef·exp(logit + denom) to bf16 before subtracting ce would leave up to
    2^-9 of it there, larger than the rest of g, and miss the plain
    version's de, dp and dW by 0.12–0.23 in relative norm (the plain
    version so changed, on the CPU), far beyond the bf16 tolerance."""
    B, T, U, V, H = 2, 9, 4, 24, 64
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=8, dtype=dtype, device=dev)
    W = (W.float() * 0.1).to(dtype)
    labels = torch.full_like(labels, 3)
    bias = bias.clone()
    bias[3] = 8.0
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0)
    valid = gradients._valid_cells((B, T, U), il, ll, dev)
    has_label = valid & (pr.lpe > -1e29)
    one = has_label.float()
    fields = gradients.Coefficients(one, torch.zeros_like(one),
                                    torch.where(has_label, pr.lpe.exp(), 0.0).contiguous())
    got = kjoint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, 0)
    torch.cuda.synchronize()
    want = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, 0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("de", "dp", "dW", "db"), got, want):
        assert _rel(g, w) <= tol, (name, _rel(g, w))


def test_misaligned_W_takes_plain_loads(dev):
    """W whose rows are not 16-byte aligned (a view at an odd offset): the
    kernel that lays W out for the products reads it with plain loads, so
    the kernels agree all the same."""
    B, T, U, V, H = 2, 9, 4, 64, 128
    e, p, W, bias, labels, il, ll = _problem(B, T, U, V, H, seed=9, device=dev)
    flat = torch.empty(H * V + 1, device=dev)
    Wm = flat[1:].view(H, V)
    Wm.copy_(W)
    assert Wm.is_contiguous() and Wm.data_ptr() % 16 != 0
    got = kjoint.fused_prep(e, p, Wm, bias, labels, il, ll, 0)
    want = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0)
    for name in ("lpb", "lpe", "denom"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), **F32)
    res = lattice.forward_backward(want.lpb, want.lpe, il, ll)
    fields = gradients.coefficients(want.lpb, want.lpe, res.alphas, res.betas, res.ll_forward,
                                    il, ll)
    g_k = kjoint.fused_grad(e, p, Wm, bias, labels, il, ll, want.denom, fields, 0)
    torch.cuda.synchronize()
    g_p = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, want.denom, fields, 0)
    for name, g, w in zip(("de", "dp", "dW", "db"), g_k, g_p):
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))


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
    # Above H = 1024 the kernels compute (they refused there before the
    # k-slices and passes), and agree with the plain versions.
    big = _problem(1, 2, 2, 4, 1100, device=dev)
    got = kjoint.fused_prep(*big, 0)
    pr = fused_joint.fused_prep(*big, 0)
    for name in ("lpb", "lpe", "denom"):
        torch.testing.assert_close(getattr(got, name), getattr(pr, name), **F32)
    fields = gradients.Coefficients(pr.lpb, pr.lpb, pr.lpb)
    g_k = kjoint.fused_grad(*big, pr.denom, fields, 0)
    g_p = fused_joint.fused_grad(*big, pr.denom, fields, 0)
    for name, g, w in zip(("de", "dp", "dW", "db"), g_k, g_p):
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))


@pytest.mark.parametrize("H", [1100, 1280])
def test_fused_loss_above_1024(dev, H):
    """Above H = 1024 the fused loss runs its kernels under "auto" (it
    raised there before) and matches the plain version."""
    e, p, W, bias, labels, il, ll = _problem(2, 4, 3, 16, H, device=dev)
    K.reset_launches()
    costs, grads = _fused_step(e, p, W, bias, labels, il, ll)
    torch.cuda.synchronize()
    assert K.launches["joint_prep"] == 1 and K.launches["joint_grad"] == 2
    ref_costs, ref_grads = _fused_step(e, p, W, bias, labels, il, ll, implementation="torch")
    torch.testing.assert_close(costs, ref_costs, **F32)
    for g, w in zip(grads, ref_grads):
        assert _rel(g, w) <= 1e-4


def test_joint_smem_fits_a_block_at_every_h(dev):
    """Each kernel's dynamic shared memory, as its C entry gives it (the
    larger of the two W types), is within a block's 227 KB at every H from 1
    to 8192: the plan slices what does not fit."""
    entries = ("wtt_joint_prep_smem", "wtt_joint_grad_rows_smem", "wtt_joint_grad_cols_smem",
               "wtt_joint_grad_dwd_smem")
    for H in range(1, 8193):
        for entry in entries:
            assert 0 < getattr(K.lib(), entry)(H) <= K.SMEM_BYTES, (entry, H)


def test_joint_plan_matches_its_mirror(dev):
    """csrc/joint.cuh plans the kernels (padded widths, k-slices, stages,
    shared memory, the chunks of rows); ops/cuda/joint.py mirrors the plan
    for the CPU tests and the wrappers take their chunks from the mirror."""
    for dtype in (torch.float32, torch.bfloat16):
        for H in range(1, 8193):
            for V in (5, 1003, 5000):
                assert kjoint.kernel_plan(H, V, dtype) == kjoint.joint_plan(H, V, dtype), (H, V)
        for H in (1, 256, 1100, 2048, 8192):
            for mb in (0, 1, 32, 100):
                assert kjoint.kernel_plan(H, 333, dtype, mb) == kjoint.joint_plan(H, 333, dtype, mb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_joint_layouts_match_their_mirror(dev, dtype):
    """W and Wᵀ as the kernel lays them out for the products (padded with
    zeros, in tiles of wgmma's core-matrix order; f32 as tf32 hi and lo)
    equal ops/cuda/joint.py::tile_order's placement, which the CPU replay of
    the schedule reads back."""
    H, V = 200, 300
    _, _, W, *_ = _problem(1, 1, 1, V, H, seed=12, dtype=dtype, device=dev)
    q = kjoint.joint_plan(H, V, dtype)
    parts = 2 if dtype == torch.float32 else 1
    wt = torch.empty(parts * q.vp * q.hp, dtype=dtype, device=dev)
    wp = torch.empty_like(wt)
    err = K.lib().wtt_joint_weights(W.data_ptr(), K.DTYPE_CODES[dtype], H, V, wt.data_ptr(),
                                    wp.data_ptr(), K.stream(dev))
    torch.cuda.synchronize()
    assert err == 0
    Wp = torch.zeros((q.hp, q.vp), device=dev)
    Wp[:H, :V] = W.float()
    for got, x in ((wt, Wp.t().contiguous()), (wp, Wp)):
        order = kjoint.tile_order(*x.shape, dtype).to(dev).flatten()
        if dtype == torch.bfloat16:
            want = torch.empty_like(got)
            want[order] = x.flatten().to(dtype)
        else:  # hi = tf32(x), lo = tf32(x − hi): cvt.rna, ties away from zero
            tf32 = lambda y: ((y.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)  # noqa
            hi = tf32(x.flatten().contiguous())
            lo = tf32((x.flatten() - hi).contiguous())
            want = torch.empty_like(got)
            want[order] = hi
            want[order + x.numel()] = lo
        assert torch.equal(got, want)


# Every width at the engine's boundaries (H padded to 128 around 128, 256,
# 1024 and 2048; 4096 and 6000 deep streams), both W types and each hook: K
# = 2 big blanks on the last two columns with the blank just before them,
# all in V's last, partial 128-column tile; the D = 4 duration head; ragged
# rows that fill no 128-row tile, and grids small enough that dh and dW
# split their sums.
WIDTHS = [1, 8, 127, 128, 129, 200, 256, 257, 1023, 1024, 1025, 1100, 2048, 2049, 4096, 6000]
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("hook", ["k0", "k2", "d4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", WIDTHS)
def test_joint_kernels_at_every_width(dev, H, dtype, hook):
    B, T, U, V = 3, 11, 6, 300
    blank, cols = V - 3, (V - 2, V - 1)
    e, p, W, bias, _, il, ll = _problem(B, T, U, V, H, seed=H, dtype=dtype, device=dev)
    rng = np.random.default_rng(H)
    labels = torch.tensor(rng.integers(0, V - 3, (B, U - 1)), dtype=torch.int32, device=dev)
    Wd = torch.tensor(rng.standard_normal((H, 4)) / np.sqrt(H), dtype=torch.float32, device=dev)
    bias_d = torch.tensor(rng.standard_normal(4) * 0.1, dtype=torch.float32, device=dev)
    valid = gradients._valid_cells((B, T, U), il, ll, dev)
    f = [torch.tensor(rng.random((B, T, U)), dtype=torch.float32, device=dev) * valid
         for _ in range(9)]
    prep_kw = {"k0": {}, "k2": {"extra_cols": cols}, "d4": {"dur_head": (Wd, bias_d)}}[hook]
    grad_kw = {"k0": {}, "k2": {"extra": (cols, torch.stack(f[3:5], -1))},
               "d4": {"dur_head": (Wd, (torch.stack(f[5:9], -1) - 0.5) * valid[..., None])}}[hook]
    args = (e, p, W, bias, labels, il, ll)
    got = kjoint.fused_prep(*args, blank, **prep_kw)
    torch.cuda.synchronize()
    want = fused_joint.fused_prep(*args, blank, **prep_kw)
    for name in ("lpb", "lpe", "denom", "extras", "dur"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            torch.testing.assert_close(a, b, **F32)
    fields = gradients.Coefficients(*f[:3])
    g_k = kjoint.fused_grad(*args, want.denom, fields, blank, **grad_kw)
    torch.cuda.synchronize()
    g_p = fused_joint.fused_grad(*args, want.denom, fields, blank, **grad_kw)
    assert len(g_k) == len(g_p) == (5 if hook == "d4" else 4)
    for name, a, b, like in zip(("de", "dp", "dW", "db", "dWd"), g_k, g_p, (e, p, W, bias, Wd)):
        assert a.dtype == like.dtype and a.shape == like.shape, name
        tol = 1e-4 if name == "dWd" else GRAD_REL[dtype]
        assert torch.isfinite(a.float()).all() and _rel(a, b) <= tol, (name, _rel(a, b))


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
