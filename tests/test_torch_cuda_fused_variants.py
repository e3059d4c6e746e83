"""The fused joint kernels with their two hooks — K big-blank columns and the
duration head (csrc/joint_prep.cu, joint_grad.cu) — and the standalone
duration-head kernels (csrc/dur_head.cu) against their plain PyTorch versions
(ops/fused_joint.py), and the two fused duration-arc losses and the Joint
module through them, on the card, at small shapes.

Every test here needs a CUDA device; without one each skips (the ``dev``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_fused_variants.py --noconftest``
(tests/conftest.py imports JAX).

Tolerances. Prep fields and extra columns: rtol 1e-5 / atol 1e-5 in f32 (the
kernel's online (max, sum-exp) and tiled sums over H against the plain
two-pass logsumexp and the library's product); atol 1e-3 with bf16 W (a tanh
that differs in its last bit can round h to the neighbouring bf16 value).
The duration logits: 1e-5 in both cases, since the duration head never sees
the rounded h. Gradients by relative norm error: f32 1e-4 (sums over rows and
over V in another order, de and dp with atomics), bf16 2e-2 (h and g rounded
to bf16 after sums taken in different orders); dWd 1e-4 in both cases.
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import (rnnt_loss_multiblank, rnnt_loss_multiblank_fused_joint,
                                       rnnt_loss_tdt, rnnt_loss_tdt_fused_joint)
from warp_transducer_tpu_torch.models import Joint, TransducerConfig
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import fused_joint, gradients, tdt_fused
from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
from warp_transducer_tpu_torch.utils.convert import joint_state_dict_from_flax

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-5)
PREP_TOL = {torch.float32: F32, torch.bfloat16: dict(rtol=1e-5, atol=1e-3)}
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(B, T, U, V, H, n_cols, D, seed=0, dtype=torch.float32, device="cpu", empty=False):
    """e, p, W in ``dtype``; bias, Wd, bias_d in f32; labels off the blank
    (0) and off the last ``n_cols`` columns; ragged lengths. ``empty``: one
    utterance without frames, one without labels."""
    rng = np.random.default_rng(seed)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt, device=device)  # noqa: E731
    e = t(rng.standard_normal((B, T, H)) * 0.5, dtype)
    p = t(rng.standard_normal((B, U, H)) * 0.5, dtype)
    W = t(rng.standard_normal((H, V)) / np.sqrt(H), dtype)
    bias = t(rng.standard_normal(V) * 0.1)
    Wd = t(rng.standard_normal((H, max(D, 1))) / np.sqrt(H))
    bias_d = t(rng.standard_normal(max(D, 1)) * 0.1)
    labels = t(rng.integers(1, V - n_cols, (B, max(U - 1, 1))), torch.int32)
    il = rng.integers(1, T + 1, B)
    ll = rng.integers(0, U, B)
    il[0], ll[0] = T, U - 1
    if empty:
        il[1], ll[B - 1] = 0, 0
    return e, p, W, bias, Wd, bias_d, labels, t(il, torch.int32), t(ll, torch.int32)


def _fields(B, T, U, n, il, ll, seed, dev):
    """n random (B, T, U) fields, zero outside each utterance's lattice."""
    rng = np.random.default_rng(seed)
    valid = gradients._valid_cells((B, T, U), il, ll, dev)
    return [torch.tensor(rng.random((B, T, U)), dtype=torch.float32, device=dev) * valid
            for _ in range(n)]


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _cols(V, n_cols):
    return tuple(range(V - n_cols, V))


# B, T, U, V, H, K, D, with empty utterances
CASES = [(3, 37, 9, 1003, 200, 2, 4, False), (2, 5, 3, 5, 8, 1, 1, False),
         (2, 9, 20, 128, 256, 8, 8, False), (2, 6, 4, 128, 512, 2, 4, False),
         (4, 11, 5, 40, 16, 2, 4, True), (1, 5, 3, 20, 600, 1, 8, False)]
IDS = ["awkward", "tiny", "H256_K8_D8", "H512", "empty_utterances", "H600"]
SHAPES = pytest.mark.parametrize("B,T,U,V,H,n_cols,D,empty", CASES, ids=IDS)


@DTYPES
@SHAPES
def test_joint_prep_with_hooks(dev, B, T, U, V, H, n_cols, D, empty, dtype):
    """The extra columns alone, the duration head alone, both at once."""
    e, p, W, bias, Wd, bias_d, labels, il, ll = _problem(B, T, U, V, H, n_cols, D, dtype=dtype,
                                                         device=dev, empty=empty)
    cols = _cols(V, n_cols)
    for kw in ({"extra_cols": cols}, {"dur_head": (Wd, bias_d)},
               {"extra_cols": cols, "dur_head": (Wd, bias_d)}):
        got = kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, **kw)
        torch.cuda.synchronize()
        want = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0, **kw)
        for name in ("lpb", "lpe", "denom"):
            torch.testing.assert_close(getattr(got, name), getattr(want, name), **PREP_TOL[dtype])
        if "extra_cols" in kw:
            assert got.extras.shape == (B, T, U, n_cols)
            torch.testing.assert_close(got.extras, want.extras, **PREP_TOL[dtype])
        else:
            assert got.extras is None
        if "dur_head" in kw:
            assert got.dur.shape == (B, T, U, D)
            torch.testing.assert_close(got.dur, want.dur, **F32)
        else:
            assert got.dur is None


@SHAPES
def test_duration_logits_never_see_the_rounded_h(dev, B, T, U, V, H, n_cols, D, empty):
    """With bf16 W the token head rounds h to bf16; the duration head of the
    same launch must give what it gives with f32 W."""
    e, p, W, bias, Wd, bias_d, labels, il, ll = _problem(
        B, T, U, V, H, n_cols, D, dtype=torch.bfloat16, device=dev, empty=empty)
    got = kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, dur_head=(Wd, bias_d)).dur
    f32 = kjoint.fused_prep(e.float(), p.float(), W.float(), bias, labels, il, ll, 0,
                            dur_head=(Wd, bias_d)).dur
    alone = kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll)
    torch.cuda.synchronize()
    assert torch.equal(got, f32) and torch.equal(got, alone)
    fields = gradients.Coefficients(*_fields(B, T, U, 3, il, ll, 7, dev))
    denom = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0).denom
    (gd,) = _fields(B, T, U, 1, il, ll, 8, dev)
    gd = (gd[..., None] * torch.linspace(-1, 1, D, device=dev)).contiguous()
    dWd = kjoint.fused_grad(e, p, W, bias, labels, il, ll, denom, fields, 0,
                            dur_head=(Wd, gd))[4]
    dWd_alone = kjoint.dur_head_grad(e, p, Wd, gd, il, ll)[2]
    want = fused_joint.dur_head_grad(e.float(), p.float(), Wd, gd)[2]
    torch.cuda.synchronize()
    assert torch.equal(dWd, dWd_alone)
    assert _rel(dWd, want) <= 1e-5


@DTYPES
@SHAPES
def test_joint_grad_with_hooks(dev, B, T, U, V, H, n_cols, D, empty, dtype):
    e, p, W, bias, Wd, _, labels, il, ll = _problem(B, T, U, V, H, n_cols, D, seed=1, dtype=dtype,
                                                    device=dev, empty=empty)
    cols = _cols(V, n_cols)
    denom = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0).denom
    f = _fields(B, T, U, 3 + n_cols + D, il, ll, 2, dev)
    fields = gradients.Coefficients(*f[:3])
    cX = torch.stack(f[3:3 + n_cols], dim=-1)
    gd = torch.stack(f[3 + n_cols:], dim=-1) - 0.5 * f[0][..., None]
    for kw in ({"extra": (cols, cX)}, {"dur_head": (Wd, gd)},
               {"extra": (cols, cX), "dur_head": (Wd, gd)}):
        got = kjoint.fused_grad(e, p, W, bias, labels, il, ll, denom, fields, 0, **kw)
        torch.cuda.synchronize()
        want = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, denom, fields, 0, **kw)
        assert len(got) == len(want) == (5 if "dur_head" in kw else 4)
        for name, g, w, like in zip(("de", "dp", "dW", "db", "dWd"), got, want,
                                    (e, p, W, bias, Wd)):
            assert g.dtype == like.dtype and g.shape == like.shape, name
            assert torch.isfinite(g.float()).all(), name
            tol = 1e-4 if name == "dWd" else GRAD_REL[dtype]
            assert _rel(g, w) <= tol, (name, kw.keys(), _rel(g, w))
        for b in range(B):  # beyond an utterance's lengths: exactly zero
            assert torch.count_nonzero(got[0][b, int(il[b]):]) == 0
            assert torch.count_nonzero(got[1][b, int(ll[b]) + 1:]) == 0


def test_joint_grad_dwd_is_reproducible(dev):
    """dWd is a sum of partials in a fixed order: two runs give the same
    bits (de and dp go through atomics and need not)."""
    B, T, U, V, H, n_cols, D = 3, 37, 9, 1003, 200, 2, 4
    e, p, W, bias, Wd, _, labels, il, ll = _problem(B, T, U, V, H, n_cols, D, seed=3, device=dev)
    denom = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0).denom
    f = _fields(B, T, U, 3 + D, il, ll, 4, dev)
    gd = torch.stack(f[3:], dim=-1)
    runs = [kjoint.fused_grad(e, p, W, bias, labels, il, ll, denom,
                              gradients.Coefficients(*f[:3]), 0, dur_head=(Wd, gd))
            for _ in range(2)]
    for i in (2, 3, 4):  # dW, db, dWd
        assert torch.equal(runs[0][i], runs[1][i])


@DTYPES
@SHAPES
def test_dur_head_kernels(dev, B, T, U, V, H, n_cols, D, empty, dtype):
    e, p, _, _, Wd, bias_d, _, il, ll = _problem(B, T, U, V, H, n_cols, D, seed=5, dtype=dtype,
                                                 device=dev, empty=empty)
    for lengths in ((il, ll), ()):
        got = kjoint.dur_head_prep(e, p, Wd, bias_d, *lengths)
        torch.cuda.synchronize()
        want = fused_joint.dur_head_prep(e, p, Wd, bias_d, *lengths)
        assert got.shape == (B, T, U, D) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, **F32)
    gd = torch.stack(_fields(B, T, U, D, il, ll, 6, dev), dim=-1) - 0.3
    gd = gd * gradients._valid_cells((B, T, U), il, ll, dev)[..., None]
    got = kjoint.dur_head_grad(e, p, Wd, gd, il, ll)
    torch.cuda.synchronize()
    want = fused_joint.dur_head_grad(e, p, Wd, gd, il, ll)
    for name, g, w, like in zip(("de2", "dp2", "dWd"), got, want, (e, p, Wd)):
        assert g.dtype == like.dtype and g.shape == like.shape, name
        # de2 and dp2 come back in the type of e and p: one bf16 rounding
        assert _rel(g, w) <= (1e-4 if like.dtype == torch.float32 else 1e-2), (name, _rel(g, w))
    # without lengths every row is visited, and the zero cotangents mask
    again = kjoint.dur_head_grad(e, p, Wd, gd)
    for g, w in zip(again, want):
        assert _rel(g, w) <= (1e-4 if w.dtype == torch.float32 else 1e-2)


def _step(fn, leaves, *args, **kw):
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    costs = fn(*leaves, *args, reduction="none", **kw)
    costs.sum().backward()
    return costs.detach(), [x.grad for x in leaves]


def _counted(step):
    """Run ``step`` with no host sync allowed; (result, launch counts)."""
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # the main path never waits on the card
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, dict(K.launches)


def _counts(**kw):
    return dict.fromkeys(K.launches, 0) | kw


@pytest.mark.parametrize("kw", [{}, {"sigma": 0.05}, {"fastemit_lambda": 0.3},
                                {"delay_penalty": 0.2},
                                {"big_blank_indices": (3, 77), "sigma": 0.05}],
                         ids=["plain", "sigma", "fastemit", "delay", "indices"])
def test_multiblank_fused_step(dev, kw):
    B, T, U, V, H = 4, 21, 7, 150, 48
    e, p, W, bias, _, _, labels, il, ll = _problem(B, T, U, V, H, 2, 0, seed=9, device=dev)
    if "big_blank_indices" in kw:
        labels = labels.clamp_min(4).where(labels != 77, 78)
    (costs, grads), counts = _counted(lambda: _step(
        rnnt_loss_multiblank_fused_joint, (e, p, W, bias), labels, il, ll, (2, 4), **kw))
    assert counts == _counts(joint_prep=1, window_stream=1, joint_grad=2)
    K.reset_launches()
    ref_costs, ref_grads = _step(rnnt_loss_multiblank_fused_joint, (e, p, W, bias), labels, il,
                                 ll, (2, 4), implementation="torch", **kw)
    assert K.launches == _counts()
    torch.testing.assert_close(costs, ref_costs, **F32)
    for g, w in zip(grads, ref_grads):
        assert _rel(g, w) <= 1e-4
    # and against the unfused composition
    leaves = [x.clone().requires_grad_(True) for x in (e, p, W, bias)]
    acts = torch.tanh(leaves[0][:, :, None] + leaves[1][:, None]) @ leaves[2] + leaves[3]
    dense = rnnt_loss_multiblank(acts, labels, il, ll, (2, 4), reduction="none", **kw)
    dense.sum().backward()
    torch.testing.assert_close(costs, dense.detach(), **F32)
    for g, x in zip(grads, leaves):
        assert _rel(g, x.grad) <= 1e-4


@pytest.mark.parametrize("kw", [{}, {"sigma": 0.05}, {"fastemit_lambda": 0.3},
                                {"delay_penalty": 0.2}, {"durations": (1, 2)}],
                         ids=["plain", "sigma", "fastemit", "delay", "no_d0"])
def test_tdt_fused_step_both_routes(dev, kw, monkeypatch):
    B, T, U, V, H = 4, 21, 7, 150, 48
    durations = kw.setdefault("durations", (0, 1, 2, 4))
    e, p, W, bias, Wd, bias_d, labels, il, ll = _problem(B, T, U, V, H, 0, len(durations), seed=10,
                                                         device=dev)
    leaves = (e, p, W, bias, Wd, bias_d)
    out = {}
    for route, integrated in (("integrated", True), ("composed", False)):
        monkeypatch.setattr(tdt_fused, "_tdt_single_chunk", lambda *a: integrated)
        out[route], counts = _counted(lambda: _step(rnnt_loss_tdt_fused_joint, leaves, labels, il,
                                                    ll, **kw))
        assert counts == (_counts(joint_prep=1, window_stream=1, joint_grad=3) if integrated else
                          _counts(joint_prep=1, window_stream=1, joint_grad=2, dur_head=2))
    torch.testing.assert_close(out["integrated"][0], out["composed"][0], rtol=1e-6, atol=1e-6)
    for g, w in zip(out["integrated"][1], out["composed"][1]):
        assert _rel(g, w) <= 1e-5
    K.reset_launches()
    ref_costs, ref_grads = _step(rnnt_loss_tdt_fused_joint, leaves, labels, il, ll,
                                 implementation="torch", **kw)
    assert K.launches == _counts()
    costs, grads = out["integrated"]
    torch.testing.assert_close(costs, ref_costs, **F32)
    for g, w in zip(grads, ref_grads):
        assert _rel(g, w) <= 1e-4
    # and against the unfused composition
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    h = torch.tanh(leaves[0][:, :, None] + leaves[1][:, None])
    dense = rnnt_loss_tdt(h @ leaves[2] + leaves[3], h @ leaves[4] + leaves[5], labels, il, ll,
                          reduction="none", **kw)
    dense.sum().backward()
    torch.testing.assert_close(costs, dense.detach(), **F32)
    for g, x in zip(grads, leaves):
        assert _rel(g, x.grad) <= 1e-4


def test_tdt_fused_infeasible_utterance_on_card(dev):
    """T_b = 3 with durations (0, 2): no combination consumes three frames.
    The sentinel cost, and exactly zero gradients to all six inputs."""
    e, p, W, bias, Wd, bias_d, labels, il, ll = _problem(2, 4, 3, 9, 8, 0, 2, seed=11, device=dev)
    il = torch.tensor([4, 3], dtype=torch.int32, device=dev)
    ll = torch.tensor([2, 2], dtype=torch.int32, device=dev)
    leaves = [x.clone().requires_grad_(True) for x in (e, p, W, bias, Wd, bias_d)]
    costs = rnnt_loss_tdt_fused_joint(*leaves, labels, il, ll, durations=(0, 2), reduction="none")
    assert float(costs[0]) < 1e29 and float(costs[1]) > 1e29 and torch.isfinite(costs).all()
    costs[1].backward()
    for x in leaves:
        assert torch.count_nonzero(x.grad) == 0


def test_joint_module_duration_losses_on_card(dev, monkeypatch):
    durations = (0, 1, 2, 4)
    cfg = TransducerConfig(vocab_size=60, encoder_dim=20, prediction_dim=12, joint_dim=32,
                           dtype=torch.float32, tdt_durations=durations)
    rng = np.random.default_rng(12)
    tree = {name: {"kernel": rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i),
                   "bias": rng.standard_normal(o).astype(np.float32) * 0.1}
            for name, i, o in (("Dense_0", 20, 32), ("Dense_1", 12, 32), ("Dense_2", 32, 60),
                               ("DurHead_0", 32, 4))}
    joint = Joint(cfg, device=dev)
    joint.load_state_dict(joint_state_dict_from_flax(tree))
    B, T, U = 3, 11, 6
    enc = torch.tensor(rng.standard_normal((B, T, 20)), dtype=torch.float32, device=dev)
    pred = torch.tensor(rng.standard_normal((B, U, 12)), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.integers(1, 58, (B, U - 1)), dtype=torch.int32, device=dev)
    il = torch.tensor([11, 9, 6], dtype=torch.int32, device=dev)
    ll = torch.tensor([5, 3, 4], dtype=torch.int32, device=dev)

    def grads_of(loss):
        joint.zero_grad()
        loss.backward()
        return {n: q.grad.clone() for n, q in joint.named_parameters() if q.grad is not None}

    K.reset_launches()
    loss = joint.multiblank_fused_loss(enc, pred, labels, il, ll, (2, 4), reduction="sum",
                                       sigma=0.05)
    fused = grads_of(loss)
    assert K.launches["joint_prep"] == 1 and K.launches["joint_grad"] == 2
    dense = rnnt_loss_multiblank(joint(enc, pred), labels, il, ll, (2, 4), reduction="sum",
                                 sigma=0.05)
    want = grads_of(dense)
    torch.testing.assert_close(loss.detach(), dense.detach(), **F32)
    assert "dur_proj.weight" not in fused
    for n in fused:
        assert _rel(fused[n], want[n]) <= 1e-4, n

    for integrated in (True, False):
        monkeypatch.setattr(tdt_fused, "_tdt_single_chunk", lambda *a: integrated)
        K.reset_launches()
        loss = joint.tdt_fused_loss(enc, pred, labels, il, ll, reduction="sum", sigma=0.05)
        fused = grads_of(loss)
        assert K.launches["dur_head"] == (0 if integrated else 2)
        dense = rnnt_loss_tdt(*joint.tdt(enc, pred), labels, il, ll, durations, reduction="sum",
                              sigma=0.05)
        want = grads_of(dense)
        torch.testing.assert_close(loss.detach(), dense.detach(), **F32)
        assert sorted(fused) == sorted(n for n, _ in joint.named_parameters())
        for n in fused:
            assert _rel(fused[n], want[n]) <= 1e-4, n


def test_wrapper_refusals(dev):
    e, p, W, bias, Wd, bias_d, labels, il, ll = _problem(2, 5, 3, 12, 8, 2, 4, device=dev)
    with pytest.raises(ValueError, match="extra columns"):
        kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, extra_cols=(12,))
    with pytest.raises(ValueError, match="at most 8"):
        kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, extra_cols=tuple(range(1, 10)))
    with pytest.raises(ValueError, match="Wd must be"):
        kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, dur_head=(Wd[:4], bias_d))
    with pytest.raises(ValueError, match="bias_d"):
        kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, dur_head=(Wd, bias_d[:2]))
    with pytest.raises(ValueError, match="Wd is on"):
        kjoint.dur_head_prep(e, p, Wd.cpu(), bias_d.cpu())
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0)
    fields = gradients.Coefficients(pr.lpb, pr.lpb, pr.lpb)
    with pytest.raises(ValueError, match="extra fields must be"):
        kjoint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, 0,
                          extra=((10, 11), pr.lpb[..., None].contiguous()))
    with pytest.raises(ValueError, match="g_dur must be"):
        kjoint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, 0,
                          dur_head=(Wd, pr.lpb[:, :2, :, None].expand(-1, -1, -1, 4).contiguous()))
    cpu = [x.cpu() for x in (e, p, W, bias, Wd, bias_d, labels, il, ll)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_tdt_fused_joint(*cpu, durations=(0, 1, 2, 4), implementation="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_multiblank_fused_joint(*cpu[:4], *cpu[6:], (2, 4), implementation="cuda")
