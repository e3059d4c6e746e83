"""The pruned path's CUDA kernels (csrc/band_prep.cu, band_stream.cu,
band_grad.cu, ranges.cu) against their plain PyTorch versions
(ops/band.py), and the pruned main path through them, on the card, at small
shapes.

Every test here needs a CUDA device; without one each skips (the ``cuda``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_pruned.py --noconftest``
(tests/conftest.py imports JAX).

Tolerances: f32 rtol 1e-5 / atol 1e-5 — the prep kernel's online
(max, sum-exp) and the plain two-pass logsumexp round differently (~1e-7
relative); the lattice's row walk (S <= 32) takes its log-sum-exp's exp
and log on the SFU (ex2/lg2.approx, about 1e-7 absolute a step; its adds
follow the plain version's order), and the chunk kernel (S > 32) carries
its prefixes across 32-lane chunks, another association than the plain
full-row scan; neither is bit-equal to the plain version, each is
bit-reproducible (no atomics). 16-bit gradients within one ulp of
their type (both round one f32 value once). Ranges exactly.
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import (gather_banded, rnnt_loss, rnnt_loss_pruned,
                                       rnnt_loss_simple)
from warp_transducer_tpu_torch.ops import band
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops.cuda import band as kband
from warp_transducer_tpu_torch.ops.cuda import ranges as kranges

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(B, T, U, V, S, seed=0, dtype=torch.float32, device="cpu", infeasible=False):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, S, V)) * 2.0, dtype=dtype, device=device)
    labels = torch.tensor(rng.integers(1, max(V, 2), (B, max(U - 1, 1))) % V, dtype=torch.int32,
                          device=device)
    il = rng.integers(1, T + 1, B)
    ll = rng.integers(0, U, B)
    il[0], ll[0] = T, U - 1
    if infeasible:  # U_b - 1 > T_b·(S - 1): no width-S band holds a path
        il[-1], ll[-1] = 1, min(U - 1, S + 1)
    steps = rng.integers(0, S, (B, T))
    steps[:, 0] = 0
    ranges = np.minimum(np.cumsum(steps, axis=1), np.maximum(ll[:, None] + 1 - S, 0))
    to = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return acts, labels, to(il), to(ll), to(ranges)


def _lab_row(labels, ranges, S):
    return band.label_rows(*band.band_labels(labels, ranges, S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("V,blank", [(5, 0), (50, 3), (600, 599)])
def test_band_prep_kernel(dev, dtype, V, blank):
    acts, labels, il, ll, ranges = _problem(3, 7, 6, V, 4, dtype=dtype, device=dev)
    lab_row = _lab_row(labels, ranges, 4)
    got = kband.band_prep(acts, lab_row, blank)
    torch.cuda.synchronize()
    want = band.band_prep(acts, lab_row, blank)
    for name in ("lpb", "lpe", "denom"):
        assert getattr(got, name).dtype == torch.float32
        torch.testing.assert_close(getattr(got, name), getattr(want, name), **F32)


@pytest.mark.parametrize("B,T,U,S,infeasible", [
    (4, 9, 6, 3, False), (3, 12, 9, 5, True), (2, 1, 3, 2, False), (2, 17, 12, 11, True),
    (2, 6, 45, 40, False), (2, 5, 80, 70, True)],
    ids=["S3", "S5_infeasible", "T1", "S11", "S40_two_chunks", "S70_three_chunks"])
def test_band_stream_kernel(dev, B, T, U, S, infeasible):
    acts, labels, il, ll, ranges = _problem(B, T, U, 6, S, seed=1, device=dev,
                                            infeasible=infeasible)
    p = band.band_prep(acts, _lab_row(labels, ranges, S), 0)
    got = kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)
    torch.cuda.synchronize()
    want = band.forward_backward(p.lpb, p.lpe, ranges, il, ll)
    valid = band.band_valid(ranges, il, ll, S)
    feasible = want.ll_forward > -1e29
    for name in ("alphas", "betas"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.all(g[~valid] == w[~valid]), name  # NEG in both
        keep = valid & feasible[:, None, None]  # an infeasible β is NEG-level
        torch.testing.assert_close(g[keep], w[keep], **F32)
    torch.testing.assert_close(got.ll_forward, want.ll_forward, **F32)
    torch.testing.assert_close(got.ll_backward[feasible], want.ll_backward[feasible], **F32)
    if infeasible:
        assert got.ll_forward[-1] < -1e29


def _lattice_case(dev, B, T, U, S, seed, infeasible=False):
    acts, labels, il, ll, ranges = _problem(B, T, U, 6, S, seed=seed, device=dev,
                                            infeasible=infeasible)
    p = band.band_prep(acts, _lab_row(labels, ranges, S), 0)
    return p.lpb, p.lpe, ranges, il, ll


def _check_lattice(got, want, ranges, il, ll, S):
    valid = band.band_valid(ranges, il, ll, S)
    feasible = want.ll_forward > -1e29
    for name in ("alphas", "betas"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.all(g[~valid] == w[~valid]), name  # NEG in both
        keep = valid & feasible[:, None, None]  # an infeasible β is NEG-level
        torch.testing.assert_close(g[keep], w[keep], **F32)
    torch.testing.assert_close(got.ll_forward, want.ll_forward, **F32)
    torch.testing.assert_close(got.ll_backward[feasible], want.ll_backward[feasible], **F32)


@pytest.mark.parametrize("B,T,S", [(3, 70, 5), (2, 1500, 5), (1, 1, 1), (4, 33, 32), (2, 9, 33),
                                   (300, 150, 5)])
def test_band_plan_matches_kernel(dev, B, T, S):
    assert kband.kernel_plan(B, T, S) == kband.plan(B, T, S)


@pytest.mark.parametrize("S", [1, 2, 5, 31, 32])
def test_band_row_walk_registers(dev, S):
    """Every instance of the row walk: registers reported, no spills."""
    regs, local = kband.kernel_registers(S)
    assert 0 < regs <= 255 and local == 0, (regs, local)


@pytest.mark.parametrize("B,T,U,S,infeasible", [
    (3, 40, 3, 1, False), (4, 45, 9, 2, True), (3, 70, 60, 31, False), (3, 64, 70, 32, True),
    (3, 47, 70, 33, False), (3, 1, 6, 5, True), (3, 1, 40, 32, False), (5, 97, 30, 5, True),
    (3, 32, 12, 5, False), (3, 33, 12, 5, False)],
    ids=["S1", "S2_infeasible", "S31", "S32_infeasible", "S33_chunks", "T1", "T1_S32",
         "T97", "T32", "T33"])
def test_band_row_walk_kernel(dev, B, T, U, S, infeasible):
    """The row walk (S <= 32) and the chunk kernel (S = 33) against the plain
    version, at the edges of the plan: S = 1, 2, 31, 32, 33, T = 1, T on and
    off the tile of 32 rows, T_b = 1, U_b = 1 and infeasible bands."""
    lpb, lpe, ranges, il, ll = _lattice_case(dev, B, T, U, S, seed=S + T, infeasible=infeasible)
    assert kband.plan(B, T, S).row_mode == (S <= 32)
    got = kband.forward_backward(lpb, lpe, ranges, il, ll)
    torch.cuda.synchronize()
    _check_lattice(got, band.forward_backward(lpb, lpe, ranges, il, ll), ranges, il, ll, S)


def test_band_row_walk_long_ragged(dev):
    """A T = 1500 band with ragged lengths, δ up to S - 1 (the pruned_long
    lattice's shape at B = 6), and input tensors off the 16-byte grid (views
    one value into a larger buffer), which the copies take a word at a time."""
    B, T, U, S = 6, 1500, 301, 5
    lpb, lpe, ranges, il, ll = _lattice_case(dev, B, T, U, S, seed=11, infeasible=True)
    want = band.forward_backward(lpb, lpe, ranges, il, ll)
    got = kband.forward_backward(lpb, lpe, ranges, il, ll)
    _check_lattice(got, want, ranges, il, ll, S)
    off = [torch.empty(lpb.numel() + 1, device=dev)[1:].view_as(lpb) for _ in range(2)]
    off[0].copy_(lpb)
    off[1].copy_(lpe)
    r_off = torch.empty(ranges.numel() + 1, dtype=torch.int32, device=dev)[1:].view_as(ranges)
    r_off.copy_(ranges)
    shifted = kband.forward_backward(off[0], off[1], r_off, il, ll)
    for a, b in zip(shifted, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [5, 32, 40])
def test_band_stream_kernel_is_reproducible(dev, S):
    """Two calls give the same bits (no atomics, a fixed order of sums)."""
    lpb, lpe, ranges, il, ll = _lattice_case(dev, 4, 100, 60, S, seed=3)
    one = kband.forward_backward(lpb, lpe, ranges, il, ll)
    two = kband.forward_backward(lpb, lpe, ranges, il, ll)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_band_grad_kernel(dev, dtype):
    B, T, U, V, S = 3, 8, 6, 7, 3
    acts, labels, il, ll, ranges = _problem(B, T, U, V, S, seed=2, dtype=dtype, device=dev,
                                            infeasible=True)
    labels[1, 0] = 0  # a label equal to blank
    lab_band, has_lab = band.band_labels(labels, ranges, S)
    lab_row = band.label_rows(lab_band, has_lab)
    p = band.band_prep(acts, lab_row, 0)
    lat = band.forward_backward(p.lpb, p.lpe, ranges, il, ll)
    scale = torch.linspace(0.5, 1.5, B, device=dev)
    fields = band.band_coefs(p.lpb, p.lpe, lat, ranges, has_lab, il, ll, scale, 0.1)
    got = kband.band_grad(acts, p.denom, fields, lab_row, ranges, il, ll, 0, dtype)
    torch.cuda.synchronize()
    want = band.band_grad(acts, p.denom, fields, lab_row, ranges, il, ll, 0, dtype)
    assert got.dtype == dtype
    if dtype in (torch.bfloat16, torch.float16):
        ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
        torch.testing.assert_close(got.float(), want.float(), rtol=ulp, atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(got[-1]) == 0  # the infeasible utterance


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("V", [1, 2, 7, 28, 31, 32, 33, 50, 64, 65, 127, 128, 129, 1000, 5000])
def test_band_grad_kernel_rows(dev, V, dtype):
    """K5b across the planner's switch from tiles to a warp a row, with rows
    off the 16-byte grid: B·T·S = 585 rows (more than a tile of small V
    holds, a multiple of no tile), an infeasible utterance, T_b = 1 and
    U_b = 1 among the lengths, blank first and last with a label equal to
    it, a cotangent scale and FastEmit."""
    B, T, U, S = 5, 13, 12, 9
    for blank in sorted({0, V - 1}):
        acts, labels, il, ll, ranges = _problem(B, T, U, V, S, seed=7, dtype=dtype, device=dev,
                                                infeasible=True)
        labels[0, 0] = labels[1, 1] = blank
        lab_band, has_lab = band.band_labels(labels, ranges, S)
        lab_row = band.label_rows(lab_band, has_lab)
        p = band.band_prep(acts, lab_row, blank)
        lat = band.forward_backward(p.lpb, p.lpe, ranges, il, ll)
        fields = band.band_coefs(p.lpb, p.lpe, lat, ranges, has_lab, il, ll,
                                 torch.linspace(0.5, 1.5, B, device=dev), 0.1)
        K.reset_launches()
        got = kband.band_grad(acts, p.denom, fields, lab_row, ranges, il, ll, blank, dtype)
        torch.cuda.synchronize()
        assert K.launches["band_grad"] == 1
        want = band.band_grad(acts, p.denom, fields, lab_row, ranges, il, ll, blank, dtype)
        assert got.dtype == dtype
        if dtype in (torch.bfloat16, torch.float16):
            ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
            torch.testing.assert_close(got.float(), want.float(), rtol=ulp, atol=1e-6)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert torch.count_nonzero(got[-1]) == 0  # the infeasible utterance


@pytest.mark.parametrize("seed,B,T,U,S", [(0, 6, 40, 12, 3), (1, 5, 1, 4, 2), (2, 8, 300, 61, 5),
                                          (3, 4, 20, 30, 7)])
def test_ranges_kernel(dev, seed, B, T, U, S):
    """Random peaks that jump about drive every clamp; lengths include
    T_b = 1, U_b = 1 and utterances no width-S band can align."""
    rng = np.random.default_rng(seed)
    best_u = torch.tensor(rng.integers(0, U, (B, T)), dtype=torch.int32, device=dev)
    il = torch.tensor(rng.integers(1, T + 1, B), dtype=torch.int32, device=dev)
    ll = torch.tensor(rng.integers(0, U, B), dtype=torch.int32, device=dev)
    il[0], ll[0] = T, U - 1
    ll[-1] = 0
    got = kranges.band_starts(best_u, il, ll, S)
    torch.cuda.synchronize()
    want = band.band_starts(best_u, il, ll, S)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def _pruned_step(am, lm, labels, il, ll, S, **kw):
    a = am.clone().requires_grad_(True)
    m = lm.clone().requires_grad_(True)
    loss_s, ranges = rnnt_loss_simple(a, m, labels, il, ll, reduction="sum", prune_range=S, **kw)
    band_acts = a[:, :, None, :] + gather_banded(m, ranges, S)
    loss_p = rnnt_loss_pruned(band_acts, ranges, labels, il, ll, reduction="sum", **kw)
    (loss_s + loss_p).backward()
    return loss_s.detach(), loss_p.detach(), ranges, a.grad, m.grad


def test_pruned_main_path_launches_each_kernel(dev):
    B, T, U, V, S = 4, 30, 9, 12, 4
    rng = np.random.default_rng(3)
    am = torch.tensor(rng.standard_normal((B, T, V)), dtype=torch.float32, device=dev)
    lm = torch.tensor(rng.standard_normal((B, U, V)), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.integers(1, V, (B, U - 1)), dtype=torch.int32, device=dev)
    il = torch.tensor([30, 25, 20, 28], dtype=torch.int32, device=dev)
    ll = torch.tensor([8, 6, 5, 7], dtype=torch.int32, device=dev)
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # the main path never waits on the card
    try:
        out = _pruned_step(am, lm, labels, il, ll, S)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert K.launches == dict.fromkeys(K.launches, 0) | {
        "wavefront": 1, "ranges": 1, "band_prep": 1, "band_stream": 1, "band_grad": 1}
    K.reset_launches()
    ref = _pruned_step(am, lm, labels, il, ll, S, implementation="torch")
    assert K.launches == dict.fromkeys(K.launches, 0)
    assert torch.equal(out[2], ref[2])
    for got, want in zip(out[:2], ref[:2]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(out[3:], ref[3:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_full_band_equals_dense_on_card(dev):
    B, T, U, V = 3, 9, 36, 8  # S = U = 36: the band lattice in two chunks
    rng = np.random.default_rng(4)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.integers(1, V, (B, U - 1)), dtype=torch.int32, device=dev)
    il = torch.tensor([9, 7, 5], dtype=torch.int32, device=dev)
    ll = torch.tensor([35, 20, 4], dtype=torch.int32, device=dev)
    a = acts.clone().requires_grad_(True)
    dense = rnnt_loss(a, labels, il, ll, reduction="none")
    (gd,) = torch.autograd.grad(dense.sum(), a)
    pruned = rnnt_loss_pruned(a, torch.zeros((B, T), dtype=torch.int32, device=dev), labels, il,
                              ll, reduction="none")
    (gp,) = torch.autograd.grad(pruned.sum(), a)
    torch.testing.assert_close(pruned, dense, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gp, gd, rtol=1e-4, atol=1e-5)
