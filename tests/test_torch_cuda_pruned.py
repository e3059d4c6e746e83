"""The pruned path's CUDA kernels (csrc/band_prep.cu, band_stream.cu,
band_grad.cu, ranges.cu) against their plain PyTorch versions
(ops/band.py), and the pruned main path through them, on the card, at small
shapes.

Every test here needs a CUDA device; without one each skips (the ``cuda``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_pruned.py --noconftest``
(tests/conftest.py imports JAX).

Tolerances: f32 rtol 1e-5 / atol 1e-5 — the band prep's warp mode
(V > 256) keeps an online (max, sum-exp) that rounds otherwise than the
plain two-pass logsumexp (~1e-7 relative; its tile mode takes two passes
too, but sums in another order); the lattice's row walk (S <= 32) takes its log-sum-exp's exp
and log on the SFU (ex2/lg2.approx, about 1e-7 absolute a step; its adds
follow the plain version's order), and the cells walk (S > 32) scans C
cells a lane, then the lane totals, then the warps' (each warp in its own
frame of the chain), another association than the plain full-row scan;
neither is bit-equal to the plain version, each is bit-reproducible (no
atomics). 16-bit gradients within one ulp of
their type (both round one f32 value once). Ranges exactly: the range
kernel forms (α + β) − ll in the plain version's order and type and takes
the first maximum, as torch.argmax.
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import (gather_banded, rnnt_loss, rnnt_loss_pruned,
                                       rnnt_loss_simple)
from warp_transducer_tpu_torch.ops import band
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops.cuda import band as kband
from warp_transducer_tpu_torch.ops.cuda import prep as kprep
from warp_transducer_tpu_torch.ops.cuda import ranges as kranges
from warp_transducer_tpu_torch.ops.cuda import rows as R
from test_torch_cuda_prep import _forced

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


BAND_PREP_V = [1, 2, 28, 50, 255, 256, 257, 600, 1003, 5000]
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


def _band_prep_case(V, dtype, dev, seed, offset=0):
    """A (3, 37, 5, V) band of ``dtype`` on the card, ``offset`` elements
    into a larger buffer: 555 rows, a multiple of no tile (512 rows at V = 1,
    80 at V = 50 f32), and its lab_row with rows without a label."""
    B, T, U, S = 3, 37, 9, 5
    acts, labels, _, _, ranges = _problem(B, T, U, V, S, seed=seed, dtype=dtype, device=dev)
    buf = torch.empty(acts.numel() + offset, dtype=dtype, device=dev)
    band_acts = buf[offset:].view_as(acts)
    band_acts.copy_(acts)
    return band_acts, _lab_row(labels, ranges, S)


def _check_band_prep(got, want):
    for name in ("lpb", "lpe", "denom"):
        assert getattr(got, name).dtype == torch.float32
        torch.testing.assert_close(getattr(got, name), getattr(want, name), **F32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("V", BAND_PREP_V)
def test_band_prep_kernel_every_v(dev, V, dtype):
    """K5a on the tiled row reductions against the plain band_prep, across
    the switch from tiles to a warp a row, blank first or last."""
    acts, lab_row = _band_prep_case(V, dtype, dev, seed=V)
    for blank in sorted({0, V - 1}):
        K.reset_launches()
        got = kband.band_prep(acts, lab_row, blank)
        torch.cuda.synchronize()
        assert K.launches["band_prep"] == 1
        _check_band_prep(got, band.band_prep(acts, lab_row, blank))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("V", [1, 28, 50, 257, 5000])
def test_band_prep_kernel_unaligned(dev, V, dtype):
    """A band one element into a buffer, off the 16-byte grid: the kernel
    plans one-element loads from the actual pointer."""
    acts, lab_row = _band_prep_case(V, dtype, dev, seed=V + 1, offset=1)
    assert acts.data_ptr() % 16 != 0
    assert kprep.library_plan(V, acts.element_size(), R.alignment(acts.data_ptr()))[2] == 1
    got = kband.band_prep(acts, lab_row, 0)
    torch.cuda.synchronize()
    _check_band_prep(got, band.band_prep(acts, lab_row, 0))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mode", [R.TILE, R.WARP], ids=["tile", "warp"])
@pytest.mark.parametrize("V", [2, 28, 50, 600, 1000])
def test_band_prep_kernel_both_modes(dev, V, mode, dtype):
    """Each mode at V on both sides of the switch point, through the planned
    entry."""
    acts, lab_row = _band_prep_case(V, dtype, dev, seed=V + 2)
    p = _forced(V, acts.element_size(), mode)
    assert p is not None, f"no tile at V={V}"
    K.reset_launches()
    got = kband.band_prep_planned(acts, lab_row, 1, p)
    torch.cuda.synchronize()
    assert K.launches["band_prep"] == 1
    _check_band_prep(got, band.band_prep(acts, lab_row, 1))


def test_band_prep_kernel_refuses_bad_plans(dev):
    acts, lab_row = _band_prep_case(28, torch.float32, dev, seed=0)
    p = R.reduce_plan(28, 4)
    for bad in (p._replace(group=3), p._replace(stride=32), p._replace(rows=1000),
                p._replace(vec=2), p._replace(mode=7)):
        with pytest.raises(RuntimeError, match="band_prep kernel launch failed"):
            kband.band_prep_planned(acts, lab_row, 0, bad)
    odd, lab = _band_prep_case(28, torch.float32, dev, seed=0, offset=1)
    with pytest.raises(RuntimeError, match="band_prep kernel launch failed"):  # vectors, unaligned
        kband.band_prep_planned(odd, lab, 0, p)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mode", [R.TILE, R.WARP], ids=["tile", "warp"])
@pytest.mark.parametrize("vec", [1, 2], ids=["scalar", "vectors"])
def test_band_prep_kernel_registers(dev, dtype, mode, vec):
    """Every instance of the band prep: registers reported, no spills."""
    p = R.reduce_plan(28, torch.empty((), dtype=dtype).element_size())._replace(mode=mode, vec=vec)
    regs, local = kband.band_prep_registers(dtype, p)
    assert 0 < regs <= 255 and local == 0, (regs, local)


def test_band_prep_plan_matches_python(dev):
    """The plan the band prep applies (csrc/reduce.cuh::plan) is
    rows.reduce_plan at every V it runs and every element size."""
    for elt in (2, 4, 8):
        for align in (16, 8, 4, 2):
            for V in BAND_PREP_V + list(range(1, 300)):
                assert kprep.library_plan(V, elt, align) == tuple(R.reduce_plan(V, elt, align)), \
                    (V, elt, align)


@pytest.mark.parametrize("V", [50, 5000])
def test_band_prep_kernel_is_reproducible(dev, V):
    acts, lab_row = _band_prep_case(V, torch.float32, dev, seed=5)
    one, two = kband.band_prep(acts, lab_row, 0), kband.band_prep(acts, lab_row, 0)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


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
                                   (300, 150, 5), (128, 150, 41), (2, 9, 100), (2, 9, 544),
                                   (2, 9, 545), (2, 9, 600), (2, 9, 4353), (2, 9, 20000),
                                   (2, 9, 30000), (2, 4_000_000, 5), (2, 300_000, 600)])
def test_band_plan_matches_kernel(dev, B, T, S):
    assert kband.kernel_plan(B, T, S) == kband.plan(B, T, S)


@pytest.mark.parametrize("S", [1, 2, 5, 31, 32])
def test_band_row_walk_registers(dev, S):
    """Every instance of the row walk: registers reported, no spills."""
    regs, local = kband.kernel_registers(150, S)
    assert 0 < regs <= 255 and local == 0, (regs, local)


@pytest.mark.parametrize("T", [150, 100_000_000], ids=["int", "long_long"])
def test_band_cells_walk_registers(dev, T):
    """Every instance of the cells walk (C = 1, 3, … 17; 32- and 64-bit
    offsets; C = 1 with 32-bit offsets is the row walk's band): registers
    reported, no spills."""
    for C in range(1, 18, 2):
        p = kband.plan(1, T, 32 * C)
        if p.row_mode:
            continue
        assert p.cells == C and p.offsets64 == (T > 1_000_000), p
        regs, local = kband.kernel_registers(T, 32 * C)
        assert 0 < regs <= 255 and local == 0, (C, regs, local)


@pytest.mark.parametrize("B,T,U,S,infeasible", [
    (128, 150, 41, 41, False), (3, 40, 120, 100, True), (3, 30, 700, 600, False),
    (2, 6, 20100, 20000, False), (2, 4, 30100, 30000, True)],
    ids=["full_band_S41", "S100", "S600_two_warps", "S20000_chunks", "S30000_rows_in_memory"])
def test_band_cells_walk_kernel(dev, B, T, U, S, infeasible):
    """The cells walk at the shapes that took the earlier chunk kernel and
    past any earlier limit: the full band of the headline shape, one warp of
    five cells a lane, two warps, 8 warps in chunks, the rows in device
    memory; against the plain version."""
    lpb, lpe, ranges, il, ll = _lattice_case(dev, B, T, U, S, seed=S, infeasible=infeasible)
    p = kband.plan(B, T, S)
    assert not p.row_mode and (p.rows_device == (S == 30000)) and (p.chunks > 1) == (S >= 20000)
    K.reset_launches()
    got = kband.forward_backward(lpb, lpe, ranges, il, ll)
    torch.cuda.synchronize()
    assert K.launches["band_stream"] == 1
    if S <= 100:
        _check_lattice(got, band.forward_backward(lpb, lpe, ranges, il, ll), ranges, il, ll, S)
        return
    # Wide bands: the walk and the f32 plain version round the prefix form's
    # cancellation against |c| each their own way (both about one to four
    # ulps of max |c| off the f64 value at S = 20,000; PERF.md §6):
    # held against the plain version in f64 at rtol 1e-5 and an atol of
    # 1e-5, four ulps of max |c| and the f32 plain version's own largest
    # error there.
    want = band.forward_backward(lpb.double(), lpe.double(), ranges, il, ll)
    plain = band.forward_backward(lpb, lpe, ranges, il, ll)
    c_max = float(lpe.clamp_min(-1e4).double().sum(-1).abs().max())
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        w = getattr(want, name)
        # (the cells a path reaches; NEG is -1e30 in f64 and -1.0000000150e30 in f32)
        own = float(((getattr(plain, name).double() - w).abs() * (w.abs() < 1e29)).max())
        torch.testing.assert_close(getattr(got, name).double(), w, rtol=1e-5,
                                   atol=1e-5 + c_max * 2.0 ** -22 + own)


@pytest.mark.parametrize("B,T,U,S,infeasible", [
    (3, 40, 3, 1, False), (4, 45, 9, 2, True), (3, 70, 60, 31, False), (3, 64, 70, 32, True),
    (3, 47, 70, 33, False), (3, 1, 6, 5, True), (3, 1, 40, 32, False), (5, 97, 30, 5, True),
    (3, 32, 12, 5, False), (3, 33, 12, 5, False)],
    ids=["S1", "S2_infeasible", "S31", "S32_infeasible", "S33_chunks", "T1", "T1_S32",
         "T97", "T32", "T33"])
def test_band_row_walk_kernel(dev, B, T, U, S, infeasible):
    """The row walk (S <= 32) and the cells walk (S = 33) against the plain
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


def _posteriors(rng, B, T, U, dtype, dev, ties):
    """alphas, betas (B, T, U) and ll (B,): integer-valued (every row full
    of equal maxima) or random ones whose peaks jump about."""
    if ties:
        a, b = (rng.integers(-3, 1, (B, T, U)) for _ in range(2))
    else:
        a, b = rng.standard_normal((B, T, U)) * 5, np.zeros((B, T, U))
    to = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return to(a), to(b), to(rng.standard_normal(B).round())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
@pytest.mark.parametrize("seed,B,T,U,S", [(0, 6, 40, 12, 3), (1, 5, 1, 4, 2), (2, 8, 300, 61, 5),
                                          (3, 4, 20, 30, 7)])
def test_ranges_kernel(dev, seed, B, T, U, S, ties, dtype):
    """The range kernel (argmax and scans) against posterior_peaks +
    band_starts, exactly: posteriors with ties or with peaks that jump about
    and drive every clamp; lengths include T_b = 1, U_b = 1 and utterances
    no width-S band can align."""
    rng = np.random.default_rng(seed)
    alphas, betas, llf = _posteriors(rng, B, T, U, dtype, dev, ties)
    il = torch.tensor(rng.integers(1, T + 1, B), dtype=torch.int32, device=dev)
    ll = torch.tensor(rng.integers(0, U, B), dtype=torch.int32, device=dev)
    il[0], ll[0] = T, U - 1
    ll[-1] = 0
    K.reset_launches()
    got = kranges.ranges_from_posteriors(alphas, betas, llf, il, ll, S)
    torch.cuda.synchronize()
    assert K.launches["ranges"] == 1
    want = band.band_starts(band.posterior_peaks(alphas, betas, llf), il, ll, S)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "random"])
def test_ranges_kernel_long(dev, ties):
    """pruned_long's lattice shape (T = 1500, U = 301) at B = 6, lengths
    from T_b = 0 to beyond T, and two calls bit-equal."""
    B, T, U, S = 6, 1500, 301, 5
    rng = np.random.default_rng(8)
    alphas, betas, llf = _posteriors(rng, B, T, U, torch.float32, dev, ties)
    il = torch.tensor([T, 1, 0, 977, T + 2, 2], dtype=torch.int32, device=dev)
    ll = torch.tensor([U - 1, 300, 17, 150, 0, 60], dtype=torch.int32, device=dev)
    got = kranges.ranges_from_posteriors(alphas, betas, llf, il, ll, S)
    again = kranges.ranges_from_posteriors(alphas, betas, llf, il, ll, S)
    torch.cuda.synchronize()
    want = band.ranges_from_posteriors(alphas, betas, llf, il, ll, S)
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("T,U", [(1, 1), (40, 12), (150, 21), (1500, 301), (33, 2), (7, 5000)])
def test_ranges_plan_matches_kernel(dev, T, U):
    assert kranges.kernel_plan(T, U) == kranges.plan(T, U)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("U", [1, 8, 16, 32, 64, 301])  # G = 1, 2, 4, 8, 16, 32 lanes a row
def test_ranges_kernel_registers(dev, dtype, U):
    """Every instance of the range kernel: registers reported, no spills."""
    regs, local = kranges.kernel_registers(dtype, U)
    assert 0 < regs <= 64 and local == 0, (regs, local)


def test_ranges_kernel_refuses_other_types(dev):
    a = torch.zeros((2, 3, 4), dtype=torch.bfloat16, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        kranges.ranges_from_posteriors(a, a, torch.zeros(2, dtype=torch.bfloat16, device=dev),
                                       lengths, lengths, 3)


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
