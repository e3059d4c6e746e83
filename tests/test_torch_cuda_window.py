"""The duration-arc losses' CUDA kernels against their plain PyTorch versions
on the card, at small shapes: the pending-window lattice
(csrc/window_stream.cu vs ops/window.py), the prep and gradient kernels with
extra columns (csrc/prep.cu, csrc/grad.cu), and ``rnnt_loss_multiblank`` /
``rnnt_loss_tdt`` through them.

Every test here needs a CUDA device; without one each skips (the ``dev``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_window.py --noconftest``
(tests/conftest.py imports JAX).

Tolerances: f32 rtol 1e-5 / atol 1e-5, f64 1e-10 — the kernel's scans add
and log-sum-exp in another order than ``torch.cumsum`` and
``torch.logcumsumexp``; a lattice's atol grows with its row width (see
``_close``). 16-bit gradients within one ulp of their type (both versions
round one f32 value once).
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import rnnt_loss_multiblank, rnnt_loss_tdt
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import gradients, lattice, prep, window
from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
from warp_transducer_tpu_torch.ops.cuda import prep as kprep
from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
from warp_transducer_tpu_torch.ops.cuda import window as kwindow

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.float64: dict(rtol=1e-10, atol=1e-10)}

MULTIBLANK = [(), (2,), (2, 4), (2, 3, 8)]
TDT = [(0, 1, 2, 4), (1, 2, 3), (0, 1, 3), (1, 2), (2,)]
# (B, T, U): ragged; B = 1; T = 1 (so T_b = 1); U = 1; U not a multiple of
# 32; U past one warp's 17 cells (two warps); U above 1024 (four warps, and
# for the larger arc sets' f64 rings two passes).
SHAPES = [(4, 9, 6), (1, 9, 4), (2, 1, 3), (3, 7, 1), (2, 6, 45), (2, 5, 600), (2, 4, 1100)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lengths(rng, B, T, U, device):
    il = torch.tensor(rng.integers(1, T + 1, B), dtype=torch.int32, device=device)
    ll = torch.tensor(rng.integers(0, U, B), dtype=torch.int32, device=device)
    il[0], ll[0] = T, U - 1
    return il, ll


def _channels(B, T, U, C, seed, dtype, device):
    """lpb, lpe (column U-1 NEG) and C extra channels: log-probs of random
    logits over 3 + C classes, and ragged lengths."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.tensor(rng.standard_normal((B, T, U, 3 + C)) * 2.0,
                                        dtype=dtype, device=device), -1)
    lpe = lp[..., 1].clone()
    lpe[:, :, U - 1] = prep.NEG
    il, ll = _lengths(rng, B, T, U, device)
    return lp[..., 0].contiguous(), lpe, lp[..., 3:].contiguous(), il, ll


def _close(got, want, dtype, U=0):
    """``U``: the width of a lattice row. The prefix form c + LSE(ne − c)
    cancels against |c| <= ~2·U with these inputs, in the kernel and in the
    plain version alike but in another order of addition, so a lattice's
    atol grows with U (|c|·2^-23 in f32, a few times over)."""
    tol = TOL[dtype]
    torch.testing.assert_close(got.double().cpu(), want.double().cpu(), rtol=tol["rtol"],
                               atol=tol["atol"] * (1 + U / 10))


def _check_wide(arcs, B, T, U, C, dtype, dev, seed):
    """A lattice past what one block's rings hold at one pass, or with many
    warps: the f32 walk and the f32 plain version round the prefix form's
    cancellation against |c| each their own way (at U = 30,000 the plain
    version is about nine ulps of max |c| off its f64 value, the walk
    about four; PERF.md §6), so an f32 kernel is held against the
    plain version run in f64, at rtol 1e-5 and an atol of 1e-5, four ulps of
    max |c| (chip_smoke.window_tol) and the f32 plain version's own largest
    error there; f64 against the plain version, rtol 1e-10 and atol 1e-10
    and four ulps of max |c|."""
    lpb, lpe, extra, il, ll = _channels(B, T, U, C, seed, dtype, dev)
    got = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)
    torch.cuda.synchronize()
    want = window.forward_backward(lpb.double(), lpe.double(), extra.double(), arcs, il, ll)
    plain = window.forward_backward(lpb, lpe, extra, arcs, il, ll)
    chain = (lpe if arcs.chain == (1,) else lpe + extra[..., arcs.chain[1] - 2]
             if arcs.chain else None)
    c_max = float(chain[..., :-1].clamp_min(-1e4).double().sum(-1).abs().max()) if chain is not None else 0.0
    ulps = 2.0 ** -22 if dtype == torch.float32 else 2.0 ** -51
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        w = getattr(want, name).cpu()
        # (the cells a path reaches; NEG is -1e30 in f64 and -1.0000000150e30 in f32)
        own = float(((getattr(plain, name).double().cpu() - w).abs() * (w.abs() < 1e29)).max()) \
            if dtype == torch.float32 else 0.0
        tol = TOL[dtype]
        torch.testing.assert_close(getattr(got, name).double().cpu(), w, rtol=tol["rtol"],
                                   atol=tol["atol"] + c_max * ulps + own)
    return got


def _check_lattice(arcs, B, T, U, C, dtype, dev, betas=True, seed=1):
    lpb, lpe, extra, il, ll = _channels(B, T, U, C, seed, dtype, dev)
    got = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll, compute_betas=betas)
    torch.cuda.synchronize()
    want = window.forward_backward(lpb, lpe, extra, arcs, il, ll, compute_betas=betas)
    # Every cell is written, NEG at invalid ones, in both versions.
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), dtype, U)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B,T,U", SHAPES)
@pytest.mark.parametrize("durations", MULTIBLANK, ids=str)
def test_window_kernel_multiblank(dev, durations, B, T, U, dtype):
    _check_lattice(window.multiblank_arcs(durations), B, T, U, len(durations), dtype, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B,T,U", SHAPES)
@pytest.mark.parametrize("durations", TDT, ids=str)
def test_window_kernel_tdt(dev, durations, B, T, U, dtype):
    _check_lattice(window.tdt_arcs(durations), B, T, U, len(durations), dtype, dev)


@pytest.mark.parametrize("W", range(1, 9))
def test_window_kernel_every_window(dev, W):
    """One arc with m = W for W = 1 … 8 (it lands on the slot being
    cleared), as a big blank and as a TDT duration beside d = 1."""
    if W == 1:
        _check_lattice(window.multiblank_arcs(()), 3, 19, 5, 0, torch.float32, dev)
    else:
        _check_lattice(window.multiblank_arcs((W,)), 3, 19, 5, 1, torch.float32, dev)
    durs = (1,) if W == 1 else (1, W)
    _check_lattice(window.tdt_arcs(durs), 3, 19, 5, len(durs), torch.float32, dev)
    _check_lattice(window.tdt_arcs((0,) + durs), 3, 19, 5, 1 + len(durs), torch.float32, dev)


@pytest.mark.parametrize("durations", [(2, 4), (0, 1, 2, 4), (1, 2)], ids=str)
def test_window_kernel_score_only(dev, durations):
    arcs = (window.tdt_arcs(durations) if 1 in durations
            else window.multiblank_arcs(durations))
    got = _check_lattice(arcs, 4, 9, 6, len(durations), torch.float32, dev, betas=False)
    assert got.betas is got.alphas and got.ll_backward is got.ll_forward


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B,T,U", [(4, 9, 6), (2, 40, 45), (2, 3, 600)])
def test_window_kernel_without_big_blanks_is_the_wavefront_kernel(dev, B, T, U, dtype):
    """K = 0: W = 1, one blank arc, the label chain: the dense lattice, which
    csrc/wavefront.cu computes along anti-diagonals, cell by cell."""
    lpb, lpe, extra, il, ll = _channels(B, T, U, 0, 2, dtype, dev)
    got = kwindow.forward_backward(lpb, lpe, extra, window.multiblank_arcs(()), il, ll)
    want = kwave.forward_backward(lpb, lpe, il, ll)
    torch.cuda.synchronize()
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), dtype, U)


# The walk's edges: U at 31/32/33 (one to two cells a lane, C odd: 1 and 3),
# one warp's 17 (f32) and 9 (f64) cells ± 1 (above each, two warps a
# lattice); ragged lengths with T_b = T, U_b = U in the first lattice.
EDGE_U = [(torch.float32, U) for U in (31, 32, 33, 543, 544, 545)] + \
    [(torch.float64, U) for U in (31, 32, 33, 287, 288, 289)]


@pytest.mark.parametrize("betas", [True, False], ids=["betas", "alpha_only"])
@pytest.mark.parametrize("dtype,U", EDGE_U, ids=[f"{str(d)[6:]}_U{U}" for d, U in EDGE_U])
@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_window_kernel_edge_u(dev, family, dtype, U, betas):
    arcs = (window.multiblank_arcs(MULTIBLANK[2]) if family == "multiblank"
            else window.tdt_arcs(TDT[0]))
    C = len(MULTIBLANK[2]) if family == "multiblank" else len(TDT[0])
    _check_lattice(arcs, 3, 7, U, C, dtype, dev, betas=betas, seed=U)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("U", [41, 301, 600])
def test_window_kernel_bit_equal_across_calls(dev, dtype, U):
    """No atomics: two calls give the same bits (one warp a lattice; two and
    four at U = 600, and two passes in f64 at U = 600)."""
    lpb, lpe, extra, il, ll = _channels(5, 12, U, 4, 7, dtype, dev)
    arcs = window.tdt_arcs(TDT[0])
    first = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)
    second = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_window_plan_matches_kernel(dev):
    """ops/cuda/window.py::plan (the CPU tests' mirror) against the C plan,
    on this card's SM count and on an H100's, with the warps a lattice the
    rule's and forced, arcs of two and three channels, at the U of one warp,
    of several, of the wide instance, of passes and past 32-bit offsets."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    arc_sets = [window.multiblank_arcs(()), window.multiblank_arcs((2, 4)),
                window.tdt_arcs((0, 1, 2, 4)), window.tdt_arcs((1, 2)), window.tdt_arcs((1, 2, 4)),
                window.tdt_arcs(tuple(range(1, 9))), window.tdt_arcs((0, 1, 2, 3, 4)),
                window.multiblank_arcs((2, 4, 8)), window.tdt_arcs(tuple(range(9))),
                window.multiblank_arcs(tuple(range(2, 11))), window.multiblank_arcs((2, 300))]
    for dtype in (torch.float32, torch.float64):
        elt = torch.tensor([], dtype=dtype).element_size()
        for arcs in arc_sets:
            W, n_arcs = arcs.window, len(arcs.blank_arcs) + len(arcs.emit_arcs)
            n_extra = max(0, max(c for _, chs in arcs.blank_arcs + arcs.emit_arcs for c in chs) - 1)
            chain = arcs.chain is not None
            for U in (1, 21, 31, 32, 33, 41, 129, 257, 287, 288, 289, 301, 543, 544, 545, 601,
                      1100, 1800, 2177, 5000, 30000):
                for B in (1, 16, 33, 128, 1000):
                    for betas in (True, False):
                        for sms in (n_sm, 132):
                            for T in (1, 1500, 4_000_000):
                                for warps in (0, 1, 4, 16):
                                    for ch in (2, 3):
                                        args = (W, n_arcs, n_extra, chain, betas, sms, warps, ch,
                                                kwindow.by_value(arcs, n_extra))
                                        p = kwindow.plan(B, T, U, elt, *args)
                                        assert p == kwindow.kernel_plan(B, T, U, dtype, *args), \
                                            (dtype, U, B, T, args)
                                        for form in kwindow.TABLES if p and p.wide else ():
                                            assert kwindow.plan(B, T, U, elt, *args, form) == \
                                                kwindow.kernel_plan(B, T, U, dtype, *args,
                                                                    form), (form, U, B, T, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_window_kernels_do_not_spill(dev, dtype):
    """Every instance of the kernel, narrow and wide (C = 1, 3, … up to the
    cap): no local memory."""
    elt = torch.tensor([], dtype=dtype).element_size()
    for wide in (kwindow.NARROW, kwindow.WIDE, kwindow.TABLE, kwindow.PENDING):
        cap = kwindow.kind_max_cells(wide, elt)
        for C in range(1, cap + 1, 2):
            p = kwindow.Plan(wide, 1, C, 1, 1, 1, 32, 0, 0, 0)
            regs, local = kwindow.kernel_registers(p, dtype)
            assert local == 0, (wide, C, regs, local)


# (U, warps a lattice, dtype): forced choices of the narrow instance (G <=
# 4) and the wide one (8 and 16 warps; f64 at U = 301 with one warp: C = 11
# is past its cap, so passes).
WARPS_CASES = [(U, G, torch.float32) for U in (70, 130, 301) for G in (1, 2, 4, 8)] + \
    [(U, G, torch.float64) for U in (70, 130) for G in (1, 2, 4)] + \
    [(301, G, torch.float64) for G in (1, 2, 4, 16)] + [(601, 16, torch.float32)]


@pytest.mark.parametrize("U,warps,dtype", WARPS_CASES,
                         ids=[f"U{U}_G{G}_{str(d)[6:]}" for U, G, d in WARPS_CASES])
@pytest.mark.parametrize("family", ["multiblank", "tdt", "tdt_no_d0"])
def test_window_kernel_warps_a_lattice(dev, family, U, warps, dtype):
    """The walk with one to sixteen warps a lattice forced (a named barrier
    a row, two with emit arcs; without a chain only the emit arcs' one),
    against the plain lattice; the warps' column boundaries fall inside the
    lattices and beyond U_b."""
    arcs, C = _family(family)
    lpb, lpe, extra, il, ll = _channels(3, 11, U, C, U + warps, dtype, dev)
    for betas in (True, False):
        got = kwindow.launch(lpb, lpe, extra, arcs, il, ll, compute_betas=betas, warps=warps)
        torch.cuda.synchronize()
        want = window.forward_backward(lpb, lpe, extra, arcs, il, ll, compute_betas=betas)
        for name in ("alphas", "betas", "ll_forward", "ll_backward"):
            _close(getattr(got, name), getattr(want, name), dtype, U)


def _family(family):
    """The arcs and extra channels of the three lattices of the tests."""
    if family == "multiblank":
        return window.multiblank_arcs(MULTIBLANK[2]), len(MULTIBLANK[2])
    if family == "tdt":
        return window.tdt_arcs(TDT[0]), len(TDT[0])
    return window.tdt_arcs((1, 2, 4)), 3


def test_window_kernel_three_channel_arcs(dev):
    """An arc of three channels (no public loss has one) takes the wide
    instance; the result is the plain lattice's, also with several warps
    and in passes."""
    arcs = window.WindowArcs(chain=(1, 2), blank_arcs=((1, (0, 2, 3)), (2, (0, 3))),
                             emit_arcs=((2, (1, 2, 3)),))
    for B, T, U in ((3, 9, 6), (2, 7, 70), (2, 6, 700), (2, 5, 3000)):
        for dtype in (torch.float32, torch.float64):
            _check_wide(arcs, B, T, U, 2, dtype, dev, seed=U)


# The shapes that took the earlier block kernel, now on the walk: many
# lattices at U = 601 (B = 128; fewer rows than the main shapes' 1000), TDT
# without a 0 duration (G > 1 without a chain), f64 past U = 288, rings past
# one block (passes), in f32 and f64.
WIDE_CASES = {
    "mb_B128_U601": ("multiblank", 128, 6, 601),
    "tdt_B128_U601": ("tdt", 128, 6, 601),
    "tdt124_B32_U601": ("tdt_no_d0", 32, 9, 601),
    "mb_U1100": ("multiblank", 3, 8, 1100),
    "tdt_U2000": ("tdt", 2, 7, 2000),
    "mb_U5000": ("multiblank", 2, 5, 5000),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_window_kernel_former_block_shapes(dev, case, dtype):
    family, B, T, U = WIDE_CASES[case]
    arcs, C = _family(family)
    p = kwindow.plan(B, T, U, torch.tensor([], dtype=dtype).element_size(), arcs.window,
                     len(arcs.blank_arcs) + len(arcs.emit_arcs), C, arcs.chain is not None, True,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    assert p is not None
    if family == "tdt_no_d0" and dtype == torch.float32:
        assert p.warps > 1
    K.reset_launches()
    _check_wide(arcs, B, T, U, C, dtype, dev, seed=U)
    assert K.launches["window_stream"] == 1


def test_window_kernel_infeasible_tdt(dev):
    """durations (2,): an odd T_b has no path and ll_forward is NEG in both;
    T_b = 4 with one label (2 + 2 frames) has one."""
    arcs = window.tdt_arcs((2,))
    lpb, lpe, extra, il, ll = _channels(2, 5, 3, 1, 3, torch.float32, dev)
    il[:], ll[:] = torch.tensor([5, 4]), torch.tensor([2, 1])
    got = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)
    want = window.forward_backward(lpb, lpe, extra, arcs, il, ll)
    torch.cuda.synchronize()
    assert float(got.ll_forward[0]) < -1e29 and float(got.ll_forward[1]) > -1e29
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), torch.float32)


def test_window_kernel_u_30000(dev):
    """U = 30,000 with a window of 8 (the wrapper refused it before the
    passes; 17 passes now): the lattice computes and equals its plain
    version (``_check_wide``)."""
    arcs = window.multiblank_arcs((8,))
    for dtype in (torch.float32, torch.float64):
        _check_wide(arcs, 1, 8, 30000, 1, dtype, dev, seed=30)


def test_window_kernel_rejects(dev):
    lpb = torch.zeros((1, 2, 30), device=dev)
    extra = torch.zeros((1, 2, 30, 1), device=dev)
    il, ll = torch.tensor([2]), torch.tensor([3])
    small, ex = lpb[:, :, :4].contiguous(), extra[:, :, :4].contiguous()
    with pytest.raises(ValueError, match="channels"):
        kwindow.forward_backward(small, small, ex, window.multiblank_arcs((2, 3)), il, ll)
    with pytest.raises(ValueError, match="dtype"):
        kwindow.forward_backward(small.half(), small.half(), ex.half(),
                                 window.multiblank_arcs((2,)), il, ll)
    with pytest.raises(ValueError, match="contiguous"):
        kwindow.forward_backward(lpb[:, :, ::2], lpb[:, :, ::2], extra[:, :, ::2],
                                 window.multiblank_arcs((2,)), il, ll)


def _acts_problem(B, T, U, V, seed, dtype, device):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=dtype, device=device)
    labels = torch.tensor(rng.integers(1, V, (B, max(U - 1, 1))), dtype=torch.int32,
                          device=device)
    return (acts, labels) + _lengths(rng, B, T, U, device)


EXTRA_COLS = {0: (), 1: (5,), 2: (26, 27), 8: (27, 3, 9, 26, 11, 2, 25, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("lpi", [False, True], ids=["acts", "log_probs"])
@pytest.mark.parametrize("K_cols", EXTRA_COLS)
def test_prep_kernel_extra_cols(dev, K_cols, lpi, dtype):
    cols = EXTRA_COLS[K_cols]
    acts, labels, _, _ = _acts_problem(3, 7, 5, 28, 4, dtype, dev)
    if lpi:
        acts = torch.log_softmax(acts.float(), -1).to(dtype)
    got = kprep.prepare(acts, labels, 0, lpi, extra_cols=cols)
    base = kprep.prepare(acts, labels, 0, lpi)
    torch.cuda.synchronize()
    want = prep.prepare(acts, labels, 0, lpi, extra_cols=cols)
    cdtype = prep.compute_dtype(dtype)
    assert got.extras.shape == (3, 7, 5, K_cols) and got.extras.dtype == cdtype
    assert base.extras.shape == (3, 7, 5, 0)
    _close(got.extras, want.extras, cdtype)
    # The extra columns leave the three standard outputs as they were, bit
    # for bit.
    for name in ("lpb", "lpe") + (() if lpi else ("denom",)):
        assert torch.equal(getattr(got, name), getattr(base, name)), name
        _close(getattr(got, name), getattr(want, name), cdtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("K_cols", EXTRA_COLS)
def test_grad_kernel_extra_cols(dev, K_cols, dtype):
    cols = EXTRA_COLS[K_cols]
    B, T, U, V = 3, 6, 4, 28
    acts, labels, il, ll = _acts_problem(B, T, U, V, 5, dtype, dev)
    labels[1, 0] = 0  # a label equal to blank
    if K_cols:
        labels[2, 0] = cols[0]  # and one equal to an extra column: both subtractions apply
    p = prep.prepare(acts, labels, 0, False)
    res = lattice.forward_backward(p.lpb, p.lpe, il, ll)
    fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll,
                                    fastemit_lambda=0.1)
    rng = np.random.default_rng(6)
    extra = torch.tensor(rng.random((B, T, U, K_cols)), dtype=fields.coef.dtype, device=dev)
    labels_u = prep.label_rows(labels, U)
    args = (acts, p.denom, fields, labels_u, il, ll, 0, dtype)
    got = kgrad.dense_grad(*args, extra_cols=cols, extra_fields=extra)
    base = kgrad.dense_grad(*args)
    zeroed = kgrad.dense_grad(*args, extra_cols=cols, extra_fields=torch.zeros_like(extra))
    torch.cuda.synchronize()
    want = gradients.dense_grad(*args, extra_cols=cols, extra_fields=extra)
    assert got.dtype == dtype
    # With zero posteriors the extra columns change no bit of the standard pass.
    assert torch.equal(zeroed, base)
    if K_cols:
        assert not torch.equal(got, base)
    if dtype in (torch.bfloat16, torch.float16):
        ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=ulp, atol=1e-6)
    else:
        _close(got, want, dtype)


def test_extra_cols_rejected(dev):
    acts, labels, il, ll = _acts_problem(2, 3, 3, 12, 7, torch.float32, dev)
    # nine columns are taken (the instance past eight reads a device table)
    got = kprep.prepare(acts, labels, 0, False, extra_cols=tuple(range(1, 10)))
    torch.testing.assert_close(got.extras, prep.prepare(acts, labels, 0, False,
                                                        extra_cols=tuple(range(1, 10))).extras)
    with pytest.raises(ValueError, match="inside"):
        kprep.prepare(acts, labels, 0, False, extra_cols=(12,))
    p = prep.prepare(acts, labels, 0, False)
    fields = gradients.Coefficients(p.lpb, p.lpb, p.lpb)
    with pytest.raises(ValueError, match="extra_fields"):
        kgrad.dense_grad(acts, p.denom, fields, prep.label_rows(labels, 3), il, ll, 0,
                         torch.float32, extra_cols=(3, 4),
                         extra_fields=torch.zeros((2, 3, 3, 1), device=dev))


def _no_sync(fn):
    torch.cuda.set_sync_debug_mode("error")  # the main path never waits on the card
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("durations,sigma,lam,dp,indices", [
    ((2,), 0.0, 0.0, 0.0, None), ((2, 4), 0.05, 0.0, 0.0, None), ((2, 3, 8), 0.0, 0.25, 0.0, None),
    ((2, 4), 0.05, 0.1, 0.02, (3, 7)), ((), 0.0, 0.1, 0.0, None)], ids=str)
def test_multiblank_loss_cuda_vs_torch(dev, durations, sigma, lam, dp, indices, dtype):
    B, T, U, V = 4, 9, 5, 11
    Kb = len(durations)
    rng = np.random.default_rng(8)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=dtype, device=dev)
    labels = torch.tensor(rng.integers(1, V - Kb, (B, U - 1)), dtype=torch.int32, device=dev)
    if indices:
        labels[(labels == indices[0]) | (labels == indices[1])] = 1
    il, ll = _lengths(rng, B, T, U, dev)
    scale = torch.linspace(0.5, 1.5, B, device=dev, dtype=dtype)

    def run(implementation):
        a = acts.clone().requires_grad_(True)
        costs = rnnt_loss_multiblank(a, labels, il, ll, durations, big_blank_indices=indices,
                                     sigma=sigma, fastemit_lambda=lam, delay_penalty=dp,
                                     reduction="none", implementation=implementation)
        (costs * scale).sum().backward()
        return costs.detach(), a.grad

    K.reset_launches()
    costs, grads = _no_sync(lambda: run("cuda"))
    torch.cuda.synchronize()
    assert K.launches == dict.fromkeys(K.launches, 0) | {"prep": 1, "window_stream": 1, "grad_fields": 1}
    K.reset_launches()
    costs_t, grads_t = run("torch")
    assert K.launches == dict.fromkeys(K.launches, 0)
    assert costs.dtype == dtype and grads.dtype == dtype
    if dtype == torch.bfloat16:
        torch.testing.assert_close(costs.float(), costs_t.float(), rtol=2 ** -8, atol=1e-6)
        torch.testing.assert_close(grads.float(), grads_t.float(), rtol=2 ** -8, atol=1e-4)
    else:
        _close(costs, costs_t, dtype)
        # exp(α + β − ll) turns the lattice's rounding into a relative error.
        tol = dict(rtol=1e-4, atol=1e-6) if dtype == torch.float32 else TOL[dtype]
        torch.testing.assert_close(grads, grads_t, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("durations,sigma,lam,dp", [
    ((0, 1, 2, 4), 0.0, 0.0, 0.0), ((0, 1, 2, 4), 0.05, 0.0, 0.0), ((1, 2, 3), 0.0, 0.25, 0.0),
    ((0, 1, 3), 0.05, 0.1, 0.02), ((2,), 0.0, 0.0, 0.0)], ids=str)
def test_tdt_loss_cuda_vs_torch(dev, durations, sigma, lam, dp, dtype):
    """The last case has utterances no path consumes exactly: the cost is the
    sentinel and both gradients are zero, on both routes."""
    B, T, U, V = 4, 9, 4, 7
    rng = np.random.default_rng(9)
    tok = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=dtype, device=dev)
    dur = torch.tensor(rng.standard_normal((B, T, U, len(durations))) * 2.0, dtype=dtype,
                       device=dev)
    labels = torch.tensor(rng.integers(1, V, (B, U - 1)), dtype=torch.int32, device=dev)
    il, ll = _lengths(rng, B, T, U, dev)

    def run(implementation):
        t = tok.clone().requires_grad_(True)
        d = dur.clone().requires_grad_(True)
        costs = rnnt_loss_tdt(t, d, labels, il, ll, durations, sigma=sigma, fastemit_lambda=lam,
                              delay_penalty=dp, reduction="none", implementation=implementation)
        costs.sum().backward()
        return costs.detach(), t.grad, d.grad

    K.reset_launches()
    costs, gt, gd = _no_sync(lambda: run("cuda"))
    torch.cuda.synchronize()
    assert K.launches == dict.fromkeys(K.launches, 0) | {"prep": 1, "window_stream": 1, "grad_fields": 1}
    costs_t, gt_t, gd_t = run("torch")
    infeasible = costs_t.float() > 1e29
    assert bool(infeasible[0]) == (durations == (2,))  # T_b = 9 is odd
    assert torch.equal(costs.float() > 1e29, infeasible)
    for g in (gt, gd):
        assert bool(torch.isfinite(g).all()) and not bool(g[infeasible].any())
    ok = ~infeasible
    if dtype == torch.bfloat16:
        torch.testing.assert_close(costs[ok].float(), costs_t[ok].float(), rtol=2 ** -8, atol=1e-6)
        torch.testing.assert_close(gt.float(), gt_t.float(), rtol=2 ** -8, atol=1e-4)
        torch.testing.assert_close(gd.float(), gd_t.float(), rtol=2 ** -8, atol=1e-4)
    else:
        _close(costs[ok], costs_t[ok], dtype)
        tol = dict(rtol=1e-4, atol=1e-6) if dtype == torch.float32 else TOL[dtype]
        torch.testing.assert_close(gt, gt_t, **tol)
        torch.testing.assert_close(gd, gd_t, **tol)


def test_losses_need_cuda_tensors_for_cuda(dev):
    acts = torch.zeros((1, 3, 2, 6))
    args = (torch.ones((1, 1), dtype=torch.int32), torch.tensor([3]), torch.tensor([1]))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_multiblank(acts, *args, (2,), implementation="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_tdt(acts, torch.zeros((1, 3, 2, 2)), *args, (0, 1), implementation="cuda")
    with pytest.raises(ValueError, match="duration_logits is on"):
        rnnt_loss_tdt(acts.to(dev), torch.zeros((1, 3, 2, 2)), *args, (0, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("V", [3, 28, 33, 50, 129, 1000, 5000])
def test_grad_fields_kernel_k2_rows(dev, V, dtype):
    """The gradient kernel's fields mode with K = 2 extra columns (the last
    two, as the multi-blank loss puts its big blanks) across the planner's
    switch from tiles to a warp a row; B·T·U = 585 rows, a multiple of no
    tile; a label equal to blank and one equal to an extra column."""
    B, T, U = 5, 13, 9
    acts, labels, il, ll = _acts_problem(B, T, U, V, 12, dtype, dev)
    cols = (V - 2, V - 1)
    labels[1, 0], labels[2, 0] = 0, cols[0]
    p = prep.prepare(acts, labels, 0, False)
    res = lattice.forward_backward(p.lpb, p.lpe, il, ll)
    fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll,
                                    fastemit_lambda=0.1)
    rng = np.random.default_rng(13)
    extra = torch.tensor(rng.random((B, T, U, 2)), dtype=fields.coef.dtype, device=dev)
    args = (acts, p.denom, fields, prep.label_rows(labels, U), il, ll, 0, dtype)
    K.reset_launches()
    got = kgrad.dense_grad(*args, extra_cols=cols, extra_fields=extra)
    torch.cuda.synchronize()
    assert K.launches["grad_fields"] == 1 and K.launches["grad"] == 0
    want = gradients.dense_grad(*args, extra_cols=cols, extra_fields=extra)
    if dtype in (torch.bfloat16, torch.float16):
        ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=ulp, atol=1e-6)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("loss", ["multiblank", "tdt"])
@pytest.mark.parametrize("V", [7, 33, 129, 1000])
def test_duration_losses_rows_cuda_vs_torch(dev, loss, V):
    """``rnnt_loss_multiblank`` (big blanks of 2 and 4 frames) and
    ``rnnt_loss_tdt`` (durations 0, 1, 2, 4) through the fields mode of the
    gradient kernel, across the planner's switch, against their plain
    versions; f32 tolerances as the tests above."""
    B, T, U = 5, 13, 9
    rng = np.random.default_rng(14)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=torch.float32, device=dev)
    dur = torch.tensor(rng.standard_normal((B, T, U, 4)) * 2.0, dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.integers(1, V - 2, (B, U - 1)), dtype=torch.int32, device=dev)
    il, ll = _lengths(rng, B, T, U, dev)

    def run(implementation):
        a = acts.clone().requires_grad_(True)
        d = dur.clone().requires_grad_(True)
        if loss == "multiblank":
            costs = rnnt_loss_multiblank(a, labels, il, ll, (2, 4), sigma=0.05,
                                         fastemit_lambda=0.1, reduction="none",
                                         implementation=implementation)
        else:
            costs = rnnt_loss_tdt(a, d, labels, il, ll, (0, 1, 2, 4), fastemit_lambda=0.1,
                                  reduction="none", implementation=implementation)
        costs.sum().backward()
        return costs.detach(), a.grad

    K.reset_launches()
    costs, grads = _no_sync(lambda: run("cuda"))
    torch.cuda.synchronize()
    assert K.launches["grad_fields"] == 1 and K.launches["grad"] == 0
    costs_t, grads_t = run("torch")
    _close(costs, costs_t, torch.float32)
    torch.testing.assert_close(grads, grads_t, rtol=1e-4, atol=1e-6)
