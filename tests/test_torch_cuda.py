"""The CUDA kernels of warp_transducer_tpu_torch against their plain PyTorch
versions, on the card, at small shapes.

Every test here needs a CUDA device; without one each skips (the ``cuda``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda.py`` (add ``--noconftest``
where JAX is not installed: tests/conftest.py imports it).
"""
import numpy as np
import pytest
import torch

import golden as G
from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_and_grad, rnnt_score
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import gradients, lattice, prep
from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
from warp_transducer_tpu_torch.ops.cuda import prep as kprep
from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave

pytestmark = pytest.mark.cuda

# Tolerances. f32: the kernel's online (max, sum-exp) and the plain
# two-pass logsumexp round differently, ~1e-7 relative; the lattice adds
# that up over T+U-1 diagonals. f64: the same at 1e-16 scale.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.float64: dict(rtol=1e-10, atol=1e-10)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(B, T, U, V, seed=0, ragged=True, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=dtype, device=device)
    labels = torch.tensor(rng.integers(1, V, (B, max(U - 1, 1))), dtype=torch.int32,
                          device=device)
    if ragged:
        il = torch.tensor(rng.integers(1, T + 1, B), dtype=torch.int32, device=device)
        il[0] = T
        ll = torch.tensor(rng.integers(0, U, B), dtype=torch.int32, device=device)
        ll[0] = U - 1
    else:
        il = torch.full((B,), T, dtype=torch.int32, device=device)
        ll = torch.full((B,), U - 1, dtype=torch.int32, device=device)
    return acts, labels, il, ll


def _close(a, b, dtype=torch.float32, mask=None):
    a, b = a.double().cpu(), b.double().cpu()
    if mask is not None:
        a, b = a[mask.cpu()], b[mask.cpu()]
    torch.testing.assert_close(a, b, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("V,blank,lpi", [(5, 0, False), (28, 3, False), (600, 599, False),
                                         (28, 0, True)])
def test_prep_kernel(dev, dtype, V, blank, lpi):
    acts, labels, _, _ = _problem(3, 7, 5, V, dtype=dtype, device=dev)
    if lpi:
        acts = torch.log_softmax(acts.float(), -1).to(dtype)
    got = kprep.prepare(acts, labels, blank, lpi)
    torch.cuda.synchronize()
    want = prep.prepare(acts, labels, blank, lpi)
    cdtype = prep.compute_dtype(dtype)
    assert got.lpb.dtype == cdtype
    _close(got.lpb, want.lpb, cdtype)
    _close(got.lpe, want.lpe, cdtype)
    if lpi:
        assert got.denom is None
    else:
        _close(got.denom, want.denom, cdtype)


# The band kernel's band edges (U = 32·bands ± 1), its cap (f32 U <= 512,
# f64 U <= 352) ± 1, where the stripe kernel takes over, the stripe kernel
# at U = 1100 (f32 three stripes, f64 four), and batches of two and four
# lattices a block.
WAVEFRONT_SHAPES = [(4, 9, 6, True), (1, 9, 4, False), (2, 1, 3, True), (3, 7, 1, True),
                    (2, 3, 1100, True), (5, 6, 31, True), (5, 6, 32, True), (5, 6, 33, True),
                    (4, 5, 255, True), (4, 5, 256, True), (4, 5, 257, True), (3, 4, 320, True),
                    (3, 3, 351, True), (3, 3, 352, True), (3, 3, 353, True),
                    (3, 4, 321, True), (3, 3, 511, True), (3, 3, 512, True), (3, 3, 513, True),
                    (6, 40, 41, True), (3, 30, 41, False), (300, 7, 41, True),
                    (300, 6, 21, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T,U,ragged", WAVEFRONT_SHAPES)
@pytest.mark.parametrize("betas", [True, False])
def test_wavefront_kernel(dev, dtype, B, T, U, ragged, betas):
    acts, labels, il, ll = _problem(B, T, U, 6, seed=1, ragged=ragged, dtype=dtype, device=dev)
    if ragged and B >= 5:  # T_b = 1 and U_b = 1 beside the full lattice
        il[1], ll[2] = 1, 0
    p = prep.prepare(acts, labels, 0, False)
    got = kwave.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    torch.cuda.synchronize()
    want = lattice.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    # Every cell is written, NEG at invalid ones, in both versions.
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), dtype)


# The stripe kernel at the widths of tests/test_torch_wavefront_plan.py's
# emulation: U_b just before, on and just after a stripe's edge (f32 U =
# 513: 288 columns a stripe; 601: 320; f64 353: 192; 700: 352) and a
# cluster's (f32 4097: 3840 columns a cluster; 5000: 4096, two passes; f64
# 2817: 2560), with T_b = 1 and L_b = 0: B, T, U, input lengths, label
# lengths (U_b = label length + 1), dtype.
STRIPE_CASES = {
    "f32_U513": (4, 4, 513, [4, 1, 3, 4], [512, 286, 287, 288], torch.float32),
    "f32_U601": (5, 5, 601, [5, 3, 1, 5, 4], [600, 318, 319, 320, 0], torch.float32),
    "f32_U4097": (4, 3, 4097, [3, 1, 2, 3], [4096, 3838, 3839, 3840], torch.float32),
    "f32_U5000": (3, 8, 5000, [8, 2, 5], [4999, 4095, 4096], torch.float32),
    "f64_U353": (4, 4, 353, [4, 1, 3, 2], [352, 190, 191, 192], torch.float64),
    "f64_U700": (3, 4, 700, [4, 2, 1], [699, 351, 352], torch.float64),
    "f64_U2817": (4, 3, 2817, [3, 1, 2, 3], [2816, 2558, 2559, 2560], torch.float64),
}


@pytest.mark.parametrize("betas", [True, False])
@pytest.mark.parametrize("case", sorted(STRIPE_CASES))
def test_stripe_kernel(dev, case, betas):
    """The stripe kernel against the plain version, every cell; its launch
    counted under wavefront_stripe; two calls the same bits."""
    B, T, U, il, ll, dtype = STRIPE_CASES[case]
    acts, labels, _, _ = _problem(B, T, U, 6, seed=5, dtype=dtype, device=dev)
    il = torch.tensor(il, dtype=torch.int32, device=dev)
    ll = torch.tensor(ll, dtype=torch.int32, device=dev)
    p = prep.prepare(acts, labels, 0, False)
    K.reset_launches()
    got = kwave.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    again = kwave.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    torch.cuda.synchronize()
    assert K.launches["wavefront_stripe"] == 2 and K.launches["wavefront"] == 0
    want = lattice.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), dtype)
        assert torch.equal(getattr(got, name), getattr(again, name)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("U", [41, 301, 601, 700, 5000])
def test_wavefront_kernel_bit_equal_across_calls(dev, dtype, U):
    acts, labels, il, ll = _problem(6, 20, U, 6, seed=3, dtype=dtype, device=dev)
    p = prep.prepare(acts, labels, 0, False)
    first = kwave.forward_backward(p.lpb, p.lpe, il, ll)
    second = kwave.forward_backward(p.lpb, p.lpe, il, ll)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_wavefront_plan_matches_kernel(dev):
    """ops/cuda/wavefront.py::plan (the CPU tests' mirror) against the C
    plan, on this card's SM count and on an H100's."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        elt = torch.tensor([], dtype=dtype).element_size()
        for U in (1, 21, 31, 32, 33, 41, 255, 256, 257, 301, 321, 352, 353, 511, 512, 513, 601,
                  700, 1100, 2816, 2817, 4096, 4097, 5000, 40000):
            for B in (1, 16, 67, 128, 1000):
                for betas in (True, False):
                    for sms in (n_sm, 132):
                        for T in (1, 1500, 4_000_000, 5_000_000):
                            assert kwave.plan(B, T, U, elt, betas, sms) == \
                                kwave.kernel_plan(B, T, U, dtype, betas, sms), \
                                (dtype, T, U, B, betas, sms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wavefront_kernels_do_not_spill(dev, dtype):
    for U in (41, 2000):  # the band kernel, the stripe kernel
        regs, local = kwave.kernel_registers(U, dtype)
        assert local == 0 and regs <= 128, (U, regs, local)  # 512 threads a block


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wavefront_kernel_at_huge_u(dev, dtype):
    """No U refuses: U = 20000 is 40 (f32) or 57 (f64) stripes, five or
    eight passes of a cluster, each pass's edge column through device
    memory."""
    acts, labels, il, ll = _problem(2, 3, 20000, 4, seed=6, dtype=dtype, device=dev)
    ll[1] = 11000
    p = prep.prepare(acts, labels, 0, False)
    got = kwave.forward_backward(p.lpb, p.lpe, il, ll)
    torch.cuda.synchronize()
    want = lattice.forward_backward(p.lpb, p.lpe, il, ll)
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("sparse", [False, True])
def test_grad_kernel(dev, dtype, sparse):
    B, T, U, V = 3, 6, 4, 7
    acts, labels, il, ll = _problem(B, T, U, V, seed=2, dtype=dtype, device=dev)
    labels[1, 0] = 0  # a label equal to blank
    p = prep.prepare(acts, labels, 0, sparse)
    res = lattice.forward_backward(p.lpb, p.lpe, il, ll)
    scale = torch.linspace(0.5, 1.5, B, device=dev, dtype=res.alphas.dtype)
    fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward,
                                    il, ll, scale=scale, fastemit_lambda=0.1)
    labels_u = prep.label_rows(labels, U)
    K.reset_launches()
    if sparse:
        got = kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
        want = gradients.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
    else:
        got = kgrad.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype)
        want = gradients.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype)
    torch.cuda.synchronize()
    assert K.launches["grad_fields"] == 1 and K.launches["grad"] == 0
    assert got.dtype == dtype
    _ulp_close(got, want, dtype)


# Rows of V across the planner's switch from tiles to a warp a row
# (ops/cuda/rows.py::TILE_MAX_V), with rows starting off the 16-byte grid.
GRAD_VS = [1, 2, 7, 28, 31, 32, 33, 50, 64, 65, 127, 128, 129, 1000, 5000]


def _ulp_close(got, want, dtype):
    if dtype in (torch.bfloat16, torch.float16):
        # One f32 result rounded once to 16 bits in both versions: within one
        # ulp of each other (2^-8 relative for bf16, 2^-11 for f16).
        ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=ulp, atol=1e-6)
    else:
        _close(got, want, dtype)


def _lattice_problem(V, dtype, sparse, blank, dev, seed=11):
    """B·T·U = 585 rows (more than a tile of small V holds, and a multiple of
    no tile), T_b = 1 in utterance 1 and U_b = 1 in utterance 2, a label
    equal to blank, the delay penalty in lpe; the prep and the lattice are
    the plain versions."""
    B, T, U = 5, 13, 9
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=dtype, device=dev)
    if sparse:
        acts = torch.log_softmax(acts.float(), -1).to(dtype)
    labels = torch.tensor(rng.integers(0, V, (B, U - 1)), dtype=torch.int32, device=dev)
    labels[0, 0] = blank
    il = torch.tensor([13, 1, 9, 13, 6], dtype=torch.int32, device=dev)
    ll = torch.tensor([8, 3, 0, 5, 2], dtype=torch.int32, device=dev)
    p = prep.prepare(acts, labels, blank, sparse)
    lpe = prep.delay_shift(p.lpe, il, 0.05)
    res = lattice.forward_backward(p.lpb, lpe, il, ll)
    lat = (p.lpb, lpe, res.alphas, res.betas, res.ll_forward, prep.label_rows(labels, U), il, ll)
    return acts, p.denom, lat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("V", GRAD_VS)
@pytest.mark.parametrize("sparse", [False, True])
def test_grad_lattice_kernel(dev, V, dtype, sparse):
    """The lattice mode (``grad_wrt_acts`` / ``grad_wrt_log_probs``) against
    the plain versions, blank first and last, with a cotangent scale (once
    as a stride-0 expanded tensor) and FastEmit."""
    for blank in sorted({0, V - 1}):
        acts, denom, lat = _lattice_problem(V, dtype, sparse, blank, dev)
        cdtype = lat[2].dtype
        B = acts.shape[0]
        scale = (torch.linspace(0.5, 1.5, B, device=dev, dtype=cdtype) if blank == 0
                 else torch.tensor(1.5, device=dev, dtype=cdtype).expand(B))
        K.reset_launches()
        if sparse:
            got = kgrad.grad_wrt_log_probs(*lat, blank, V, dtype, scale, 0.1)
            want = gradients.grad_wrt_log_probs(*lat, blank, V, dtype, scale, 0.1)
        else:
            got = kgrad.grad_wrt_acts(acts, denom, *lat, blank, dtype, scale, 0.1)
            want = gradients.grad_wrt_acts(acts, denom, *lat, blank, dtype, scale, 0.1)
        torch.cuda.synchronize()
        assert K.launches["grad"] == 1 and K.launches["grad_fields"] == 0
        assert got.dtype == dtype and got.shape == want.shape
        _ulp_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [28, 33, 1000])
def test_grad_kernels_unaligned_acts(dev, V, dtype):
    """Activations one element off the 16-byte grid: both modes fall back
    to one element a load and agree with the plain versions."""
    acts, denom, lat = _lattice_problem(V, dtype, False, 0, dev)
    buf = torch.empty(acts.numel() + 1, dtype=dtype, device=dev)
    shifted = buf[1:].view(acts.shape)
    shifted.copy_(acts)
    assert shifted.data_ptr() % 16
    got = kgrad.grad_wrt_acts(shifted, denom, *lat, 0, dtype)
    _ulp_close(got, gradients.grad_wrt_acts(acts, denom, *lat, 0, dtype), dtype)
    fields = gradients.coefficients(lat[0], lat[1], lat[2], lat[3], lat[4], lat[6], lat[7])
    args = (denom, fields, lat[5], lat[6], lat[7], 0, dtype)
    _ulp_close(kgrad.dense_grad(shifted, *args), gradients.dense_grad(acts, *args), dtype)


def test_grad_lattice_rejects_bad_input(dev):
    acts, denom, lat = _lattice_problem(7, torch.float32, False, 0, dev)
    with pytest.raises(ValueError, match="outside"):
        kgrad.grad_wrt_acts(acts, denom, *lat, 7)
    with pytest.raises(ValueError, match="writes acts' dtype"):
        kgrad.grad_wrt_acts(acts, denom, *lat, 0, torch.float64)
    with pytest.raises(ValueError, match="scale"):
        kgrad.grad_wrt_acts(acts, denom, *lat, 0, None, torch.ones(3, device=dev))


def test_main_path_launches_each_kernel(dev):
    acts, labels, il, ll = _problem(4, 9, 6, 28, seed=3, device=dev)
    acts.requires_grad_(True)
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # the main path never waits on the card
    try:
        loss = rnnt_loss(acts, labels, il, ll, reduction="sum")
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert K.launches == dict.fromkeys(K.launches, 0) | {"prep": 1, "wavefront": 1, "grad": 1}
    K.reset_launches()
    costs_t, grads_t = rnnt_loss_and_grad(acts.detach(), labels, il, ll, implementation="torch")
    assert K.launches == dict.fromkeys(K.launches, 0)
    _close(loss.detach(), costs_t.sum())
    torch.testing.assert_close(acts.grad, grads_t, rtol=1e-5, atol=1e-6)


def test_small_test_on_card(dev):
    acts = torch.tensor(G.SMALL_ACTS, dtype=torch.float32, device=dev)
    args = [torch.tensor(x, device=dev) for x in
            (G.SMALL_LABELS, G.SMALL_INPUT_LENGTHS, G.SMALL_LABEL_LENGTHS)]
    costs, grads = rnnt_loss_and_grad(acts, *args, implementation="cuda")
    np.testing.assert_allclose(costs.cpu().numpy(), [G.SMALL_COST], rtol=1e-5)
    np.testing.assert_allclose(grads.cpu().numpy(), G.SMALL_GRADS_ACTS, atol=1e-5)
    np.testing.assert_allclose(rnnt_score(acts, *args).cpu().numpy(), [G.SMALL_COST], rtol=1e-5)
