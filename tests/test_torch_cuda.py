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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T,U,ragged", [(4, 9, 6, True), (1, 9, 4, False), (2, 1, 3, True),
                                          (3, 7, 1, True), (2, 3, 1100, True)])
@pytest.mark.parametrize("betas", [True, False])
def test_wavefront_kernel(dev, dtype, B, T, U, ragged, betas):
    acts, labels, il, ll = _problem(B, T, U, 6, seed=1, ragged=ragged, dtype=dtype, device=dev)
    p = prep.prepare(acts, labels, 0, False)
    got = kwave.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    torch.cuda.synchronize()
    want = lattice.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
    # Every cell is written, NEG at invalid ones, in both versions.
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):
        _close(getattr(got, name), getattr(want, name), dtype)


def test_wavefront_kernel_rejects_huge_u(dev):
    lpb = torch.zeros((1, 2, 40000), device=dev)
    with pytest.raises(ValueError, match="limit"):
        kwave.forward_backward(lpb, lpb, torch.tensor([2]), torch.tensor([3]))


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
    if sparse:
        got = kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
        want = gradients.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
    else:
        got = kgrad.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype)
        want = gradients.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    if dtype in (torch.bfloat16, torch.float16):
        # One f32 result rounded once to 16 bits in both versions: within one
        # ulp of each other (2^-8 relative for bf16, 2^-11 for f16).
        ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=ulp, atol=1e-6)
    else:
        _close(got, want, dtype)


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
