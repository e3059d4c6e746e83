"""The multi-blank loss on log-probs on the card: the sparse fields mode of
csrc/grad.cu with K big-blank columns against ``gradients.sparse_grad``,
csrc/prep.cu in log-probs mode with two big-blank columns (−inf entries
among them) against ``prep.prepare``, and
``bindings/torch_binding.py::rnnt_loss_multiblank(from_log_probs=True)`` on
CUDA tensors against the same call on CPU tensors (the plain versions).

Every test here needs a CUDA device; without one each skips (the ``dev``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_multiblank_log_probs.py
--noconftest`` (tests/conftest.py imports JAX).

Tolerances: the sparse gradient and the log-probs prep do no arithmetic
(a negation, a selection, one rounding to the output type; the read of a
column, plus 0), so both are held bit-equal. End to end: f32 costs rtol /
atol 1e-5 and gradients rtol 1e-4 / atol 1e-6 (the window kernel adds in
another order than the plain lattice), f64 1e-10; the gradient exactly 0
at a −inf input.
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch.bindings import torch_binding as tb
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import gradients, lattice, prep
from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
from warp_transducer_tpu_torch.ops.cuda import prep as kprep

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-6)),
       torch.float64: (dict(rtol=1e-10, atol=1e-10), dict(rtol=1e-10, atol=1e-10))}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cols(K_cols, V):
    """K distinct columns off blank (0), spread over the row's ends."""
    return {1: (V - 1,), 2: (V - 2, V - 1),
            8: (V - 1, 3, 9, V - 2, 11, 2, V - 3, 1)}[K_cols]


def _log_probs(B, T, U, V, seed, dtype, device, cols=(), masked=0.25):
    """log_softmax of seeded activations, a big-blank column masked to −inf
    in ``masked`` of the utterances; labels off the big blanks; ragged
    lengths, utterance 0 full."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=torch.float64)
    lp = torch.log_softmax(x, -1)
    if cols:
        for b in range(0, B, max(1, round(1 / masked))):
            lp[b, :, :, cols[-1]] = -float("inf")
    allowed = np.array([v for v in range(1, V) if v not in cols])
    labels = allowed[rng.integers(0, len(allowed), (B, max(U - 1, 1)))]
    il = rng.integers(1, T + 1, B)
    ll = rng.integers(0, U, B)
    il[0], ll[0] = T, U - 1
    ints = [torch.tensor(v, dtype=torch.int32, device=device) for v in (labels, il, ll)]
    return [lp.to(dtype).to(device)] + ints


def _no_sync(fn):
    torch.cuda.set_sync_debug_mode("error")  # the main path never waits on the card
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("V", [28, 1003, 5000])  # the tile plan, then a warp a row
@pytest.mark.parametrize("K_cols", [1, 2, 8])
def test_sparse_grad_kernel_extra_cols(dev, K_cols, V, out_dtype):
    """Bit-equal to the plain version: blank, then the K columns, then the
    label, each over the last (a label on blank and one on an extra
    column); rows past the lengths 0."""
    B, T, U = 3, 6, 4
    cols = _cols(K_cols, V)
    cdtype = torch.float64 if out_dtype == torch.float64 else torch.float32
    lp, labels, il, ll = _log_probs(B, T, U, V, 3, cdtype, dev)
    labels[1, 0] = 0
    labels[0, 1] = cols[0]
    p = prep.prepare(lp, labels, 0, True)
    res = lattice.forward_backward(p.lpb, p.lpe, il, ll)
    fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll,
                                    fastemit_lambda=0.1)
    rng = np.random.default_rng(4)
    extra = torch.tensor(rng.random((B, T, U, K_cols)), dtype=cdtype, device=dev)
    args = (fields, prep.label_rows(labels, U), il, ll, 0, V, out_dtype)
    K.reset_launches()
    got = kgrad.sparse_grad(*args, extra_cols=cols, extra_fields=extra)
    torch.cuda.synchronize()
    assert K.launches["grad_fields"] == 1
    want = gradients.sparse_grad(*args, extra_cols=cols, extra_fields=extra)
    assert got.dtype == out_dtype and got.shape == (B, T, U, V)
    assert torch.equal(got, want)
    assert float(got[0, 0, 1, cols[0]]) == float(-fields.ce[0, 0, 1].to(out_dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("V", [28, 1003])
def test_prep_kernel_log_probs_extra_cols(dev, V, dtype):
    """Log-probs mode with two big-blank columns, −inf entries among them:
    every output bit-equal to the plain version, −inf kept as −inf."""
    cols = _cols(2, V)
    lp, labels, _, _ = _log_probs(4, 7, 5, V, 5, dtype, dev, cols=cols, masked=0.5)
    K.reset_launches()
    got = kprep.prepare(lp, labels, 0, True, extra_cols=cols)
    torch.cuda.synchronize()
    assert K.launches["prep"] == 1
    want = prep.prepare(lp, labels, 0, True, extra_cols=cols)
    assert got.denom is None and got.extras.shape == (4, 7, 5, 2)
    for name in ("lpb", "lpe", "extras"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool(torch.isneginf(got.extras[0, ..., 1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("V", [28, 1003])
def test_binding_log_probs_cuda_vs_cpu(dev, V, dtype):
    """The binding on CUDA tensors (no host sync; prep, the window lattice
    and the sparse fields mode, not the dense lattice) against the same
    call on CPU tensors, with a masked big blank, σ, FastEmit and the delay
    penalty; "none" and "mean"."""
    B, T, U = 8, 13, 9
    cols = _cols(2, V)
    lp, labels, il, ll = _log_probs(B, T, U, V, 7, dtype, dev, cols=cols)
    kw = dict(sigma=0.05, fastemit_lambda=0.1, delay_penalty=0.01, from_log_probs=True)
    cost_tol, grad_tol = TOL[dtype]
    for reduction in ("none", "mean"):
        def run(device):
            a = lp.detach().to(device).clone().requires_grad_(True)
            out = tb.rnnt_loss_multiblank(a, labels.to(device), il.to(device), ll.to(device),
                                          (2, 4), reduction=reduction, **kw)
            out.sum().backward()
            return out.detach(), a.grad

        K.reset_launches()
        costs, grads = _no_sync(lambda: run(dev))
        torch.cuda.synchronize()
        assert all(K.launches[k] == 1 for k in ("prep", "window_stream", "grad_fields"))
        assert K.launches["wavefront"] == 0 and K.launches["grad"] == 0
        costs_c, grads_c = run("cpu")
        assert grads.dtype == dtype and bool(torch.isfinite(grads).all())
        torch.testing.assert_close(costs.cpu(), costs_c, **cost_tol)
        torch.testing.assert_close(grads.cpu(), grads_c, **grad_tol)
        assert bool((grads[torch.isneginf(lp)] == 0).all())
