"""The multi-blank loss on log-probs: ``bindings/torch_binding.py::
rnnt_loss_multiblank(..., from_log_probs=True)`` of warp_transducer_tpu_torch
on CPU tensors, against the float64 oracle
(``warp_transducer_tpu/utils/numpy_oracle_multiblank.py``) and, where its
C++ library is built, against the JAX package's binding, which computes this
mode on its native engine (``native/src/rnnt_cpu.cpp``, ``MultiblankLattice``).

The oracle takes the σ-shifted log-probs as they are and gives α, β and ll;
the expected sparse gradient is formed here from them, as the native engine
writes it: −cb at blank, then −cB_k at each big-blank column, then
−(1+λ)·ce at the label, each entry over the last. The port runs its plain
versions here (CPU tensors): the prep in log-probs mode, the window
lattice and ``gradients.sparse_grad`` with the big-blank columns, the twins
of csrc/prep.cu, csrc/window_stream.cu and csrc/grad.cu's sparse fields
mode (tests/test_torch_cuda_multiblank_log_probs.py holds those on a card).

Inputs are made with numpy from a seed. Tolerances: f64 costs rtol 1e-10
and gradients atol 1e-10 (rounding only); f32 inputs, against the oracle on
the same f32 values in f64, costs rtol 1e-5 / atol 1e-6 and gradients
rtol 1e-4 / atol 1e-5 (the lattice adds in f32 over T + U terms, and
exp(α + β − ll) turns that into a relative error of the gradient).
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu.bindings import native
from warp_transducer_tpu.bindings import torch_binding as jax_binding
from warp_transducer_tpu.utils.numpy_oracle_multiblank import multiblank_single
from warp_transducer_tpu_torch.bindings import torch_binding as tb
from warp_transducer_tpu_torch.ops import gradients as TG
from warp_transducer_tpu_torch.ops import prep as TP
import torch_threads  # noqa: F401  (one torch thread a process)

TOL = {torch.float64: (dict(rtol=1e-10, atol=0), dict(rtol=0, atol=1e-10)),
       torch.float32: (dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-5))}


def _problem(seed, B=3, T=9, L=4, V=9, K=2, blank=0, idx=None, normalised=True):
    """Log-probs (B, T, L+1, V) in f64, labels off the big blanks (and off
    blank), ragged lengths with utterance 0 full."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, L + 1, V)) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    if not normalised:  # a different constant a row: no longer a distribution
        lp = lp + rng.uniform(-1.5, 1.0, (B, T, L + 1, 1))
    idx = tuple(range(V - K, V)) if idx is None else idx
    allowed = np.array([v for v in range(V) if v != blank and v not in idx])
    labels = allowed[rng.integers(0, len(allowed), (B, L))].astype(np.int32)
    il = rng.integers(max(2, T - 4), T + 1, B).astype(np.int32)
    ll = rng.integers(0, L + 1, B).astype(np.int32)
    il[0], ll[0] = T, L
    return lp, labels, il, ll


def _expected(lp, labels, il, ll, durations, idx, blank=0, sigma=0.0, fastemit_lambda=0.0,
              delay_penalty=0.0):
    """(costs, sparse gradient) in f64 from the oracle's α, β and ll, written
    in the native engine's order (rnnt_cpu.cpp:513-537)."""
    B, T, U, V = lp.shape
    costs, grads = np.zeros(B), np.zeros((B, T, U, V))
    lam = fastemit_lambda
    for b in range(B):
        t_b, u_b = int(il[b]), int(ll[b]) + 1
        lab = labels[b, :u_b - 1].astype(np.int64)
        st = multiblank_single(lp[b, :t_b, :u_b] - sigma, lab, durations, idx, blank=blank,
                               delay_penalty=delay_penalty)
        a, beta, ll_b = st["alphas"], st["betas"], st["ll_fwd"]
        lpb, lpe, lpB = st["lpb"], st["lpe"], st["lpB"]
        costs[b] = -ll_b
        g = grads[b, :t_b, :u_b]
        with np.errstate(invalid="ignore", over="ignore"):
            cb = np.zeros((t_b, u_b))
            cb[:t_b - 1] = np.exp(a[:t_b - 1] + lpb[:t_b - 1] + beta[1:] - ll_b)
            cb[t_b - 1, u_b - 1] = np.exp(a[-1, -1] + lpb[-1, -1] - ll_b)
            g[..., blank] = -cb
            for k, m in enumerate(durations):
                cB = np.zeros((t_b, u_b))
                if m <= t_b - 1:
                    cB[:t_b - m] = np.exp(a[:t_b - m] + lpB[k, :t_b - m] + beta[m:] - ll_b)
                if m <= t_b:
                    cB[t_b - m, u_b - 1] += np.exp(a[t_b - m, -1] + lpB[k, t_b - m, -1] - ll_b)
                g[..., idx[k]] = -cB
            for u in range(u_b - 1):
                ce = np.exp(a[:, u] + lpe[:, u] + beta[:, u + 1] - ll_b)
                g[:, u, lab[u]] = -(1.0 + lam) * ce
    return costs, grads


def _binding(fn, lp, labels, il, ll, durations, dtype, reduction="none", **kw):
    """(costs, gradient of their sum) of a binding on CPU tensors."""
    a = torch.tensor(lp).to(dtype).requires_grad_(True)
    costs = fn(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durations,
               reduction=reduction, from_log_probs=True, **kw)
    costs.sum().backward()
    return costs.detach().double().numpy(), a.grad.double().numpy()


# name: (problem keywords, durations, loss keywords, an edit of the inputs)
CASES = {
    "k0": (dict(K=0), (), {}, None),
    "k1": (dict(K=1), (3,), {}, None),
    "k2": (dict(), (2, 4), {}, None),
    "k2_sigma": (dict(), (2, 4), dict(sigma=0.05), None),
    "k2_explicit_indices": (dict(idx=(2, 6)), (4, 2), dict(sigma=0.05, big_blank_indices=(2, 6)),
                            None),
    "blank_not_0": (dict(blank=4), (2, 4), dict(blank=4, sigma=0.05), None),
    "fastemit": (dict(), (2, 4), dict(fastemit_lambda=0.1), None),
    "delay_penalty": (dict(), (2, 4), dict(delay_penalty=0.01, sigma=0.05), None),
    # a label equal to blank: the label's entry is written over blank's
    "label_is_blank": (dict(), (2, 4), dict(fastemit_lambda=0.1), "label_is_blank"),
    # a masked big blank: a finite cost and a zero gradient there
    "masked_big_blank": (dict(), (2, 4), dict(sigma=0.05), "mask"),
    "unnormalised": (dict(normalised=False), (2, 4), dict(sigma=0.05), None),
    "v1003": (dict(V=1003, T=6, L=3), (2, 4), dict(sigma=0.05, fastemit_lambda=0.1), None),
}


def _case(name):
    pkw, durations, kw, edit = CASES[name]
    lp, labels, il, ll = _problem(7, **pkw)
    V = lp.shape[-1]
    idx = kw.get("big_blank_indices") or tuple(range(V - len(durations), V))
    if edit == "label_is_blank":
        labels[0, 0] = labels[2, 0] = kw.get("blank", 0)
    elif edit == "mask":
        lp[1, :, :, idx[1]] = -np.inf
        lp[0, 3:, :, idx[0]] = -np.inf
    return lp, labels, il, ll, durations, idx, kw


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_log_probs_matches_the_oracle(name, dtype):
    lp, labels, il, ll, durations, idx, kw = _case(name)
    lp = lp.astype(np.float32 if dtype == torch.float32 else np.float64)
    costs, grads = _binding(tb.rnnt_loss_multiblank, lp, labels, il, ll, durations, dtype, **kw)
    want_c, want_g = _expected(lp.astype(np.float64), labels, il, ll, durations, idx,
                               **{k: v for k, v in kw.items() if k != "big_blank_indices"})
    cost_tol, grad_tol = TOL[dtype]
    assert np.isfinite(costs).all() and np.isfinite(grads).all()
    np.testing.assert_allclose(costs, want_c, **cost_tol)
    np.testing.assert_allclose(grads, want_g, **grad_tol)
    if CASES[name][3] == "mask":
        assert (grads[np.isneginf(lp)] == 0).all()
    if native.available():
        got = _binding(jax_binding.rnnt_loss_multiblank, lp, labels, il, ll, durations, dtype,
                       **kw)
        np.testing.assert_allclose(costs, got[0], **cost_tol)
        np.testing.assert_allclose(grads, got[1], **grad_tol)


def _backward(out, weights):
    """Backward from a (1,) reduction, or from (B,) costs under weights."""
    if out.shape == (1,):
        out.backward()
    else:
        (out * torch.tensor(weights)).sum().backward()


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_log_probs_reductions(reduction):
    """Shape (1,) for "sum" / "mean", "mean" over B; the upstream cotangent
    scales the sparse gradient."""
    lp, labels, il, ll, durations, idx, kw = _case("k2_sigma")
    B = lp.shape[0]
    a = torch.tensor(lp, requires_grad=True)
    out = tb.rnnt_loss_multiblank(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                                  durations, reduction=reduction, from_log_probs=True, **kw)
    weights = np.linspace(0.5, 1.5, B)
    _backward(out, weights)
    want_c, want_g = _expected(lp, labels, il, ll, durations, idx, sigma=kw["sigma"])
    scale = {"none": weights, "sum": np.ones(B), "mean": np.full(B, 1.0 / B)}[reduction]
    if reduction == "none":
        assert out.shape == (B,)
        np.testing.assert_allclose(out.detach().numpy(), want_c, **TOL[torch.float64][0])
    else:
        assert out.shape == (1,)
        np.testing.assert_allclose(out.detach().numpy(), [want_c @ scale], **TOL[torch.float64][0])
    np.testing.assert_allclose(a.grad.numpy(), want_g * scale[:, None, None, None],
                               **TOL[torch.float64][1])
    if native.available():
        r = torch.tensor(lp, requires_grad=True)
        want = jax_binding.rnnt_loss_multiblank(
            r, torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durations,
            reduction=reduction, from_log_probs=True, **kw)
        _backward(want, weights)
        np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), rtol=1e-10)
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-10)


def test_k0_is_the_dense_loss_on_log_probs():
    """With no big blank the loss is ``rnnt_loss(from_log_probs=True)``,
    costs and sparse gradient, FastEmit and the delay penalty included."""
    lp, labels, il, ll = _problem(3, K=0)
    kw = dict(fastemit_lambda=0.1, delay_penalty=0.01)
    costs, grads = _binding(tb.rnnt_loss_multiblank, lp, labels, il, ll, (), torch.float64, **kw)
    a = torch.tensor(lp, requires_grad=True)
    want = tb.rnnt_loss(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                        reduction="none", from_log_probs=True, **kw)
    want.sum().backward()
    np.testing.assert_allclose(costs, want.detach().numpy(), rtol=1e-10)
    np.testing.assert_allclose(grads, a.grad.numpy(), atol=1e-10)


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_normalised_log_probs_cost_the_raw_route(sigma):
    """On log_softmax(x) the cost is that of the raw-activation route on x
    (the gradients differ: sparse w.r.t. log-probs, dense w.r.t. x)."""
    lp, labels, il, ll = _problem(5)
    x = lp * 1.0 + np.random.default_rng(5).uniform(-2, 2, lp.shape[:-1] + (1,))
    ints = [torch.tensor(v) for v in (labels, il, ll)]
    raw = tb.rnnt_loss_multiblank(torch.tensor(x), *ints, (2, 4), sigma=sigma, reduction="none")
    on_lp = tb.rnnt_loss_multiblank(torch.tensor(lp), *ints, (2, 4), sigma=sigma,
                                    reduction="none", from_log_probs=True)
    np.testing.assert_allclose(on_lp.numpy(), raw.numpy(), rtol=1e-10)


def _sparse_grad_before(fields, labels_u, input_lengths, label_lengths, blank, shape_v,
                        out_dtype):
    """``gradients.sparse_grad`` as it was before it took extra columns."""
    B, T, U = fields.cb.shape
    dev = fields.cb.device
    Tb, Ub, t, u = TG._iotas(B, T, U, input_lengths, label_lengths, dev)
    has_label = (t < Tb) & (u < Ub - 1)
    v = torch.arange(shape_v, device=dev)
    is_blank = (v == blank)[None, None, None, :]
    is_label = ((v[None, None, None, :] == labels_u.to(torch.int64)[:, None, :, None])
                & has_label[..., None])
    zero = torch.zeros((), dtype=fields.cb.dtype, device=dev)
    g = torch.where(is_blank, -fields.cb[..., None], zero)
    g = torch.where(is_label, -fields.ce[..., None], g)
    return g.to(out_dtype)


def _fields(seed, B=3, T=6, U=4, V=9, K=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.uniform(0.1, 1.0, s))  # noqa: E731
    fields = TG.Coefficients(f(B, T, U), f(B, T, U), f(B, T, U))
    labels = torch.tensor(rng.integers(0, V, (B, U - 1)), dtype=torch.int32)
    labels[0, 0] = 0  # a label equal to blank
    il, ll = torch.tensor([T, T - 2, 3], dtype=torch.int32), torch.tensor([U - 1, 1, 0],
                                                                           dtype=torch.int32)
    return fields, f(B, T, U, K), TP.label_rows(labels, U), il, ll


@pytest.mark.parametrize("out_dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_sparse_grad_k0_is_as_before(out_dtype):
    """No extra column: every bit as before, signs of zeros included (the
    fields are nonzero in invalid rows too)."""
    fields, _, labels_u, il, ll = _fields(11)
    got = TG.sparse_grad(fields, labels_u, il, ll, 0, 9, out_dtype)
    want = _sparse_grad_before(fields, labels_u, il, ll, 0, 9, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_sparse_grad_extra_columns_order():
    """Blank, then the extra columns, then the label, each over the last;
    the extra columns only in valid rows; where two extra columns coincide
    the later one is written."""
    fields, extra, labels_u, il, ll = _fields(12)
    B, T, U, K = extra.shape
    labels_u[1, 0] = 7  # a label on an extra column, inside utterance 1
    cols = (7, 0)  # the second extra column on blank
    g = TG.sparse_grad(fields, labels_u, il, ll, 0, 9, torch.float64, extra_cols=cols,
                       extra_fields=extra)
    Tb, Ub = il.long(), ll.long() + 1
    for b in range(B):
        for t in range(T):
            for u in range(U):
                row = g[b, t, u]
                if t >= Tb[b] or u >= Ub[b]:
                    assert torch.equal(row[1:], torch.zeros(8, dtype=row.dtype))
                    continue
                want = torch.zeros(9, dtype=torch.float64)
                want[0] = -fields.cb[b, t, u]
                want[7] = -extra[b, t, u, 0]
                want[0] = -extra[b, t, u, 1]
                if u < Ub[b] - 1:
                    want[int(labels_u[b, u])] = -fields.ce[b, t, u]
                assert torch.equal(row, want), (b, t, u)
    same = TG.sparse_grad(fields, labels_u, il, ll, 0, 9, torch.float64, extra_cols=(7, 7),
                          extra_fields=extra)
    assert torch.equal(same[0, 0, U - 1, 7], -extra[0, 0, U - 1, 1])  # a row with no label
    with pytest.raises(ValueError, match="extra_fields"):
        TG.sparse_grad(fields, labels_u, il, ll, 0, 9, torch.float64, extra_cols=(7,),
                       extra_fields=extra)


@pytest.mark.parametrize("from_log_probs", [False, True])
@pytest.mark.parametrize("indices", [None, (2, 6)])
def test_label_on_a_big_blank_raises_on_cpu(from_log_probs, indices):
    """A valid label on a big-blank column raises the JAX binding's
    ValueError in both modes; the same value past the label length does
    not."""
    lp, labels, il, ll = _problem(9, idx=indices)
    L, V = labels.shape[1], lp.shape[-1]
    ll[2] = 1
    col = (V - 1) if indices is None else indices[1]
    ints = lambda lab: (torch.tensor(lab), torch.tensor(il), torch.tensor(ll))  # noqa: E731
    kw = dict(big_blank_indices=indices, from_log_probs=from_log_probs)
    bad = labels.copy()
    bad[0, L - 1] = col  # the last label of the full utterance
    with pytest.raises(ValueError, match="big-blank"):
        tb.rnnt_loss_multiblank(torch.tensor(lp), *ints(bad), (2, 4), **kw)
    padded = labels.copy()
    padded[2, 1:] = col  # past utterance 2's one label
    out = tb.rnnt_loss_multiblank(torch.tensor(lp), *ints(padded), (2, 4), **kw)
    assert bool(torch.isfinite(out).all())
