"""The "simple" RNN-T loss of the additive joiner, without the (B, T, U, V)
tensor.

For ``logit[b,t,u,v] = am[b,t,v] + lm[b,u,v]`` (the trivial joiner of
pruned-transducer training, Kuang et al., arXiv:2206.13236) every per-cell
quantity of the lattice factorises:

  logZ[t,u] = Ma[t] + Ml[u] + log( (e^{am-Ma}) · (e^{lm-Ml})ᵀ )[t,u]

so one matrix product replaces the O(T·U·V) reduction and the joint tensor
is never formed: O((T+U)·V + T·U) memory per utterance. The gradients
w.r.t. am and lm are the u- and t-marginals of the dense gradient, again
matrix products:

  d cost/d am[t,v] = A[t,v]·(W·Bm)[t,v] − [v=∅]·Σ_u cb − Σ_u ce·[v=y_u]
  d cost/d lm[u,v] = Bm[u,v]·(Wᵀ·A)[u,v] − [v=∅]·Σ_t cb − [v=y_u]·Σ_t ce

with W = coef / S and coef, cb, ce the dense loss's coefficient fields
(``gradients.coefficients``). The lattice is the dense loss's
(``csrc/wavefront.cu`` on a CUDA tensor). Counterpart of
``warp_transducer_tpu/ops/simple.py``; the label picks are gathers here
and the emit term of the gradient a scatter-add along V. Computes in f32
for every input type.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import band as _band
from . import gradients as _gradients
from . import prep as _prep
from .rnnt import _engine, _on_device, _reduce

# Floor of the normaliser product: it underflows only when am and lm rows
# are both peaked (> ~85 nats of range) on different labels.
_S_FLOOR = 1e-30
PRECISIONS = ("highest", "default")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """``"highest"``: IEEE f32 products; ``"default"``: TF32 allowed on the
    card (no effect on the CPU). The flag is restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        flags.allow_tf32 = old


class FactorisedInputs(NamedTuple):
    lpb: torch.Tensor  # (B, T, U) f32 blank log-probs
    lpe: torch.Tensor  # (B, T, U) f32 label log-probs, column U-1 NEG
    S: torch.Tensor  # (B, T, U) the normaliser product, logZ = Ma + Ml + log S


def _exp_rows(x32):
    """(row max, e^{x - max}) along V."""
    m = x32.amax(dim=-1)
    return m, torch.exp(x32 - m[..., None])


def _label_mask(labels_u, V):
    """Labels outside [0, V) select nothing, as a one-hot of them would."""
    ok = (labels_u >= 0) & (labels_u < V)
    return ok, torch.where(ok, labels_u, 0).long()


def _factorised_lattice_inputs(am, lm, labels_u, blank, precision) -> FactorisedInputs:
    """lpb, lpe and S of the additive joiner. labels_u: (B, U) from
    ``prep.label_rows``."""
    B, T, V = am.shape
    U = lm.shape[1]
    am32, lm32 = am.float(), lm.float()
    Ma, A = _exp_rows(am32)
    Ml, Bm = _exp_rows(lm32)
    with matmul_precision(precision):
        S = torch.clamp_min(torch.matmul(A, Bm.transpose(1, 2)), _S_FLOOR)
    logZ = Ma[:, :, None] + Ml[:, None, :] + torch.log(S)
    lpb = am32[..., blank][:, :, None] + lm32[..., blank][:, None, :] - logZ
    ok, idx = _label_mask(labels_u, V)
    am_y = torch.gather(am32, 2, idx[:, None, :].expand(B, T, U))
    lm_y = torch.gather(lm32, 2, idx[..., None])[..., 0]
    emit = torch.where(ok[:, None, :], am_y + lm_y[:, None, :], 0.0) - logZ
    last = torch.arange(U, device=am.device) == U - 1
    lpe = torch.where(last, _prep.NEG, emit)
    return FactorisedInputs(lpb.contiguous(), lpe.contiguous(), S)


class _SimpleCosts(torch.autograd.Function):
    """(B,) costs, and with ``prune_range`` the (B, T) band starts read from
    the same lattice. The backward is the closed form above."""

    @staticmethod
    def forward(ctx, am, lm, labels, input_lengths, label_lengths, blank, eng, precision,
                prune_range, fastemit_lambda, delay_penalty):
        labels_u = _prep.label_rows(labels, lm.shape[1])
        f = _factorised_lattice_inputs(am, lm, labels_u, blank, precision)
        lpe = f.lpe
        if delay_penalty:
            lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
        needs_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        res = eng.forward_backward(f.lpb, lpe, input_lengths, label_lengths,
                                   compute_betas=needs_grad or prune_range is not None)
        costs = (-res.ll_forward).to(am.dtype)
        if needs_grad:
            ctx.save_for_backward(am, lm, labels_u, input_lengths, label_lengths, f.lpb, lpe,
                                  f.S, res.alphas, res.betas, res.ll_forward)
            ctx.config = (blank, precision, fastemit_lambda)
        if prune_range is None:
            return costs
        best_u = _band.posterior_peaks(res.alphas, res.betas, res.ll_forward)
        ranges = eng.band_starts(best_u, input_lengths, label_lengths, prune_range)
        ctx.mark_non_differentiable(ranges)
        return costs, ranges

    @staticmethod
    def backward(ctx, g, *_ranges_grad):
        (am, lm, labels_u, input_lengths, label_lengths, lpb, lpe, S, alphas, betas,
         ll) = ctx.saved_tensors
        blank, precision, fastemit_lambda = ctx.config
        B, T, V = am.shape
        U = lm.shape[1]
        _, A = _exp_rows(am.float())
        _, Bm = _exp_rows(lm.float())
        fields = _gradients.coefficients(lpb, lpe, alphas, betas, ll, input_lengths,
                                         label_lengths, scale=g.float(),
                                         fastemit_lambda=fastemit_lambda)
        W = fields.coef / S
        with matmul_precision(precision):
            dam = A * torch.matmul(W, Bm)
            dlm = Bm * torch.matmul(W.transpose(1, 2), A)
        dam[..., blank] -= fields.cb.sum(dim=2)
        dlm[..., blank] -= fields.cb.sum(dim=1)
        ok, idx = _label_mask(labels_u, V)
        has_label = ok & (torch.arange(U, device=am.device) < label_lengths.long()[:, None])
        ce = torch.where(has_label[:, None, :], fields.ce, 0.0)
        # Σ_u ce·[v = y_u], then one subtraction, as the one-hot product.
        emit = torch.zeros_like(dam).scatter_add_(2, idx[:, None, :].expand(B, T, U), ce)
        dam = dam - emit
        dlm.scatter_add_(2, idx[..., None], -ce.sum(dim=1)[..., None])
        return (dam.to(am.dtype), dlm.to(lm.dtype)) + (None,) * 9


def _check_lengths(input_lengths, label_lengths, B):
    for name, arr in (("input_lengths", input_lengths), ("label_lengths", label_lengths)):
        if arr.dim() != 1 or arr.shape[0] != B:
            raise ValueError(f"{name} must be ({B},); got shape {tuple(arr.shape)}")


def rnnt_loss_simple(am, lm, labels, input_lengths, label_lengths, blank: int = 0,
                     reduction: str = "mean", implementation: str = "auto",
                     precision: str = "highest", prune_range: int | None = None,
                     fastemit_lambda: float = 0.0, delay_penalty: float = 0.0):
    """RNN-T loss of the additive joiner, without the (B, T, U, V) tensor.

    Args:
      am: (B, T, V) encoder ("acoustic model") logits.
      lm: (B, U, V) prediction-network ("language model") logits, U = L+1.
      labels, input_lengths, label_lengths, blank, reduction: as in
        ``rnnt_loss``.
      implementation: 'auto' | 'torch' | 'cuda' (``rnnt_loss``).
      precision: 'highest' (IEEE f32) or 'default' (TF32 allowed on the
        card) for the normaliser and gradient products.
      prune_range: when set, also return the (B, T) band starts of width
        ``prune_range`` (``rnnt_prune_ranges``) from the same lattice: the
        result is then ``(loss, ranges)``.
      fastemit_lambda: FastEmit λ (arXiv:2010.11148); changes the gradient
        only.
      delay_penalty: delay-penalized transducer λ (arXiv:2211.00490);
        changes the objective.

    Equals ``rnnt_loss(am[:, :, None] + lm[:, None], ...)``, with
    O((T+U)·V) memory instead of O(T·U·V). Differentiable w.r.t. am and lm.
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if am.dim() != 3 or lm.dim() != 3:
        raise ValueError(f"am must be (B, T, V) and lm (B, U, V); got {tuple(am.shape)}, "
                         f"{tuple(lm.shape)}")
    if am.shape[0] != lm.shape[0] or am.shape[2] != lm.shape[2]:
        raise ValueError(f"am/lm batch or vocab mismatch: {tuple(am.shape)} vs {tuple(lm.shape)}")
    if labels.dim() != 2 or labels.shape[1] < lm.shape[1] - 1:
        raise ValueError(f"labels must be (B, L) with L >= U-1 = {lm.shape[1] - 1}; "
                         f"got {tuple(labels.shape)}")
    _check_lengths(input_lengths, label_lengths, am.shape[0])
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if prune_range is not None and int(prune_range) < 2:
        raise ValueError(f"prune_range must be >= 2, got {prune_range}")
    eng = _engine(implementation, am)
    labels, input_lengths, label_lengths = _on_device(am, labels, input_lengths, label_lengths)
    out = _SimpleCosts.apply(am, lm, labels, input_lengths, label_lengths, int(blank), eng,
                             precision, None if prune_range is None else int(prune_range),
                             float(fastemit_lambda), float(delay_penalty))
    if prune_range is None:
        return _reduce(out, reduction)
    costs, ranges = out
    return _reduce(costs, reduction), ranges
