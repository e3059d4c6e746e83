"""Multi-blank RNN-Transducer loss (Xu et al., arXiv:2211.03541).

Besides the standard blank (advance one frame), the vocabulary carries K
"big blank" symbols with durations m_k >= 2: emitting big blank k advances
t by m_k while keeping u, letting the model skip steady frames. This module
computes the exact multi-blank negative log-likelihood and its dense
gradient w.r.t. the raw joint activations (log-softmax fused, as
``rnnt_loss``). Counterpart of ``warp_transducer_tpu/ops/multiblank.py``.

Stages, each the kernel on a CUDA tensor and the plain version on a CPU
tensor (``implementation`` as in ``ops/rnnt.py``):

* prep with the K big-blank columns (``prep.prepare(extra_cols=...)``,
  ``csrc/prep.cu``), then the σ shift: every log-prob is lowered by
  ``sigma`` and ``denom`` stays unshifted (the gradient needs the true
  log-softmax denominator);
* the pending-window lattice (``ops/window.py``, ``csrc/window_stream.cu``)
  with the arcs of ``window.multiblank_arcs``;
* the (B, T, U) coefficient fields, plain torch on every device
  (``_mb_coefs``), and the pass over V with the K big-blank corrections
  (``gradients.dense_grad(extra_cols=...)``, ``csrc/grad.cu``).

On log-probs (``_multiblank_costs(log_probs_input=True)``, the way in of
``bindings/torch_binding.py::rnnt_loss_multiblank(from_log_probs=True)``,
the JAX package's native engine's mode, rnnt_cpu.cpp:408-575) the prep
reduces nothing: the inputs' own blank, label and big-blank columns are
shifted by −σ. The gradient is the sparse one w.r.t. the log-probs: −cb at
blank, −cB_k at each big-blank column, −ce at the label, written in that
order (``gradients.sparse_grad(extra_cols=...)``, the sparse fields mode of
``csrc/grad.cu``, which reads no input).

The loss is a ``torch.autograd.Function`` with the closed-form gradient:
autograd never runs through the recursion. With K = 0 it is ``rnnt_loss``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import gradients as _gradients
from . import prep as _prep
from . import window as _window
from .lattice import LatticeResult
from .prep import NEG
from .rnnt import _certify_inputs, _engine, _on_device, _reduce


def _resolve_indices(V, blank, durations, big_blank_indices):
    K = len(durations)
    durs = tuple(int(m) for m in durations)
    if any(m < 2 for m in durs):
        raise ValueError(f"big-blank durations must all be >= 2, got {durs}")
    if len(set(durs)) != K:
        raise ValueError(f"big-blank durations must be distinct, got {durs}")
    if big_blank_indices is None:
        idx = tuple(range(V - K, V))
    else:
        idx = tuple(int(i) for i in big_blank_indices)
    if len(idx) != K:
        raise ValueError(
            f"big_blank_indices has {len(idx)} entries for {K} durations")
    if len(set(idx)) != K or any(i < 0 or i >= V for i in idx) or blank in idx:
        raise ValueError(
            f"big_blank_indices must be distinct in-range and != blank; "
            f"got {idx} (blank={blank}, V={V})")
    return durs, idx


def _multiblank_prep(eng, acts, labels, blank, bb_indices, sigma, log_probs_input=False):
    """(lpb, lpe, lpB, denom): the σ-shifted blank, label and big-blank
    log-probs, (B, T, U) and (B, T, U, K), and the unshifted denominator
    (None on log-probs, where lp_v = acts_v − σ).

    lp_v = acts_v + denom − σ: the paper's logit under-normalization (σ > 0
    leaves per-cell mass < 1, so paths with fewer emissions, more big
    blanks, are penalized less)."""
    p = eng.prepare(acts, labels, blank, log_probs_input, extra_cols=bb_indices)
    if not sigma:
        return p.lpb, p.lpe, p.extras, p.denom
    # NEG − σ rounds back to NEG; the clamp keeps the sentinel finite anyhow.
    return (p.lpb - sigma, torch.clamp_min(p.lpe - sigma, NEG), p.extras - sigma, p.denom)


def _beta_shift_m(betas, m, input_lengths, label_lengths):
    """bshift_m[t, u] = betas[t+m, u] for t+m <= T_b-1; 0 on the terminal
    arc (t+m == T_b and u == U_b-1); NEG elsewhere."""
    B, T, U = betas.shape
    Tb, Ub, t, u = _gradients._iotas(B, T, U, input_lengths, label_lengths, betas.device)
    neg = torch.full((), NEG, dtype=betas.dtype, device=betas.device)
    if m < T:
        shifted = torch.nn.functional.pad(betas[:, m:, :], (0, 0, 0, m), value=NEG)
        shifted = torch.where(t + m < Tb, shifted, neg)
    else:
        shifted = neg.expand(B, T, U)
    terminal = (t + m == Tb) & (u == Ub - 1)
    return torch.where(terminal, torch.zeros_like(neg), shifted)


def _mb_coefs(lpb, lpe, lpB, lat, durations, input_lengths, label_lengths,
              scale=None, fastemit_lambda=0.0):
    """The cotangent-scaled coefficient fields (coef, cb, ce, cBs) of the
    multi-blank gradient, zero at invalid cells — ce already (1+λ)-scaled,
    coef carrying FastEmit's + λ·ce (``gradients.coefficients``); cBs is
    the list of the K big-blank arc posteriors, each (B, T, U)."""
    alphas, betas, ll = lat.alphas, lat.betas, lat.ll_forward
    coef, cb, ce = _gradients.coefficients(lpb, lpe, alphas, betas, ll, input_lengths,
                                           label_lengths, None, fastemit_lambda)
    valid = _gradients._valid_cells(alphas.shape, input_lengths, label_lengths, alphas.device)
    zero = torch.zeros((), dtype=alphas.dtype, device=alphas.device)
    a_ll = alphas - ll[:, None, None]
    cBs = []
    for k, m in enumerate(durations):
        sh = _beta_shift_m(betas, m, input_lengths, label_lengths)
        cBs.append(torch.where(valid, torch.exp(a_ll + lpB[..., k] + sh), zero))
    if scale is not None:
        s = scale.to(alphas.dtype)[:, None, None]
        coef, cb, ce = coef * s, cb * s, ce * s
        cBs = [c * s for c in cBs]
    return coef, cb, ce, cBs


def _mb_fields(lpb, lpe, lpB, lat, durations, input_lengths, label_lengths, scale,
               fastemit_lambda):
    """The gradient pass's inputs: the (B, T, U) fields of ``_mb_coefs`` and
    the (B, T, U, K) big-blank posteriors."""
    coef, cb, ce, cBs = _mb_coefs(lpb, lpe, lpB, lat, durations, input_lengths,
                                  label_lengths, scale=scale, fastemit_lambda=fastemit_lambda)
    fields = _gradients.Coefficients(coef.contiguous(), cb.contiguous(), ce.contiguous())
    extra = (torch.stack(cBs, dim=-1) if cBs
             else torch.zeros(cb.shape + (0,), dtype=cb.dtype, device=cb.device))
    return fields, extra


def _multiblank_grad(eng, acts, denom, lpb, lpe, lpB, lat, labels, durations, bb_indices,
                     input_lengths, label_lengths, blank, scale=None, fastemit_lambda=0.0):
    """Dense d(cost)/d(acts):
    g = p·W − [v==blank]·cb − [v==y_u]·ce − Σ_k [v==idx_k]·cB_k, with
    W = exp(α+β−ll), the sum of all outgoing-arc posteriors (σ is constant
    w.r.t. acts, so the softmax Jacobian is the standard one)."""
    fields, extra = _mb_fields(lpb, lpe, lpB, lat, durations, input_lengths, label_lengths,
                               scale, fastemit_lambda)
    return eng.dense_grad(acts, denom, fields, _prep.label_rows(labels, acts.shape[2]),
                          input_lengths, label_lengths, blank, acts.dtype, extra_cols=bb_indices,
                          extra_fields=extra)


def _multiblank_sparse_grad(eng, shape_v, out_dtype, lpb, lpe, lpB, lat, labels, durations,
                            bb_indices, input_lengths, label_lengths, blank, scale=None,
                            fastemit_lambda=0.0):
    """Sparse d(cost)/d(log_probs): −cb at blank, −cB_k at big-blank column
    k, −ce ((1+λ)-scaled) at the label, zero elsewhere."""
    fields, extra = _mb_fields(lpb, lpe, lpB, lat, durations, input_lengths, label_lengths,
                               scale, fastemit_lambda)
    return eng.sparse_grad(fields, _prep.label_rows(labels, lpb.shape[2]), input_lengths,
                           label_lengths, blank, shape_v, out_dtype, extra_cols=bb_indices,
                           extra_fields=extra)


def _mb_forward(eng, acts, labels, input_lengths, label_lengths, blank, durations,
                bb_indices, sigma, delay_penalty, compute_betas=True, log_probs_input=False):
    lpb, lpe, lpB, denom = _multiblank_prep(eng, acts, labels, blank, bb_indices, sigma,
                                            log_probs_input)
    if delay_penalty:
        lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
    lat = eng.window_forward_backward(lpb, lpe, lpB, _window.multiblank_arcs(durations),
                                      input_lengths, label_lengths,
                                      compute_betas=compute_betas)
    return lpb, lpe, lpB, denom, lat


class _MultiblankCosts(torch.autograd.Function):
    """(B,) costs; the backward is the closed-form gradient pass with the
    upstream cotangent folded into its coefficients: dense w.r.t. raw
    activations, or sparse w.r.t. log-probs (``log_probs_input``)."""

    @staticmethod
    def forward(ctx, acts, labels, input_lengths, label_lengths, blank, durations,
                bb_indices, sigma, fastemit_lambda, delay_penalty, log_probs_input, eng):
        needs_grad = ctx.needs_input_grad[0]
        lpb, lpe, lpB, denom, lat = _mb_forward(
            eng, acts, labels, input_lengths, label_lengths, blank, durations, bb_indices,
            sigma, delay_penalty, compute_betas=needs_grad, log_probs_input=log_probs_input)
        if needs_grad:
            # The sparse gradient reads no input: only its width and type.
            ctx.save_for_backward(None if log_probs_input else acts, lpb, lpe, lpB, denom,
                                  lat.alphas, lat.betas, lat.ll_forward, labels, input_lengths,
                                  label_lengths)
            ctx.config = (eng, blank, durations, bb_indices, fastemit_lambda, log_probs_input,
                          acts.shape[-1], acts.dtype)
        return (-lat.ll_forward).to(acts.dtype)

    @staticmethod
    def backward(ctx, g):
        (acts, lpb, lpe, lpB, denom, alphas, betas, ll, labels, input_lengths,
         label_lengths) = ctx.saved_tensors
        eng, blank, durations, bb_indices, fastemit_lambda, log_probs_input, V, dtype = ctx.config
        lat = LatticeResult(alphas, betas, ll, ll)
        args = (lpb, lpe, lpB, lat, labels, durations, bb_indices, input_lengths, label_lengths,
                blank)
        kw = dict(scale=g.to(alphas.dtype), fastemit_lambda=fastemit_lambda)
        if log_probs_input:
            d_acts = _multiblank_sparse_grad(eng, V, dtype, *args, **kw)
        else:
            d_acts = _multiblank_grad(eng, acts, denom, *args, **kw)
        return (d_acts,) + (None,) * 11


def rnnt_loss_multiblank(acts, labels, input_lengths, label_lengths,
                         big_blank_durations: Sequence[int], blank: int = 0,
                         big_blank_indices: Optional[Sequence[int]] = None,
                         reduction: str = "mean", sigma: float = 0.0,
                         fastemit_lambda: float = 0.0, delay_penalty: float = 0.0,
                         implementation: str = "auto"):
    """Multi-blank transducer loss (arXiv:2211.03541), differentiable
    w.r.t. ``acts``.

    Args:
      acts: (B, T, U, V) contiguous raw joint activations (log-softmax
        fused).
      labels / input_lengths / label_lengths / blank / reduction: as in
        ``rnnt_loss``. Labels must not use the big-blank vocab entries; the
        values are on the device and are not validated (that would be a
        host sync): a collision merges the emit and big-blank posteriors
        on that column, as a label equal to ``blank`` does.
      big_blank_durations: K distinct durations, each >= 2 — emitting big
        blank k advances t by m_k and keeps u. The path may also end on a
        big blank that consumes the remaining frames exactly.
      big_blank_indices: the K vocab indices of the big blanks, aligned
        with the durations. Default: the last K entries (V-K .. V-1).
      sigma: logit under-normalization (the paper's trick): every log-prob
        is shifted by -sigma, so paths with fewer emissions (more big
        blanks) are penalized less. 0 disables; the paper uses ~0.05.
      fastemit_lambda / delay_penalty: the latency regularizers, exactly
        as in ``rnnt_loss`` (FastEmit scales only the label-emit arc).
      implementation: 'auto' | 'torch' | 'cuda' (``ops/rnnt.py``). The
        duration arcs break the anti-diagonal wavefront's two-neighbour
        structure, so the lattice is the pending-window recursion over
        rows: ``csrc/window_stream.cu`` on a CUDA tensor at every T,
        ``ops/window.py`` on a CPU tensor.

    Returns (B,) costs for reduction='none', a scalar otherwise. With
    K = 0 this is ``rnnt_loss``.
    """
    return _multiblank_costs(acts, labels, input_lengths, label_lengths, big_blank_durations,
                             blank, big_blank_indices, reduction, sigma, fastemit_lambda,
                             delay_penalty, False, implementation)


def _multiblank_costs(acts, labels, input_lengths, label_lengths, big_blank_durations, blank,
                      big_blank_indices, reduction, sigma, fastemit_lambda, delay_penalty,
                      log_probs_input, implementation):
    """``rnnt_loss_multiblank``, also on log-probs (``log_probs_input``:
    ``acts`` already log-softmaxed, the gradient the sparse one w.r.t.
    them). The binding's way in; the public function keeps the JAX op's
    signature, which has no log-probs mode."""
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    durs, idx = _resolve_indices(acts.shape[-1], int(blank), big_blank_durations,
                                 big_blank_indices)
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    costs = _MultiblankCosts.apply(acts, labels, input_lengths, label_lengths, int(blank),
                                   durs, idx, float(sigma), float(fastemit_lambda),
                                   float(delay_penalty), bool(log_probs_input), eng)
    return _reduce(costs, reduction)
