"""Token-and-Duration Transducer (TDT) loss (Xu et al., arXiv:2304.06795).

The joint network outputs two heads per lattice cell: token logits over V
and duration logits over a small duration set (e.g. ``(0, 1, 2, 3, 4)``).
Every emission carries a duration d: a token emission moves
(t, u) -> (t+d, u+1), a blank emission moves (t, u) -> (t+d, u).
Counterpart of ``warp_transducer_tpu/ops/tdt.py``.

Semantics (matched by the float64 oracle of the JAX package,
``utils/numpy_oracle_tdt.py``):

* token arcs may use d = 0 (the standard transducer's vertical moves);
  blank arcs require d >= 1 (no self-loop);
* interior arcs land on a frame (t + d <= T-1); the path ends with a blank
  arc consuming the remaining frames exactly (t + d == T at u = U-1);
* both heads are independently log-softmaxed (fused here, as in
  ``rnnt_loss``); ``sigma`` under-normalizes the token head only;
* an utterance whose frames no combination of durations consumes exactly
  is infeasible: its cost is the finite sentinel (about 1e30) and its
  gradients are zero.

Stages, each the kernel on a CUDA tensor and the plain version on a CPU
tensor (``implementation`` as in ``ops/rnnt.py``): the token head's prep
(``csrc/prep.cu``), the pending-window lattice with the arcs of
``window.tdt_arcs`` (``csrc/window_stream.cu``), and the token head's pass
over V (``csrc/grad.cu``). The duration head (D columns, any number of
them: the duration set has no cap) is plain torch on every device:
``torch.log_softmax`` going in, one elementwise (B, T, U, D) expression
coming out.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import gradients as _gradients
from . import prep as _prep
from . import window as _window
from .lattice import LatticeResult
from .prep import NEG
from .rnnt import _certify_inputs, _engine, _on_device, _reduce


def _check_durations(durations):
    durs = tuple(int(d) for d in durations)
    if not durs:
        raise ValueError("durations must be non-empty")
    if any(d < 0 for d in durs):
        raise ValueError(f"durations must be >= 0, got {durs}")
    if len(set(durs)) != len(durs):
        raise ValueError(f"durations must be distinct, got {durs}")
    if max(durs) < 1:
        raise ValueError(
            f"at least one duration must be >= 1 (blank arcs need it), "
            f"got {durs}")
    return durs


def _tdt_prep(eng, token_logits, duration_logits, labels, blank, sigma):
    """(lpb, lpe, lpd, denom): the σ-shifted token-head log-probs (B, T, U),
    the duration head's log-softmax (B, T, U, D) and the token head's
    unshifted denominator."""
    p = eng.prepare(token_logits, labels, blank, False)
    lpd = torch.log_softmax(duration_logits.to(p.lpb.dtype), dim=-1)
    if not sigma:
        return p.lpb, p.lpe, lpd, p.denom
    return p.lpb - sigma, torch.clamp_min(p.lpe - sigma, NEG), lpd, p.denom


def _tdt_shifts(betas, d, input_lengths, label_lengths):
    """(bs_blank, bs_tok) for duration d:
    bs_blank[t,u] = betas[t+d, u] (t+d < T_b), 0 on the terminal arc
    (t+d == T_b, u == U_b-1, d >= 1), NEG elsewhere (all NEG for d = 0:
    no blank self-loop);
    bs_tok[t,u]   = betas[t+d, u+1] (t+d < T_b and u+1 < U_b), else NEG."""
    B, T, U = betas.shape
    Tb, Ub, t, u = _gradients._iotas(B, T, U, input_lengths, label_lengths, betas.device)
    neg = torch.full((), NEG, dtype=betas.dtype, device=betas.device)
    pad = torch.nn.functional.pad
    if d < T:
        sh = pad(betas[:, d:, :], (0, 0, 0, d), value=NEG)
    else:
        sh = neg.expand(B, T, U)
    in_t = t + d < Tb
    bs_tok = torch.where(in_t & (u + 1 < Ub), pad(sh[:, :, 1:], (0, 1), value=NEG), neg)
    if d < 1:
        return neg.expand(B, T, U), bs_tok
    terminal = (t + d == Tb) & (u == Ub - 1)
    bs_blank = torch.where(terminal, torch.zeros_like(neg), torch.where(in_t, sh, neg))
    return bs_blank, bs_tok


def _tdt_coefs(lpb, lpe, lpd, lat, durations, input_lengths, label_lengths,
               scale=None, fastemit_lambda=0.0):
    """The cotangent-scaled coefficient fields of both heads' gradients:
    (coef, cb, ce, cb_js, ce_js) — all (B, T, U), per-duration lists for
    the duration head. coef = exp(α+β−ll) (+ λ·ce under FastEmit) is the
    shared occupation; cb/ce are the summed blank/token arc posteriors (ce
    not yet (1+λ)-scaled — the callers apply that where the token and
    duration selects consume it). An infeasible utterance (ll at the NEG
    sentinel) gets zero fields, by a select: its α − ll is meaningless."""
    alphas, betas, ll = lat.alphas, lat.betas, lat.ll_forward
    dtype = alphas.dtype
    valid = _gradients._valid_cells(alphas.shape, input_lengths, label_lengths, alphas.device)
    zero = torch.zeros((), dtype=dtype, device=alphas.device)
    a_ll = alphas - ll[:, None, None]

    cb_js, ce_js = [], []
    for j, d in enumerate(durations):
        bs_blank, bs_tok = _tdt_shifts(betas, d, input_lengths, label_lengths)
        cb_js.append(torch.where(valid, torch.exp(a_ll + lpb + lpd[..., j] + bs_blank), zero))
        ce_js.append(torch.where(valid, torch.exp(a_ll + lpe + lpd[..., j] + bs_tok), zero))
    cb = sum(cb_js[1:], cb_js[0])
    ce = sum(ce_js[1:], ce_js[0])
    coef = torch.where(valid, torch.exp(a_ll + betas), zero)
    if fastemit_lambda:
        coef = coef + fastemit_lambda * ce
    feasible = (ll > NEG / 2)[:, None, None]
    s = (torch.ones_like(ll) if scale is None else scale.to(dtype))[:, None, None]

    def scaled(x):
        return torch.where(feasible, x * s, zero)

    return (scaled(coef), scaled(cb), scaled(ce),
            [scaled(c) for c in cb_js], [scaled(c) for c in ce_js])


def _tdt_grads(eng, token_logits, duration_logits, denom, lpb, lpe, lpd, lat, labels,
               durations, input_lengths, label_lengths, blank, scale=None,
               fastemit_lambda=0.0):
    """Dense (d cost/d token_logits, d cost/d duration_logits), one pass
    per head: g_head = p_head · W − per-class arc posteriors (both heads
    share W = exp(α+β−ll); every arc carries one factor from each head)."""
    U = token_logits.shape[2]
    lam = float(fastemit_lambda)
    coef, cb, ce, cb_js, ce_js = _tdt_coefs(
        lpb, lpe, lpd, lat, durations, input_lengths, label_lengths,
        scale=scale, fastemit_lambda=fastemit_lambda)

    # token head: the pass over V
    ce_tok = (1.0 + lam) * ce if lam else ce
    fields = _gradients.Coefficients(coef.contiguous(), cb.contiguous(), ce_tok.contiguous())
    g_tok = eng.dense_grad(token_logits, denom, fields, _prep.label_rows(labels, U),
                           input_lengths, label_lengths, blank, token_logits.dtype)

    # duration head: D columns, elementwise
    arcs = torch.stack([cb_js[j] + (1.0 + lam) * ce_js[j] for j in range(len(durations))],
                       dim=-1)
    valid = _gradients._valid_cells(coef.shape, input_lengths, label_lengths, coef.device)
    g_dur = torch.where(valid[..., None], coef[..., None] * torch.exp(lpd) - arcs, 0.0)
    return g_tok, g_dur.to(duration_logits.dtype)


def _tdt_forward(eng, token_logits, duration_logits, labels, input_lengths, label_lengths,
                 blank, durations, sigma, delay_penalty, compute_betas=True):
    lpb, lpe, lpd, denom = _tdt_prep(eng, token_logits, duration_logits, labels, blank, sigma)
    if delay_penalty:
        lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
    lat = eng.window_forward_backward(lpb, lpe, lpd, _window.tdt_arcs(durations),
                                      input_lengths, label_lengths,
                                      compute_betas=compute_betas)
    return lpb, lpe, lpd, denom, lat


class _TDTCosts(torch.autograd.Function):
    """(B,) costs; the backward is the closed-form gradient of both heads
    with the upstream cotangent folded into the coefficients."""

    @staticmethod
    def forward(ctx, token_logits, duration_logits, labels, input_lengths, label_lengths,
                blank, durations, sigma, fastemit_lambda, delay_penalty, eng):
        needs_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        lpb, lpe, lpd, denom, lat = _tdt_forward(
            eng, token_logits, duration_logits, labels, input_lengths, label_lengths, blank,
            durations, sigma, delay_penalty, compute_betas=needs_grad)
        if needs_grad:
            ctx.save_for_backward(token_logits, duration_logits, lpb, lpe, lpd, denom,
                                  lat.alphas, lat.betas, lat.ll_forward, labels,
                                  input_lengths, label_lengths)
            ctx.config = (eng, blank, durations, fastemit_lambda)
        return (-lat.ll_forward).to(token_logits.dtype)

    @staticmethod
    def backward(ctx, g):
        (token_logits, duration_logits, lpb, lpe, lpd, denom, alphas, betas, ll, labels,
         input_lengths, label_lengths) = ctx.saved_tensors
        eng, blank, durations, fastemit_lambda = ctx.config
        lat = LatticeResult(alphas, betas, ll, ll)
        g_tok, g_dur = _tdt_grads(eng, token_logits, duration_logits, denom, lpb, lpe, lpd,
                                  lat, labels, durations, input_lengths, label_lengths, blank,
                                  scale=g.to(alphas.dtype), fastemit_lambda=fastemit_lambda)
        return (g_tok, g_dur) + (None,) * 9


def rnnt_loss_tdt(token_logits, duration_logits, labels, input_lengths, label_lengths,
                  durations: Sequence[int] = (0, 1, 2, 3, 4), blank: int = 0,
                  reduction: str = "mean", sigma: float = 0.0,
                  fastemit_lambda: float = 0.0, delay_penalty: float = 0.0,
                  implementation: str = "auto"):
    """Token-and-Duration Transducer loss (arXiv:2304.06795),
    differentiable w.r.t. both logits tensors.

    Args:
      token_logits: (B, T, U, V) contiguous raw token-head outputs
        (log-softmax fused).
      duration_logits: (B, T, U, D) raw duration-head outputs, column j for
        ``durations[j]`` (log-softmax fused, independent of the token head).
      labels / input_lengths / label_lengths / blank / reduction: as in
        ``rnnt_loss``.
      durations: the duration set. Token emissions may use any of them
        (including 0 = stay on the frame); blank emissions only d >= 1. The
        path ends with a blank consuming the remaining frames exactly, so
        the set should contain 1 unless every utterance's frame count is
        reachable without it.
      sigma: logit under-normalization on the token head (the TDT paper's
        training trick). 0 disables.
      fastemit_lambda / delay_penalty: latency regularizers, as in
        ``rnnt_loss`` (both act on the token-emit arcs).
      implementation: 'auto' | 'torch' | 'cuda' (``ops/rnnt.py``): the
        pending-window lattice is ``csrc/window_stream.cu`` on a CUDA
        tensor at every T, ``ops/window.py`` on a CPU tensor.

    Returns (B,) costs for reduction='none', a scalar otherwise.
    """
    if token_logits.dim() != 4 or duration_logits.dim() != 4:
        raise ValueError(
            f"token/duration logits must be 4-D; got {tuple(token_logits.shape)}, "
            f"{tuple(duration_logits.shape)}")
    if token_logits.shape[:3] != duration_logits.shape[:3]:
        raise ValueError(
            f"token and duration logits disagree on (B, T, U): "
            f"{tuple(token_logits.shape[:3])} vs {tuple(duration_logits.shape[:3])}")
    durs = _check_durations(durations)
    if duration_logits.shape[-1] != len(durs):
        raise ValueError(
            f"duration_logits last dim {duration_logits.shape[-1]} != "
            f"len(durations) = {len(durs)}")
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    _certify_inputs(token_logits, labels, input_lengths, label_lengths)
    if duration_logits.device != token_logits.device:
        raise ValueError(f"duration_logits is on {duration_logits.device}, token_logits on "
                         f"{token_logits.device}")
    eng = _engine(implementation, token_logits)
    labels, input_lengths, label_lengths = _on_device(token_logits, labels, input_lengths,
                                                      label_lengths)
    costs = _TDTCosts.apply(token_logits, duration_logits, labels, input_lengths,
                            label_lengths, int(blank), durs, float(sigma),
                            float(fastemit_lambda), float(delay_penalty), eng)
    return _reduce(costs, reduction)
