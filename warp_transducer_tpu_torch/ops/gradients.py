"""Analytic RNN-T gradients, plain PyTorch.

Two conventions, matching the reference's two backends:

* ``grad_wrt_acts`` — dense gradient w.r.t. raw activations with the
  log-softmax fused into the loss (the reference GPU convention,
  ``compute_grad_kernel``; closed form in ``docs/rnnt_math.md``).
* ``grad_wrt_log_probs`` — sparse gradient w.r.t. log-softmaxed inputs,
  non-zero only at blank/label entries (the reference CPU convention,
  ``cpu_rnnt.h:253-267``).

Here both split into small (B, T, U) coefficient fields (``coefficients``,
plain torch ops on the lattice outputs) and one pass over (B, T, U, V)
(``dense_grad`` / ``sparse_grad``). On a CUDA tensor ``csrc/grad.cu`` runs
them (``ops/cuda/grad.py``): ``grad_wrt_acts`` and ``grad_wrt_log_probs`` in
its lattice mode, which computes the coefficients row by row inside the one
pass, and ``dense_grad`` / ``sparse_grad`` in its fields mode, for callers
whose coefficients are not the standard ones (the multi-blank and TDT
losses; the sparse mode with its big-blank columns is the multi-blank loss
on log-probs).
Counterpart of ``warp_transducer_tpu/ops/gradients.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .prep import NEG, check_extra_cols


def _iotas(B, T, U, input_lengths, label_lengths, device):
    Tb = input_lengths.to(device=device, dtype=torch.int64)[:, None, None]
    Ub = label_lengths.to(device=device, dtype=torch.int64)[:, None, None] + 1
    t = torch.arange(T, device=device)[None, :, None]
    u = torch.arange(U, device=device)[None, None, :]
    return Tb, Ub, t, u


def _beta_shifts(betas, input_lengths, label_lengths):
    """The two shifted beta terms used by both conventions, (B, T, U):
      bshift_t[t,u] = betas[t+1,u] for t < T_b-1, 0 at the terminal cell
                      (T_b-1, U_b-1), NEG elsewhere (no blank transition);
      bshift_u[t,u] = betas[t,u+1] for u < U_b-1, else NEG.
    """
    B, T, U = betas.shape
    Tb, Ub, t, u = _iotas(B, T, U, input_lengths, label_lengths, betas.device)
    neg = torch.full((), NEG, dtype=betas.dtype, device=betas.device)
    pad = torch.nn.functional.pad
    bshift_t = torch.where(t < Tb - 1, pad(betas[:, 1:, :], (0, 0, 0, 1), value=NEG), neg)
    terminal = (t == Tb - 1) & (u == Ub - 1)
    bshift_t = torch.where(terminal, torch.zeros_like(bshift_t), bshift_t)
    bshift_u = torch.where(u < Ub - 1, pad(betas[:, :, 1:], (0, 1), value=NEG), neg)
    return bshift_t, bshift_u


def _valid_cells(shape, input_lengths, label_lengths, device):
    B, T, U = shape
    Tb, Ub, t, u = _iotas(B, T, U, input_lengths, label_lengths, device)
    return (t < Tb) & (u < Ub)


class Coefficients(NamedTuple):
    coef: torch.Tensor  # (B, T, U) weight of softmax(v) (dense) — unused sparse
    cb: torch.Tensor  # (B, T, U) blank-arc posterior
    ce: torch.Tensor  # (B, T, U) emit-arc posterior


def coefficients(lpb, lpe, alphas, betas, ll, input_lengths, label_lengths,
                 scale=None, fastemit_lambda=0.0) -> Coefficients:
    """The (B, T, U) fields of the gradient, zero at invalid cells:
    coef = exp(a+b-ll), cb = exp(a+lpb-ll+bshift_t),
    ce = exp(a+lpe-ll+bshift_u). ``scale`` ((B,) or None) folds an upstream
    cotangent in so the big pass needs no extra multiply. FastEmit
    (arXiv:2010.11148) scales ce by (1 + λ) and adds λ·ce to coef, which
    is exactly cb + ce."""
    bshift_t, bshift_u = _beta_shifts(betas, input_lengths, label_lengths)
    valid = _valid_cells(alphas.shape, input_lengths, label_lengths, alphas.device)
    zero = torch.zeros((), dtype=alphas.dtype, device=alphas.device)
    a_ll = alphas - ll[:, None, None]
    coef = torch.where(valid, torch.exp(a_ll + betas), zero)
    cb = torch.where(valid, torch.exp(a_ll + lpb + bshift_t), zero)
    ce = torch.where(valid, torch.exp(a_ll + lpe + bshift_u), zero)
    if fastemit_lambda:
        coef = coef + fastemit_lambda * ce
        ce = ce * (1.0 + fastemit_lambda)
    if scale is not None:
        s = scale.to(alphas.dtype)[:, None, None]
        coef, cb, ce = coef * s, cb * s, ce * s
    return Coefficients(coef.contiguous(), cb.contiguous(), ce.contiguous())


def dense_grad(acts, denom, fields: Coefficients, labels_u, input_lengths,
               label_lengths, blank, out_dtype, extra_cols=(), extra_fields=None):
    """The (B, T, U, V) pass of the dense convention (plain version of
    ``csrc/grad.cu``): g = coef·exp(x+denom) − cb·[v=blank] − ce·[v=y_u]
    − Σ_k extra_fields[..., k]·[v=extra_cols[k]], zero in invalid rows;
    every subtraction whose column matches applies. ``extra_fields``:
    (B, T, U, K) posteriors of K further arcs (the big blanks), or None."""
    B, T, U, V = acts.shape
    cols = check_extra_cols(extra_cols, V)
    if cols and (extra_fields is None or extra_fields.shape != (B, T, U, len(cols))):
        raise ValueError(f"extra_fields must be (B, T, U, {len(cols)}) for extra_cols {cols}")
    dtype = fields.coef.dtype
    v = torch.arange(V, device=acts.device)
    is_blank = (v == blank)[None, None, None, :]
    is_label = v[None, None, None, :] == labels_u.to(torch.int64)[:, None, :, None]
    valid = _valid_cells((B, T, U), input_lengths, label_lengths, acts.device)
    zero = torch.zeros((), dtype=dtype, device=acts.device)
    g = fields.coef[..., None] * torch.exp(acts.to(dtype) + denom[..., None])
    g = g - torch.where(is_blank, fields.cb[..., None], zero)
    g = g - torch.where(is_label, fields.ce[..., None], zero)
    for k, col in enumerate(cols):
        g = g - torch.where((v == col)[None, None, None, :], extra_fields[..., k, None], zero)
    g = torch.where(valid[..., None], g, zero)
    return g.to(out_dtype)


def sparse_grad(fields: Coefficients, labels_u, input_lengths, label_lengths,
                blank, shape_v, out_dtype, extra_cols=(), extra_fields=None):
    """The (B, T, U, V) pass of the sparse convention: −cb at blank,
    −extra_fields[..., k] at ``extra_cols[k]`` in valid rows, −ce at the
    label, zero elsewhere. The entries are written in the native engine's
    order (blank, the extra columns, the label; rnnt_cpu.cpp:529-533,
    cpu_rnnt.h:253-267), so a label equal to blank or to an extra column
    overwrites it."""
    B, T, U = fields.cb.shape
    cols = check_extra_cols(extra_cols, shape_v)
    if cols and (extra_fields is None or extra_fields.shape != (B, T, U, len(cols))):
        raise ValueError(f"extra_fields must be (B, T, U, {len(cols)}) for extra_cols {cols}")
    dev = fields.cb.device
    Tb, Ub, t, u = _iotas(B, T, U, input_lengths, label_lengths, dev)
    has_label = (t < Tb) & (u < Ub - 1)
    v = torch.arange(shape_v, device=dev)
    is_blank = (v == blank)[None, None, None, :]
    is_label = ((v[None, None, None, :] == labels_u.to(torch.int64)[:, None, :, None])
                & has_label[..., None])
    zero = torch.zeros((), dtype=fields.cb.dtype, device=dev)
    g = torch.where(is_blank, -fields.cb[..., None], zero)
    valid = ((t < Tb) & (u < Ub))[..., None]
    for k, col in enumerate(cols):
        g = torch.where((v == col)[None, None, None, :] & valid, -extra_fields[..., k, None], g)
    g = torch.where(is_label, -fields.ce[..., None], g)
    return g.to(out_dtype)


def grad_wrt_acts(acts, denom, lpb, lpe, alphas, betas, ll, labels_u,
                  input_lengths, label_lengths, blank, out_dtype=None,
                  scale=None, fastemit_lambda=0.0):
    """Dense d(cost)/d(acts), cost = -ll, log-softmax fused:

    grad[b,t,u,v] = exp(a+b-ll) * p(v)
                  - [v == blank] * exp(a + lpb - ll + bshift_t)
                  - [v == y_u]   * exp(a + lpe - ll + bshift_u)
    """
    fields = coefficients(lpb, lpe, alphas, betas, ll, input_lengths,
                          label_lengths, scale, fastemit_lambda)
    return dense_grad(acts, denom, fields, labels_u, input_lengths,
                      label_lengths, blank, out_dtype or acts.dtype)


def grad_wrt_log_probs(lpb, lpe, alphas, betas, ll, labels_u, input_lengths,
                       label_lengths, blank, shape_v, out_dtype, scale=None,
                       fastemit_lambda=0.0):
    """Sparse d(cost)/d(log_probs): non-zero at blank and label entries
    only. ``scale`` and ``fastemit_lambda`` as in ``grad_wrt_acts``
    (FastEmit touches only the emit entries here)."""
    fields = coefficients(lpb, lpe, alphas, betas, ll, input_lengths,
                          label_lengths, scale, fastemit_lambda)
    return sparse_grad(fields, labels_u, input_lengths, label_lengths, blank,
                       shape_v, out_dtype)
