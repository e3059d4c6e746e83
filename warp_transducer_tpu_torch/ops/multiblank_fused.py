"""Multi-blank loss fused into the joint network: (B, T, U, V) never exists.

``rnnt_loss_multiblank_fused_joint(e, p, W, bias, labels, ...)`` computes
the same value as

    acts = tanh(e[:, :, None, :] + p[:, None, :, :]) @ W + bias
    rnnt_loss_multiblank(acts, labels, ...)

but the logits (and the (B, T, U, H) joint features) live only tile-wise,
forward and backward: the multi-blank twin of ``rnnt_loss_fused_joint``.
The forward's prep also caches the K big-blank columns, and the backward
subtracts K more coefficient fields at those columns
(``ops/multiblank.py::_mb_coefs``). Gradients flow to all four joint inputs.
Counterpart of ``warp_transducer_tpu/ops/multiblank_fused.py``.

Stages, each the kernel on a CUDA tensor and the plain version on a CPU
tensor (``implementation`` as in ``ops/rnnt.py``): the fused prep with the
K columns (``csrc/joint_prep.cu``), the σ shift, the pending-window lattice
(``csrc/window_stream.cu``), the coefficient fields (plain torch on every
device) and the fused gradient with the K fields (``csrc/joint_grad.cu``).
With K = 0 it equals ``rnnt_loss_fused_joint`` (plus σ a step, when given).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import gradients as _gradients
from . import prep as _prep
from . import window as _window
from .fused_joint import _check_joint_inputs
from .lattice import LatticeResult
from .multiblank import _mb_coefs, _resolve_indices
from .prep import NEG
from .rnnt import _engine, _on_device, _reduce


class _MultiblankFusedCosts(torch.autograd.Function):
    """(B,) costs; the backward forms the 3 + K coefficient fields with the
    upstream cotangent folded in and runs the fused gradient."""

    @staticmethod
    def forward(ctx, e, p, W, bias, labels, input_lengths, label_lengths, blank, durations,
                bb_indices, sigma, fastemit_lambda, delay_penalty, eng):
        prepped = eng.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank,
                                 extra_cols=bb_indices)
        lpb, lpe, lpB = prepped.lpb, prepped.lpe, prepped.extras
        if lpB is None:  # K = 0: the standard lattice through the same stages
            lpB = lpb.new_zeros(lpb.shape + (0,))
        if sigma:
            # NEG − σ rounds back to NEG; the clamp keeps the sentinel finite anyhow.
            lpb, lpe, lpB = lpb - sigma, torch.clamp_min(lpe - sigma, NEG), lpB - sigma
        if delay_penalty:
            lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
        needs_grad = any(ctx.needs_input_grad[:4])
        lat = eng.window_forward_backward(lpb, lpe, lpB, _window.multiblank_arcs(durations),
                                          input_lengths, label_lengths,
                                          compute_betas=needs_grad)
        if needs_grad:
            ctx.save_for_backward(e, p, W, bias, labels, input_lengths, label_lengths,
                                  prepped.denom, lpb, lpe, lpB, lat.alphas, lat.betas,
                                  lat.ll_forward)
            ctx.config = (eng, blank, durations, bb_indices, fastemit_lambda)
        return (-lat.ll_forward).to(e.dtype)

    @staticmethod
    def backward(ctx, g):
        (e, p, W, bias, labels, input_lengths, label_lengths, denom, lpb, lpe, lpB, alphas,
         betas, ll) = ctx.saved_tensors
        eng, blank, durations, bb_indices, fastemit_lambda = ctx.config
        coef, cb, ce, cBs = _mb_coefs(lpb, lpe, lpB, LatticeResult(alphas, betas, ll, ll),
                                      durations, input_lengths, label_lengths,
                                      scale=g.float(), fastemit_lambda=fastemit_lambda)
        fields = _gradients.Coefficients(coef.contiguous(), cb.contiguous(), ce.contiguous())
        grads = eng.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                               fields, blank,
                               extra=(bb_indices, torch.stack(cBs, dim=-1)) if cBs else None)
        return tuple(grads) + (None,) * 10


def rnnt_loss_multiblank_fused_joint(e, p, W, bias, labels, input_lengths, label_lengths,
                                     big_blank_durations: Sequence[int], blank: int = 0,
                                     big_blank_indices: Optional[Sequence[int]] = None,
                                     reduction: str = "mean", sigma: float = 0.0,
                                     fastemit_lambda: float = 0.0, delay_penalty: float = 0.0,
                                     implementation: str = "auto"):
    """Multi-blank transducer loss with the joint projection fused in.

    Equals ``rnnt_loss_multiblank(tanh(e ⊕ p) @ W + bias, ...)`` without
    ever holding the (B, T, U, V) logits, their gradient or the (B, T, U, H)
    joint features in device memory. Differentiable w.r.t. e, p, W and bias.
    Arguments as in ``rnnt_loss_fused_joint`` plus the multi-blank ones of
    ``rnnt_loss_multiblank`` (at most ``prep.MAX_EXTRA_COLS`` big blanks);
    ``implementation``: 'auto' | 'torch' | 'cuda' (``ops/rnnt.py``).
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    _check_joint_inputs(e, p, W, bias, labels)
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    durs, idx = _resolve_indices(W.shape[1], int(blank), big_blank_durations,
                                 big_blank_indices)
    eng = _engine(implementation, e)
    _prep.check_extra_cols(idx, W.shape[1])
    labels, input_lengths, label_lengths = _on_device(e, labels, input_lengths, label_lengths)
    costs = _MultiblankFusedCosts.apply(e, p, W, bias, labels, input_lengths, label_lengths,
                                        int(blank), durs, idx, float(sigma),
                                        float(fastemit_lambda), float(delay_penalty), eng)
    return _reduce(costs, reduction)
