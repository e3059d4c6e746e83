"""The ``warprnnt_pytorch`` surface, on CPU and CUDA tensors.

Counterpart of ``warp_transducer_tpu/bindings/torch_binding.py``, a drop-in
for the reference's ``warprnnt_pytorch``: a functional ``rnnt_loss`` and a
module ``RNNTLoss``, and the eight other loss families under the JAX
module's names and argument names. Each is a thin call into the port's
entry point; the tensor's device picks the route, as in the reference's
binding: a CUDA tensor runs the port's CUDA kernels, a CPU tensor their
plain PyTorch versions. There is no ``backend=`` argument.

The binding's own conventions, which differ from the port's entry points:
* ``reduction="sum"`` / ``"mean"`` returns shape (1,), not a scalar;
  ``"mean"`` divides the sum by the batch size B;
* ``rnnt_loss``, ``rnnt_loss_multiblank`` and ``rnnt_loss_tdt`` certify
  their inputs as the reference does: acts 4-D and contiguous, labels 2-D,
  labels and lengths int32 (``ValueError`` / ``TypeError``);
* the fused families take ``reduction="sum"`` or ``"mean"`` only;
* the log-softmax is fused (gradients are w.r.t. raw activations) unless
  ``from_log_probs=True``.

One departure from the JAX module, deliberate: CUDA tensors are taken (the
JAX module raises on them). ``rnnt_loss_multiblank`` refuses labels that
use a big-blank column with the JAX module's ``ValueError`` on CPU tensors
only: on a CUDA tensor the check would wait for the card.
"""
from __future__ import annotations

import torch

from ..ops.fused_joint import rnnt_loss_fused_joint as _fused_joint
from ..ops.multiblank import _multiblank_costs
from ..ops.multiblank_fused import rnnt_loss_multiblank_fused_joint as _multiblank_fused
from ..ops.pruned import rnnt_loss_pruned as _pruned
from ..ops.pruned_fused import rnnt_loss_pruned_fused as _pruned_fused
from ..ops.rnnt import rnnt_loss as _rnnt_loss
from ..ops.simple import rnnt_loss_simple as _simple
from ..ops.tdt import rnnt_loss_tdt as _tdt
from ..ops.tdt_fused import rnnt_loss_tdt_fused_joint as _tdt_fused


def _certify(acts, labels, act_lens, label_lens):
    if acts.dim() != 4:
        raise ValueError("acts must be 4-D (B, T, U, V)")
    if labels.dim() != 2:
        raise ValueError("labels must be 2-D (B, L)")
    for name, t in (("labels", labels), ("act_lens", act_lens), ("label_lens", label_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    if not acts.is_contiguous():
        raise ValueError("acts must be contiguous")


def _check_reduction(reduction, fused=False):
    allowed = ("sum", "mean") if fused else ("none", "sum", "mean")
    if reduction not in allowed:
        raise ValueError(f"reduction must be {'|'.join(allowed)}, got {reduction!r}")


def _reduce(costs, reduction, B):
    """(B,) costs for "none"; their sum, or the sum over B, as shape (1,)."""
    if reduction == "none":
        return costs
    total = costs.sum().unsqueeze(-1)
    return total / B if reduction == "mean" else total


def rnnt_loss(acts, labels, act_lens, label_lens, blank=0, reduction="mean",
              from_log_probs=False, fastemit_lambda=0.0, delay_penalty=0.0):
    """Functional RNN-T loss: acts (B, T, U, V) raw activations (log-probs
    with ``from_log_probs``), labels (B, L) and the lengths int32.
    ``fastemit_lambda`` scales the emit-arc gradient by (1 + λ) (FastEmit,
    arXiv:2010.11148); ``delay_penalty`` (arXiv:2211.00490) changes the
    objective."""
    _check_reduction(reduction)
    _certify(acts, labels, act_lens, label_lens)
    costs = _rnnt_loss(acts, labels, act_lens, label_lens, blank=blank, reduction="none",
                       log_probs_input=from_log_probs, fastemit_lambda=fastemit_lambda,
                       delay_penalty=delay_penalty)
    return _reduce(costs, reduction, acts.size(0))


class RNNTLoss(torch.nn.Module):
    """Module form of ``rnnt_loss``."""

    def __init__(self, blank=0, reduction="mean", from_log_probs=False, fastemit_lambda=0.0,
                 delay_penalty=0.0):
        super().__init__()
        self.blank = blank
        self.reduction = reduction
        self.from_log_probs = from_log_probs
        self.fastemit_lambda = fastemit_lambda
        self.delay_penalty = delay_penalty

    def forward(self, acts, labels, act_lens, label_lens):
        return rnnt_loss(acts, labels, act_lens, label_lens, blank=self.blank,
                         reduction=self.reduction, from_log_probs=self.from_log_probs,
                         fastemit_lambda=self.fastemit_lambda, delay_penalty=self.delay_penalty)


def rnnt_loss_simple(am, lm, labels, act_lens, label_lens, blank=0, reduction="mean",
                     fastemit_lambda=0.0, delay_penalty=0.0):
    """Factorised additive-joiner loss: am (B, T, V) + lm (B, U, V), without
    the (B, T, U, V) tensor."""
    _check_reduction(reduction)
    costs = _simple(am, lm, labels, act_lens, label_lens, blank=blank, reduction="none",
                    fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty)
    return _reduce(costs, reduction, am.size(0))


def rnnt_loss_fused_joint(e, p, W, bias, labels, act_lens, label_lens, blank=0,
                          reduction="mean", fastemit_lambda=0.0, delay_penalty=0.0):
    """Joint-fused loss: e (B, T, H) and p (B, U, H) projected trunk
    activations, W (H, V) and bias (V,) the output projection; the
    (B, T, U, V) logits are never formed. Differentiable w.r.t. all four.
    ``reduction`` "sum" or "mean" only, as the JAX module's."""
    _check_reduction(reduction, fused=True)
    costs = _fused_joint(e, p, W, bias, labels, act_lens, label_lens, blank=blank,
                         reduction="none", fastemit_lambda=fastemit_lambda,
                         delay_penalty=delay_penalty)
    return _reduce(costs, reduction, e.size(0))


def rnnt_loss_pruned(acts, ranges, labels, act_lens, label_lens, blank=0, reduction="mean",
                     fastemit_lambda=0.0, delay_penalty=0.0):
    """Banded (pruned) loss: acts (B, T, S, V) on the band, ranges (B, T) the
    band starts."""
    _check_reduction(reduction)
    costs = _pruned(acts, ranges, labels, act_lens, label_lens, blank=blank, reduction="none",
                    fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty)
    return _reduce(costs, reduction, acts.size(0))


def rnnt_loss_pruned_fused(e, p, W, bias, ranges, labels, act_lens, label_lens, s_range,
                           blank=0, reduction="mean", fastemit_lambda=0.0, delay_penalty=0.0):
    """Pruned fused joint+loss; differentiable w.r.t. e, p, W and bias.
    ``reduction`` "sum" or "mean" only."""
    _check_reduction(reduction, fused=True)
    costs = _pruned_fused(e, p, W, bias, ranges, labels, act_lens, label_lens, s_range,
                          blank=blank, reduction="none", fastemit_lambda=fastemit_lambda,
                          delay_penalty=delay_penalty)
    return _reduce(costs, reduction, e.size(0))


def _check_big_blank_labels(acts, labels, label_lens, big_blank_durations, big_blank_indices):
    """The JAX module's ``ValueError`` where a valid label uses a big-blank
    column (the emit and big-blank posteriors would merge there)."""
    K, U = len(big_blank_durations), acts.shape[2]
    if not K:
        return
    V = acts.shape[-1]
    idx = range(V - K, V) if big_blank_indices is None else big_blank_indices
    lab = labels[:, :U - 1].long().cpu()
    pos = torch.arange(lab.shape[1])[None, :] < label_lens.long().cpu()[:, None]
    used = torch.isin(lab[pos], torch.tensor([int(i) for i in idx], dtype=torch.int64))
    if bool(used.any()):
        raise ValueError(f"labels use big-blank vocab entries {sorted(int(i) for i in idx)}")


def rnnt_loss_multiblank(acts, labels, act_lens, label_lens, big_blank_durations, blank=0,
                         big_blank_indices=None, sigma=0.0, reduction="mean",
                         from_log_probs=False, fastemit_lambda=0.0, delay_penalty=0.0):
    """Multi-blank transducer loss (arXiv:2211.03541): big blanks on the last
    K vocabulary columns by default; ``sigma`` is the paper's logit
    under-normalization. With ``from_log_probs`` the inputs are log-probs
    (read as given, shifted by −sigma) and the gradient is the sparse one
    w.r.t. them: at blank, at the big blanks and at the label. On a CPU
    tensor a valid label that uses a big-blank column raises
    ``ValueError``, as the JAX module's does; on a CUDA tensor it is not
    checked (that would wait for the card), and the two posteriors meet on
    that column: both subtracted from raw activations' gradient, the emit
    one written over the big blank's on log-probs."""
    _check_reduction(reduction)
    _certify(acts, labels, act_lens, label_lens)
    if acts.device.type == "cpu":
        _check_big_blank_labels(acts, labels, label_lens, big_blank_durations, big_blank_indices)
    costs = _multiblank_costs(acts, labels, act_lens, label_lens, big_blank_durations, blank,
                              big_blank_indices, "none", sigma, fastemit_lambda, delay_penalty,
                              from_log_probs, "auto")
    return _reduce(costs, reduction, acts.size(0))


def rnnt_loss_tdt(token_logits, duration_logits, labels, act_lens, label_lens,
                  durations=(0, 1, 2, 3, 4), blank=0, sigma=0.0, reduction="mean",
                  fastemit_lambda=0.0, delay_penalty=0.0):
    """Token-and-Duration Transducer loss (arXiv:2304.06795); differentiable
    w.r.t. both logits tensors."""
    _check_reduction(reduction)
    _certify(token_logits, labels, act_lens, label_lens)
    costs = _tdt(token_logits, duration_logits, labels, act_lens, label_lens,
                 durations=durations, blank=blank, sigma=sigma, reduction="none",
                 fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty)
    return _reduce(costs, reduction, token_logits.size(0))


def rnnt_loss_multiblank_fused(e, p, W, bias, labels, act_lens, label_lens, big_blank_durations,
                               blank=0, big_blank_indices=None, sigma=0.0, reduction="mean",
                               fastemit_lambda=0.0, delay_penalty=0.0):
    """Fused multi-blank joint+loss: the (B, T, U, V) logits are never
    formed. ``reduction`` "sum" or "mean" only."""
    _check_reduction(reduction, fused=True)
    costs = _multiblank_fused(e, p, W, bias, labels, act_lens, label_lens, big_blank_durations,
                              blank=blank, big_blank_indices=big_blank_indices, sigma=sigma,
                              reduction="none", fastemit_lambda=fastemit_lambda,
                              delay_penalty=delay_penalty)
    return _reduce(costs, reduction, e.size(0))


def rnnt_loss_tdt_fused(e, p, W, bias, Wd, bias_d, labels, act_lens, label_lens,
                        durations=(0, 1, 2, 3, 4), blank=0, sigma=0.0, reduction="mean",
                        fastemit_lambda=0.0, delay_penalty=0.0):
    """Fused TDT joint+loss; differentiable w.r.t. all six joint inputs.
    ``reduction`` "sum" or "mean" only."""
    _check_reduction(reduction, fused=True)
    costs = _tdt_fused(e, p, W, bias, Wd, bias_d, labels, act_lens, label_lens,
                       durations=durations, blank=blank, sigma=sigma, reduction="none",
                       fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty)
    return _reduce(costs, reduction, e.size(0))
