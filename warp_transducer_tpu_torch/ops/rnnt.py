"""Public RNN-Transducer loss op for PyTorch, with CUDA kernels for Hopper.

Counterpart of ``warp_transducer_tpu/ops/rnnt.py``. The forward pass runs
prep and the wavefront lattice and keeps only the small (B, T, U) arrays;
the dense O(B·T·U·V) analytic gradient runs in the backward with the
upstream cotangent folded into its coefficients. The loss is a
``torch.autograd.Function``: autograd never runs through the recursion.

The loss runs on the device of ``acts``. ``implementation``:
* ``"auto"`` — the CUDA kernels for a CUDA tensor, the plain PyTorch
  version for a CPU tensor;
* ``"cuda"`` — the kernels; a CPU tensor raises;
* ``"torch"`` — the plain version on any device (an explicit request, to
  compare the two).

Conventions:
* default (``log_probs_input=False``): raw activations in, log-softmax fused
  into the loss, dense gradient w.r.t. activations — the reference GPU path.
* ``log_probs_input=True``: the caller provides log-probs, sparse gradient —
  the reference CPU path.

Dtypes: f64 computes in f64; f32, bf16 and f16 compute in f32. Costs and
gradients come back in the input's dtype.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import torch

from . import band as _band
from . import fused_joint as _fused
from . import gradients as _gradients
from . import lattice as _lattice
from . import prep as _prep
from . import window as _window
from .cuda import band as _cuda_band
from .cuda import grad as _cuda_grad
from .cuda import joint as _cuda_joint
from .cuda import prep as _cuda_prep
from .cuda import ranges as _cuda_ranges
from .cuda import wavefront as _cuda_wavefront
from .cuda import window as _cuda_window
from ..utils.options import RNNTOptions

_IMPLEMENTATIONS = ("auto", "torch", "cuda")

# The stages of the dense loss, of the pruned path (ops/simple.py,
# ops/pruned.py), of the fused joint (ops/fused_joint.py,
# ops/pruned_fused.py) and of the duration-arc losses (ops/multiblank.py,
# ops/tdt.py, and fused into the joint: ops/multiblank_fused.py,
# ops/tdt_fused.py), as plain PyTorch and as kernel wrappers. A wrapper given a
# CPU tensor runs the plain version, so "auto" needs no branch of its own.
_PLAIN = SimpleNamespace(prepare=_prep.prepare,
                         forward_backward=_lattice.forward_backward,
                         dense_grad=_gradients.dense_grad,
                         sparse_grad=_gradients.sparse_grad,
                         band_prep=_band.band_prep,
                         band_forward_backward=_band.forward_backward,
                         band_grad=_band.band_grad,
                         band_starts=_band.band_starts,
                         fused_prep=_fused.fused_prep,
                         fused_grad=_fused.fused_grad,
                         dur_head_prep=_fused.dur_head_prep,
                         dur_head_grad=_fused.dur_head_grad,
                         window_forward_backward=_window.forward_backward)
_KERNELS = SimpleNamespace(prepare=_cuda_prep.prepare,
                           forward_backward=_cuda_wavefront.forward_backward,
                           dense_grad=_cuda_grad.dense_grad,
                           sparse_grad=_cuda_grad.sparse_grad,
                           band_prep=_cuda_band.band_prep,
                           band_forward_backward=_cuda_band.forward_backward,
                           band_grad=_cuda_band.band_grad,
                           band_starts=_cuda_ranges.band_starts,
                           fused_prep=_cuda_joint.fused_prep,
                           fused_grad=_cuda_joint.fused_grad,
                           dur_head_prep=_cuda_joint.dur_head_prep,
                           dur_head_grad=_cuda_joint.dur_head_grad,
                           window_forward_backward=_cuda_window.forward_backward)


def _engine(implementation: str, acts: torch.Tensor):
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(
            f"implementation must be one of {_IMPLEMENTATIONS}, got {implementation!r}")
    if implementation == "cuda" and acts.device.type != "cuda":
        raise ValueError(
            f"implementation='cuda' needs CUDA tensors; input is on {acts.device}")
    return _PLAIN if implementation == "torch" else _KERNELS


def _reduce(costs, reduction):
    if reduction == "sum":
        return costs.sum()
    if reduction == "mean":
        return costs.mean()
    return costs


def _certify_inputs(acts, labels, input_lengths, label_lengths):
    """Static shape/dtype validation mirroring the reference's
    ``certify_inputs``. Data-dependent checks (T == max(input_lengths)) are
    omitted, as in the JAX package; padding beyond the lengths is masked."""
    if acts.dim() != 4:
        raise ValueError(f"acts must be 4-D (B, T, U, V); got shape {tuple(acts.shape)}")
    if labels.dim() != 2:
        raise ValueError(f"labels must be 2-D (B, L); got shape {tuple(labels.shape)}")
    if input_lengths.dim() != 1 or label_lengths.dim() != 1:
        raise ValueError("input_lengths and label_lengths must be 1-D")
    B = acts.shape[0]
    for name, arr in (("labels", labels), ("input_lengths", input_lengths),
                      ("label_lengths", label_lengths)):
        if arr.shape[0] != B:
            raise ValueError(f"{name} batch dim {arr.shape[0]} != acts batch dim {B}")
        if arr.dtype.is_floating_point or arr.dtype.is_complex or arr.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor; got {arr.dtype}")
    if labels.shape[1] < acts.shape[2] - 1:
        raise ValueError(
            f"labels length {labels.shape[1]} is smaller than U-1={acts.shape[2] - 1}")
    if acts.dtype not in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        raise TypeError(f"acts must be f32, f64, bf16 or f16; got {acts.dtype}")
    if not acts.is_contiguous():
        raise ValueError("acts must be contiguous")


def _on_device(acts, *ints):
    """Labels and lengths may arrive on either device: move them to acts'."""
    return tuple(x.to(device=acts.device, dtype=torch.int32) for x in ints)


def _maybe_check_mismatch(res, tol):
    """Warn when |ll_fwd - ll_bwd| > tol (the reference CPU backend's
    mismatch warning, cpu_rnnt.h:167-169). The one host sync of the path,
    and only when asked for."""
    if tol is None:
        return
    diff = float((res.ll_forward - res.ll_backward).abs().max())
    if diff > tol:
        warnings.warn(f"forward backward likelihood mismatch {diff} (tol {tol})",
                      RuntimeWarning, stacklevel=3)


def _prepare(eng, acts, labels, input_lengths, blank, log_probs_input, delay_penalty):
    prepped = eng.prepare(acts, labels, blank, log_probs_input)
    if delay_penalty:
        prepped = prepped._replace(
            lpe=_prep.delay_shift(prepped.lpe, input_lengths, delay_penalty))
    return prepped


def _grads(eng, acts, prepped, res, labels, input_lengths, label_lengths, blank,
           log_probs_input, scale, fastemit_lambda):
    """The gradient (``gradients.grad_wrt_acts`` / ``grad_wrt_log_probs``):
    the (B, T, U) coefficient fields, then the engine's pass over V."""
    B, T, U, V = acts.shape
    labels_u = _prep.label_rows(labels, U)
    fields = _gradients.coefficients(prepped.lpb, prepped.lpe, res.alphas, res.betas,
                                     res.ll_forward, input_lengths, label_lengths, scale,
                                     fastemit_lambda)
    if log_probs_input:
        return eng.sparse_grad(fields, labels_u, input_lengths, label_lengths, blank, V,
                               acts.dtype)
    return eng.dense_grad(acts, prepped.denom, fields, labels_u, input_lengths,
                          label_lengths, blank, acts.dtype)


class _RNNTCosts(torch.autograd.Function):
    """(B,) costs; the backward is the gradient pass with the upstream
    cotangent folded into its coefficients (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, acts, labels, input_lengths, label_lengths, blank,
                log_probs_input, eng, check_tol, fastemit_lambda, delay_penalty):
        prepped = _prepare(eng, acts, labels, input_lengths, blank, log_probs_input,
                           delay_penalty)
        needs_grad = ctx.needs_input_grad[0]
        res = eng.forward_backward(prepped.lpb, prepped.lpe, input_lengths, label_lengths,
                                   compute_betas=needs_grad or check_tol is not None)
        _maybe_check_mismatch(res, check_tol)
        if needs_grad:
            ctx.save_for_backward(acts, prepped.lpb, prepped.lpe, prepped.denom,
                                  res.alphas, res.betas, res.ll_forward, labels,
                                  input_lengths, label_lengths)
            ctx.config = (eng, blank, log_probs_input, fastemit_lambda)
        return (-res.ll_forward).to(acts.dtype)

    @staticmethod
    def backward(ctx, g):
        (acts, lpb, lpe, denom, alphas, betas, ll, labels, input_lengths,
         label_lengths) = ctx.saved_tensors
        eng, blank, log_probs_input, fastemit_lambda = ctx.config
        prepped = _prep.PreparedInputs(lpb, lpe, denom)
        res = _lattice.LatticeResult(alphas, betas, ll, ll)
        d_acts = _grads(eng, acts, prepped, res, labels, input_lengths, label_lengths,
                        blank, log_probs_input, g.to(alphas.dtype), fastemit_lambda)
        return (d_acts,) + (None,) * 9


def rnnt_loss(acts, labels, input_lengths, label_lengths, blank: int = 0,
              reduction: str = "mean", log_probs_input: bool = False,
              implementation: str = "auto", fastemit_lambda: float = 0.0,
              delay_penalty: float = 0.0, options: RNNTOptions | None = None):
    """RNN-Transducer loss, differentiable w.r.t. ``acts``.

    Args:
      acts: (B, T, U, V) contiguous joint-network outputs — raw activations
        by default, or log-probs when ``log_probs_input``.
      labels: (B, L) integer zero-padded targets, L >= U-1.
      input_lengths: (B,) integer valid encoder lengths.
      label_lengths: (B,) integer label counts (U_b = label_lengths + 1).
      blank: blank symbol index.
      reduction: 'none' | 'sum' | 'mean' (mean divides by the batch size).
      log_probs_input: the reference-CPU convention (sparse gradient).
      implementation: 'auto' | 'torch' | 'cuda' (module docstring).
      fastemit_lambda: FastEmit λ (arXiv:2010.11148); changes the gradient
        only.
      delay_penalty: delay-penalized transducer λ (arXiv:2211.00490);
        changes the objective.
      options: an ``RNNTOptions``; when given, its fields take precedence,
        and its ``fwd_bwd_check_tol`` arms the likelihood self-check.

    Returns:
      (B,) costs for reduction='none', a scalar otherwise.
    """
    check_tol = None
    if options is not None:
        blank = options.blank
        reduction = options.reduction
        log_probs_input = options.log_probs_input
        implementation = options.implementation
        check_tol = options.fwd_bwd_check_tol
        fastemit_lambda = options.fastemit_lambda
        delay_penalty = options.delay_penalty
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    costs = _RNNTCosts.apply(
        acts, labels, input_lengths, label_lengths, int(blank), bool(log_probs_input),
        eng, None if check_tol is None else float(check_tol),
        float(fastemit_lambda), float(delay_penalty))
    return _reduce(costs, reduction)


@torch.no_grad()
def rnnt_loss_and_grad(acts, labels, input_lengths, label_lengths, blank=0,
                       log_probs_input=False, implementation="auto",
                       fastemit_lambda=0.0, delay_penalty=0.0):
    """Return (costs[B], grads[B,T,U,V]) in one call — the reference C API's
    ``cost_and_grad``: prep, lattice and gradient pass."""
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    prepped = _prepare(eng, acts, labels, input_lengths, int(blank),
                       bool(log_probs_input), float(delay_penalty))
    res = eng.forward_backward(prepped.lpb, prepped.lpe, input_lengths, label_lengths)
    grads = _grads(eng, acts, prepped, res, labels, input_lengths, label_lengths,
                   int(blank), bool(log_probs_input), None, float(fastemit_lambda))
    return (-res.ll_forward).to(acts.dtype), grads


@torch.no_grad()
def rnnt_score(acts, labels, input_lengths, label_lengths, blank=0,
               log_probs_input=False, implementation="auto"):
    """Loss-only scoring: alphas only, no betas and no gradient (the
    reference's ``score_forward``). Not differentiable; use ``rnnt_loss``
    for gradients."""
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    prepped = eng.prepare(acts, labels, int(blank), bool(log_probs_input))
    res = eng.forward_backward(prepped.lpb, prepped.lpe, input_lengths, label_lengths,
                               compute_betas=False)
    return (-res.ll_forward).to(acts.dtype)


@torch.no_grad()
def rnnt_forward_backward(acts, labels, input_lengths, label_lengths, blank=0,
                          log_probs_input=False, implementation="auto"):
    """Debug introspection: the full lattice state, a ``LatticeResult`` with
    (B, T, U) alphas/betas (NEG at invalid cells) and per-utterance
    forward/backward log-likelihoods."""
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    prepped = eng.prepare(acts, labels, int(blank), bool(log_probs_input))
    return eng.forward_backward(prepped.lpb, prepped.lpe, input_lengths, label_lengths)


def forward_backward_mismatch(acts, labels, input_lengths, label_lengths, blank=0,
                              log_probs_input=False, implementation="auto"):
    """Numerical self-check: per-utterance |ll_forward - ll_backward|."""
    res = rnnt_forward_backward(acts, labels, input_lengths, label_lengths, blank=blank,
                                log_probs_input=log_probs_input,
                                implementation=implementation)
    return (res.ll_forward - res.ll_backward).abs()


class RNNTLoss(torch.nn.Module):
    """Module form of ``rnnt_loss``, taking the individual kwargs or a whole
    ``RNNTOptions`` (``RNNTLoss(options=RNNTOptions(...))``)."""

    def __init__(self, blank: int = 0, reduction: str = "mean",
                 log_probs_input: bool = False, implementation: str = "auto",
                 fastemit_lambda: float = 0.0, options: RNNTOptions | None = None):
        super().__init__()
        if options is None:
            options = RNNTOptions(blank=blank, reduction=reduction,
                                  log_probs_input=log_probs_input,
                                  implementation=implementation,
                                  fastemit_lambda=fastemit_lambda)
        self.options = options

    def forward(self, acts, labels, input_lengths, label_lengths):
        return rnnt_loss(acts, labels, input_lengths, label_lengths, options=self.options)
