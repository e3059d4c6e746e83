"""TDT loss fused into the joint network: the (B, T, U, V) token logits never exist.

``rnnt_loss_tdt_fused_joint(e, p, W, bias, Wd, bias_d, labels, ...)``
computes the same value as

    h = tanh(e[:, :, None, :] + p[:, None, :, :])
    rnnt_loss_tdt(h @ W + bias, h @ Wd + bias_d, labels, ...)

but the token logits (and the (B, T, U, H) joint features) live only
tile-wise, forward and backward: the TDT twin of ``rnnt_loss_fused_joint``.
The duration head is narrow (D columns, one a duration; the duration set
has no cap), so its logits are held as (B, T, U, D); the O(B·T·U·V) token
tensor and the O(B·T·U·H) features are not. Gradients flow to all six joint
inputs. Counterpart of
``warp_transducer_tpu/ops/tdt_fused.py``.

Why the composition is exact: the TDT token-head gradient is
``p_tok·coef − [v=blank]·Σ_j cb_j − [v=y_u]·(1+λ)·Σ_j ce_j``, the same
softmax-minus-selects form as the dense loss with the per-duration arc
posteriors summed, so the fused gradient takes the TDT coefficient fields
unchanged (``ops/tdt.py::_tdt_coefs``).

Stages, each the kernel on a CUDA tensor and the plain version on a CPU
tensor (``implementation`` as in ``ops/rnnt.py``), on one of two routes:

* integrated — the fused prep and gradient with the duration head inside
  (``csrc/joint_prep.cu``, ``csrc/joint_grad.cu``);
* composed — the fused prep and gradient of the token head alone, then the
  standalone duration-head pair (``csrc/dur_head.cu``), whose de and dp
  shares add to the token head's: dh enters the (1 − h²) linearly.

``_tdt_single_chunk`` picks the route. Between them run the σ shift, the
duration head's ``log_softmax``, the pending-window lattice
(``csrc/window_stream.cu``) and the coefficient fields, plain torch on
every device, as is d(bias_d) = Σ g_dur over its D columns.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import gradients as _gradients
from . import prep as _prep
from . import window as _window
from .fused_joint import _check_joint_inputs
from .lattice import LatticeResult
from .prep import NEG
from .rnnt import _engine, _on_device, _reduce
from .tdt import _check_durations, _tdt_coefs


def _tdt_single_chunk(e, p, W) -> bool:
    """True for the integrated route, False for the composed one. In the JAX
    package the question is whether W fits the TPU's fast memory beside the
    duration head's buffers; on a CUDA card one launch covers all of V at
    any size, so the rule is which route is the faster there. Timed at
    B=64, T=150, L=20, V=5000, H=256, D=4 on an H100 (``chip_smoke.py``,
    its ``route fused`` line; PERF.md has the times): the composed route,
    by 1–2% of a step and with the lower peak memory. The duration head
    inside the fused kernels costs a warp's tanh pass a row in the prep and
    a third kernel for dWd in the gradient, more than the standalone pair
    (about 0.1 ms together there). One shape was timed, so the rule is a
    constant."""
    return False


def _tdt_fused_prep(eng, e, p, W, bias, Wd, bias_d, labels, input_lengths, label_lengths,
                    blank, integrated):
    if integrated:
        return eng.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank,
                              dur_head=(Wd, bias_d))
    prepped = eng.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank)
    return prepped._replace(dur=eng.dur_head_prep(e, p, Wd, bias_d, input_lengths,
                                                  label_lengths))


def _tdt_fused_grad(eng, e, p, W, bias, Wd, labels, input_lengths, label_lengths, denom,
                    fields, g_dur, blank, integrated):
    """(de, dp, dW, db, dWd) on either route."""
    if integrated:
        return eng.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                              fields, blank, dur_head=(Wd, g_dur))
    de, dp, dW, db = eng.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths,
                                    denom, fields, blank)
    de2, dp2, dWd = eng.dur_head_grad(e, p, Wd, g_dur, input_lengths, label_lengths)
    return de + de2, dp + dp2, dW, db, dWd


class _TDTFusedCosts(torch.autograd.Function):
    """(B,) costs; the backward forms both heads' coefficient fields with
    the upstream cotangent folded in and runs the fused gradient."""

    @staticmethod
    def forward(ctx, e, p, W, bias, Wd, bias_d, labels, input_lengths, label_lengths, blank,
                durations, sigma, fastemit_lambda, delay_penalty, eng):
        integrated = bool(_tdt_single_chunk(e, p, W))
        prepped = _tdt_fused_prep(eng, e, p, W, bias, Wd, bias_d, labels, input_lengths,
                                  label_lengths, blank, integrated)
        lpb, lpe = prepped.lpb, prepped.lpe
        if sigma:
            lpb, lpe = lpb - sigma, torch.clamp_min(lpe - sigma, NEG)
        if delay_penalty:
            lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
        lpd = torch.log_softmax(prepped.dur, dim=-1)
        needs_grad = any(ctx.needs_input_grad[:6])
        lat = eng.window_forward_backward(lpb, lpe, lpd, _window.tdt_arcs(durations),
                                          input_lengths, label_lengths,
                                          compute_betas=needs_grad)
        if needs_grad:
            ctx.save_for_backward(e, p, W, bias, Wd, bias_d, labels, input_lengths,
                                  label_lengths, prepped.denom, lpb, lpe, lpd, lat.alphas,
                                  lat.betas, lat.ll_forward)
            ctx.config = (eng, blank, durations, fastemit_lambda, integrated)
        return (-lat.ll_forward).to(e.dtype)

    @staticmethod
    def backward(ctx, g):
        (e, p, W, bias, Wd, bias_d, labels, input_lengths, label_lengths, denom, lpb, lpe, lpd,
         alphas, betas, ll) = ctx.saved_tensors
        eng, blank, durations, lam, integrated = ctx.config
        coef, cb, ce, cb_js, ce_js = _tdt_coefs(
            lpb, lpe, lpd, LatticeResult(alphas, betas, ll, ll), durations, input_lengths,
            label_lengths, scale=g.float(), fastemit_lambda=lam)
        ce_tok = (1.0 + lam) * ce if lam else ce
        fields = _gradients.Coefficients(coef.contiguous(), cb.contiguous(), ce_tok.contiguous())
        # The duration head's cotangent: D columns, elementwise. Outside the
        # lattice, and for an utterance no path can finish, every field is an
        # exact zero and lpd is finite, so g_dur is an exact zero there.
        arcs = torch.stack([cb_js[j] + (1.0 + lam) * ce_js[j] for j in range(len(durations))],
                           dim=-1)
        g_dur = coef[..., None] * torch.exp(lpd) - arcs
        dbd = g_dur.sum(dim=(0, 1, 2)).to(bias_d.dtype)
        de, dp, dW, db, dWd = _tdt_fused_grad(eng, e, p, W, bias, Wd, labels, input_lengths,
                                              label_lengths, denom, fields, g_dur, blank,
                                              integrated)
        return (de, dp, dW, db, dWd, dbd) + (None,) * 9


def rnnt_loss_tdt_fused_joint(e, p, W, bias, Wd, bias_d, labels, input_lengths, label_lengths,
                              durations: Sequence[int] = (0, 1, 2, 3, 4), blank: int = 0,
                              reduction: str = "mean", sigma: float = 0.0,
                              fastemit_lambda: float = 0.0, delay_penalty: float = 0.0,
                              implementation: str = "auto"):
    """TDT loss with the joint projection fused in.

    Args:
      e: (B, T, H) projected encoder activations; p: (B, U, H) projected
        prediction activations.
      W: (H, V) token-head weight; bias: (V,). Any floating type and
        layout, as ``rnnt_loss_fused_joint``'s.
      Wd: (H, D) duration-head weight; bias_d: (D,), column j for
        ``durations[j]``. Both are used in f32 whatever their type.
      labels / lengths / durations / blank / reduction / sigma /
      fastemit_lambda / delay_penalty: as in ``rnnt_loss_tdt``.
      implementation: 'auto' | 'torch' | 'cuda' (``ops/rnnt.py``): the fused
        kernels and the lattice kernel, or their plain versions.

    Equals ``rnnt_loss_tdt(h @ W + bias, h @ Wd + bias_d, ...)`` with
    ``h = tanh(e ⊕ p)``, without holding the (B, T, U, V) token logits or
    the (B, T, U, H) joint features. Differentiable w.r.t. all six joint
    inputs.

    On a CUDA tensor the fused kernels and the duration-head kernels take
    any H (``rnnt_loss_fused_joint``).
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if Wd.dim() != 2 or bias_d.dim() != 1:
        raise ValueError(f"expected Wd (H,D), bias_d (D,); got {tuple(Wd.shape)}, "
                         f"{tuple(bias_d.shape)}")
    _check_joint_inputs(e, p, W, bias, labels)
    if W.shape[0] != Wd.shape[0] or Wd.shape[1] != bias_d.shape[0]:
        raise ValueError(f"hidden/duration dims disagree: W {tuple(W.shape)}, "
                         f"Wd {tuple(Wd.shape)}, bias_d {tuple(bias_d.shape)}")
    durs = _check_durations(durations)
    if Wd.shape[1] != len(durs):
        raise ValueError(f"duration head has {Wd.shape[1]} columns for {len(durs)} durations")
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    if Wd.device != e.device or bias_d.device != e.device:
        raise ValueError(f"the duration head is on {Wd.device}, e on {e.device}")
    eng = _engine(implementation, e)
    labels, input_lengths, label_lengths = _on_device(e, labels, input_lengths, label_lengths)
    costs = _TDTFusedCosts.apply(e, p, W, bias, Wd, bias_d, labels, input_lengths,
                                 label_lengths, int(blank), durs, float(sigma),
                                 float(fastemit_lambda), float(delay_penalty), eng)
    return _reduce(costs, reduction)
