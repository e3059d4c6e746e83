"""Pruned + fused joint: the joint projection evaluated only on the band.

``rnnt_loss_pruned`` takes banded logits (B, T, S, V) that the caller must
first hold in memory; at B=128, T=1500, S=5, V=5000 that tensor alone is
19 GB in f32. ``rnnt_loss_pruned_fused`` takes the projected activations
instead — e (B, T, H), p (B, U, H), W (H, V), bias — and gives the band
loss and all four gradients with the banded logits living one T chunk at
a time:

* forward: a T-chunked sweep gathers the band's prediction rows
  ``p[ranges[t] + s]`` (clipped to U-1; the clipped cells lie outside the
  lattice), forms ``tanh(e ⊕ p_band) @ W + bias`` and reduces it to the
  (B, T, S) lpb / lpe / denom fields; the band recursion then runs on those
  (``csrc/band_stream.cu`` on a CUDA tensor);
* backward: the (B, T, S) coefficient fields (``band.band_coefs``) drive a
  second sweep that recomputes each chunk, forms
  ``g = coef·softmax − cb·1_blank − ce·1_label`` and contracts it at once:
  ``dW += hᵀ g``, ``db += Σ g``, ``dh = g·Wᵀ``, de by the sum over the
  band, dp by an ``index_add_`` over the band's u indices in f32 (cells
  outside the lattice carry zero coefficients, so their clipped indices
  add zero; on the card the sum's order varies from run to run).

Counterpart of ``warp_transducer_tpu/ops/pruned_fused.py``, where the two
sweeps are XLA chunk loops outside any Pallas kernel; here they are torch
loops of IEEE-f32 ``torch.matmul`` on every device (``fused_joint._mm``,
whatever the global TF32 switch). Below a working-set threshold
the banded joint is simply formed and handed to ``rnnt_loss_pruned`` (the
band prep and gradient kernels), which is the faster route when it fits.
Types as ``ops/fused_joint.py``.
"""
from __future__ import annotations

import torch

from . import band as _band
from . import fused_joint as _fused
from . import prep as _prep
from .fused_joint import (_check_joint_inputs, _contract, _label_index, _mm, _mm_dtype, _rounded,
                          _row_fields, _row_grads, exact_matmul)
from .pruned import gather_banded, rnnt_loss_pruned
from .rnnt import _engine, _on_device, _reduce
from .simple import _check_lengths

# Up to this working set — the band's logits and their gradient (B, T, S, V)
# plus the gathered band rows and their tanh (B, T, S, H), all f32 — the
# banded joint is formed whole; above it the chunked sweeps run.
_MATERIALIZE_MB = 4096


def _materialize_bytes(B, T, S, H, V):
    return 4 * B * T * S * (2 * V + 2 * H)


def _t_chunk(B, T, S, H, V):
    per_t = B * S * (V + 2 * H) * 4
    return max(1, min(T, (_fused._T_CHUNK_MB << 20) // max(per_t, 1)))


def _chunk(e, p32, W32, bias32, ranges, t0, t1, S, mm):
    """One T chunk of the band: the flat source rows (B·Tc·S,) of p, h and
    the rounded h (B, Tc, S, H), and the logits (B, Tc, S, V), all f32."""
    B, U, H = p32.shape
    dev = e.device
    idx = (ranges[:, t0:t1, None].long() + torch.arange(S, device=dev)).clamp(0, U - 1)
    flat = (idx + torch.arange(B, device=dev)[:, None, None] * U).reshape(-1)
    p_band = p32.reshape(B * U, H).index_select(0, flat).reshape(B, t1 - t0, S, H)
    h = torch.tanh(e[:, t0:t1].float()[:, :, None, :] + p_band)
    hm = _rounded(h, mm)
    return flat, h, hm, _mm(hm, W32) + bias32


def _sweep_prep(e, p, W, bias, ranges, lab_row, blank) -> _band.BandPrep:
    """lpb, lpe, denom (B, T, S) f32; the logits live one chunk at a time."""
    B, T, H = e.shape
    V, S = W.shape[1], lab_row.shape[2]
    mm = _mm_dtype(W)
    Tc = _t_chunk(B, T, S, H, V)
    p32, W32, bias32 = p.float(), W.float(), bias.float()
    has, idx = _label_index(lab_row, V)
    lpb = torch.empty((B, T, S), dtype=torch.float32, device=e.device)
    lpe, denom = torch.empty_like(lpb), torch.empty_like(lpb)
    for t0 in range(0, T, Tc):
        sl = slice(t0, min(t0 + Tc, T))
        *_, logits = _chunk(e, p32, W32, bias32, ranges, sl.start, sl.stop, S, mm)
        denom[:, sl], lpb[:, sl], lpe[:, sl] = _row_fields(logits, has[:, sl], idx[:, sl], blank)
    return _band.BandPrep(lpb, lpe, denom)


def _sweep_grad(e, p, W, bias, ranges, lab_row, denom, fields, blank):
    """(de, dp, dW, db) in one T-chunked sweep; each chunk's logits are
    recomputed and the (B, T, S, V) gradient is contracted in place."""
    B, T, H = e.shape
    U, V, S = p.shape[1], W.shape[1], lab_row.shape[2]
    mm = _mm_dtype(W)
    Tc = _t_chunk(B, T, S, H, V)
    p32, W32, bias32 = p.float(), W.float(), bias.float()
    has, idx = _label_index(lab_row, V)
    de = torch.empty((B, T, H), dtype=torch.float32, device=e.device)
    dp = torch.zeros((B * U, H), dtype=torch.float32, device=e.device)
    dW = torch.zeros((H, V), dtype=torch.float32, device=e.device)
    db = torch.zeros((V,), dtype=torch.float32, device=e.device)
    for t0 in range(0, T, Tc):
        sl = slice(t0, min(t0 + Tc, T))
        flat, h, hm, logits = _chunk(e, p32, W32, bias32, ranges, sl.start, sl.stop, S, mm)
        g = _row_grads(logits, denom[:, sl], fields.coef[:, sl], fields.cb[:, sl],
                       fields.ce[:, sl], has[:, sl], idx[:, sl], blank)
        d, dW_c, db_c, _ = _contract(g, h, hm, W32, mm)
        de[:, sl] = d.sum(dim=2)
        dp.index_add_(0, flat, d.reshape(-1, H))
        dW += dW_c
        db += db_c
    return (de.to(e.dtype), dp.reshape(B, U, H).to(p.dtype), dW.to(W.dtype),
            db.to(bias.dtype))


class _PrunedFusedCosts(torch.autograd.Function):
    """(B,) costs of the band through the sweeps; an infeasible band (no
    path inside it reaches the terminal cell) costs -NEG and has a zero
    gradient, as in ``rnnt_loss_pruned``."""

    @staticmethod
    def forward(ctx, e, p, W, bias, ranges, labels, input_lengths, label_lengths, S, blank,
                eng, fastemit_lambda, delay_penalty):
        lab_band, has_lab = _band.band_labels(labels, ranges, S)
        lab_row = _band.label_rows(lab_band, has_lab)
        f = _sweep_prep(e, p, W, bias, ranges, lab_row, blank)
        lpe = f.lpe
        if delay_penalty:
            lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
        lat = eng.band_forward_backward(f.lpb, lpe, ranges, input_lengths, label_lengths)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(e, p, W, bias, ranges, input_lengths, label_lengths, f.lpb,
                                  lpe, f.denom, lab_row, has_lab, *lat)
            ctx.config = (blank, fastemit_lambda)
        return (-lat.ll_forward).to(e.dtype)

    @staticmethod
    def backward(ctx, g):
        (e, p, W, bias, ranges, input_lengths, label_lengths, lpb, lpe, denom, lab_row, has_lab,
         *lat) = ctx.saved_tensors
        blank, fastemit_lambda = ctx.config
        fields = _band.band_coefs(lpb, lpe, _band.BandLattice(*lat), ranges, has_lab,
                                  input_lengths, label_lengths, g.float(), fastemit_lambda)
        grads = _sweep_grad(e, p, W, bias, ranges, lab_row, denom, fields, blank)
        return tuple(grads) + (None,) * 9


def rnnt_loss_pruned_fused(e, p, W, bias, ranges, labels, input_lengths, label_lengths,
                           s_range: int, blank: int = 0, reduction: str = "mean",
                           implementation: str = "auto", fastemit_lambda: float = 0.0,
                           delay_penalty: float = 0.0):
    """Pruned RNN-T loss with the joint projection fused in.

    Args:
      e: (B, T, H) projected encoder activations.
      p: (B, U, H) projected prediction activations, U = L+1.
      W: (H, V) output-projection weight; bias: (V,). e, p, W and bias may
        be of any floating type and layout: the products take bf16 inputs
        when W is bf16 and f32 inputs otherwise, the gradients come back in
        the inputs' types (as the JAX package).
      ranges: (B, T) integer band starts from ``rnnt_prune_ranges`` or
        ``rnnt_loss_simple(..., prune_range=S)``.
      labels, input_lengths, label_lengths, blank, reduction: as in
        ``rnnt_loss``.
      s_range: band width S (ranges carry only the starts).
      implementation: 'auto' | 'torch' | 'cuda' (``rnnt_loss``): the band
        kernels or their plain versions; the chunked joint sweeps are torch
        ops either way.
      fastemit_lambda: FastEmit λ (arXiv:2010.11148); changes the gradient
        only.
      delay_penalty: delay-penalized transducer λ (arXiv:2211.00490);
        changes the objective.

    Equals ``rnnt_loss_pruned(tanh(e ⊕ p_band) @ W + bias, ranges, ...)``
    without holding the (B, T, S, V) banded logits or their gradient in
    device memory above the threshold. Differentiable w.r.t. e, p, W and
    bias.

    Neither of its routes runs the fused joint kernels; like
    ``rnnt_loss_fused_joint`` it takes any H on a CUDA tensor.
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    _check_joint_inputs(e, p, W, bias, labels)
    B, T, H = e.shape
    V = W.shape[1]
    if tuple(ranges.shape) != (B, T):
        raise ValueError(f"ranges must be (B, T) = {(B, T)}; got {tuple(ranges.shape)}")
    S = int(s_range)
    if S < 2:
        raise ValueError(f"s_range must be >= 2, got {s_range}")
    _check_lengths(input_lengths, label_lengths, B)
    eng = _engine(implementation, e)
    if _materialize_bytes(B, T, S, H, V) <= _MATERIALIZE_MB << 20:
        # Cheap at this size: form the banded joint in f32 and train through
        # the band prep and gradient kernels; the same objective by this
        # function's defining identity.
        p_band = gather_banded(p.float(), ranges, S)
        acts = exact_matmul(torch.tanh(e.float()[:, :, None, :] + p_band), W.float()) \
            + bias.float()
        return rnnt_loss_pruned(acts, ranges, labels, input_lengths, label_lengths, blank=blank,
                                reduction=reduction, implementation=implementation,
                                fastemit_lambda=fastemit_lambda,
                                delay_penalty=delay_penalty).to(e.dtype)  # as the sweep's
    ranges, labels, input_lengths, label_lengths = _on_device(e, ranges, labels, input_lengths,
                                                              label_lengths)
    costs = _PrunedFusedCosts.apply(e, p, W, bias, ranges.contiguous(), labels, input_lengths,
                                    label_lengths, S, int(blank), eng, float(fastemit_lambda),
                                    float(delay_penalty))
    return _reduce(costs, reduction)
