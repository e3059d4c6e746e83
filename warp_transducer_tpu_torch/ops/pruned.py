"""Pruned RNN-T loss: the transducer loss on a (B, T, S, V) band of the
lattice (Kuang et al., arXiv:2206.13236).

Stage 1 (``rnnt_loss_simple(..., prune_range=S)``, or ``rnnt_prune_ranges``
on its own) scores the additive joiner and turns its lattice posteriors
into per-frame band starts ``ranges[b, t]``; the real joiner is evaluated
on the banded cells only (``gather_banded`` brings the prediction network's
rows to the band), and ``rnnt_loss_pruned`` is the loss over the paths
inside the band: O(B·T·S·V) memory instead of O(B·T·U·V).

The stages run on the device of the input: on a CUDA tensor the band
prep, lattice, gradient and range kernels (``ops/cuda/band.py``,
``ops/cuda/ranges.py``), on a CPU tensor their plain versions
(``ops/band.py``). Counterpart of ``warp_transducer_tpu/ops/pruned.py``;
both compute in f32 for every input type.
"""
from __future__ import annotations

import torch

from . import band as _band
from . import prep as _prep
from .rnnt import _engine, _on_device, _reduce
from .simple import _check_lengths, _factorised_lattice_inputs


def ranges_from_posteriors(alphas, betas, ll, input_lengths, label_lengths, s_range: int):
    """Band starts (B, T) int32 from the lattice's alphas, betas and
    ll_forward (``rnnt_prune_ranges`` states the guarantees), on the device
    of ``alphas``."""
    if int(s_range) < 2:
        raise ValueError(f"s_range must be >= 2, got {s_range}")
    il, lbl = (x.to(device=alphas.device, dtype=torch.int32) for x in (input_lengths, label_lengths))
    return _engine("auto", alphas).ranges_from_posteriors(
        alphas.contiguous(), betas.contiguous(), ll.contiguous(), il, lbl, int(s_range))


@torch.no_grad()
def rnnt_prune_ranges(am, lm, labels, input_lengths, label_lengths, s_range: int,
                      blank: int = 0, implementation: str = "auto"):
    """Band starts (B, T) from the simple-joiner lattice posteriors; the
    normaliser product runs at ``precision="default"``.

    Inside a training step prefer ``rnnt_loss_simple(..., prune_range=S)``,
    which reads the ranges from the lattice its loss already ran.

    Guarantees: ranges[:, 0] == 0; non-decreasing; steps <= s_range - 1
    (also across the frames beyond T_b, which hold the last value);
    ranges[b, t] <= max(0, U_b - s_range). The terminal cell
    (T_b-1, U_b-1) is inside the band whenever a band of that width can
    hold a path at all, U_b - 1 <= T_b·(s_range - 1); otherwise
    ``rnnt_loss_pruned`` gives that utterance a huge finite cost (~1e30)
    and a zero gradient.
    """
    if int(s_range) < 2:
        raise ValueError(f"s_range must be >= 2, got {s_range}")
    eng = _engine(implementation, am)
    labels, input_lengths, label_lengths = _on_device(am, labels, input_lengths, label_lengths)
    f = _factorised_lattice_inputs(am, lm, _prep.label_rows(labels, lm.shape[1]), int(blank),
                                   "default")
    res = eng.forward_backward(f.lpb, f.lpe, input_lengths, label_lengths)
    return eng.ranges_from_posteriors(res.alphas, res.betas, res.ll_forward, input_lengths,
                                      label_lengths, int(s_range))


class _GatherBanded(torch.autograd.Function):
    """out[b, t, s] = x_u[b, idx[b, t, s]]; the backward adds each band
    row's cotangent back into its source row (index_add_, accumulated in
    f32). On the card index_add_ uses atomics, so the f32 sum of rows that
    share a source (the clipped indices) is taken in an order that varies
    from run to run."""

    @staticmethod
    def forward(ctx, x_u, flat_idx, out_shape):
        B, U = x_u.shape[:2]
        ctx.save_for_backward(flat_idx)
        ctx.shape = tuple(x_u.shape)
        return x_u.reshape(B * U, -1).index_select(0, flat_idx).reshape(out_shape)

    @staticmethod
    def backward(ctx, g):
        (flat_idx,) = ctx.saved_tensors
        B, U = ctx.shape[:2]
        g2 = g.reshape(flat_idx.shape[0], -1).float()
        dx = torch.zeros((B * U, g2.shape[1]), dtype=torch.float32, device=g.device)
        dx.index_add_(0, flat_idx, g2)
        return dx.reshape(ctx.shape).to(g.dtype), None, None


def gather_banded(x_u: torch.Tensor, ranges: torch.Tensor, s_range: int) -> torch.Tensor:
    """Per-frame bands of a U-indexed array.

    x_u: (B, U, ...) (e.g. prediction-network outputs); ranges: (B, T).
    Returns (B, T, S, ...) with out[b, t, s] = x_u[b, min(ranges[b, t] + s,
    U-1)] (the clipped cells lie outside the lattice and are masked in the
    loss). Differentiable w.r.t. x_u."""
    B, U = x_u.shape[:2]
    T, S = ranges.shape[1], int(s_range)
    dev = x_u.device
    idx = (ranges.to(device=dev, dtype=torch.int64)[:, :, None]
           + torch.arange(S, device=dev)).clamp(0, U - 1)
    flat = (idx + torch.arange(B, device=dev)[:, None, None] * U).reshape(-1)
    return _GatherBanded.apply(x_u, flat, (B, T, S) + tuple(x_u.shape[2:]))


class _PrunedCosts(torch.autograd.Function):
    """(B,) costs of the band; the backward is the band gradient pass with
    the upstream cotangent folded into its coefficient fields."""

    @staticmethod
    def forward(ctx, acts, ranges, labels, input_lengths, label_lengths, blank, eng,
                fastemit_lambda, delay_penalty):
        S = acts.shape[2]
        lab_band, has_lab = _band.band_labels(labels, ranges, S)
        lab_row = _band.label_rows(lab_band, has_lab)
        p = eng.band_prep(acts, lab_row, blank)
        lpe = p.lpe
        if delay_penalty:
            lpe = _prep.delay_shift(lpe, input_lengths, delay_penalty)
        lat = eng.band_forward_backward(p.lpb, lpe, ranges, input_lengths, label_lengths)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(acts, ranges, input_lengths, label_lengths, p.lpb, lpe,
                                  p.denom, lab_row, has_lab, *lat)
            ctx.config = (eng, blank, fastemit_lambda)
        return (-lat.ll_forward).to(acts.dtype)

    @staticmethod
    def backward(ctx, g):
        (acts, ranges, input_lengths, label_lengths, lpb, lpe, denom, lab_row, has_lab,
         *lat) = ctx.saved_tensors
        eng, blank, fastemit_lambda = ctx.config
        fields = _band.band_coefs(lpb, lpe, _band.BandLattice(*lat), ranges, has_lab,
                                  input_lengths, label_lengths, g.float(), fastemit_lambda)
        d_acts = eng.band_grad(acts, denom, fields, lab_row, ranges, input_lengths,
                               label_lengths, blank, acts.dtype)
        return (d_acts,) + (None,) * 8


def rnnt_loss_pruned(acts, ranges, labels, input_lengths, label_lengths, blank: int = 0,
                     reduction: str = "mean", implementation: str = "auto",
                     fastemit_lambda: float = 0.0, delay_penalty: float = 0.0):
    """Transducer loss restricted to a pruned band of the lattice.

    Args:
      acts: (B, T, S, V) joint logits on the band (raw; log-softmax fused):
        ``acts[b, t, s]`` is the joint at lattice cell (t, ranges[b, t] + s).
      ranges: (B, T) integer band starts from ``rnnt_prune_ranges`` or
        ``rnnt_loss_simple(..., prune_range=S)`` (monotone, steps < S,
        ranges[:, 0] == 0).
      labels, input_lengths, label_lengths, blank, reduction: as in
        ``rnnt_loss``.
      implementation: 'auto' | 'torch' | 'cuda' (``rnnt_loss``).
      fastemit_lambda: FastEmit λ (arXiv:2010.11148); changes the gradient
        only.
      delay_penalty: delay-penalized transducer λ (arXiv:2211.00490);
        changes the objective.

    Returns the negative log-likelihood over the paths inside the band; it
    equals ``rnnt_loss`` when the band covers the whole lattice (S = U,
    ranges = 0). Differentiable w.r.t. acts.
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    if acts.dim() != 4:
        raise ValueError(f"acts must be (B, T, S, V); got {tuple(acts.shape)}")
    if tuple(ranges.shape) != tuple(acts.shape[:2]):
        raise ValueError(f"ranges must be (B, T) = {tuple(acts.shape[:2])}; "
                         f"got {tuple(ranges.shape)}")
    if labels.dim() != 2 or labels.shape[0] != acts.shape[0]:
        raise ValueError(f"labels must be (B, L); got {tuple(labels.shape)}")
    _check_lengths(input_lengths, label_lengths, acts.shape[0])
    if acts.dtype not in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        raise TypeError(f"acts must be f32, f64, bf16 or f16; got {acts.dtype}")
    if not acts.is_contiguous():
        raise ValueError("acts must be contiguous")
    if fastemit_lambda < 0:
        raise ValueError(f"fastemit_lambda must be >= 0, got {fastemit_lambda}")
    if delay_penalty < 0:
        raise ValueError(f"delay_penalty must be >= 0, got {delay_penalty}")
    eng = _engine(implementation, acts)
    ranges, labels, input_lengths, label_lengths = _on_device(
        acts, ranges, labels, input_lengths, label_lengths)
    costs = _PrunedCosts.apply(acts, ranges.contiguous(), labels, input_lengths, label_lengths,
                               int(blank), eng, float(fastemit_lambda), float(delay_penalty))
    return _reduce(costs, reduction)
