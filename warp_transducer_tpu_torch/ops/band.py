"""The pruned (banded) RNN-T lattice, plain PyTorch.

Band cell (t, s) of a (B, T, S) band is lattice cell u = ranges[b, t] + s.
This module holds the plain versions of the four band kernels; on a CUDA
tensor the same functions are the kernels (``ops/cuda/band.py``,
``ops/cuda/ranges.py``):

* ``band_prep`` — one pass over the (B, T, S, V) band: denom, lpb and lpe
  per row (``csrc/band_prep.cu``);
* ``forward_backward`` — the t-major band recursion
  (``csrc/band_stream.cu``). The no-emit predecessor of (t, s) is
  (t-1, s + δ(t)), δ(t) = ranges[t] - ranges[t-1] ∈ [0, S); the emit
  predecessor is (t, s-1), a chain within the row solved with prefix scans:

      α(t, s) = c(s) + LSE_{j ≤ s}(ne(j) - c(j)),   c(s) = Σ_{k<s} lpe(t, k)

  with lpe clamped at ``CLAMP`` so the prefix sums keep their precision.
  β is the mirror (suffix scan), seeded with lpb at the terminal cell;
* ``band_grad`` — the gradient pass over the band (``csrc/band_grad.cu``);
* ``ranges_from_posteriors`` — the band starts from a lattice's
  posteriors: ``posterior_peaks`` (the argmax over u of α + β − ll), then
  ``band_starts`` (three scans over T) (``csrc/ranges.cu``).

The scans here are Hillis–Steele scans (log2 S shifted adds or log-sum-exps
over the whole row), the order the kernel's warp scans add in, so for
S <= 32 the two agree bit for bit. Semantics follow the JAX package's
``ops/pruned.py``: the finite sentinel ``NEG`` at invalid cells, the
validity mask (t < T_b) & (u < U_b), and ll_forward = NEG for an infeasible
band (no path inside it reaches the terminal cell).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gradients import Coefficients
from .lattice import _lse
from .prep import NEG

# Row-chain sentinel: kills a path (e^-1e4 = 0) without destroying f32
# precision in the prefix sums (the JAX package's _CLAMP).
CLAMP = -1.0e4


class BandPrep(NamedTuple):
    lpb: torch.Tensor  # (B, T, S) f32 blank log-probs
    lpe: torch.Tensor  # (B, T, S) f32 label log-probs, NEG where no label
    denom: torch.Tensor  # (B, T, S) f32 -logsumexp of each row


class BandLattice(NamedTuple):
    alphas: torch.Tensor  # (B, T, S)
    betas: torch.Tensor  # (B, T, S)
    ll_forward: torch.Tensor  # (B,)
    ll_backward: torch.Tensor  # (B,)


def band_labels(labels: torch.Tensor, ranges: torch.Tensor, S: int):
    """(lab_band, has_lab), both (B, T, S): the label of lattice row
    u = ranges[b, t] + s (0 where there is none) and whether it exists,
    u < L. ``labels``: (B, L) on the device of ``ranges``."""
    B, T = ranges.shape
    L = labels.shape[1]
    u = ranges.long()[:, :, None] + torch.arange(S, device=ranges.device)
    has_lab = u < L
    if L == 0:
        return torch.zeros((B, T, S), dtype=torch.int32, device=ranges.device), has_lab
    lab = torch.gather(labels.to(torch.int32)[:, None, :].expand(B, T, L), 2, u.clamp(0, L - 1))
    return torch.where(has_lab, lab, 0), has_lab


def label_rows(lab_band: torch.Tensor, has_lab: torch.Tensor) -> torch.Tensor:
    """The per-row label the band kernels read: (B, T, S) int32, -1 where
    the row has no label."""
    return torch.where(has_lab, lab_band, -1).to(torch.int32).contiguous()


def band_valid(ranges, input_lengths, label_lengths, S):
    """(B, T, S) mask of the band cells inside each utterance's lattice."""
    B, T = ranges.shape
    dev = ranges.device
    Tb = input_lengths.to(device=dev, dtype=torch.int64)[:, None, None]
    Ub = label_lengths.to(device=dev, dtype=torch.int64)[:, None, None] + 1
    t = torch.arange(T, device=dev)[None, :, None]
    u = ranges.long()[:, :, None] + torch.arange(S, device=dev)
    return (t < Tb) & (u < Ub)


def band_prep(acts: torch.Tensor, lab_row: torch.Tensor, blank: int) -> BandPrep:
    """Plain version of ``csrc/band_prep.cu``. acts: (B, T, S, V) in any
    float type, computed in f32; lab_row: (B, T, S) from ``label_rows``."""
    V = acts.shape[-1]
    x = acts.float()
    m = x.amax(dim=-1)
    denom = -(m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1)))
    lpb = x[..., blank] + denom
    lab = lab_row.long()
    has = (lab >= 0) & (lab < V)
    e = torch.gather(x, 3, torch.where(has, lab, 0)[..., None])[..., 0]
    lpe = torch.where(has, e + denom, NEG)
    return BandPrep(lpb.contiguous(), lpe.contiguous(), denom.contiguous())


def _shifted(x, d, s_iota):
    """out[:, s] = x[:, s + d] per row (d: (B,)), NEG outside [0, S)."""
    S = x.shape[1]
    idx = s_iota + d[:, None]
    ok = (idx >= 0) & (idx < S)
    return torch.where(ok, torch.gather(x, 1, idx.clamp(0, S - 1)), NEG)


def _scan_sum(x):
    """Inclusive prefix sum along dim 1, Hillis–Steele."""
    sh = 1
    while sh < x.shape[1]:
        x = torch.cat([x[:, :sh], x[:, sh:] + x[:, :-sh]], dim=1)
        sh *= 2
    return x


def _scan_lse(x):
    """Inclusive prefix log-sum-exp along dim 1, Hillis–Steele."""
    sh = 1
    while sh < x.shape[1]:
        x = torch.cat([x[:, :sh], _lse(x[:, sh:], x[:, :-sh])], dim=1)
        sh *= 2
    return x


def _scan_lse_rev(x):
    """Inclusive suffix log-sum-exp along dim 1, Hillis–Steele."""
    sh = 1
    while sh < x.shape[1]:
        x = torch.cat([_lse(x[:, :-sh], x[:, sh:]), x[:, -sh:]], dim=1)
        sh *= 2
    return x


def _excl_prefix(lpe_row):
    """Σ_{k<s} max(lpe, CLAMP): the inclusive scan shifted by one (never
    the inclusive sum minus the element)."""
    incl = _scan_sum(torch.clamp_min(lpe_row, CLAMP))
    return torch.nn.functional.pad(incl[:, :-1], (1, 0))


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor, ranges: torch.Tensor,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor) -> BandLattice:
    """Plain version of ``csrc/band_stream.cu``: α ascending and β
    descending over the T rows of the band. lpb, lpe: (B, T, S) f32;
    ranges: (B, T) band starts (monotone, steps < S)."""
    B, T, S = lpb.shape
    dev = lpb.device
    lpb = torch.clamp_min(lpb, NEG)
    r = ranges.to(device=dev, dtype=torch.int64)
    Tb = input_lengths.to(device=dev, dtype=torch.int64)
    Ub = label_lengths.to(device=dev, dtype=torch.int64) + 1
    s_iota = torch.arange(S, device=dev)[None, :]
    delta = torch.nn.functional.pad(r[:, 1:] - r[:, :-1], (1, 0))  # δ(t) at t, 0 at t = 0

    def valid(t):
        return (t < Tb[:, None]) & (r[:, t, None] + s_iota < Ub[:, None])

    alphas = torch.empty((B, T, S), dtype=lpb.dtype, device=dev)
    prev = torch.full((B, S), NEG, dtype=lpb.dtype, device=dev)  # α + lpb of row t-1
    for t in range(T):
        ne = _shifted(prev, delta[:, t], s_iota)
        if t == 0:
            ne[:, 0] = 0.0
        c = _excl_prefix(lpe[:, t])
        a = torch.where(valid(t), c + _scan_lse(ne - c), NEG)
        alphas[:, t] = a
        prev = a + lpb[:, t]

    betas = torch.empty_like(alphas)
    nxt = torch.full((B, S), NEG, dtype=lpb.dtype, device=dev)  # β of row t+1
    for t in range(T - 1, -1, -1):
        d_next = delta[:, t + 1] if t + 1 < T else torch.zeros_like(delta[:, 0])
        ne_b = _shifted(nxt, -d_next, s_iota) + lpb[:, t]
        terminal = (t == Tb[:, None] - 1) & (r[:, t, None] + s_iota == Ub[:, None] - 1)
        ne_b = torch.where(terminal, lpb[:, t], ne_b)
        pre = _excl_prefix(lpe[:, t])
        b = torch.where(valid(t), _scan_lse_rev(ne_b + pre) - pre, NEG)
        betas[:, t] = b
        nxt = b

    b_idx = torch.arange(B, device=dev)
    t_last = (Tb - 1).clamp(0, T - 1)
    s_star = Ub - 1 - r[b_idx, t_last]
    feasible = (s_star >= 0) & (s_star < S) & (Tb >= 1) & (Tb <= T)
    s_c = s_star.clamp(0, S - 1)
    ll_forward = torch.where(feasible, alphas[b_idx, t_last, s_c] + lpb[b_idx, t_last, s_c], NEG)
    return BandLattice(alphas, betas, ll_forward, betas[:, 0, 0].clone())


def band_coefs(lpb, lpe, lat: BandLattice, ranges, has_lab, input_lengths, label_lengths,
               scale, fastemit_lambda=0.0) -> Coefficients:
    """The (B, T, S) coefficient fields of the band gradient (the band twin
    of ``gradients.coefficients``), zero at invalid cells, with the (B,)
    cotangent ``scale`` and FastEmit folded in. An infeasible utterance
    (ll_forward is the NEG sentinel) gets zero fields: its a - ll
    cancellation is meaningless. Plain torch on every device."""
    B, T, S = lpb.shape
    dev = lpb.device
    Tb = input_lengths.to(device=dev, dtype=torch.int64)[:, None, None]
    Ub = label_lengths.to(device=dev, dtype=torch.int64)[:, None, None] + 1
    t = torch.arange(T, device=dev)[None, :, None]
    s_iota = torch.arange(S, device=dev)
    r = ranges.to(device=dev, dtype=torch.int64)
    u = r[:, :, None] + s_iota
    valid = (t < Tb) & (u < Ub)
    pad = torch.nn.functional.pad
    alphas, betas, ll = lat.alphas, lat.betas, lat.ll_forward
    # β(t, u+1) is band cell (t, s+1).
    bshift_u = torch.where(u + 1 < Ub, pad(betas[:, :, 1:], (0, 1), value=NEG), NEG)
    # β(t+1, u) is band cell (t+1, s - δ(t+1)).
    beta_next = pad(betas[:, 1:, :], (0, 0, 0, 1), value=NEG)
    d_next = pad(r[:, 1:] - r[:, :-1], (0, 1))[:, :, None]
    idx = s_iota - d_next
    bshift_t = torch.where((idx >= 0) & (idx < S),
                           torch.gather(beta_next, 2, idx.clamp(0, S - 1)), NEG)
    bshift_t = torch.where(t + 1 < Tb, bshift_t, NEG)
    terminal = (t == Tb - 1) & (u == Ub - 1)
    bshift_t = torch.where(terminal, 0.0, bshift_t)

    a_ll = alphas - ll[:, None, None]
    coef = torch.where(valid, torch.exp(a_ll + betas), 0.0)
    cb = torch.where(valid, torch.exp(a_ll + lpb + bshift_t), 0.0)
    ce = torch.where(valid & has_lab, torch.exp(a_ll + lpe + bshift_u), 0.0)
    if fastemit_lambda:
        coef = coef + fastemit_lambda * ce
        ce = ce * (1.0 + fastemit_lambda)
    feasible = (ll > NEG / 2)[:, None, None]
    sc = scale.to(device=dev, dtype=lpb.dtype)[:, None, None]
    return Coefficients(*(torch.where(feasible, f * sc, 0.0).contiguous()
                          for f in (coef, cb, ce)))


def band_grad(acts, denom, fields: Coefficients, lab_row, ranges, input_lengths,
              label_lengths, blank, out_dtype):
    """Plain version of ``csrc/band_grad.cu``: per valid row
    g = coef·exp(x + denom) − cb·[v = blank] − ce·[v = label], zero in
    invalid rows, in ``out_dtype``."""
    S, V = acts.shape[2], acts.shape[3]
    v = torch.arange(V, device=acts.device)
    valid = band_valid(ranges, input_lengths, label_lengths, S)
    g = fields.coef[..., None] * torch.exp(acts.float() + denom[..., None])
    g = g - torch.where(v == blank, fields.cb[..., None], 0.0)
    g = g - torch.where(v == lab_row[..., None].long(), fields.ce[..., None], 0.0)
    return torch.where(valid[..., None], g, 0.0).to(out_dtype)


def posterior_peaks(alphas, betas, ll):
    """(B, T) int32: per frame, the first u of largest posterior
    α + β − ll (torch.argmax returns the first maximum, as jnp.argmax)."""
    gamma = alphas + betas - ll[:, None, None]
    return torch.argmax(gamma, dim=2).to(torch.int32)


def ranges_from_posteriors(alphas, betas, ll, input_lengths, label_lengths, s_range: int):
    """Plain version of ``csrc/ranges.cu``: the band starts (B, T) int32 of
    ``band_starts`` from the ``posterior_peaks`` of one lattice's alphas,
    betas and ll (the JAX package's ``ranges_from_posteriors``)."""
    return band_starts(posterior_peaks(alphas, betas, ll), input_lengths, label_lengths, s_range)


def band_starts(best_u, input_lengths, label_lengths, s_range: int):
    """Band starts (B, T) int32 from the posterior peaks ``best_u`` (B, T),
    in three scans over T (the second half of ``csrc/ranges.cu``) —

    1. forward clamp: start at 0, monotone, steps <= S-1, at most
       max(U_b - S, 0); then the last frame T_b-1 is forced to that maximum
       so the band reaches the terminal cell;
    2. backward raise, so the forced end never needs a step > S-1;
    3. forward fix from 0 again (an infeasible utterance keeps its
       contract), then the value held beyond T_b-1 and clipped to U_b-1.

    Guarantees: ranges[:, 0] == 0, non-decreasing, steps <= S-1."""
    B, T = best_u.shape
    S = int(s_range)
    if S < 2:
        raise ValueError(f"s_range must be >= 2, got {S}")
    dev = best_u.device
    best = best_u.long()
    Tb = input_lengths.to(device=dev, dtype=torch.int64)
    Ub = label_lengths.to(device=dev, dtype=torch.int64) + 1
    hi = (Ub - S).clamp_min(0)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)

    def clamp_step(x, r_prev):
        return torch.minimum(torch.minimum(torch.maximum(x, r_prev), r_prev + (S - 1)), hi)

    raw = torch.minimum(torch.maximum(best - (S - 1) // 2, zero[:, None]), hi[:, None])
    out = torch.empty((B, T), dtype=torch.int64, device=dev)
    r = zero
    for t in range(T):
        r = clamp_step(raw[:, t], r)
        out[:, t] = r
    out[:, 0] = 0
    t_iota = torch.arange(T, device=dev)[None, :]
    out = torch.where(t_iota == (Tb - 1)[:, None], hi[:, None], out)
    r = out[:, T - 1]
    for t in range(T - 2, -1, -1):
        r = torch.maximum(out[:, t], r - (S - 1))
        out[:, t] = r
    out[:, 0] = 0
    r = zero
    for t in range(T):
        r = clamp_step(out[:, t], r)
        out[:, t] = r
    t_end = (Tb - 1).clamp(0, T - 1)
    r_end = torch.gather(out, 1, t_end[:, None])
    out = torch.where(t_iota >= (Tb - 1)[:, None], r_end, out)
    out = torch.minimum(torch.maximum(out, zero[:, None]), (Ub - 1).clamp_min(0)[:, None])
    return out.to(torch.int32)
