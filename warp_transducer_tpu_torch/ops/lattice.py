"""Anti-diagonal (wavefront) RNN-T lattice recursions, plain PyTorch.

alpha(t, u) = lse(alpha(t-1, u) + lpb(t-1, u), alpha(t, u-1) + lpe(t, u-1))
beta(t, u)  = lse(beta(t+1, u) + lpb(t, u),   beta(t, u+1) + lpe(t, u))

Every cell of anti-diagonal n = t + u depends only on diagonal n-1 (alpha)
or n+1 (beta), so each step below updates one whole diagonal of the
(B, T, U) arrays at once, read and written in place at t = n - u. No
skewed copy is made: that was a TPU layout device.

Semantics kept from the Pallas kernels (``ops/pallas/wavefront.py``):
the finite sentinel ``NEG`` for every invalid cell and ±inf-free
arithmetic, inputs clamped to >= NEG, the validity mask
``(t >= 0) & (t < T_b) & (u < U_b)``, ``ll_forward`` read at the terminal
cell (T_b-1, U_b-1), beta seeded there by a masked overwrite, and
``ll_backward = beta(0, 0)``.

This is the plain version of ``csrc/wavefront.cu``; on a CUDA tensor the
kernel runs instead (``ops/cuda/wavefront.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .prep import NEG


class LatticeResult(NamedTuple):
    alphas: torch.Tensor  # (B, T, U) forward log-probabilities
    betas: torch.Tensor  # (B, T, U) backward log-probabilities
    ll_forward: torch.Tensor  # (B,) total log-likelihood from alphas
    ll_backward: torch.Tensor  # (B,) total log-likelihood from betas


def _lse(a, b):
    """log(exp(a) + exp(b)) for finite inputs (sentinel NEG, never ±inf)."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-torch.abs(a - b)))


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> LatticeResult:
    """Run the wavefront alpha (and optionally beta) recursions.

    Args:
      lpb: (B, T, U) log-prob of emitting blank at each cell.
      lpe: (B, T, U) log-prob of emitting the next label; column U-1 unused.
      input_lengths: (B,) valid T per utterance.
      label_lengths: (B,) label count per utterance (U_b = len + 1).
      compute_betas: False skips the backward sweep (the scoring path);
        then ``betas`` is ``alphas`` and ``ll_backward`` is ``ll_forward``.
    """
    B, T, U = lpb.shape
    N = T + U - 1
    dev, dtype = lpb.device, lpb.dtype
    lpb = torch.clamp_min(lpb, NEG)
    lpe = torch.clamp_min(lpe, NEG)
    Tb = input_lengths.to(device=dev, dtype=torch.int64)[:, None]  # (B, 1)
    Ub = label_lengths.to(device=dev, dtype=torch.int64)[:, None] + 1
    u = torch.arange(U, device=dev)
    neg = torch.full((), NEG, dtype=dtype, device=dev)

    def diagonal(n):
        t = n - u
        in_range = (t >= 0) & (t < T)  # (U,) the cells diagonal n has
        valid = in_range & (t < Tb) & (u < Ub)  # (B, U)
        return t.clamp(0, T - 1), in_range, valid

    alphas = torch.full((B, T, U), NEG, dtype=dtype, device=dev)
    alphas[:, 0, 0] = 0.0
    u_prev = (u - 1).clamp_min(0)
    for n in range(1, N):
        t, in_range, valid = diagonal(n)
        t_prev = (t - 1).clamp_min(0)
        no_emit = alphas[:, t_prev, u] + lpb[:, t_prev, u]
        no_emit = torch.where((n - u) >= 1, no_emit, neg)
        emit = alphas[:, t, u_prev] + lpe[:, t, u_prev]
        emit = torch.where(u >= 1, emit, neg)
        a = torch.where(valid, _lse(no_emit, emit), neg)
        alphas[:, t, u] = torch.where(in_range, a, alphas[:, t, u])

    b_idx = torch.arange(B, device=dev)
    t_last, u_last = Tb[:, 0] - 1, Ub[:, 0] - 1
    final_lpb = lpb[b_idx, t_last, u_last]
    ll_forward = alphas[b_idx, t_last, u_last] + final_lpb
    if not compute_betas:
        return LatticeResult(alphas, alphas, ll_forward, ll_forward)

    betas = torch.full((B, T, U), NEG, dtype=dtype, device=dev)
    n_seed = Tb + Ub - 2  # (B, 1) diagonal of the terminal cell
    is_final = u == Ub - 1  # (B, U)
    u_next = (u + 1).clamp_max(U - 1)
    for n in range(N - 1, -1, -1):
        t, in_range, valid = diagonal(n)
        t_next = (t + 1).clamp_max(T - 1)
        no_emit = betas[:, t_next, u] + lpb[:, t, u]
        no_emit = torch.where((n - u) + 1 < T, no_emit, neg)
        emit = betas[:, t, u_next] + lpe[:, t, u]
        emit = torch.where(u + 1 < U, emit, neg)
        b = torch.where(valid, _lse(no_emit, emit), neg)
        b = torch.where((n == n_seed) & is_final, lpb[:, t, u], b)
        betas[:, t, u] = torch.where(in_range, b, betas[:, t, u])
    return LatticeResult(alphas, betas, ll_forward, betas[:, 0, 0].clone())
