"""Input preparation: fused log-softmax denominator and blank/label caches.

One pass over the (B, T, U, V) activations produces three (B, T, U) arrays:

* ``denom[b,t,u] = -logsumexp_v acts[b,t,u,v]``;
* ``lpb = acts[..., blank] + denom``;
* ``lpe = acts[..., y_u] + denom``, column U-1 set to the finite sentinel
  ``NEG`` (there is no label to emit from the last row);

and, for K extra columns (the big blanks of the multi-blank loss), one
(B, T, U, K) array ``extras[..., k] = acts[..., extra_cols[k]] + denom``,
so the O(T·U) recursion never touches the alphabet axis. ``prepare`` here is
the plain PyTorch version; on a CUDA tensor the same function is the
``prep.cu`` kernel (``ops/cuda/prep.py``). Counterpart of
``warp_transducer_tpu/ops/prep.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Large finite negative: behaves as -inf under log-sum-exp but keeps the
# arithmetic NaN-free (exp(NEG - x) flushes to 0, NEG + NEG stays finite).
NEG = -1.0e30


class PreparedInputs(NamedTuple):
    lpb: torch.Tensor  # (B, T, U) blank log-probs
    lpe: torch.Tensor  # (B, T, U) label log-probs (column U-1 is NEG)
    denom: Optional[torch.Tensor]  # (B, T, U) -logsumexp(acts), or None
    # (B, T, U, K) log-probs of the extra columns (K = 0: an empty last axis)
    extras: Optional[torch.Tensor] = None
    # (B, T, U, D) raw logits of the duration head (the fused joint's prep only)
    dur: Optional[torch.Tensor] = None


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 computes in f64; f32, bf16 and f16 compute in f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _pad_labels(labels: torch.Tensor, U: int) -> torch.Tensor:
    """Pad/truncate (B, L) labels to exactly (B, U-1)."""
    L = labels.shape[1]
    if L >= U - 1:
        return labels[:, : U - 1]
    return torch.nn.functional.pad(labels, (0, U - 1 - L))


def label_rows(labels: torch.Tensor, U: int) -> torch.Tensor:
    """(B, L) labels -> (B, U) int32 per-row labels; column U-1 is 0 and
    never read as a label (lpe there is NEG, ce there is 0)."""
    lab = _pad_labels(labels.to(torch.int32), U)
    return torch.nn.functional.pad(lab, (0, 1)).contiguous()


def device_ints(values, device, dtype=torch.int64) -> torch.Tensor:
    """A short integer tensor made on ``device`` by one ``fill_`` an entry:
    unlike ``torch.tensor(values, device=...)`` or ``out[i] = v`` (a copy
    into a 0-dim view), it copies nothing from the host, so it does not wait
    for the card."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(int(v))
    return out


def check_extra_cols(extra_cols, V: int) -> tuple:
    """The extra columns as a tuple of ints, each inside [0, V); any number
    of them."""
    cols = tuple(int(c) for c in extra_cols)
    if any(c < 0 or c >= V for c in cols):
        raise ValueError(f"extra columns {cols} must lie inside [0, V={V})")
    return cols


def prepare(acts: torch.Tensor, labels: torch.Tensor, blank: int,
            log_probs_input: bool, extra_cols=()) -> PreparedInputs:
    """Plain PyTorch prep (the plain version of ``csrc/prep.cu``).

    Args:
      acts: (B, T, U, V) raw activations, or log-probs when
        ``log_probs_input`` (then ``denom`` is None and lpb/lpe are read
        directly).
      labels: (B, L) integer targets, L >= U-1.
      blank: blank symbol index.
      extra_cols: K further column indices to read beside blank and label.
    """
    B, T, U, V = acts.shape
    cols = check_extra_cols(extra_cols, V)
    x = acts.to(compute_dtype(acts.dtype))
    lab = label_rows(labels, U).to(torch.int64)
    # A label outside [0, V) selects nothing (NEG), as the masked select of
    # the JAX prep does.
    in_range = (lab >= 0) & (lab < V)
    idx = torch.where(in_range, lab, torch.zeros_like(lab))
    idx = idx[:, None, :, None].expand(B, T, U, 1)
    e = torch.gather(x, 3, idx)[..., 0]
    e = torch.where(in_range[:, None, :], e, torch.full_like(e, NEG))
    lpb = x[..., blank]
    extras = x[..., list(cols)]
    if log_probs_input:
        denom = None
    else:
        m = x.amax(dim=-1)
        denom = -(m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1)))
        lpb = lpb + denom
        e = e + denom
        extras = extras + denom[..., None]
    last = torch.arange(U, device=x.device) == U - 1
    lpe = torch.where(last, torch.full_like(e, NEG), e)
    return PreparedInputs(lpb=lpb.contiguous(), lpe=lpe.contiguous(),
                          denom=denom, extras=extras.contiguous())


def delay_shift(lpe: torch.Tensor, input_lengths: torch.Tensor,
                delay_penalty: float) -> torch.Tensor:
    """Delay-penalized transducer (arXiv:2211.00490): add
    λ·((T_b-1)/2 - t) to every emit log-weight. Applied after prep, so the
    closed-form gradient stays exact (the lattice and the coefficient
    fields both see the shifted arc weight). lpe: (B, T, U)."""
    dtype = lpe.dtype
    T = lpe.shape[1]
    t = torch.arange(T, dtype=dtype, device=lpe.device)
    mid = (input_lengths.to(dtype) - 1) / 2
    shift = delay_penalty * (mid[:, None] - t[None, :])
    return lpe + shift[:, :, None]
