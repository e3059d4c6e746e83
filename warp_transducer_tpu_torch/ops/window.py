"""The pending-window lattice of the duration-arc losses (multi-blank,
TDT), plain PyTorch.

An arc of these lattices may cross several frames at once, so the
anti-diagonal wavefront of ``ops/lattice.py`` does not apply. The lattice is
walked row by row instead (t-major), with W = the longest duration:

* alpha keeps a window of W pending rows: the log-sum-exp of every arc that
  was sent from an earlier row and lands on rows t … t+W-1;
* beta keeps the last W beta rows;
* arcs that stay in the row (t, u) → (t, u+1) form a chain solved in prefix
  form, α(t, u) = c(u) + LSE_{j ≤ u}(ne(j) − c(j)), with c the exclusive
  prefix sum of the chain weight clamped at ``CLAMP`` (the mirror for beta).

Arc algebra (``WindowArcs``). A channel is one per-cell log-weight: channel
0 is ``lpb``, channel 1 is ``lpe``, channel 2 + k is ``extra[..., k]``. An
arc's weight is the sum of its channels.

* ``chain``: the channels of the within-row arc (t, u) → (t, u+1), or None
  when the lattice has none (then no chain is solved: running the clamped
  chain anyway would leak impossible paths at e^CLAMP);
* ``blank_arcs``: (m, channels) arcs (t, u) → (t+m, u), m >= 1; such an arc
  with t + m == T_b at u = U_b-1 ends the path;
* ``emit_arcs``: (m, channels) arcs (t, u) → (t+m, u+1), m >= 1.

Semantics kept from the JAX package (``ops/multiblank.py``, ``ops/tdt.py``
and ``ops/pallas/window_stream.py``): inputs clamped at the finite sentinel
``NEG``; cells outside (t < T_b) & (u < U_b) hold NEG; the start is
α(0, 0) = 0; ``ll_forward`` is the log-sum-exp of the terminal arcs
(starting from NEG); ``ll_backward`` = β(0, 0); a pending row is cleared
before the arcs of its own row are sent, because an arc with m = W lands on
the row that takes its place.

This is the plain version of ``csrc/window_stream.cu``; on a CUDA tensor the
kernel runs instead (``ops/cuda/window.py``). Counterpart of
``_multiblank_lattice``, ``_tdt_lattice`` and the Pallas ``_window_kernel``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .band import CLAMP
from .lattice import LatticeResult, _lse
from .prep import NEG

# The most channels an arc sums (the kernel's arc rows hold three). The
# lattice takes any number of channels and arcs.
MAX_ARC_CHANNELS = 3

Arc = Tuple[int, Tuple[int, ...]]


class WindowArcs(NamedTuple):
    chain: Optional[Tuple[int, ...]]
    blank_arcs: Tuple[Arc, ...]
    emit_arcs: Tuple[Arc, ...]

    @property
    def window(self) -> int:
        """W: the longest duration of any arc."""
        return max(m for m, _ in self.blank_arcs + self.emit_arcs)


def multiblank_arcs(durations) -> WindowArcs:
    """The arcs of the multi-blank lattice: the label arc is the chain, the
    standard blank is the m = 1 arc, big blank k (channel 2 + k) advances
    ``durations[k]`` frames."""
    blank = ((1, (0,)),) + tuple((int(m), (2 + k,)) for k, m in enumerate(durations))
    return WindowArcs(chain=(1,), blank_arcs=blank, emit_arcs=())


def tdt_arcs(durations) -> WindowArcs:
    """The arcs of the TDT lattice: duration j (channel 2 + j) pairs with
    the blank (d >= 1 only) and with the label; the d = 0 label arc is the
    chain, and without a 0 among the durations there is none."""
    chain, blank, emit = None, [], []
    for j, d in enumerate(durations):
        if d == 0:
            chain = (1, 2 + j)
        else:
            blank.append((int(d), (0, 2 + j)))
            emit.append((int(d), (1, 2 + j)))
    return WindowArcs(chain=chain, blank_arcs=tuple(blank), emit_arcs=tuple(emit))


def check_arcs(arcs: WindowArcs, n_extra: int) -> None:
    """Raise ValueError unless the arc table and the number of extra
    channels are what the lattice takes: any number of arcs and channels,
    each arc summing one to three distinct channels that exist."""
    if not arcs.blank_arcs:
        raise ValueError("the lattice needs at least one blank arc (none ends the path)")
    groups = [chs for _, chs in arcs.blank_arcs + arcs.emit_arcs]
    if arcs.chain is not None:
        groups.append(arcs.chain)
    for chs in groups:
        if not 1 <= len(chs) <= MAX_ARC_CHANNELS:
            raise ValueError(f"an arc sums 1 to {MAX_ARC_CHANNELS} channels, got {chs}")
        if any(c < 0 or c >= 2 + n_extra for c in chs) or len(set(chs)) != len(chs):
            raise ValueError(f"arc channels {chs} must be distinct and lie inside "
                             f"[0, {2 + n_extra})")
    if any(m < 1 for m, _ in arcs.blank_arcs + arcs.emit_arcs):
        raise ValueError("blank and emit arcs advance at least one frame")


def _excl_prefix(w):
    """Σ_{k<u} max(w, CLAMP) along dim 1: the inclusive sum shifted by one,
    never the inclusive sum minus the element."""
    incl = torch.cumsum(torch.clamp_min(w, CLAMP), dim=1)
    return torch.nn.functional.pad(incl[:, :-1], (1, 0))


def _shift_right(x):
    """out[:, u] = x[:, u-1]; column 0 gets NEG."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=NEG)


def _shift_left(x):
    """out[:, u] = x[:, u+1]; the last column gets NEG."""
    return torch.nn.functional.pad(x[:, 1:], (0, 1), value=NEG)


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor, extra: torch.Tensor,
                     arcs: WindowArcs, input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> LatticeResult:
    """Run the pending-window alpha (and optionally beta) recursions.

    Args:
      lpb, lpe: (B, T, U) channels 0 and 1.
      extra: (B, T, U, C) channels 2 … 2+C-1 (C may be 0).
      arcs: the arc table (``multiblank_arcs`` / ``tdt_arcs``).
      input_lengths, label_lengths: (B,) T_b and U_b - 1.
      compute_betas: False skips the backward sweep (score only); then
        ``betas`` is ``alphas`` and ``ll_backward`` is ``ll_forward``.
    """
    B, T, U = lpb.shape
    check_arcs(arcs, extra.shape[-1])
    dev, dtype = lpb.device, lpb.dtype
    W = arcs.window
    lpb = torch.clamp_min(lpb, NEG)
    lpe = torch.clamp_min(lpe, NEG)
    extra = torch.clamp_min(extra, NEG)
    Tb = input_lengths.to(device=dev, dtype=torch.int64)[:, None]  # (B, 1)
    Ub = label_lengths.to(device=dev, dtype=torch.int64)[:, None] + 1
    u = torch.arange(U, device=dev)[None, :]
    final = u == Ub - 1  # (B, U)
    in_u = u < Ub
    neg = torch.full((), NEG, dtype=dtype, device=dev)

    def weight(t, chs):
        """The summed channels of row t, (B, U)."""
        rows = [lpb[:, t] if c == 0 else lpe[:, t] if c == 1 else extra[:, t, :, c - 2]
                for c in chs]
        return sum(rows[1:], rows[0])

    # ---- alpha, rows ascending; pending[:, r % W] collects the arrivals of row r
    alphas = torch.empty((B, T, U), dtype=dtype, device=dev)
    pending = torch.full((B, W, U), NEG, dtype=dtype, device=dev)
    ll_forward = torch.full((B,), NEG, dtype=dtype, device=dev)
    for t in range(T):
        slot = t % W
        ne = pending[:, slot].clone()
        if t == 0:
            ne[:, 0] = 0.0
        if arcs.chain is not None:
            c = _excl_prefix(weight(t, arcs.chain))
            a = c + torch.logcumsumexp(ne - c, dim=1)
        else:
            a = ne
        valid = (t < Tb) & in_u
        a = torch.where(valid, a, neg)
        alphas[:, t] = a
        pending[:, slot] = NEG  # before the arcs: one with m = W lands on this slot
        for m, chs in arcs.blank_arcs:
            dep = a + weight(t, chs)
            s = (slot + m) % W
            pending[:, s] = _lse(pending[:, s], dep)
            # the arc that lands exactly on T_b from the last label ends the path
            cand = torch.where(final & valid, dep, neg).amax(dim=1)
            ll_forward = torch.where(t + m == Tb[:, 0], _lse(ll_forward, cand), ll_forward)
        for m, chs in arcs.emit_arcs:
            s = (slot + m) % W
            pending[:, s] = _lse(pending[:, s], _shift_right(a + weight(t, chs)))
    if not compute_betas:
        return LatticeResult(alphas, alphas, ll_forward, ll_forward)

    # ---- beta, rows descending; window[:, r % W] holds beta row r
    betas = torch.empty((B, T, U), dtype=dtype, device=dev)
    window = torch.full((B, W, U), NEG, dtype=dtype, device=dev)
    for r in range(T - 1, -1, -1):
        slot = r % W
        nb = torch.full((B, U), NEG, dtype=dtype, device=dev)
        for m, chs in arcs.blank_arcs:
            w = weight(r, chs)
            nb = _lse(nb, w + window[:, (slot + m) % W])
            nb = _lse(nb, torch.where((r + m == Tb) & final, w, neg))
        for m, chs in arcs.emit_arcs:
            nb = _lse(nb, weight(r, chs) + _shift_left(window[:, (slot + m) % W]))
        if arcs.chain is not None:
            c = _excl_prefix(weight(r, arcs.chain))
            b = torch.logcumsumexp((nb + c).flip(1), dim=1).flip(1) - c
        else:
            b = nb
        b = torch.where((r < Tb) & in_u, b, neg)
        betas[:, r] = b
        window[:, slot] = b
    return LatticeResult(alphas, betas, ll_forward, betas[:, 0, 0].clone())
