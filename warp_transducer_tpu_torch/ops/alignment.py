"""Viterbi forced alignment over the RNN-T lattices, plain PyTorch.

The most likely monotonic alignment of an utterance to its transcript: the
max-plus analog of a loss's forward recursion (log-sum-exp replaced by
max), then a backtrace that recovers the path. Counterpart of
``warp_transducer_tpu/ops/alignment.py``, for the three lattices:

* ``rnnt_viterbi_align``: the dense lattice (``rnnt_loss``), swept along
  the T+U-1 anti-diagonals as ``ops/lattice.py`` does, in place in a
  (B, T, U) array; ``path`` holds 1 = emit, 0 = frame advance, -1 = pad;
* ``tdt_viterbi_align``: the TDT lattice (``rnnt_loss_tdt``), row by row
  with a window of pending rows as ``ops/window.py`` does; it returns each
  label's frame and duration;
* ``multiblank_viterbi_align``: the multi-blank lattice
  (``rnnt_loss_multiblank``), the same walk; ``path`` holds 0 = emit,
  m >= 1 = a blank of m frames, -1 = pad.

Ties go where the JAX package sends them: the dense backtrace takes the
emit arc when the two arcs are equal; the TDT and multi-blank backtraces
take the first strict maximum in their arc order (``torch.argmax``, which
returns the first maximum); a terminal arc replaces the best one only when
it is strictly larger.

The prep is the losses' (``prep.prepare``, ``multiblank._multiblank_prep``,
``tdt._tdt_prep``): ``csrc/prep.cu`` on a CUDA tensor unless
``implementation="torch"``. The recursions and the backtraces are torch
loops on every device (T+U-1 or T steps, then up to T+U), with no host
sync. The port's prep marks a missing label log-prob with the finite
``NEG``; the duration-arc alignments turn it into an exact -inf before the
max-plus pass, as the JAX package does, so that an utterance no path fits
scores -inf. The results are integer tensors, so nothing here is
differentiable: every function runs under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .multiblank import _multiblank_prep, _resolve_indices
from .prep import device_ints
from .rnnt import _certify_inputs, _engine, _on_device
from .tdt import _check_durations, _tdt_prep


class ViterbiAlignment(NamedTuple):
    score: torch.Tensor  # (B,) log-prob of the best path
    # (B, U-1) int32: frame index where label u was emitted (-1 beyond
    # label_lengths)
    emit_frames: torch.Tensor
    # (B, N) int32: 1 = emit, 0 = frame advance, -1 = beyond the
    # utterance's path length (N = T+U-1)
    path: torch.Tensor


class TDTViterbiAlignment(NamedTuple):
    score: torch.Tensor  # (B,) log-prob of the best path
    # (B, U-1) int32: frame where label u was emitted (-1 beyond
    # label_lengths)
    emit_frames: torch.Tensor
    # (B, U-1) int32: duration chosen by that emission (-1 beyond
    # label_lengths)
    emit_durations: torch.Tensor


class MultiblankViterbiAlignment(NamedTuple):
    score: torch.Tensor  # (B,) log-prob of the best path
    # (B, U-1) int32: frame where label u was emitted (-1 beyond
    # label_lengths)
    emit_frames: torch.Tensor
    # (B, N) int32; the encoding differs from ViterbiAlignment.path:
    # 0 = emit, m >= 1 = blank advancing m frames, -1 = padding
    path: torch.Tensor


def _scatter_steps(B, width, index, values, fill=-1):
    """A (B, width) int32 tensor of ``fill`` with ``values[k, b]`` written at
    column ``index[k, b]`` for every step k; an index of ``width`` goes to a
    spare column that is cut off (the JAX ``mode="drop"`` scatter)."""
    out = torch.full((B, width + 1), fill, dtype=torch.int32, device=index.device)
    out.scatter_(1, index.t().long(), values.t().to(torch.int32))
    return out[:, :width].contiguous()


def _iotas(input_lengths, label_lengths, U, device):
    Tb = input_lengths.to(device=device, dtype=torch.int64)
    Ub = label_lengths.to(device=device, dtype=torch.int64) + 1
    return Tb, Ub, torch.arange(Tb.shape[0], device=device), torch.arange(U, device=device)


@torch.no_grad()
def rnnt_viterbi_align(acts, labels, input_lengths, label_lengths, blank: int = 0,
                       log_probs_input: bool = False,
                       implementation: str = "auto") -> ViterbiAlignment:
    """Best monotonic alignment of each utterance to its transcript.

    Args mirror ``rnnt_loss``; ``implementation`` ('auto' | 'torch' |
    'cuda', ``ops/rnnt.py``) picks the prep. Returns a
    ``ViterbiAlignment``; ``score`` is the log-probability of the single
    best path (<= the total log-likelihood the loss integrates over all
    paths), in the input's dtype.
    """
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    B, T, U, _ = acts.shape
    N = T + U - 1
    prepped = eng.prepare(acts, labels, int(blank), bool(log_probs_input))
    lpb, lpe = prepped.lpb, prepped.lpe
    dev, dtype = lpb.device, lpb.dtype
    Tb, Ub, batch, u = _iotas(input_lengths, label_lengths, U, dev)
    neg = torch.full((), -torch.inf, dtype=dtype, device=dev)

    # ---- max-plus forward along the anti-diagonals n = t + u ------------------
    alphas = torch.full((B, T, U), -torch.inf, dtype=dtype, device=dev)
    alphas[:, 0, 0] = 0.0
    u_prev = (u - 1).clamp_min(0)
    for n in range(1, N):
        t = n - u
        in_range = (t >= 0) & (t < T)  # (U,) the cells diagonal n has
        valid = in_range & (t < Tb[:, None]) & (u < Ub[:, None])  # (B, U)
        t = t.clamp(0, T - 1)
        t_prev = (t - 1).clamp_min(0)
        no_emit = torch.where(n - u >= 1, alphas[:, t_prev, u] + lpb[:, t_prev, u], neg)
        # the emit arc reads lpe up to column U-2 only: column U-1's sentinel never enters
        emit = torch.where(u >= 1, alphas[:, t, u_prev] + lpe[:, t, u_prev], neg)
        a = torch.where(valid, torch.maximum(no_emit, emit), neg)
        alphas[:, t, u] = torch.where(in_range, a, alphas[:, t, u])
    t_last, u_last = Tb - 1, Ub - 1
    score = alphas[batch, t_last, u_last] + lpb[batch, t_last, u_last]

    # ---- backtrace from (T_b-1, U_b-1) to (0, 0): N-1 steps; finished
    # utterances idle on (0, 0) ----------------------------------------------
    t, uu = t_last, u_last
    recs, steps, emitted, frames = [], [], [], []
    for _ in range(N - 1):
        n = t + uu
        active = n > 0
        tm1, um1 = (t - 1).clamp_min(0), (uu - 1).clamp_min(0)
        a_no_emit = torch.where(t >= 1, alphas[batch, tm1, uu] + lpb[batch, tm1, uu], neg)
        a_emit = torch.where(uu >= 1, alphas[batch, t, um1] + lpe[batch, t, um1], neg)
        took_emit = active & (a_emit >= a_no_emit)
        recs.append(torch.where(active, took_emit.to(torch.int32), -1))
        steps.append(torch.where(active, n - 1, N))  # inactive steps go to the spare column
        # a label index below 0 (an emit at u = 0, only between two -inf arcs) is dropped
        emitted.append(torch.where(took_emit & (uu >= 1), uu - 1, U - 1))
        frames.append(torch.where(took_emit, t, -1))
        uu = torch.where(took_emit, uu - 1, uu)
        t = torch.where(active & ~took_emit, t - 1, t)
    if N > 1:
        path = _scatter_steps(B, N, torch.stack(steps), torch.stack(recs))
        emit_frames = _scatter_steps(B, U - 1, torch.stack(emitted), torch.stack(frames))
    else:
        path = torch.full((B, N), -1, dtype=torch.int32, device=dev)
        emit_frames = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return ViterbiAlignment(score=score.to(acts.dtype), emit_frames=emit_frames, path=path)


def _chain_max(ne, w):
    """max_{j <= u}(ne(j) + sum_{j <= i < u} w(i)) for every u: the in-row
    chain of a max-plus row, as c + cummax(ne - c) with c the exclusive
    prefix sum of w built by a shift (a -inf weight counts as -1e9, as in
    the JAX package)."""
    c = torch.cumsum(torch.where(torch.isfinite(w), w, torch.full_like(w, -1e9)), dim=1)
    c = torch.nn.functional.pad(c[:, :-1], (1, 0))
    return c + torch.cummax(ne - c, dim=1).values


def _window_rows(T, B, W, U, neg, row, dtype, dev):
    """The row walk of the duration-arc forward: ``row(t, ne)`` returns the
    row v_t (masked) and the departures [(m, dep)] it sends m rows ahead;
    a window of W pending rows collects them by max. Returns v (B, T, U)."""
    P = torch.full((B, W, U), -torch.inf, dtype=dtype, device=dev)
    rows = []
    for t in range(T):
        ne = P[:, 0]
        if t == 0:
            ne = ne.clone()
            ne[:, 0] = 0.0
        v_t, departures = row(t, ne)
        P = torch.cat([P[:, 1:], neg.expand(B, 1, U)], dim=1)
        for m, dep in departures:
            P[:, m - 1] = torch.maximum(P[:, m - 1], dep)
        rows.append(v_t)
    return torch.stack(rows, dim=1)


@torch.no_grad()
def tdt_viterbi_align(token_logits, duration_logits, labels, input_lengths, label_lengths,
                      durations, blank: int = 0, sigma: float = 0.0,
                      implementation: str = "auto") -> TDTViterbiAlignment:
    """Best TDT alignment: the max-plus analog of ``rnnt_loss_tdt``'s
    recursion plus a backtrace that recovers, for every emitted label, the
    frame it was emitted at and the duration the duration head gave it.

    Args mirror ``rnnt_loss_tdt``; ``implementation`` picks the token
    head's prep. ``score`` is the log-probability of the single best path
    (<= -rnnt_loss_tdt, which integrates over all paths), -inf for an
    utterance whose frames no combination of durations consumes.
    """
    durs = _check_durations(durations)
    if duration_logits.shape[:3] != token_logits.shape[:3] or \
            duration_logits.shape[-1] != len(durs):
        raise ValueError(f"duration_logits {tuple(duration_logits.shape)} does not match "
                         f"token_logits {tuple(token_logits.shape)} and {len(durs)} durations")
    _certify_inputs(token_logits, labels, input_lengths, label_lengths)
    eng = _engine(implementation, token_logits)
    labels, input_lengths, label_lengths = _on_device(token_logits, labels, input_lengths,
                                                      label_lengths)
    B, T, U, _ = token_logits.shape
    lpb, lpe, lpd, _ = _tdt_prep(eng, token_logits, duration_logits, labels, int(blank),
                                 float(sigma))
    dev, dtype = lpb.device, lpb.dtype
    neg = torch.full((), -torch.inf, dtype=dtype, device=dev)
    lpe = torch.where(lpe < -1e29, neg, lpe)  # exact -inf for max-plus
    Tb, Ub, batch, u_iota = _iotas(input_lengths, label_lengths, U, dev)
    in_lattice = u_iota < Ub[:, None]
    j0 = durs.index(0) if 0 in durs else None

    # ---- max-plus forward: the LSE window walk of ops/window.py with max ----
    def row(t, ne):
        lpb_t, lpe_t, lpd_t = lpb[:, t], lpe[:, t], lpd[:, t]
        v_t = ne if j0 is None else _chain_max(ne, lpe_t + lpd_t[..., j0])
        v_t = torch.where(in_lattice & (t < Tb[:, None]), v_t, neg)
        departures = []
        for j, d in enumerate(durs):
            if d < 1:
                continue
            tok = torch.nn.functional.pad((v_t + lpe_t + lpd_t[..., j])[:, :-1], (1, 0),
                                          value=-torch.inf)
            departures.append((d, torch.maximum(v_t + lpb_t + lpd_t[..., j], tok)))
        return v_t, departures

    v = _window_rows(T, B, max(durs), U, neg, row, dtype, dev)

    # ---- terminal arcs: the score and the backtrace's start cell ---------------
    u_star = (Ub - 1).clamp(0, U - 1)
    score = neg.expand(B).clone()
    final_t = torch.zeros(B, dtype=torch.int64, device=dev)
    for j, d in enumerate(durs):
        if d < 1:
            continue
        tk = (Tb - d).clamp(0, T - 1)
        cand = torch.where(Tb - d >= 0,
                           v[batch, tk, u_star] + lpb[batch, tk, u_star]
                           + lpd[batch, tk, u_star, j], neg)
        final_t = torch.where(cand > score, tk, final_t)
        score = torch.maximum(score, cand)

    # ---- backtrace: from the best terminal arc, the first strict maximum of
    # the incoming arcs, token then blank for each duration; <= T+U steps,
    # finished utterances idle at (0, 0) ------------------------------------------
    d_all = device_ints(durs, dev)
    D = len(durs)
    jj = torch.arange(D, device=dev).expand(B, D)
    b2 = batch[:, None].expand(B, D)
    blank_ok = d_all >= 1
    t, u = final_t, u_star
    emitted, frames, chosen = [], [], []
    for _ in range(T + U):
        active = (t > 0) | (u > 0)
        tp = t[:, None] - d_all  # (B, D) the source frame of each duration's arcs
        tpc = tp.clamp(0, T - 1)
        up = (u - 1).clamp(0, U - 1)[:, None].expand(B, D)
        uc = u.clamp(0, U - 1)[:, None].expand(B, D)
        s_tok = torch.where((tp >= 0) & (u[:, None] >= 1),
                            v[b2, tpc, up] + lpe[b2, tpc, up] + lpd[b2, tpc, up, jj], neg)
        s_bl = torch.where((tp >= 0) & blank_ok,
                           v[b2, tpc, uc] + lpb[b2, tpc, uc] + lpd[b2, tpc, uc, jj], neg)
        cands = torch.stack((s_tok, s_bl), dim=-1).reshape(B, 2 * D)  # tok_0, bl_0, tok_1, …
        k = torch.argmax(cands, dim=1)  # the first maximum
        found = cands.gather(1, k[:, None])[:, 0] > neg  # a strict update happened
        j = k // 2
        took_tok = active & found & (k % 2 == 0)
        best_t = torch.where(found, tpc.gather(1, j[:, None])[:, 0], 0)
        emitted.append(torch.where(took_tok, u - 1, U - 1))
        frames.append(best_t)
        chosen.append(torch.where(found, d_all[j], 0))
        t = torch.where(active, best_t, t)
        u = torch.where(took_tok, u - 1, u)
    if U > 1:
        idx = torch.stack(emitted)
        ef = _scatter_steps(B, U - 1, idx, torch.stack(frames))
        ed = _scatter_steps(B, U - 1, idx, torch.stack(chosen))
    else:
        ef = ed = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return TDTViterbiAlignment(score=score.to(token_logits.dtype), emit_frames=ef,
                               emit_durations=ed)


@torch.no_grad()
def multiblank_viterbi_align(acts, labels, input_lengths, label_lengths, big_blank_durations,
                             blank: int = 0, big_blank_indices=None, sigma: float = 0.0,
                             implementation: str = "auto") -> MultiblankViterbiAlignment:
    """Best multi-blank alignment (arXiv:2211.03541): the max-plus analog
    of ``rnnt_loss_multiblank``'s recursion plus a backtrace. Its ``path``
    records, per step, the frames that step consumed (0 = emit, m >= 1 = a
    blank advancing m frames, -1 = padding); this differs on purpose from
    the dense ``ViterbiAlignment.path`` (1 = emit, 0 = advance), which
    cannot express multi-frame blanks.

    Args mirror ``rnnt_loss_multiblank``; ``implementation`` picks the
    prep.
    """
    _certify_inputs(acts, labels, input_lengths, label_lengths)
    B, T, U, V = acts.shape
    durs, idx = _resolve_indices(V, int(blank), big_blank_durations, big_blank_indices)
    eng = _engine(implementation, acts)
    labels, input_lengths, label_lengths = _on_device(acts, labels, input_lengths,
                                                      label_lengths)
    lpb, lpe, lpB, _ = _multiblank_prep(eng, acts, labels, int(blank), idx, float(sigma))
    dev, dtype = lpb.device, lpb.dtype
    neg = torch.full((), -torch.inf, dtype=dtype, device=dev)
    lpe = torch.where(lpe < -1e29, neg, lpe)  # exact -inf for max-plus
    Tb, Ub, batch, u_iota = _iotas(input_lengths, label_lengths, U, dev)
    in_lattice = u_iota < Ub[:, None]
    all_durs = (1,) + durs  # the blank arc families: the standard blank, then the big blanks
    arcs = torch.cat((lpb[..., None], lpB), dim=-1)  # (B, T, U, 1+K), one weight a family

    # ---- max-plus forward -------------------------------------------------------
    def row(t, ne):
        v_t = torch.where(in_lattice & (t < Tb[:, None]), _chain_max(ne, lpe[:, t]), neg)
        return v_t, [(m, v_t + arcs[:, t, :, j]) for j, m in enumerate(all_durs)]

    v = _window_rows(T, B, max(durs) if durs else 1, U, neg, row, dtype, dev)

    # ---- terminal arcs ------------------------------------------------------------
    u_star = (Ub - 1).clamp(0, U - 1)
    score = neg.expand(B).clone()
    final_t = torch.zeros(B, dtype=torch.int64, device=dev)
    for j, m in enumerate(all_durs):
        tk = (Tb - m).clamp(0, T - 1)
        cand = torch.where(Tb - m >= 0, v[batch, tk, u_star] + arcs[batch, tk, u_star, j], neg)
        final_t = torch.where(cand > score, tk, final_t)
        score = torch.maximum(score, cand)

    # ---- backtrace: the first strict maximum of the emit arc, then the blank
    # families; N steps. The terminal blank, which consumes the last T_b -
    # final_t frames, is the path's last step; the steps are recorded from
    # the end and reversed at the end ------------------------------------------------
    N = T + U - 1
    A = len(all_durs)
    m_all = device_ints(all_durs, dev)
    jj = torch.arange(A, device=dev).expand(B, A)
    b2 = batch[:, None].expand(B, A)
    t, u = final_t, u_star
    k = torch.ones(B, dtype=torch.int64, device=dev)
    slots, codes, emitted, frames = [torch.zeros_like(k)], [Tb - final_t], [], []
    for _ in range(N):
        active = (t > 0) | (u > 0)
        up = (u - 1).clamp(0, U - 1)
        s_e = torch.where(u >= 1, v[batch, t, up] + lpe[batch, t, up], neg)
        tp = t[:, None] - m_all
        tpc = tp.clamp(0, T - 1)
        u2 = u[:, None].expand(B, A)
        s_b = torch.where(tp >= 0, v[b2, tpc, u2] + arcs[b2, tpc, u2, jj], neg)
        # the first maximum; none finite leaves the emit arc, as the JAX default does
        best = torch.argmax(torch.cat((s_e[:, None], s_b), dim=1), dim=1)
        jb = (best - 1).clamp_min(0)
        best_adv = torch.where(best > 0, m_all[jb], 0)
        took_emit = active & (best == 0)
        slots.append(torch.where(active, k, N))
        codes.append(torch.where(active, best_adv, -1))
        emitted.append(torch.where(took_emit, (u - 1).clamp(0, max(U - 2, 0)), U - 1))
        frames.append(t)
        t = torch.where(active & ~took_emit, tpc.gather(1, jb[:, None])[:, 0], t)
        u = torch.where(took_emit, u - 1, u)
        k = torch.where(active, k + 1, k)
    path_rev = _scatter_steps(B, N, torch.stack(slots), torch.stack(codes))
    # step j of the path is step k-1-j from the end
    src = k[:, None] - 1 - torch.arange(N, device=dev)
    path = torch.where(src >= 0, path_rev.gather(1, src.clamp(0, N - 1)), -1).to(torch.int32)
    if U > 1:
        ef = _scatter_steps(B, U - 1, torch.stack(emitted), torch.stack(frames))
    else:
        ef = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return MultiblankViterbiAlignment(score=score.to(acts.dtype), emit_frames=ef, path=path)
