"""The schedule of the window lattice kernel (csrc/window_stream.cu), pure
Python, on the CPU.

The kernel plans its launch itself; ``ops/cuda/window.py::plan`` mirrors
that plan (a card test holds it against the C entry). Here:

* the plan: cells a lane (odd), utterances a block, the warps' shared
  memory (copy ring, departure rings, staged rows, beta's ring), and the
  switch to the block kernel above the cap (f32 U > 544, f64 U > 288), where
  an utterance's rings do not fit a block, or for 32-bit offsets;
* a numpy emulation of the warp kernel over that plan: a warp a lattice,
  lane l owning the C consecutive columns l·C … l·C + C - 1; each row's
  channels copied into the copy ring AHEAD rows ahead, a group a row, read
  only after the wait that lands them (cp.async.wait_group) and the row's
  __syncwarp; the chain's prefix computed a row ahead (local exclusive sums
  and a shfl_up scan of the lane totals); the row's log-sum-exp scan as
  (max, sum) pairs: the local scan, the 5-step shfl_up (alpha) / shfl_down
  (beta) scan of the lane totals, the carry shuffle and the fix-up; alpha's
  arrivals gathered from each arc's ring of departures (an emit arc reads
  column u - 1: at a lane's first cell, the previous lane's last one),
  beta's from its ring of W + 1 rows; alpha's rows written out from the
  staged row a row late, beta's from its ring; each lattice stopping at its
  own T_b, then the NEG fill of rows T_b … T-1.

Every ring read is checked to find the row it wants, written at an earlier
row step (a __syncwarp between) and never overwritten in the step that reads
it; every copy read is checked to have landed; every cell must be written
exactly once. The result must equal the plain ``ops/window.forward_backward``
and the JAX package's ``_multiblank_lattice`` / ``_tdt_lattice`` on ragged
shapes that reach every edge: T_b = 1, U_b = 1, U_b = U, U at 31/32/33, the
f32 and f64 caps ± 1, W = 1 … 8 with an arc of m = W, an infeasible TDT
lattice.

This is the only check of the kernel's index arithmetic where no card is
present. Tolerances: f64 (the kernel's f64 path takes exact exp and log),
rtol 1e-12 / atol 1e-10 against the plain version (the chain's prefix sums
are added in another order than ``torch.cumsum``), 1e-10 against JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops.multiblank import _multiblank_lattice
from warp_transducer_tpu.ops.tdt import _tdt_lattice
from warp_transducer_tpu_torch.ops import window as TW
from warp_transducer_tpu_torch.ops.cuda import window as KW
from jax_programs import release_compiled_programs  # noqa: F401

NEG = -1.0e30
CLAMP = -1.0e4
LOWEST = -np.finfo(np.float64).max
N_SM = 132  # an H100's SMs
WARP = KW.WARP
LANE = np.arange(WARP)


def _shfl_up(x, d):
    """__shfl_up_sync along the lanes (axis 1): lane l gets lane l - d's
    value; lanes < d their own."""
    y = x.copy()
    y[:, d:] = x[:, :-d]
    return y


def _shfl_down(x, d):
    y = x.copy()
    y[:, :-d] = x[:, d:]
    return y


def _join(a, b):
    """(m, s) ⊕ (m, s) as csrc/window_stream.cu::join, elementwise."""
    (am, as_), (bm, bs) = a, b
    with np.errstate(over="ignore", invalid="ignore"):
        d = am - bm
        e = np.exp(-np.abs(d))
    ge = d >= 0
    return np.where(ge, am, bm), np.where(ge, bs * e + as_, as_ * e + bs)


def _select(cond, a, b):
    return np.where(cond, a[0], b[0]), np.where(cond, a[1], b[1])


def _value(p):
    with np.errstate(divide="ignore"):
        return p[0] + np.log(p[1])


class _Clock:
    """Row steps (a __syncwarp each) and barrier epochs (a bar.sync of the
    lattice's warps each)."""
    step = 0
    epoch = 0


class _Memory:
    """A lattice's words of shared memory, each with the row it holds, the
    warp, row step and epoch that wrote it, and each warp's last read, to
    check every access: within a warp a __syncwarp (a row step) must lie
    between a write and another access, across warps a barrier."""

    def __init__(self, shape, G, clock):
        self.value = np.full(shape, np.nan)
        self.row = np.full(shape, -10 ** 9)
        self.wwarp = np.full(shape, -1)
        self.wstep = np.full(shape, -10 ** 9)
        self.wepoch = np.full(shape, -10 ** 9)
        self.rstep = np.full(shape + (G,), -10 ** 9)
        self.repoch = np.full(shape + (G,), -10 ** 9)
        self.G, self.clock = G, clock

    @staticmethod
    def _pick(idx, mask):
        return tuple(np.broadcast_to(i, mask.shape)[mask] for i in idx)

    def write(self, idx, values, row, warp, mask):
        idx = self._pick(idx, mask)
        warp = np.broadcast_to(warp, mask.shape)[mask]
        for g in range(self.G):
            same = warp == g
            assert np.all(self.rstep[idx + (g,)][same] < self.clock.step), \
                "a word overwritten in the row step that a lane of its warp reads it"
            assert np.all(self.repoch[idx + (g,)][~same] < self.clock.epoch), \
                "a word overwritten before a barrier after another warp's read"
        self.value[idx] = np.broadcast_to(values, mask.shape)[mask]
        self.row[idx] = np.broadcast_to(row, mask.shape)[mask]
        self.wwarp[idx] = warp
        self.wstep[idx] = self.clock.step
        self.wepoch[idx] = self.clock.epoch

    def read(self, idx, row, warp, mask):
        idx_m = self._pick(idx, mask)
        warp_m = np.broadcast_to(warp, mask.shape)[mask]
        assert np.all(self.row[idx_m] == np.broadcast_to(row, mask.shape)[mask]), \
            "a ring read the wrong row"
        same = self.wwarp[idx_m] == warp_m
        assert np.all(self.wstep[idx_m][same] < self.clock.step), \
            "a word read in the row step that its warp wrote it"
        assert np.all(self.wepoch[idx_m][~same] < self.clock.epoch), \
            "a word of another warp read without a barrier after its write"
        self.rstep[idx_m + (warp_m,)] = self.clock.step
        self.repoch[idx_m + (warp_m,)] = self.clock.epoch
        out = np.full(mask.shape, np.nan)
        out[mask] = self.value[idx_m]
        return out


class _CopyRing:
    """The copy ring: row r's channels in slot r % COPY_ROWS (lpb and lpe of
    UP values each, then the U·Cx extras and ROW_PAD words), each warp
    copying its own columns in cp.async group g (a group a row, committed by
    every warp); a word can be read once its group has landed."""

    def __init__(self, U, Cx, G, C, clock):
        self.up = G * WARP * C
        self.P = WARP * C
        self.words = (2 + Cx) * self.up + KW.ROW_PAD
        self.mem = _Memory((KW.COPY_ROWS, self.words), G, clock)
        self.group = np.full((KW.COPY_ROWS, self.words), -1)
        self.groups = 0  # committed
        self.landed = -1  # the newest landed group
        self.U, self.Cx, self.G = U, Cx, G

    def copy(self, r, Tv, pb, pe, px):
        if 0 <= r < Tv:
            slot = r % KW.COPY_ROWS
            for g in range(self.G):
                lo, hi = g * self.P, min((g + 1) * self.P, self.U)
                if lo >= hi:
                    continue
                w = np.arange(lo, hi)
                wx = np.arange(lo * self.Cx, hi * self.Cx)
                words = np.concatenate([w, self.up + w, 2 * self.up + wx])
                vals = np.concatenate([pb[r, lo:hi], pe[r, lo:hi], px[r].reshape(-1)[wx]])
                self.mem.write((slot, words), vals, r, g, np.ones(len(words), bool))
                self.group[slot, words] = self.groups
        self.groups += 1  # commit (empty groups too)

    def wait(self, n):
        self.landed = max(self.landed, self.groups - 1 - n)

    def read(self, r, words, warp, mask):
        slot = r % KW.COPY_ROWS
        got = self.mem.read((slot, words), r, warp, mask)
        assert np.all(self.group[slot, np.broadcast_to(words, mask.shape)[mask]] <= self.landed), \
            "a channel read before its copy landed"
        return got


def _slot_arc(chs, up, Cx):
    """(base, stride) of each channel of an arc in a copied row."""
    return [(0, 1) if c == 0 else (up, 1) if c == 1 else (2 * up + c - 2, Cx) for c in chs]


def _weight(ring, r, refs, u, warp, mask):
    w = 0.0
    for k, (base, stride) in enumerate(refs):
        x = np.maximum(ring.read(r, base + np.where(mask, u, 0) * stride, warp, mask), NEG)
        w = x if k == 0 else w + x
    return w


def _chain_prefix(ring, r, refs, u, U, warp):
    """The chain's exclusive prefix c(u) of row r at the lane's cells, within
    each warp's columns, and the lanes' inclusive sums (lane 31: the warp's
    total)."""
    inside = u < U
    x = np.where(inside, np.maximum(_weight(ring, r, refs, u, warp, inside), CLAMP), 0.0)
    C = u.shape[-1]
    c = np.zeros_like(x)
    run = np.zeros(u.shape[:2])
    for j in range(C):
        c[..., j] = run
        run = run + x[..., j]
    incl = run
    sh = 1
    while sh < WARP:
        incl = np.where(LANE >= sh, incl + _shfl_up(incl, sh), incl)
        sh *= 2
    ex = _shfl_up(incl, 1)
    ex[:, 0] = 0.0
    return c + ex[..., None], incl


def _walk(pb, pe, px, arcs, T, U, Tb, Ub, is_beta, G):
    """One lattice as the G warps of the warp kernel walk it: (field, ll)."""
    Cx = px.shape[-1]
    C = KW.cells(-(-U // G))
    P = WARP * C
    up = G * P
    W = arcs.window
    R = W + 1
    K = KW.AHEAD
    Tv, Uv = min(max(Tb, 0), T), min(max(Ub, 0), U)
    warp = np.arange(G)[:, None, None] + np.zeros((G, WARP, C), int)
    u = warp * P + LANE[None, :, None] * C + np.arange(C)[None, None, :]  # (G, 32, C)
    inside = u < U
    cross = G > 1 and len(arcs.emit_arcs) > 0  # a second barrier a row
    out = np.full(T * U, np.nan)
    writes = np.zeros(T * U, np.int64)
    arc_list = list(arcs.blank_arcs) + list(arcs.emit_arcs)
    n_blank = len(arcs.blank_arcs)
    refs = [_slot_arc(chs, up, Cx) for _, chs in arc_list]
    chain = _slot_arc(arcs.chain, up, Cx) if arcs.chain is not None else None
    clock = _Clock()
    copies = _CopyRing(U, Cx, G, C, clock)
    xch = _Memory((2, G, 4), G, clock)
    ones = np.ones((G, WARP, C))

    def barrier():
        if G > 1:
            clock.epoch += 1

    def syncwarp():
        clock.step += 1

    def store(rows, cols, values, mask):
        cells = (rows * U + cols)[mask]
        np.add.at(writes, cells, 1)
        out[cells] = np.broadcast_to(values, mask.shape)[mask]

    def write_out(mem, lead, tag, r):
        """Row r goes out, coalesced: lane l of warp g writes g·P + l + 32k."""
        w = (np.arange(G)[:, None, None] * P + LANE[None, :, None]
             + WARP * np.arange(C)[None, None, :])
        m = w < U
        got = mem.read(lead + (np.where(m, w, 0),), tag, warp, m)
        store(np.full_like(w, r), w, got, m)

    def publish(par, values, slot):
        """One lane of each warp writes ``values`` (G,) into field `slot` of
        its exchange entry."""
        g = np.arange(G)
        xch.write((par, g, slot), values, 0, g, np.ones(G, bool))

    def gather(par, slot, warps):
        """Every warp reads field `slot` of the entries of ``warps(g)``."""
        return [xch.read((par, np.array(warps(g), int), slot), 0, g,
                         np.ones(len(warps(g)), bool)) for g in range(G)]

    for i in range(K):  # the prime
        copies.copy(Tv - 1 - i if is_beta else i, Tv, pb, pe, px)
    copies.wait(K - 1)
    syncwarp()
    c_nxt = np.zeros((G, WARP, C))
    end_nxt = np.zeros(G)  # lane 31: the warp's chain total
    if chain is not None and Tv > 0:
        c_nxt, incl = _chain_prefix(copies, Tv - 1 if is_beta else 0, chain, u, U, warp)
        end_nxt = incl[:, -1].copy()
        if G > 1:
            publish(1, end_nxt, 2)
            barrier()
            offs = [sum(v) for v in gather(1, 2, lambda g: range(g))]
            c_nxt = c_nxt + np.array(offs)[:, None, None]
    ll = NEG
    if not is_beta:
        dep = _Memory((len(arc_list), R, up), G, clock)
        stage = _Memory((2, up), G, clock)
        for t in range(Tv):
            c_cur = c_nxt
            copies.wait(K - 2)
            syncwarp()
            copies.copy(t + K, Tv, pb, pe, px)
            if chain is not None and t + 1 < Tv:
                c_nxt, incl = _chain_prefix(copies, t + 1, chain, u, U, warp)
                end_nxt = incl[:, -1].copy()
            if t > 0:
                write_out(stage, ((t - 1) & 1,), t - 1, t - 1)
            m0 = arc_list[0][0]
            m = inside & (t >= m0)
            p = (np.where(m, dep.read((0, (t - m0) % R, np.where(m, u, 0)), t - m0, warp, m),
                          NEG), ones.copy())
            for i in range(1, len(arc_list)):
                mi = arc_list[i][0]
                if t < mi:
                    continue
                emit = i >= n_blank
                src = u - 1 if emit else u
                m = inside & (src >= 0)  # at a warp's first column, the warp before's last
                x = dep.read((i, (t - mi) % R, np.where(m, src, 0)), t - mi, warp, m)
                p = _select(m, _join(p, (x, ones)), p)
            below = p[0] < NEG  # the plain sum starts at NEG
            p = (np.where(below, NEG, p[0]), np.where(below, 1.0, p[1]))
            if t == 0:
                p[0][0, 0, 0], p[1][0, 0, 0] = 0.0, 1.0
            if chain is not None:
                pm, ps = p[0] - c_cur, p[1].copy()
                for j in range(1, C):
                    pm[..., j], ps[..., j] = _join((pm[..., j - 1], ps[..., j - 1]),
                                                   (pm[..., j], ps[..., j]))
                tot = (pm[..., -1].copy(), ps[..., -1].copy())
                sh = 1
                while sh < WARP:
                    o = (_shfl_up(tot[0], sh), _shfl_up(tot[1], sh))
                    tot = _select(LANE >= sh, _join(o, tot), tot)
                    sh *= 2
                carry = [_shfl_up(tot[0], 1), _shfl_up(tot[1], 1)]
                carry[0][:, 0], carry[1][:, 0] = LOWEST, 0.0
                if G > 1:
                    wt = (tot[0][:, -1].copy(), tot[1][:, -1].copy())  # lane 31's
                    publish(t & 1, wt[0], 0)
                    publish(t & 1, wt[1], 1)
                    publish(t & 1, end_nxt, 2)
                    barrier()
                    before_m, before_s = np.full(G, LOWEST), np.zeros(G)
                    ms = gather(t & 1, 0, lambda g: range(g))
                    ss = gather(t & 1, 1, lambda g: range(g))
                    for g in range(G):
                        for k in range(g):
                            before_m[g], before_s[g] = _join((before_m[g], before_s[g]),
                                                             (ms[g][k], ss[g][k]))
                    carry = list(_join((before_m[:, None], before_s[:, None]), carry))
                    if t + 1 < Tv:
                        offs = np.array([sum(v) for v in gather(t & 1, 2, lambda g: range(g))])
                        c_nxt = c_nxt + offs[:, None, None]
                a = c_cur + _value(_join((carry[0][..., None], carry[1][..., None]), (pm, ps)))
            else:
                a = _value(p)
            a = np.where(u < Uv, a, NEG)
            stage.write(((t & 1), u), a, t, warp, np.ones_like(inside))
            for i, (mi, _) in enumerate(arc_list):
                w = _weight(copies, t, refs[i], u, warp, inside)
                dep.write((i, t % R, np.where(inside, u, 0)), a + w, t, warp, inside)
            if cross:
                barrier()
        syncwarp()
        if Tv > 0:
            write_out(stage, ((Tv - 1) & 1,), Tv - 1, Tv - 1)
        if 1 <= Ub <= U:
            uf = Ub - 1
            one = np.array([True])
            for t in range(max(Tb - W, 0), Tv):
                for i in range(n_blank):
                    if t + arc_list[i][0] == Tb:
                        x = dep.read((i, t % R, np.array([uf])), t, uf // P, one)[0]
                        with np.errstate(over="ignore"):
                            ll = max(ll, x) + np.log1p(np.exp(-abs(ll - x)))
    else:
        ring = _Memory((R, up + KW.SLACK), G, clock)
        for r in range(Tv - 1, -1, -1):
            c_cur = c_nxt
            copies.wait(K - 2)
            syncwarp()
            copies.copy(r - K, Tv, pb, pe, px)
            if chain is not None and r >= 1:
                c_nxt, incl = _chain_prefix(copies, r - 1, chain, u, U, warp)
                end_nxt = incl[:, -1].copy()
            if r + 1 < Tv:
                write_out(ring, ((r + 1) % R,), r + 1, r + 1)
            p = None
            for i, (mi, _) in enumerate(arc_list):
                emit = i >= n_blank
                w = np.where(inside, _weight(copies, r, refs[i], u, warp, inside), NEG)
                src = u + 1 if emit else u
                m = inside & (r + mi < Tv) & (src < U)  # at a warp's last column, the next's first
                b = np.where(m, ring.read(((r + mi) % R, np.where(m, src, 0)), r + mi, warp, m),
                             NEG)
                end = (not emit) and r + mi == Tb
                x = np.where(end & (u == Ub - 1), w, w + b)
                x = np.where(inside, x, NEG)
                term = (x, ones)
                p = term if p is None else _join(p, term)
            below = p[0] < NEG  # the plain sum starts at NEG
            p = (np.where(below, NEG, p[0]), np.where(below, 1.0, p[1]))
            p = (np.where(inside, p[0], LOWEST), np.where(inside, p[1], 0.0))
            if chain is not None:
                pm, ps = p[0] + c_cur, p[1].copy()
                for j in range(C - 2, -1, -1):
                    pm[..., j], ps[..., j] = _join((pm[..., j + 1], ps[..., j + 1]),
                                                   (pm[..., j], ps[..., j]))
                tot = (pm[..., 0].copy(), ps[..., 0].copy())
                sh = 1
                while sh < WARP:
                    o = (_shfl_down(tot[0], sh), _shfl_down(tot[1], sh))
                    tot = _select(LANE + sh < WARP, _join(o, tot), tot)
                    sh *= 2
                carry = [_shfl_down(tot[0], 1), _shfl_down(tot[1], 1)]
                carry[0][:, -1], carry[1][:, -1] = LOWEST, 0.0
                if G > 1:
                    par = (Tv - 1 - r) & 1
                    publish(par, tot[0][:, 0].copy(), 0)
                    publish(par, tot[1][:, 0].copy(), 1)
                    publish(par, end_nxt, 2)
                    barrier()
                    after_m, after_s = np.full(G, LOWEST), np.zeros(G)
                    ms = gather(par, 0, lambda g: range(G - 1, g, -1))
                    ss = gather(par, 1, lambda g: range(G - 1, g, -1))
                    for g in range(G):
                        for k in range(len(ms[g])):
                            after_m[g], after_s[g] = _join((after_m[g], after_s[g]),
                                                           (ms[g][k], ss[g][k]))
                    carry = list(_join((after_m[:, None], after_s[:, None]), carry))
                    if r >= 1:
                        offs = np.array([sum(v) for v in gather(par, 2, lambda g: range(g))])
                        c_nxt = c_nxt + offs[:, None, None]
                bv = _value(_join((carry[0][..., None], carry[1][..., None]), (pm, ps))) - c_cur
            else:
                bv = _value(p)
            ring.write((r % R, np.where(inside, u, 0)), np.where(u < Uv, bv, NEG), r, warp,
                       inside)
            if cross:
                barrier()
        syncwarp()
        if Tv > 0:
            write_out(ring, (0,), 0, 0)
            ll = ring.read((np.array([0]), np.array([0])), 0, 0, np.array([True]))[0]
    rows = np.arange(Tv, T)[:, None] + 0 * np.arange(U)[None, :]  # the NEG fill
    store(rows, np.arange(U)[None, :] + 0 * rows, NEG, np.ones_like(rows, bool))
    assert np.all(writes == 1), "a cell written other than once"
    return out.reshape(T, U), ll


def emulate(lpb, lpe, extra, arcs, il, ll, compute_betas=True, elt=8, warps=0):
    """(alphas, betas, ll_forward, ll_backward) of the warp kernel's plan
    for ``elt``-byte values (``warps`` a lattice forced, or the plan's),
    computed in float64 numpy."""
    B, T, U = lpb.shape
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    p = KW.plan(B, T, U, elt, arcs.window, n_arcs, extra.shape[-1], arcs.chain is not None,
                compute_betas, N_SM, warps)
    assert p.warp_mode and p.cells == KW.cells(-(-U // p.warps))
    out = {"alphas": [], "betas": [], "ll_forward": [], "ll_backward": []}
    for b in range(B):
        for is_beta in ((False, True) if compute_betas else (False,)):
            field, llv = _walk(lpb[b], lpe[b], extra[b], arcs, T, U, int(il[b]), int(ll[b]) + 1,
                               is_beta, p.warps)
            out["betas" if is_beta else "alphas"].append(field)
            out["ll_backward" if is_beta else "ll_forward"].append(llv)
    return {k: np.array(v) for k, v in out.items() if v}


def _channels(B, T, U, Cx, il, ll, seed):
    """lpb, lpe (column U-1 NEG), Cx extra channels: log-probs of random
    logits; one lpb below NEG (the clamp)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, U, 3 + Cx)) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    lpe = lp[..., 1].copy()
    lpe[:, :, U - 1] = NEG
    lpb = lp[..., 0].copy()
    lpb[0, 0, U - 1] = -1e35
    return (lpb, lpe, np.ascontiguousarray(lp[..., 3:]), np.asarray(il, np.int32),
            np.asarray(ll, np.int32))


MB = ("multiblank", (2, 4))
TDT = ("tdt", (0, 1, 2, 4))
# name: (family, durations), B, T, U, input lengths, label lengths (U_b =
# label length + 1), element bytes, warps a lattice (0: the plan's).
CASES = {
    "U31_mb": (MB, 4, 7, 31, [7, 1, 3, 6], [30, 0, 29, 12], 8, 0),
    "U32_tdt": (TDT, 3, 6, 32, [6, 2, 5], [31, 31, 0], 8, 0),
    "U33_mb": (MB, 3, 6, 33, [6, 3, 1], [32, 5, 32], 8, 0),
    "U33_tdt_no_chain": (("tdt", (1, 2)), 3, 6, 33, [6, 4, 6], [32, 5, 10], 8, 0),
    "f32_cap": (MB, 2, 3, 544, [3, 2], [543, 100], 4, 1),
    "f32_cap_minus_1": (TDT, 2, 3, 543, [3, 3], [542, 300], 4, 1),
    "f64_cap": (TDT, 2, 3, 288, [3, 2], [287, 200], 8, 1),
    "f64_cap_minus_1": (MB, 2, 4, 287, [4, 3], [286, 286], 8, 1),
    "T1_U1": (TDT, 3, 6, 5, [1, 6, 1], [0, 4, 2], 8, 0),
    "headline_like": (TDT, 5, 12, 41, [12, 6, 9, 12, 7], [40, 20, 33, 25, 40], 4, 0),
    "fused_like": (MB, 4, 10, 21, [10, 5, 8, 10], [20, 11, 20, 3], 4, 0),
    "no_big_blanks": (("multiblank", ()), 3, 9, 45, [9, 4, 7], [44, 30, 10], 8, 0),
    "eight_big_blanks": (("multiblank", (2, 3, 4, 5, 6, 7, 8, 3)), 2, 11, 9, [11, 9], [8, 4], 8,
                         0),
    "infeasible_tdt": (("tdt", (2,)), 2, 5, 3, [5, 4], [2, 1], 8, 0),
    # several warps a lattice: the plan's four at a long_t-like U, and two
    # and four forced; boundaries of a warp's columns inside and beyond U_b
    "long_t_like_mb": (MB, 2, 9, 301, [9, 5], [300, 150], 4, 0),
    "long_t_like_tdt": (TDT, 2, 9, 301, [9, 7], [300, 96], 4, 0),
    "two_warps_tdt": (TDT, 3, 8, 97, [8, 5, 8], [96, 64, 31], 8, 2),
    "two_warps_mb": (MB, 2, 7, 70, [7, 6], [69, 32], 8, 2),
    "four_warps_tdt": (("tdt", (0, 1, 3)), 2, 8, 130, [8, 6], [129, 95], 8, 4),
    "four_warps_mb_w8": (("multiblank", (8,)), 2, 12, 200, [12, 9], [199, 33], 8, 4),
}


def _arcs(family, durations):
    return TW.multiblank_arcs(durations) if family == "multiblank" else TW.tdt_arcs(durations)


def _jax(family, durations, lpb, lpe, extra, il, ll):
    fn = _multiblank_lattice if family == "multiblank" else _tdt_lattice
    return fn(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(extra), durations,
              jnp.asarray(il), jnp.asarray(ll))


def _check(got, want, names, **tol):
    for name in names:
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)), err_msg=name,
                                   **tol)


def _live(ref):
    """Cells and lls a path reaches (NEG elsewhere in every engine)."""
    return [np.asarray(x) > -1e29 for x in ref]


def _plain(lpb, lpe, extra, arcs, il, ll, betas=True):
    return TW.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(extra), arcs,
                               torch.tensor(il), torch.tensor(ll), compute_betas=betas)


FIELDS = ("alphas", "betas", "ll_forward", "ll_backward")


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain_and_jax(case):
    (family, durations), B, T, U, il, ll, elt, warps = CASES[case]
    arcs = _arcs(family, durations)
    lpb, lpe, extra, il, ll = _channels(B, T, U, len(durations), il, ll, seed=len(case))
    got = emulate(lpb, lpe, extra, arcs, il, ll, True, elt, warps)
    # every cell, NEG outside the lattice in both
    _check(got, _plain(lpb, lpe, extra, arcs, il, ll), FIELDS, rtol=1e-12, atol=1e-10)
    # The JAX engines clamp as the port does; cells no path reaches hold NEG.
    ref = _jax(family, durations, np.maximum(lpb, NEG), lpe, extra, il, ll)
    for name, x, live in zip(FIELDS, ref, _live(ref)):
        assert np.all(got[name][~live] <= -1e29), name
        np.testing.assert_allclose(got[name][live], np.asarray(x)[live], rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    if case == "infeasible_tdt":  # an odd T_b has no path; T_b = 4 with one label has one
        assert got["ll_forward"][0] < -1e29 < got["ll_forward"][1]


@pytest.mark.parametrize("case", ["U31_mb", "U33_tdt_no_chain", "headline_like", "T1_U1",
                                  "two_warps_tdt", "long_t_like_mb"])
def test_emulation_without_betas(case):
    (family, durations), B, T, U, il, ll, elt, warps = CASES[case]
    arcs = _arcs(family, durations)
    lpb, lpe, extra, il, ll = _channels(B, T, U, len(durations), il, ll, seed=len(case))
    got = emulate(lpb, lpe, extra, arcs, il, ll, False, elt, warps)
    assert set(got) == {"alphas", "ll_forward"}
    _check(got, _plain(lpb, lpe, extra, arcs, il, ll, False), ("alphas", "ll_forward"),
           rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("warps", [1, 2, 4])
@pytest.mark.parametrize("W", range(1, 9))
def test_emulation_every_window(W, warps):
    """One arc with m = W for W = 1 … 8, which reads the departure slot that
    the next row takes (alpha) or the beta row the next row overwrites: as a
    big blank, as a TDT duration beside d = 1, and with the chain d = 0; one,
    two and four warps a lattice (the last two need a chain)."""
    B, T, U = 3, 13, 70
    il, ll = [13, 9, 7], [69, 40, 3]
    sets = [(TW.multiblank_arcs(() if W == 1 else (W,)), 0 if W == 1 else 1),
            (TW.tdt_arcs((0, 1) if W == 1 else (0, 1, W)), 2 if W == 1 else 3)]
    if warps == 1:
        sets.append((TW.tdt_arcs((1,) if W == 1 else (1, W)), 1 if W == 1 else 2))
    for arcs, n in sets:
        lpb, lpe, extra, il_, ll_ = _channels(B, T, U, n, il, ll, seed=W)
        got = emulate(lpb, lpe, extra, arcs, il_, ll_, True, 8, warps)
        _check(got, _plain(lpb, lpe, extra, arcs, il_, ll_), FIELDS, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("warps", [1, 4])
def test_lengths_beyond_the_arrays(warps):
    """T_b > T and U_b > U (the kernel clamps its walk; the terminal arcs of
    T_b > T still count from the rows that exist) and T_b = 0."""
    arcs = _arcs(*TDT)
    lpb, lpe, extra, il, ll = _channels(3, 6, 140, 4, [8, 0, 6], [150, 3, 139], seed=5)
    got = emulate(lpb, lpe, extra, arcs, il, ll, True, 8, warps)
    _check(got, _plain(lpb, lpe, extra, arcs, il, ll), FIELDS, rtol=1e-12, atol=1e-10)


def _plan(B, U, elt, arcs=None, betas=True, T=1500, n_extra=None, warps=0):
    arcs = arcs or _arcs(*TDT)
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    if n_extra is None:
        n_extra = max(c for _, chs in arcs.blank_arcs + arcs.emit_arcs for c in chs) - 1
    return KW.plan(B, T, U, elt, arcs.window, n_arcs, max(n_extra, 0), arcs.chain is not None,
                   betas, N_SM, warps)


@pytest.mark.parametrize("elt,cap", [(4, 544), (8, 288)])
def test_switch_to_block_kernel_above_the_cap(elt, cap):
    """One warp a lattice (B = 100: too many lattices for more): the cap is
    the instance of most cells."""
    for U in (1, 31, 32, 33, cap - 1, cap):
        p = _plan(100, U, elt)
        assert p.warp_mode and p.warps == 1 and p.cells == KW.cells(U) <= KW.max_cells(elt)
        assert p.cells % 2 == 1 and WARP * p.cells >= U > WARP * (p.cells - 2)
        assert p.smem <= KW.SMEM_BYTES and p.threads <= KW.MAX_WARPS * WARP
    for U in (cap + 1, 600, 1100):
        p = _plan(100, U, elt)
        assert not p.warp_mode and p.blocks == 100 and p.per_block == 1
        assert p.threads == min(KW.MAX_THREADS, -(-U // WARP) * WARP)
        assert p.smem == KW.block_smem(U, 4, elt)


@pytest.mark.parametrize("B,U,betas,warps", [
    (16, 301, True, 4), (16, 301, False, 4), (64, 301, True, 2), (33, 301, True, 4),
    (34, 301, True, 2),
    (32, 301, True, 4), (128, 301, True, 1), (16, 257, True, 4), (16, 256, True, 2),
    (16, 129, True, 2), (16, 128, True, 1), (128, 41, True, 1), (64, 21, True, 1),
    (16, 600, True, 4), (16, 1100, True, 0)])
def test_warps_a_lattice(B, U, betas, warps):
    """Four or two warps a lattice where a chain is solved, each warp gets
    more than 64 columns and the lattices' warps stay within two an SM; with
    four warps U = 600 f32 fits the warp kernel, U = 1100 does not."""
    p = _plan(B, U, 4, betas=betas)
    assert p.warp_mode == (warps > 0) and p.warps == warps
    if warps:
        assert p.cells == KW.cells(-(-U // warps)) and WARP * p.cells * warps >= U
        assert p.threads == WARP * warps * p.per_block <= KW.MAX_WARPS * WARP


def test_no_chain_takes_one_warp():
    arcs = TW.tdt_arcs((1, 2))
    assert _plan(16, 301, 4, arcs).warps == 1
    assert not _plan(16, 301, 4, arcs, warps=4).warp_mode  # forced: refused


def test_switch_where_the_rings_do_not_fit():
    """TDT with eight durations up to 8 frames at U = 301 keeps 16 arcs × 9
    rows of departures: more than a block holds with one warp, so the block
    kernel; with four warps it fits."""
    arcs = TW.tdt_arcs((1, 2, 3, 4, 5, 6, 7, 8))
    assert not _plan(100, 301, 4, arcs, n_extra=8).warp_mode
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    assert KW.lattice_words(1, KW.cells(301), 8, n_arcs, 8, 2) * 4 > KW.SMEM_BYTES
    assert _plan(100, 41, 4, arcs, n_extra=8).warp_mode


def test_switch_beyond_32_bit_offsets():
    U, Cx = 301, 4
    T_max = KW.INT_MAX // (U * Cx) - KW.AHEAD
    assert _plan(4, U, 4, T=T_max).warp_mode
    assert not _plan(4, U, 4, T=T_max + 1).warp_mode


@pytest.mark.parametrize("G,C,elt", [(1, 1, 4), (1, 3, 4), (4, 3, 4), (1, 11, 4), (1, 9, 8)])
def test_shared_memory_of_a_lattice(G, C, elt):
    """The copy ring, alpha's departure rings and staged rows or beta's ring
    and slack, the exchange, in values; a lattice of the duration-arc losses'
    main shapes fits a block."""
    up = G * WARP * C
    for n_arcs, W, Cx in ((3, 4, 2), (6, 4, 4)):  # multi-blank (2, 4), TDT (0, 1, 2, 4)
        copy = KW.COPY_ROWS * ((2 + Cx) * up + KW.ROW_PAD)
        alpha = copy + n_arcs * (W + 1) * up + 2 * up + KW.XCH_WORDS
        beta = copy + (W + 1) * up + KW.SLACK + KW.XCH_WORDS
        assert KW.lattice_words(G, C, W, n_arcs, Cx, 2) == max(alpha, beta)
        assert KW.lattice_words(G, C, W, n_arcs, Cx, 1) == alpha
        assert max(alpha, beta) * elt <= KW.SMEM_BYTES


@pytest.mark.parametrize("B,U,betas,per_block", [
    (128, 41, True, 2), (128, 41, False, 1), (64, 21, True, 1), (16, 301, True, 1),
    (1, 5, False, 1), (300, 41, True, 5), (1000, 21, True, 8), (1000, 21, False, 8),
    (1000, 301, True, 2)])
def test_lattices_a_block(B, U, betas, per_block):
    p = _plan(B, U, 4, betas=betas, T=150)
    lattices = B * (2 if betas else 1)
    assert p.warp_mode and p.per_block == per_block
    assert p.threads == WARP * p.warps * per_block <= KW.MAX_WARPS * WARP
    assert p.blocks == -(-lattices // per_block)
    assert (p.blocks - 1) * p.per_block < lattices <= p.blocks * p.per_block
    assert p.smem == p.lattice_words * 4 * per_block <= KW.SMEM_BYTES


def test_cells_are_odd_and_cover_the_columns():
    for n in range(1, 600):
        C = KW.cells(n)
        assert C % 2 == 1 and WARP * C >= n and (C <= 2 or WARP * (C - 2) < n)
        # a lane stride of C words touches 32 distinct banks
        assert len({(lane * C) % 32 for lane in range(WARP)}) == WARP
