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
  own T_b, then the NEG fill of rows T_b … T-1;
* the table instance's rings form walks as the wide instance does, its
  arcs read from the table; its pending form's alpha keeps its pending
  window (``_Pending``): W + 1
  slots of (max, sum) pairs tagged with the row each gathers for, row t
  reading and emptying its slot, then scattering its departures a group of
  one m at a time, as the host's table (``_arc_rows``) lists them (the arcs
  joined first, emit arcs one column on: within
  a lane, by the shuffle, from lane 31 into its warp's entry, from the last
  warp handed on to the next pass pre-joined), ll_forward summed as the
  terminal arcs are sent. A lane's own cells need no ``__syncwarp`` (one
  thread reads and writes them); a warp's entry needs a barrier between
  its writer and its reader.

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
    """(m, s) ⊕ (m, s) as csrc/window_walk.cuh::join, elementwise."""
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
        self.wthread = np.full(shape, -1)
        self.wstep = np.full(shape, -10 ** 9)
        self.wepoch = np.full(shape, -10 ** 9)
        self.rstep = np.full(shape + (G,), -10 ** 9)
        self.rthread = np.full(shape + (G,), -1)
        self.repoch = np.full(shape + (G,), -10 ** 9)
        self.G, self.clock = G, clock

    @staticmethod
    def _pick(idx, mask):
        return tuple(np.broadcast_to(i, mask.shape)[mask] for i in idx)

    def write(self, idx, values, row, warp, mask, thread=None):
        """``thread`` (a thread id a word, or None): a word that one thread
        reads and writes in one row step (the table instance's pending
        window) needs no __syncwarp between."""
        idx = self._pick(idx, mask)
        warp = np.broadcast_to(warp, mask.shape)[mask]
        thread = -2 if thread is None else np.broadcast_to(thread, mask.shape)[mask]
        for g in range(self.G):
            same = warp == g
            own = self.rthread[idx + (g,)] == thread
            assert np.all(((self.rstep[idx + (g,)] < self.clock.step) | own)[same]), \
                "a word overwritten in the row step that a lane of its warp reads it"
            assert np.all(self.repoch[idx + (g,)][~same] < self.clock.epoch), \
                "a word overwritten before a barrier after another warp's read"
        self.value[idx] = np.broadcast_to(values, mask.shape)[mask]
        self.row[idx] = np.broadcast_to(row, mask.shape)[mask]
        self.wwarp[idx] = warp
        self.wthread[idx] = thread
        self.wstep[idx] = self.clock.step
        self.wepoch[idx] = self.clock.epoch

    def read(self, idx, row, warp, mask, thread=None):
        idx_m = self._pick(idx, mask)
        warp_m = np.broadcast_to(warp, mask.shape)[mask]
        thread = -3 if thread is None else np.broadcast_to(thread, mask.shape)[mask]
        assert np.all(self.row[idx_m] == np.broadcast_to(row, mask.shape)[mask]), \
            "a ring read the wrong row"
        same = self.wwarp[idx_m] == warp_m
        own = self.wthread[idx_m] == thread
        assert np.all(((self.wstep[idx_m] < self.clock.step) | own)[same]), \
            "a word read in the row step that its warp wrote it"
        assert np.all(self.wepoch[idx_m][~same] < self.clock.epoch), \
            "a word of another warp read without a barrier after its write"
        self.rstep[idx_m + (warp_m,)] = self.clock.step
        self.rthread[idx_m + (warp_m,)] = thread
        self.repoch[idx_m + (warp_m,)] = self.clock.epoch
        out = np.full(mask.shape, np.nan)
        out[mask] = self.value[idx_m]
        return out


class _CopyRing:
    """The copy ring: row r's channels in slot r % COPY_ROWS (lpb and lpe of
    UP values each, then the U·Cx extras, ROW_PAD words and, wide, the
    2 + n_arcs values a row that the previous pass handed on), each warp
    copying its own columns (and the taking warp the handed row) in
    cp.async group g (a group a row, committed by every warp); a word can be
    read once its group has landed."""

    def __init__(self, U, Cx, G, C, clock, hw=0):
        self.up = G * WARP * C
        self.P = WARP * C
        self.hbase = (2 + Cx) * self.up + KW.ROW_PAD
        self.words = self.hbase + hw
        self.mem = _Memory((KW.COPY_ROWS, self.words), G, clock)
        self.group = np.full((KW.COPY_ROWS, self.words), -1)
        self.groups = 0  # committed
        self.landed = -1  # the newest landed group
        self.U, self.Cx, self.G, self.hw = U, Cx, G, hw

    def copy(self, r, Tv, pb, pe, px, hin=None, taker=0):
        if 0 <= r < Tv:
            slot = r % KW.COPY_ROWS
            for g in range(self.G):
                lo, hi = g * self.P, min((g + 1) * self.P, self.U)
                if lo < hi:
                    w = np.arange(lo, hi)
                    wx = np.arange(lo * self.Cx, hi * self.Cx)
                    words = np.concatenate([w, self.up + w, 2 * self.up + wx])
                    vals = np.concatenate([pb[r, lo:hi], pe[r, lo:hi], px[r].reshape(-1)[wx]])
                    self.mem.write((slot, words), vals, r, g, np.ones(len(words), bool))
                    self.group[slot, words] = self.groups
                if hin is not None and g == taker:
                    words = self.hbase + np.arange(self.hw)
                    self.mem.write((slot, words), hin[r], r, g, np.ones(self.hw, bool))
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


class _Pending:
    """Alpha's pending window of the table instance: R slots of the UP
    columns' (max, sum) pairs and one entry a warp (the emit departures of
    its last column, for the next warp's first column or, from the last
    warp, the next pass's), each word tagged with the row it gathers for.
    A lane reads and writes its own cells in one row step (no __syncwarp);
    a warp's entry is written by its lane 31 and read by the next warp's
    lane 0 (a barrier between)."""

    def __init__(self, G, C, R, up, clock, barrier):
        self.G, self.C, self.R, self.up = G, C, R, up
        self.P = WARP * C
        self.mem = _Memory((R, 2, up + G), G, clock)
        self.warp = np.arange(G)[:, None, None] + np.zeros((G, WARP, C), int)
        self.u = self.warp * self.P + LANE[None, :, None] * C + np.arange(C)[None, None, :]
        self.thread = self.warp * WARP + LANE[None, :, None]
        self.all = np.ones((G, WARP, C), bool)
        self.g = np.arange(G)
        for r in range(R):  # every slot empty, tagged with the first row it serves
            self._put(r, self.u, (LOWEST, 0.0), r, self.warp, self.all, self.thread)
            self._put(r, up + self.g, (LOWEST, 0.0), r, self.g, np.ones(G, bool),
                      self.g * WARP + WARP - 1)
        barrier()

    def _get(self, slot, cols, row, warp, mask, thread):
        return tuple(self.mem.read((slot, k, cols), row, warp, mask, thread) for k in (0, 1))

    def _put(self, slot, cols, pair, row, warp, mask, thread):
        for k in (0, 1):
            self.mem.write((slot, k, cols), pair[k], row, warp, mask, thread)

    def arrivals(self, t, handed_in, hout):
        """Row t's arrivals (G, 32, C) from its slot, emptied for row t + R:
        at a warp's first column joined with the warp before's entry, at the
        pass's (``handed_in``) with the previous pass's pair; the last warp's
        entry goes to ``hout`` row t."""
        sl, R, up, G = t % self.R, self.R, self.up, self.G
        p = self._get(sl, self.u, t, self.warp, self.all, self.thread)
        self._put(sl, self.u, (LOWEST, 0.0), t + R, self.warp, self.all, self.thread)
        p = (p[0].copy(), p[1].copy())
        if G > 1:
            gi = np.arange(1, G)
            one = np.ones(G - 1, bool)
            x = self._get(sl, up + gi - 1, t, gi, one, gi * WARP)
            j = _join(x, (p[0][gi, 0, 0], p[1][gi, 0, 0]))
            p[0][gi, 0, 0], p[1][gi, 0, 0] = j
            self._put(sl, up + gi - 1, (LOWEST, 0.0), t + R, gi, one, gi * WARP)
        if handed_in is not None:  # lane 0 of warp 0, from its copied row
            p[0][0, 0, 0], p[1][0, 0, 0] = _join(handed_in, (p[0][0, 0, 0], p[1][0, 0, 0]))
        if hout is not None:  # lane 31 of the last warp hands its entry on
            one, last = np.array([True]), np.array([up + G - 1])
            x = self._get(sl, last, t, G - 1, one, G * WARP - 1)
            hout[t, 2], hout[t, 3] = x[0][0], x[1][0]
            self._put(sl, last, (LOWEST, 0.0), t + R, G - 1, one, G * WARP - 1)
        return p

    def scatter(self, t, groups, departures, final, Tb, lf, hands_on):
        """Row t's departures (``departures(chs)``: the α + w of the arc of
        channels ``chs`` at every cell, NEG beyond U) joined by m, emit arcs
        moved one column on,
        into slot (t + m) mod R; the terminal blank arcs (t + m = T_b) at
        the cell ``final`` added to ll_forward's running sum ``lf``, which
        is returned."""
        G, up = self.G, self.up
        # the warps whose lane 31 sends its emit departures into its entry
        sends = self.g[(self.g + 1 < G) | hands_on]
        for m, blanks, emits in groups:
            sl, row = (t + m) % self.R, t + m
            old = self._get(sl, self.u, row, self.warp, self.all, self.thread)
            d = (np.full((G, WARP, self.C), LOWEST), np.zeros((G, WARP, self.C)))
            for k, i in enumerate(blanks):
                x = departures(i)
                d = (x, np.ones_like(x)) if k == 0 else _join(d, (x, np.ones_like(x)))
                if t + m == Tb and final.any():
                    xf = x[final][0]
                    with np.errstate(over="ignore"):
                        lf = max(lf, xf) + np.log1p(np.exp(-abs(lf - xf)))
            if emits:
                # one column on: within a lane at once, arc by arc; a lane's
                # last cell's, joined over the arcs, by the shuffle to the
                # next lane's first; lane 31's into its warp's entry
                dm, ds = d[0].reshape(G, WARP, self.C).copy(), d[1].reshape(G, WARP, self.C).copy()
                last = (np.full((G, WARP), LOWEST), np.zeros((G, WARP)))
                for i in emits:
                    x = departures(i)
                    dm[..., 1:], ds[..., 1:] = _join((dm[..., 1:], ds[..., 1:]),
                                                     (x[..., :-1], np.ones_like(x[..., :-1])))
                    last = _join(last, (x[..., -1], np.ones_like(x[..., -1])))
                dm[:, 1:, 0], ds[:, 1:, 0] = _join((dm[:, 1:, 0], ds[:, 1:, 0]),
                                                   (last[0][:, :-1], last[1][:, :-1]))
                d = (dm, ds)
                if len(sends):
                    one = np.ones(len(sends), bool)
                    olde = self._get(sl, up + sends, row, sends, one, sends * WARP + WARP - 1)
                    new = _join(olde, (last[0][sends, -1], last[1][sends, -1]))
                    self._put(sl, up + sends, new, row, sends, one, sends * WARP + WARP - 1)
            self._put(sl, self.u, _join(old, d), row, self.warp, self.all, self.thread)
        return lf


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


def _hand_words(arcs, wide):
    """Values a row the passes hand on: the wide instance's and the rings
    form's 2 + n_arcs, the pending form's PENDING_HAND."""
    if wide == KW.PENDING:
        return KW.PENDING_HAND
    return 2 + len(arcs.blank_arcs) + len(arcs.emit_arcs) if wide else 0


def _groups(arcs):
    """The pending form's groups of one m, ascending: (m, the indices of
    its blank arcs, of its emit arcs), each in table order (blank arcs
    first, then emit arcs, as the kernel's arc list)."""
    n_blank = len(arcs.blank_arcs)
    ms = sorted({m for m, _ in arcs.blank_arcs + arcs.emit_arcs})
    return [(m, [i for i, (mi, _) in enumerate(arcs.blank_arcs) if mi == m],
             [n_blank + i for i, (mi, _) in enumerate(arcs.emit_arcs) if mi == m]) for m in ms]


def _table_groups(arcs):
    """The pending form's groups as the kernel reads them from the host's
    table (``KW._arc_rows``: after the chain and the arcs, the arcs sorted
    and one row (m, first, n_blank, n, 0) a group): (m, the channels of its
    blank arcs, of its emit arcs)."""
    rows = np.asarray(KW._arc_rows(arcs)).reshape(-1, 5)
    n = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    ordered, heads = rows[1 + n:1 + 2 * n], rows[1 + 2 * n:]
    chs = [tuple(int(c) for c in r[2:2 + r[1]]) for r in ordered]
    out = []
    for m, first, nb, cnt, _ in heads:
        assert np.all(ordered[first:first + cnt, 0] == m)
        out.append((int(m), chs[first:first + nb], chs[first + nb:first + cnt]))
    return out


def _walk(pb, pe, px, arcs, T, U, Tb, Ub, is_beta, G, C, passes=1, wide=False):
    """One lattice as the G warps of the kernel walk it, C cells a lane, in
    ``passes`` passes of 32·G·C columns (alpha left to right, beta right to
    left; each hands its rows on to the next through device memory,
    ``_hand_words`` values a row): (field, ll)."""
    out = np.full(T * U, np.nan)
    writes = np.zeros(T * U, np.int64)
    up = G * WARP * C
    hw = _hand_words(arcs, wide)
    hand = None  # the rows the previous pass handed on
    ll = NEG
    for q in range(passes):
        k = passes - 1 - q if is_beta else q
        start = k * up
        hout = np.full((T, hw), np.nan) if q + 1 < passes else None
        llq = _walk_pass(pb[:, start:], pe[:, start:], px[:, start:], arcs, T, U, start, Tb, Ub,
                         is_beta, G, C, wide, hand, hout, out, writes)
        if llq is not None:
            ll = llq
        hand = hout
    assert np.all(writes == 1), "a cell written other than once"
    return out.reshape(T, U), ll


def _walk_pass(pb, pe, px, arcs, T, U_all, start, Tb, Ub_all, is_beta, G, C, wide, hin, hout,
               out, writes):
    """One pass of one lattice: columns start … start + 32·G·C - 1 (U, U_b
    and u count from start); writes its cells of ``out`` and, where another
    pass follows, its rows of ``hout``; reads the previous pass's from
    ``hin``. Returns ll where this pass gives it, else None."""
    Cx = px.shape[-1]
    P = WARP * C
    up = G * P
    U = min(up, U_all - start)
    Ur = U_all - start
    Ub = Ub_all - start
    W = arcs.window
    R = W + 1
    K = KW.AHEAD
    ro = 1 if wide else 0  # alpha's rings keep column -1 (the edge)
    RS = up + (1 if wide else 0)
    Tv, Uv = min(max(Tb, 0), T), min(max(Ub, 0), U)
    first_pass = start == 0
    warp = np.arange(G)[:, None, None] + np.zeros((G, WARP, C), int)
    u = warp * P + LANE[None, :, None] * C + np.arange(C)[None, None, :]  # (G, 32, C)
    inside = u < U
    cross = G > 1 and len(arcs.emit_arcs) > 0  # a second barrier a row
    arc_list = list(arcs.blank_arcs) + list(arcs.emit_arcs)
    n_blank = len(arcs.blank_arcs)
    refs = [_slot_arc(chs, up, Cx) for _, chs in arc_list]
    chain = _slot_arc(arcs.chain, up, Cx) if arcs.chain is not None else None
    clock = _Clock()
    hw = _hand_words(arcs, wide)
    pending = wide == KW.PENDING
    taker = G - 1 if is_beta else 0
    copies = _CopyRing(U, Cx, G, C, clock, hw)
    xch = _Memory((2, G, 4), G, clock)
    ones = np.ones((G, WARP, C))
    # the lane that takes the previous pass's rows, and the one that hands on
    rx_at = (G - 1, WARP - 1, C - 1) if is_beta else (0, 0, 0)
    tx_at = (0, 0, 0) if is_beta else (G - 1, WARP - 1, C - 1)

    def barrier():
        if G > 1:
            clock.epoch += 1

    def syncwarp():
        clock.step += 1

    def store(rows, cols, values, mask):
        cells = (rows * U_all + start + cols)[mask]
        np.add.at(writes, cells, 1)
        out[cells] = np.broadcast_to(values, mask.shape)[mask]

    def write_out(mem, lead, tag, r, shift=0):
        """Row r goes out, coalesced: lane l of warp g writes g·P + l + 32k."""
        w = (np.arange(G)[:, None, None] * P + LANE[None, :, None]
             + WARP * np.arange(C)[None, None, :])
        m = w < U
        got = mem.read(lead + (np.where(m, w, 0) + shift,), tag, warp, m)
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

    def copy(r):
        copies.copy(r, Tv, pb, pe, px, hin, taker)

    def handed(r, i):
        """Value i of the row r that the previous pass handed on, as the
        taking lane reads it from its copy."""
        one = np.array([True])
        return copies.read(r, np.array([copies.hbase + i]), taker, one)[0]

    for i in range(K):  # the prime
        copy(Tv - 1 - i if is_beta else i)
    copies.wait(K - 1)
    syncwarp()
    c_nxt = np.zeros((G, WARP, C))
    end_nxt = np.zeros(G)  # lane 31: the warp's chain total
    tot_nxt = 0.0  # the pass's chain total
    if chain is not None and Tv > 0:
        c_nxt, incl = _chain_prefix(copies, Tv - 1 if is_beta else 0, chain, u, U, warp)
        end_nxt = incl[:, -1].copy()
        tot_nxt = end_nxt.sum() if G == 1 else None
        if G > 1:
            publish(1, end_nxt, 2)
            barrier()
            offs = [sum(v) for v in gather(1, 2, lambda g: range(g))]
            c_nxt = c_nxt + np.array(offs)[:, None, None]
            tot_nxt = offs[-1] + end_nxt[-1]
    ll = None
    if not is_beta:
        stage = _Memory((2, up), G, clock)
        if pending:
            pend = _Pending(G, C, R, up, clock, barrier)
            lf = NEG
        else:
            dep = _Memory((len(arc_list), R, RS), G, clock)
        for t in range(Tv):
            c_cur, tot_cur = c_nxt, tot_nxt
            copies.wait(K - 2)
            syncwarp()
            copy(t + K)
            if chain is not None and t + 1 < Tv:
                c_nxt, incl = _chain_prefix(copies, t + 1, chain, u, U, warp)
                end_nxt = incl[:, -1].copy()
                tot_nxt = end_nxt[0]
            if t > 0:
                write_out(stage, ((t - 1) & 1,), t - 1, t - 1)
            if pending:
                p = pend.arrivals(t, (handed(t, 2), handed(t, 3)) if hin is not None else None,
                                  hout)
            else:
                m0 = arc_list[0][0]
                m = inside & (t >= m0)
                p = (np.where(m, dep.read((0, (t - m0) % R, np.where(m, u, 0) + ro), t - m0, warp,
                                          m), NEG), ones.copy())
                for i in range(1, len(arc_list)):
                    mi = arc_list[i][0]
                    if t < mi:
                        continue
                    emit = i >= n_blank
                    src = u - 1 if emit else u
                    # at a warp's first column, the warp before's last; at a pass's, the edge
                    m = inside & (src >= (0 if first_pass else -1))
                    x = dep.read((i, (t - mi) % R, np.where(m, src, 0) + ro), t - mi, warp, m)
                    p = _select(m, _join(p, (x, ones)), p)
            below = p[0] < NEG  # the plain sum starts at NEG
            p = (np.where(below, NEG, p[0]), np.where(below, 1.0, p[1]))
            if t == 0 and first_pass:
                p[0][0, 0, 0], p[1][0, 0, 0] = 0.0, 1.0
            if chain is not None:
                pm, ps = p[0] - c_cur, p[1].copy()
                if hin is not None:  # the previous passes' carry, in this pass's frame
                    h = (handed(t, 0), handed(t, 1))
                    pm[rx_at], ps[rx_at] = _join(h, (pm[rx_at], ps[rx_at]))
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
                        tot_nxt = offs[-1] + end_nxt[-1]
                jn = _join((carry[0][..., None], carry[1][..., None]), (pm, ps))
                a = c_cur + _value(jn)
                if hout is not None:  # the carry, moved into the next pass's frame
                    hout[t, 0], hout[t, 1] = jn[0][tx_at] + tot_cur, jn[1][tx_at]
            else:
                a = _value(p)
            a = np.where(u < Uv, a, NEG)
            stage.write(((t & 1), u), a, t, warp, np.ones_like(inside))
            if pending:
                def departures(chs):
                    ref = _slot_arc(chs, up, Cx)
                    return np.where(inside, a + _weight(copies, t, ref, u, warp, inside), NEG)

                lf = pend.scatter(t, _table_groups(arcs), departures, u == Ub - 1, Tb, lf,
                                  hout is not None)
            for i, (mi, _) in enumerate(arc_list if not pending else ()):
                w = _weight(copies, t, refs[i], u, warp, inside)
                dep.write((i, t % R, np.where(inside, u, 0) + ro), a + w, t, warp, inside)
                if i >= n_blank:
                    if hout is not None:
                        hout[t, 2 + i - n_blank] = (a + w)[tx_at]
                    if hin is not None:  # the previous pass's edge: this ring's column -1
                        dep.write((i, t % R, np.array([0])), handed(t, 2 + i - n_blank), t, 0,
                                  np.array([True]))
            if cross:
                barrier()
        syncwarp()
        if Tv > 0:
            write_out(stage, ((Tv - 1) & 1,), Tv - 1, Tv - 1)
        if 1 <= Ub_all <= U_all and 0 <= Ub - 1 < U and pending:
            ll = lf  # summed as the terminal arcs were sent
        elif 1 <= Ub_all <= U_all and 0 <= Ub - 1 < U:
            uf = Ub - 1
            one = np.array([True])
            ll = NEG
            for t in range(max(Tb - W, 0), Tv):
                for i in range(n_blank):
                    if t + arc_list[i][0] == Tb:
                        x = dep.read((i, t % R, np.array([uf + ro])), t, uf // P, one)[0]
                        with np.errstate(over="ignore"):
                            ll = max(ll, x) + np.log1p(np.exp(-abs(ll - x)))
        elif not 1 <= Ub_all <= U_all and first_pass:
            ll = NEG
    else:
        ring = _Memory((R, RS + KW.SLACK), G, clock)
        for r in range(Tv - 1, -1, -1):
            c_cur, tot_cur = c_nxt, tot_nxt
            copies.wait(K - 2)
            syncwarp()
            copy(r - K)
            if chain is not None and r >= 1:
                c_nxt, incl = _chain_prefix(copies, r - 1, chain, u, U, warp)
                end_nxt = incl[:, -1].copy()
                tot_nxt = end_nxt[0]
            if r + 1 < Tv:
                write_out(ring, ((r + 1) % R,), r + 1, r + 1)
            p = None
            for i, (mi, _) in enumerate(arc_list):
                emit = i >= n_blank
                w = np.where(inside, _weight(copies, r, refs[i], u, warp, inside), NEG)
                src = u + 1 if emit else u
                # at a warp's last column, the next's first; at a pass's, the edge
                m = inside & (r + mi < Tv) & (src < Ur)
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
                if hin is not None:  # the later passes' carry, moved into this pass's frame
                    h = (handed(r, 0) + tot_cur, handed(r, 1))
                    pm[rx_at], ps[rx_at] = _join((pm[rx_at], ps[rx_at]), h)
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
                        tot_nxt = offs[-1] + end_nxt[-1]
                jn = _join((carry[0][..., None], carry[1][..., None]), (pm, ps))
                bv = _value(jn) - c_cur
                if hout is not None:  # the carry, in this pass's frame
                    hout[r, 0], hout[r, 1] = jn[0][tx_at], jn[1][tx_at]
            else:
                bv = _value(p)
            bv = np.where(u < Uv, bv, NEG)
            ring.write((r % R, np.where(inside, u, 0)), bv, r, warp, inside)
            if hout is not None:
                hout[r, 2] = bv[tx_at]
            if hin is not None:  # the edge: β at the next pass's first column
                ring.write((r % R, np.array([up])), handed(r, 2), r, G - 1, np.array([True]))
            if cross:
                barrier()
        syncwarp()
        if Tv > 0:
            write_out(ring, (0,), 0, 0)
            if first_pass:
                ll = ring.read((np.array([0]), np.array([0])), 0, 0, np.array([True]))[0]
        elif first_pass:
            ll = NEG
    rows = np.arange(Tv, T)[:, None] + 0 * np.arange(U)[None, :]  # the NEG fill
    store(rows, np.arange(U)[None, :] + 0 * rows, NEG, np.ones_like(rows, bool))
    return ll


def emulate(lpb, lpe, extra, arcs, il, ll, compute_betas=True, elt=8, warps=0, form=0):
    """(alphas, betas, ll_forward, ll_backward) of the kernel's plan for
    ``elt``-byte values (``warps`` a lattice and ``form`` the table
    instance's form forced, or the plan's), computed in float64 numpy."""
    B, T, U = lpb.shape
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    p = KW.plan(B, T, U, elt, arcs.window, n_arcs, extra.shape[-1], arcs.chain is not None,
                compute_betas, N_SM, warps, KW.arc_channels(arcs),
                KW.by_value(arcs, extra.shape[-1]), form)
    assert p is not None and (p.passes - 1) * WARP * p.warps * p.cells < U
    assert p.passes * WARP * p.warps * p.cells >= U
    out = {"alphas": [], "betas": [], "ll_forward": [], "ll_backward": []}
    for b in range(B):
        for is_beta in ((False, True) if compute_betas else (False,)):
            field, llv = _walk(lpb[b], lpe[b], extra[b], arcs, T, U, int(il[b]), int(ll[b]) + 1,
                               is_beta, p.warps, p.cells, p.passes, p.wide)
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
    # the shapes of the earlier block kernel: U = 601 on two and four warps
    # (f32), TDT without a 0 duration on four warps (no chain: the warps
    # trade only the emit arcs' edge column)
    "U601_two_warps_mb": (MB, 1, 4, 601, [4], [600], 4, 2),
    "U601_four_warps_tdt": (TDT, 1, 3, 601, [3], [470], 4, 4),
    "no_chain_four_warps": (("tdt", (1, 2, 4)), 2, 7, 150, [7, 5], [149, 60], 8, 4),
    "no_chain_U601": (("tdt", (1, 2, 4)), 1, 5, 601, [5], [599], 4, 0),
    # the wide instance: 8 and 16 warps, arcs of three channels, passes
    # (the rings of a lattice past one block at every G: multi-blank with a
    # window of 8 in f64 at U = 1000 in two, TDT with eight durations in
    # three, with and without a chain)
    "wide_8_warps_mb": (MB, 2, 6, 300, [6, 4], [299, 150], 8, 8),
    "wide_16_warps_tdt": (TDT, 2, 5, 200, [5, 3], [199, 120], 8, 16),
    "three_channels": (("three", (2, 3)), 2, 7, 70, [7, 5], [69, 40], 8, 0),
    "three_channels_4_warps": (("three", (2, 3)), 2, 6, 300, [6, 4], [299, 100], 4, 4),
    "passes_mb_w8": (("multiblank", (8,)), 1, 4, 1000, [4], [999], 8, 0),
    "passes_tdt_no_chain": (("tdt", (1, 2, 3, 4, 5, 6, 7, 8)), 2, 5, 300, [5, 3], [299, 140], 8,
                            0),
    "passes_tdt_chain": (("tdt", (0, 1, 2, 3, 4, 5, 6, 8)), 2, 5, 300, [5, 4], [299, 128], 8, 0),
    # the table instance: more arcs and channels than the by-value table
    # holds (TDT 0 … 8: 11 channels; 0 … 32: 64 arcs; nine and sixteen big
    # blanks), alpha's pending window and beta's ring in shared memory or,
    # where they pass a block, in device memory (sixteen big blanks on four
    # warps in f64; a window of 300 at U = 40); several warps trading emit
    # arrivals through their entries, with and without a chain; passes
    # handing on the chain's carry and the pre-joined arrivals of the next
    # pass's first column (U_b at a pass's last column)
    "table_tdt_0_8": (("tdt", tuple(range(9))), 2, 11, 9, [11, 7], [8, 4], 8, 0),
    "table_tdt_0_32": (("tdt", tuple(range(33))), 2, 6, 5, [6, 4], [4, 2], 8, 0),
    "table_mb_k9": (("multiblank", tuple(range(2, 11))), 2, 12, 9, [12, 9], [8, 5], 8, 0),
    "table_mb_k16_rings_in_device": (("multiblank", tuple(range(2, 18))), 1, 20, 300, [20],
                                     [299], 8, 4),
    "rings_in_device_w300": (("multiblank", (2, 300)), 1, 302, 40, [302], [39], 8, 0),
    "table_tdt_0_8_four_warps": (("tdt", tuple(range(9))), 2, 7, 200, [7, 5], [199, 120], 8, 4),
    "table_no_chain_two_warps": (("tdt", tuple(range(1, 10))), 2, 12, 90, [12, 9], [89, 40], 8,
                                 2),
    "table_passes_tdt_0_8": (("tdt", tuple(range(9))), 2, 5, 500, [5, 4], [499, 383], 8, 0),
}


# Cases held against the plain version alone: they check the wide
# instance's schedule (the plain lattice is held against the JAX package at
# these arcs by the other cases and, at U = 601, by
# tests/test_torch_window_wide.py), and the JAX engines' compiles at their
# shapes would cost most of a minute.
SCHEDULE_ONLY = {"U601_two_warps_mb", "no_chain_four_warps", "wide_8_warps_mb", "wide_16_warps_tdt", "passes_mb_w8",
                 "passes_tdt_no_chain", "passes_tdt_chain", "U601_four_warps_tdt",
                 "no_chain_U601", "table_tdt_0_8", "table_tdt_0_32", "table_mb_k9",
                 "table_mb_k16_rings_in_device", "rings_in_device_w300",
                 "table_tdt_0_8_four_warps", "table_no_chain_two_warps", "table_passes_tdt_0_8"}
# The table instance's cases: (the form the plan takes, whether its rings
# lie in device memory). Each case also replays the other form.
R_, P_ = KW.TABLE, KW.PENDING
TABLE_CASES = {"table_tdt_0_8": (R_, False), "table_tdt_0_32": (P_, False),
               "table_mb_k9": (R_, False), "table_mb_k16_rings_in_device": (R_, True),
               "rings_in_device_w300": (R_, True), "table_tdt_0_8_four_warps": (P_, False),
               "table_no_chain_two_warps": (P_, False), "table_passes_tdt_0_8": (R_, True)}


def _arcs(family, durations):
    if family == "three":  # arcs of three channels; no public loss has one
        return TW.WindowArcs(chain=(1, 2), blank_arcs=((1, (0, 2, 3)), (2, (0, 3))),
                             emit_arcs=((2, (1, 2, 3)),))
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
    p = _plan(B, U, elt, arcs, T=T, n_extra=len(durations), warps=warps)
    assert (p.wide in KW.TABLES) == (case in TABLE_CASES), p
    if case in TABLE_CASES:
        assert (p.wide, p.rings > 0) == TABLE_CASES[case], p
    if family == "three" or case in SCHEDULE_ONLY:
        return
    # The JAX engines clamp as the port does; cells no path reaches hold NEG.
    ref = _jax(family, durations, np.maximum(lpb, NEG), lpe, extra, il, ll)
    for name, x, live in zip(FIELDS, ref, _live(ref)):
        assert np.all(got[name][~live] <= -1e29), name
        np.testing.assert_allclose(got[name][live], np.asarray(x)[live], rtol=1e-10, atol=1e-10,
                                   err_msg=name)
    if case == "infeasible_tdt":  # an odd T_b has no path; T_b = 4 with one label has one
        assert got["ll_forward"][0] < -1e29 < got["ll_forward"][1]


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_emulation_of_the_other_table_form(case):
    """Each table case in the form its plan does not take: the rings form
    where the plan takes the pending one, and the other way round, its
    passes and its rings in shared or device memory as that form plans
    them."""
    (family, durations), B, T, U, il, ll, elt, warps = CASES[case]
    arcs = _arcs(family, durations)
    other = KW.PENDING if TABLE_CASES[case][0] == KW.TABLE else KW.TABLE
    p = _plan(B, U, elt, arcs, T=T, n_extra=len(durations), warps=warps, form=other)
    assert p.wide == other
    _covers(p, U, elt)
    lpb, lpe, extra, il, ll = _channels(B, T, U, len(durations), il, ll, seed=len(case))
    got = emulate(lpb, lpe, extra, arcs, il, ll, True, elt, warps, other)
    _check(got, _plain(lpb, lpe, extra, arcs, il, ll), FIELDS, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("family,durations", [
    ("tdt", tuple(range(9))), ("tdt", tuple(range(1, 10))), ("tdt", (0, 1, 2, 4)),
    ("multiblank", tuple(range(2, 18))), ("multiblank", (2, 4, 8, 16, 32, 64, 128, 300))])
def test_pending_table_rows(family, durations):
    """The host's table (``_arc_rows``) that the kernel copies: the chain and
    the arcs in order, then the pending form's arcs sorted by (m, blank
    before emit, table order) and its groups of one m, ascending, each
    naming its first sorted arc, its blank arcs and its arcs."""
    arcs = _arcs(family, durations)
    arc_list = arcs.blank_arcs + arcs.emit_arcs
    rows = np.asarray(KW._arc_rows(arcs)).reshape(-1, 5)
    n = len(arc_list)
    assert [tuple(r[2:2 + r[1]]) for r in rows[1:1 + n]] == [chs for _, chs in arc_list]
    assert [r[0] for r in rows[1:1 + n]] == [m for m, _ in arc_list]
    want = [(m, [arc_list[i][1] for i in b], [arc_list[i][1] for i in e])
            for m, b, e in _groups(arcs)]
    assert _table_groups(arcs) == want
    heads = rows[1 + 2 * n:]
    assert list(heads[:, 0]) == sorted({m for m, _ in arc_list})
    assert heads[0, 1] == 0 and heads[:, 3].sum() == n
    assert list(heads[1:, 1]) == list(np.cumsum(heads[:-1, 3]))


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


def _plan(B, U, elt, arcs=None, betas=True, T=1500, n_extra=None, warps=0, form=0):
    arcs = arcs or _arcs(*TDT)
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    if n_extra is None:
        n_extra = max(c for _, chs in arcs.blank_arcs + arcs.emit_arcs for c in chs) - 1
    return KW.plan(B, T, U, elt, arcs.window, n_arcs, max(n_extra, 0), arcs.chain is not None,
                   betas, N_SM, warps, KW.arc_channels(arcs), KW.by_value(arcs, max(n_extra, 0)),
                   form)


def _covers(p, U, elt):
    """What every plan holds: odd cells within the cap, the passes' columns
    cover U and no pass is empty, shared memory and threads within a block,
    the passes' device memory iff there are several."""
    up = WARP * p.warps * p.cells
    assert p.cells % 2 == 1 and p.cells <= KW.max_cells(elt)
    assert p.cells <= KW.kind_max_cells(p.wide, elt)
    assert (p.passes - 1) * up < U <= p.passes * up
    # the table instance keeps its arcs after its lattices
    table = p.smem - p.lattice_words * elt * p.per_block
    assert p.smem <= KW.SMEM_BYTES and table % KW.TABLE_ARC_BYTES == 0
    assert (table > 0) == (p.wide in KW.TABLES)
    assert p.threads == WARP * p.warps * p.per_block
    assert p.threads <= KW.block_warps(p.wide, elt, p.cells) * WARP
    assert (p.hand > 0) == (p.passes > 1) and (p.passes == 1 or p.wide)
    assert p.warps <= (KW.WIDE_MAX_G if p.wide else KW.MAX_G)


@pytest.mark.parametrize("elt,cap", [(4, 544), (8, 288)])
def test_switch_to_block_kernel_above_the_cap(elt, cap):
    """One warp a lattice (B = 100: too many lattices for more) up to the
    instance of most cells; above it the plan takes four warps (the shapes
    of the earlier block kernel), or two, and passes where the rings of two
    or four warps do not fit a block."""
    for U in (1, 31, 32, 33, cap - 1, cap):
        p = _plan(100, U, elt)
        assert not p.wide and p.warps == 1 and p.cells == KW.cells(U) <= KW.max_cells(elt)
        assert p.cells % 2 == 1 and WARP * p.cells >= U > WARP * (p.cells - 2)
        assert p.smem <= KW.SMEM_BYTES and p.threads <= KW.MAX_WARPS * WARP
    for U in (cap + 1, 600, 1100):
        p = _plan(100, U, elt)
        _covers(p, U, elt)
        assert p.warps > 1 and p.blocks == -(-200 // p.per_block)
        n_arcs, W = 6, 4  # TDT (0, 1, 2, 4)
        narrow_fits = any(KW.cells(-(-U // g)) <= KW.max_cells(elt) and KW.lattice_words(
            g, KW.cells(-(-U // g)), W, n_arcs, 4, 2) * elt <= KW.SMEM_BYTES for g in (2, 4))
        assert p.wide == (not narrow_fits) and (p.passes > 1) == (not narrow_fits)
    assert _plan(100, 600, 4)[:4] == (False, 4, 5, 1)
    assert _plan(100, 1100, 4)[:4] == (True, 2, 9, 2)


@pytest.mark.parametrize("B,U,betas,warps", [
    (16, 301, True, 4), (16, 301, False, 4), (64, 301, True, 2), (33, 301, True, 4),
    (34, 301, True, 2),
    (32, 301, True, 4), (128, 301, True, 1), (16, 257, True, 4), (16, 256, True, 2),
    (16, 129, True, 2), (16, 128, True, 1), (128, 41, True, 1), (64, 21, True, 1),
    (16, 600, True, 4), (16, 1100, True, 4)])
def test_warps_a_lattice(B, U, betas, warps):
    """Four or two warps a lattice where each warp gets more than 64 columns
    and the lattices' warps stay within two an SM; with four warps U = 600
    f32 fits one pass of the narrow instance, U = 1100 takes two passes."""
    p = _plan(B, U, 4, betas=betas)
    assert p.warps == warps
    _covers(p, U, 4)
    assert p.passes == (2 if U == 1100 else 1) and p.wide == (U == 1100)
    assert p.cells == KW.cells(-(-U // p.passes // warps)) or p.passes > 1


def test_no_chain_takes_one_warp():
    """TDT without a 0 duration (no chain) takes warps a lattice by the same
    rule as a lattice with a chain: four at B = 16, U = 301, and forced four
    runs; U = 601 at B = 32 (one warp would need 19 cells) takes four."""
    arcs = TW.tdt_arcs((1, 2))
    assert _plan(16, 301, 4, arcs).warps == 4
    assert _plan(16, 301, 4, arcs, warps=4)[:4] == (False, 4, 3, 1)
    assert _plan(32, 601, 4, TW.tdt_arcs((1, 2, 4)), T=1000)[:4] == (False, 4, 5, 1)


def test_switch_where_the_rings_do_not_fit():
    """TDT with eight durations up to 8 frames at U = 301 keeps 16 arcs × 9
    rows of departures: more than a block holds at every G, so two passes of
    one warp and five cells; at U = 41 one pass fits."""
    arcs = TW.tdt_arcs((1, 2, 3, 4, 5, 6, 7, 8))
    p = _plan(100, 301, 4, arcs, n_extra=8)
    assert p[:4] == (True, 1, 5, 2)
    _covers(p, 301, 4)
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    for g in (1, 2, 4, 8, 16):
        assert KW.lattice_words(g, KW.cells(-(-301 // g)), 8, n_arcs, 8, 2, True) * 4 > \
            KW.SMEM_BYTES
    assert _plan(100, 41, 4, arcs, n_extra=8)[:4] == (False, 1, 3, 1)


def test_switch_beyond_32_bit_offsets():
    """Past 32-bit offsets inside a lattice the wide instance (64-bit
    offsets) takes the same warps and cells in one pass."""
    U, Cx = 301, 4
    T_max = KW.INT_MAX // (U * Cx) - KW.AHEAD
    narrow, wide = _plan(4, U, 4, T=T_max), _plan(4, U, 4, T=T_max + 1)
    assert not narrow.wide and wide.wide and wide.passes == 1
    assert (narrow.warps, narrow.cells) == (wide.warps, wide.cells)


@pytest.mark.parametrize("G,C,elt", [(1, 1, 4), (1, 3, 4), (4, 3, 4), (1, 11, 4), (1, 9, 8)])
def test_shared_memory_of_a_lattice(G, C, elt):
    """The copy ring, alpha's departure rings and staged rows or beta's ring
    and slack, the exchange, in values; a lattice of the duration-arc losses'
    main shapes fits a block. The wide instance keeps the passes' values in
    each copied row, one more column a ring row, and 16 warps' exchange."""
    up = G * WARP * C
    for n_arcs, W, Cx in ((3, 4, 2), (6, 4, 4)):  # multi-blank (2, 4), TDT (0, 1, 2, 4)
        copy = KW.COPY_ROWS * ((2 + Cx) * up + KW.ROW_PAD)
        alpha = copy + n_arcs * (W + 1) * up + 2 * up + KW.xch_words(False)
        beta = copy + (W + 1) * up + KW.SLACK + KW.xch_words(False)
        assert KW.lattice_words(G, C, W, n_arcs, Cx, 2) == max(alpha, beta)
        assert KW.lattice_words(G, C, W, n_arcs, Cx, 1) == alpha
        assert max(alpha, beta) * elt <= KW.SMEM_BYTES
        copy = KW.COPY_ROWS * ((2 + Cx) * up + KW.ROW_PAD + 2 + n_arcs)
        alpha = copy + n_arcs * (W + 1) * (up + 1) + 2 * up + 128
        beta = copy + (W + 1) * (up + 1) + KW.SLACK + 128
        assert KW.lattice_words(G, C, W, n_arcs, Cx, 2, True) == max(alpha, beta)


# The table instance's shapes on the card: (name, B, T, U, arcs, extra
# channels, the form the plan takes, whether its rings lie in device
# memory).
TABLE_SHAPES = [
    ("tdt_0_8_long_t", 16, 1500, 301, TW.tdt_arcs(tuple(range(9))), 9, KW.PENDING, False),
    ("tdt_0_8_headline", 128, 150, 41, TW.tdt_arcs(tuple(range(9))), 9, KW.TABLE, False),
    ("tdt_d33_headline", 128, 150, 41, TW.tdt_arcs(tuple(range(33))), 33, KW.PENDING, False),
    ("mb_k9_headline", 128, 150, 41, TW.multiblank_arcs(tuple(range(2, 11))), 9, KW.TABLE,
     False),
    ("mb_k16_headline", 128, 150, 41, TW.multiblank_arcs(tuple(range(2, 18))), 16, KW.PENDING,
     False),
    ("w300", 4, 1500, 301, TW.multiblank_arcs((2, 4, 8, 16, 32, 64, 128, 300)), 8, KW.TABLE,
     True),
]


@pytest.mark.parametrize("case", TABLE_SHAPES, ids=[c[0] for c in TABLE_SHAPES])
def test_table_rings_in_shared_memory(case):
    """Alpha's pending window holds W + 1 slots of UP + G pairs whatever the
    number of arcs: in the pending form the table instance's rings fit a
    block at TDT 0 … 8 (long_t, headline), D = 33, K = 9 and K = 16
    (headline); only a window of hundreds of frames keeps them in device
    memory. The plan takes the pending form where, on the same warps and
    cells, the rings form's rings pass a block (long_t, D = 33) or hold
    fewer lattices a block (K = 16), else the rings form."""
    name, B, T, U, arcs, n_extra, form, in_device = case
    p = _plan(B, U, 4, arcs, T=T, n_extra=n_extra)
    assert p.wide == form and p.passes == 1 and p.hand == 0
    assert (p.rings > 0) == in_device, p
    _covers(p, U, 4)
    q = _plan(B, U, 4, arcs, T=T, n_extra=n_extra, form=KW.PENDING)
    r = _plan(B, U, 4, arcs, T=T, n_extra=n_extra, form=KW.TABLE)
    assert (q.rings > 0) == (name == "w300"), q
    same = q[1:3] == r[1:3] and q.blocks <= r.blocks
    assert p == (q if same and (q.rings == 0 < r.rings or q.blocks < r.blocks) else r)
    up = WARP * q.warps * q.cells
    W, n_arcs = arcs.window, len(arcs.blank_arcs) + len(arcs.emit_arcs)
    for n in (1, n_arcs, 1000):
        assert KW.alpha_ring_words(q.warps, q.cells, W, n, KW.PENDING) == \
            2 * (W + 1) * (up + q.warps)
    if in_device:
        assert p.rings == 2 * B * KW.ring_words(p.warps, p.cells, W, n_arcs, p.wide)


@pytest.mark.parametrize("B,U,betas,per_block", [
    (128, 41, True, 2), (128, 41, False, 1), (64, 21, True, 1), (16, 301, True, 1),
    (1, 5, False, 1), (300, 41, True, 5), (1000, 21, True, 8), (1000, 21, False, 8),
    (1000, 301, True, 2)])
def test_lattices_a_block(B, U, betas, per_block):
    p = _plan(B, U, 4, betas=betas, T=150)
    lattices = B * (2 if betas else 1)
    assert not p.wide and p.per_block == per_block
    assert p.threads == WARP * p.warps * per_block <= KW.MAX_WARPS * WARP
    assert p.blocks == -(-lattices // per_block)
    assert (p.blocks - 1) * p.per_block < lattices <= p.blocks * p.per_block
    assert p.smem == p.lattice_words * 4 * per_block <= KW.SMEM_BYTES


# The shapes that took the earlier block kernel, on the plan: (name, B, T, U,
# element bytes, arcs, the plan's (wide, warps, cells, passes)).
FORMER_BLOCK_SHAPES = [
    ("mb_B128_U601", 128, 1000, 601, 4, TW.multiblank_arcs((2, 4)), (False, 4, 5, 1)),
    ("tdt_B128_U601", 128, 1000, 601, 4, TW.tdt_arcs((0, 1, 2, 4)), (False, 4, 5, 1)),
    ("tdt124_B32_U601", 32, 1000, 601, 4, TW.tdt_arcs((1, 2, 4)), (False, 4, 5, 1)),
    ("mb_f64_B4_U601", 4, 300, 601, 8, TW.multiblank_arcs((2, 4)), (False, 4, 5, 1)),
    ("tdt_f64_B4_U601", 4, 300, 601, 8, TW.tdt_arcs((0, 1, 2, 4)), (True, 4, 3, 2)),
    ("mb_U2000", 128, 1000, 2000, 4, TW.multiblank_arcs((2, 4)), (True, 2, 17, 2)),
    ("mb248_U1100", 16, 1000, 1100, 4, TW.multiblank_arcs((2, 4, 8)), (True, 4, 5, 2)),
    ("mb_w8_U30000", 1, 8, 30000, 4, TW.multiblank_arcs((8,)), (True, 8, 7, 17)),
    ("mb_w8_U30000_f64", 1, 8, 30000, 8, TW.multiblank_arcs((8,)), (True, 4, 7, 34)),
]


@pytest.mark.parametrize("case", FORMER_BLOCK_SHAPES, ids=[c[0] for c in FORMER_BLOCK_SHAPES])
def test_plans_at_the_former_block_shapes(case):
    _, B, T, U, elt, arcs, want = case
    p = _plan(B, U, elt, arcs, T=T)
    assert tuple(p[:4]) == want, p
    _covers(p, U, elt)
    if p.passes > 1:
        assert p.hand == B * 2 * 2 * T * (2 + len(arcs.blank_arcs) + len(arcs.emit_arcs))


@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("U", [33, 301, 601, 5000])
def test_forced_warps_run(U, warps):
    """Every forced G up to 16 gives a plan that runs: the narrow instance
    up to 4 warps where it fits, else the wide one, in passes where needed."""
    p = _plan(3, U, 4, T=50, warps=warps)
    assert p.warps == warps
    _covers(p, U, 4)
    assert p.wide == (warps > 4 or p.passes > 1)


def test_no_plan_for_a_window_past_one_warp():
    """A window so long that one warp's rings do not fit a block runs on the
    table instance with its rings in device memory (at any U, in passes
    where the copy ring needs them); no plan only where even one warp's copy
    ring of a 32-column pass passes a block (thousands of channels)."""
    arcs = TW.multiblank_arcs((900,))
    p = _plan(2, 40, 4, arcs, T=50, n_extra=1)
    assert p.wide == KW.TABLE and p.passes == 1
    assert p.rings == 2 * 2 * KW.ring_words(p.warps, p.cells, 900, 2)
    _covers(p, 40, 4)
    wide = _plan(2, 40000, 4, TW.multiblank_arcs((300, 2, 4, 8, 16, 32, 64, 128, 256)), T=50)
    assert wide.wide == KW.TABLE and wide.passes > 1 and wide.rings > 0 and wide.hand > 0
    _covers(wide, 40000, 4)
    assert _plan(2, 40, 4, TW.multiblank_arcs((200,)), T=50, n_extra=1).wide != KW.TABLE
    assert KW.plan(2, 50, 40, 4, 2, 2, 3000, True, True, N_SM, by_value=False) is None


def test_cells_are_odd_and_cover_the_columns():
    for n in range(1, 600):
        C = KW.cells(n)
        assert C % 2 == 1 and WARP * C >= n and (C <= 2 or WARP * (C - 2) < n)
        # a lane stride of C words touches 32 distinct banks
        assert len({(lane * C) % 32 for lane in range(WARP)}) == WARP
