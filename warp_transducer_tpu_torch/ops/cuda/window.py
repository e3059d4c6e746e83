"""Wrapper of the pending-window lattice kernel (``csrc/window_stream.cu``;
its walk ``csrc/window_walk.cuh``), the counterpart of
``warp_transducer_tpu/ops/pallas/window_stream.py``.

The kernel plans its launch itself; ``plan`` mirrors that plan in Python for
the CPU tests (``tests/test_torch_window_plan.py``), and a card test holds it
against the C entry ``wtt_window_plan``. One kernel, two instances of each
cell count:

* G warps walk one lattice (an utterance and a direction) row by row, warp
  g owning the columns g·32·C … (g + 1)·32·C - 1 and its lane l the C (odd)
  consecutive ones from g·32·C + l·C. A lattice keeps in shared memory a
  ring of COPY_ROWS rows of its channels (copied AHEAD rows ahead), alpha a
  ring of W + 1 rows of departures per arc and two staged rows, beta a ring
  of W + 1 rows of its own values and SLACK values, and the warps' exchange
  of row totals;
* the narrow instance (G <= 4, arcs of one or two channels, 32-bit offsets
  inside a lattice) runs the main shapes; the wide one takes every other
  lattice: G up to 16, arcs of three channels, 64-bit offsets, and passes —
  where a lattice's rings do not fit a block at any G, its columns are cut
  into passes of 32·G·C walked one after another, each handing on per row
  the chain's carry and the edge column through device memory
  (``Plan.hand`` values, which the wrapper allocates).

* the table instance takes every arc table: the wide walk, its arcs (any
  number, over any number of channels) read from a table in device memory
  that the block copies into its shared memory, and, where a lattice's
  rings pass a block, the rings in device memory (``Plan.rings`` values,
  which the wrapper allocates).

G is 4 or 2 where U is long and the lattices are few, else 1; where that G
does not run (C past ``max_cells`` or the rings past a block) the plan
takes 4 warps (or 2), then the wide instance, then passes; arcs past the
by-value table (more than ``BY_VALUE_ARCS`` blank or emit arcs, or more than
``BY_VALUE_EXTRA`` extra channels) and windows whose rings pass a block at
every G and pass take the table instance. No U, window or duration set is
refused.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import window as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, device_table, lib, require, stream

_LATTICE_DTYPES = (torch.float32, torch.float64)

WARP = 32
# Channel rows copied AHEAD rows ahead into a ring of COPY_ROWS; the narrow
# instance takes at most MAX_G warps a lattice and MAX_WARPS a block, the
# wide one WIDE_MAX_G and ``wide_warps``.
AHEAD = 3
COPY_ROWS = AHEAD + 1
MAX_WARPS = 8
MAX_G = 4
WIDE_MAX_G = 16
# Channels an arc of the narrow instance sums, at most (the wide one: 3).
ARC_CHANNELS = 2
# Values after beta's ring that an emit arc's load at the last padded column
# may touch.
SLACK = 32
ROW_PAD = 4  # words after a copied row's channels; the first holds 0
INT_MAX = 2 ** 31 - 1
# The by-value arc table of the narrow and wide instances
# (csrc/window_walk.cuh::kMaxArcs, kMaxChannels): at most this many blank
# and this many emit arcs, over lpb, lpe and this many extra channels.
BY_VALUE_ARCS = 9
BY_VALUE_EXTRA = 8
# Bytes of one arc of the table instance's table in shared memory
# (SlotArc<3>: m, n, three bases, three strides).
TABLE_ARC_BYTES = 32
# The instances (Plan.wide).
NARROW, WIDE, TABLE = 0, 1, 2
# Warps a block of the table instance, at every C (window_walk.cuh::kTableWarps).
TABLE_WARPS = 8


def xch_words(wide: bool) -> int:
    """The exchange of a lattice's warps: two slots of the instance's most
    warps' four values."""
    return 2 * (WIDE_MAX_G if wide else MAX_G) * 4


def wide_warps(elt: int, C: int) -> int:
    """Warps a block of the wide instance of C cells a lane: 16 where a
    thread's registers fit 128 (f32 C <= 13, f64 C = 1), else 8."""
    return 16 if (C <= 13 if elt == 4 else C <= 1) else 8


def block_warps(wide: int, elt: int, C: int) -> int:
    """The most warps a block of the instance ``wide`` of C cells a lane."""
    return TABLE_WARPS if wide == TABLE else wide_warps(elt, C) if wide else MAX_WARPS


def max_cells(elt: int) -> int:
    """The most cells a lane: 17 in f32, 9 in f64."""
    return 17 if elt == 4 else 9


def cells(n: int) -> int:
    """C for a warp of n columns: the least odd number with 32·C >= n."""
    c = -(-n // WARP)
    return c + 1 - c % 2


class Plan(NamedTuple):
    wide: int  # the instance: NARROW, WIDE (G > 4, passes, 64-bit offsets,
    # three-channel arcs) or TABLE (the wide walk over a table in device memory)
    warps: int  # G, warps a lattice
    cells: int  # C, cells a lane
    passes: int  # column passes of 32·G·C a lattice (wide)
    per_block: int  # lattices a block
    blocks: int
    threads: int  # a block
    smem: int  # dynamic shared memory a block, bytes
    lattice_words: int  # shared memory of a lattice, values
    hand: int  # values of device memory the passes hand rows on through (0: one pass)
    rings: int = 0  # values of device memory of the rings (0: in shared memory)


def lattice_words(G: int, C: int, W: int, n_arcs: int, n_extra: int, dirs: int,
                  wide: bool = False, dev_rings: bool = False) -> int:
    """Values of one lattice's shared memory: the copy ring of COPY_ROWS rows
    (lpb and lpe of UP = G·32·C values each, then UP·n_extra extras, ROW_PAD
    words and, wide, the 2 + n_arcs values a row the passes hand on), then
    alpha's departure rings (n_arcs × (W + 1) rows) and two staged rows of UP
    or beta's ring of W + 1 rows and SLACK values, then the exchange; the
    larger of alpha's and beta's where the block holds both. The wide rings'
    rows keep one more column (the edge between passes)."""
    up = G * WARP * C
    rs = up + (1 if wide else 0)
    copy = COPY_ROWS * ((2 + n_extra) * up + ROW_PAD + (2 + n_arcs if wide else 0))
    if dev_rings:  # the table instance's rings in device memory: alpha's staged rows stay
        return copy + 2 * up + xch_words(wide)
    alpha = copy + n_arcs * (W + 1) * rs + 2 * up + xch_words(wide)
    beta = copy + (W + 1) * rs + SLACK + xch_words(wide)
    return max(alpha, beta) if dirs == 2 else alpha


def ring_words(G: int, C: int, W: int, n_arcs: int) -> int:
    """Values of a lattice's rings in device memory (the table instance):
    the larger of alpha's departure rings and beta's ring and slack."""
    rs = G * WARP * C + 1
    return max(n_arcs * (W + 1) * rs, (W + 1) * rs + SLACK)


def by_value(arcs: _plain.WindowArcs, n_extra: int) -> bool:
    """Whether the arcs fit the narrow and wide instances' by-value table."""
    return (n_extra <= BY_VALUE_EXTRA and len(arcs.blank_arcs) <= BY_VALUE_ARCS
            and len(arcs.emit_arcs) <= BY_VALUE_ARCS)


def preferred_warps(U: int, lattices: int, n_sm: int) -> int:
    """G0: 4 or 2 where each warp gets more than 64 columns and the
    lattices' warps stay within two an SM, else 1."""
    return next((g for g in (4, 2) if U > 2 * WARP * g and lattices * g <= 2 * n_sm), 1)


def plan(B: int, T: int, U: int, elt: int, W: int, n_arcs: int, n_extra: int, has_chain: bool,
         compute_betas: bool, n_sm: int, warps: int = 0, arc_channels: int = 2,
         by_value: bool = True) -> Plan | None:
    """The kernel's launch plan for B lattices of T frames and U labels of
    ``elt``-byte values, a longest duration W, n_arcs blank and emit arcs,
    n_extra extra channels, with or without a chain, arcs of up to
    ``arc_channels`` channels, on a card of ``n_sm`` SMs; ``warps`` a
    lattice forced, or 0 for the rule (``csrc/window_stream.cu::plan``):
    the narrow instance at G0, else at 4 … 2·G0, the first that runs; else
    the wide one at G0 … 16 in one pass; else the fewest passes that run on
    some G. Where the arcs pass the by-value table (``by_value`` False) or
    none of those runs: the table instance at G0 … 16 in one pass with its
    rings in shared memory, else with them in device memory, else in the
    fewest passes that run with them there.
    None only where even one warp's copy ring of a 32-column pass does not
    fit a block (thousands of channels)."""
    dirs = 2 if compute_betas else 1
    lattices = B * dirs
    G0 = warps or preferred_warps(U, lattices, n_sm)
    narrow = (by_value and arc_channels <= ARC_CHANNELS
              and (T + AHEAD) * U * max(n_extra, 1) <= INT_MAX)
    table_bytes = (n_arcs + 1) * TABLE_ARC_BYTES
    dev = False  # the table instance's rings in device memory

    def runs(G, C, wide):
        extra = table_bytes if wide == TABLE else 0
        most = TABLE_WARPS if wide == TABLE else wide_warps(elt, C)
        return (C <= max_cells(elt) and (not wide or G <= most)
                and lattice_words(G, C, W, n_arcs, n_extra, dirs, wide, dev) * elt + extra
                <= SMEM_BYTES)

    def doublings(top):
        g = G0
        while g <= top:
            yield g
            if warps:
                return
            g *= 2

    def narrow_order():
        """G0, then 4 … 2·G0: more warps walk a row sooner (PERF.md §6)."""
        yield G0
        g = MAX_G
        while not warps and g > G0:
            yield g
            g //= 2

    def in_passes(kind):
        """The fewest passes of the instance ``kind`` that run on some G."""
        n = 2
        while -(-U // (n - 1)) > WARP:
            cols = -(-U // n)
            g = next((g for g in doublings(WIDE_MAX_G) if runs(g, cells(-(-cols // g)), kind)),
                     None)
            if g is not None:
                C = cells(-(-cols // g))
                return (kind, g, C, -(-U // (g * WARP * C)))
            n += 1
        return None

    found = None
    kinds = ((NARROW, WIDE) if narrow else (WIDE,)) if by_value else ()
    for wide in kinds:
        order = doublings(WIDE_MAX_G) if wide else (g for g in narrow_order() if g <= MAX_G)
        found = next(((wide, g, cells(-(-U // g)), 1) for g in order
                      if runs(g, cells(-(-U // g)), wide)), None)
        if found:
            break
    if found is None and by_value:
        found = in_passes(WIDE)
    for dev in (False, True):  # the table instance in one pass
        if found is None:
            found = next(((TABLE, g, cells(-(-U // g)), 1) for g in doublings(WIDE_MAX_G)
                          if runs(g, cells(-(-U // g)), TABLE)), None)
            if found is not None:
                break
    if found is None:
        dev = True
        found = in_passes(TABLE)
    if found is None:
        return None
    wide, G, C, passes = found
    dev = dev and wide == TABLE
    nbytes = lattice_words(G, C, W, n_arcs, n_extra, dirs, wide, dev) * elt
    room = SMEM_BYTES - (table_bytes if wide == TABLE else 0)
    cap = min(block_warps(wide, elt, C) // G, room // nbytes)
    per_block = max(1, min(cap, -(-lattices // n_sm)))
    return Plan(wide, G, C, passes, per_block, -(-lattices // per_block), WARP * G * per_block,
                nbytes * per_block + (table_bytes if wide == TABLE else 0), nbytes // elt,
                lattices * 2 * T * (2 + n_arcs) if passes > 1 else 0,
                lattices * ring_words(G, C, W, n_arcs) if dev else 0)


def kernel_plan(B: int, T: int, U: int, dtype: torch.dtype, W: int, n_arcs: int, n_extra: int,
                has_chain: bool, compute_betas: bool, n_sm: int, warps: int = 0,
                arc_channels: int = 2, by_value: bool = True) -> Plan | None:
    """The plan as the C entry ``wtt_window_plan`` computes it."""
    out = (ctypes.c_int * 13)()
    lib().wtt_window_plan(B, T, U, DTYPE_CODES[dtype], W, n_arcs, n_extra, int(has_chain),
                          int(compute_betas), n_sm, warps, arc_channels, int(by_value), out)
    if out[0] < 0:
        raise ValueError(f"the window kernel takes no {dtype}")
    if out[1] == 0:
        return None
    return Plan(out[0], *out[1:9], out[9] + (out[10] << 31), out[11] + (out[12] << 31))


def kernel_registers(p: Plan, dtype: torch.dtype) -> tuple:
    """(registers a thread, local bytes a thread) of the kernel instance
    that plan ``p`` runs, as ptxas compiled it; for the measurement
    scripts."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_window_attrs(p.cells, int(p.wide), DTYPE_CODES[dtype], ctypes.byref(regs),
                                 ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"window_stream: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def arc_channels(arcs: _plain.WindowArcs) -> int:
    """The most channels an arc (the chain among them) sums."""
    return max(len(chs) for chs in ((arcs.chain or (1,)),)
               + tuple(chs for _, chs in arcs.blank_arcs + arcs.emit_arcs))


def lattice_plan(lpb: torch.Tensor, extra: torch.Tensor, arcs: _plain.WindowArcs,
                 compute_betas: bool = True, warps: int = 0) -> Plan | None:
    """``plan`` for these CUDA inputs on their card."""
    B, T, U = lpb.shape
    return plan(B, T, U, lpb.element_size(), arcs.window,
                len(arcs.blank_arcs) + len(arcs.emit_arcs), extra.shape[-1],
                arcs.chain is not None, compute_betas,
                torch.cuda.get_device_properties(lpb.device).multi_processor_count, warps,
                arc_channels(arcs), by_value(arcs, extra.shape[-1]))


def _arc_rows(arcs: _plain.WindowArcs) -> list:
    """The arcs as rows of five ints (m, n, ch0, ch1, ch2), flat: the chain
    first (n = 0: none), then the blank arcs, then the emit arcs."""
    def row(m, chs):
        return [m, len(chs), *chs, *([0] * (_plain.MAX_ARC_CHANNELS - len(chs)))]

    rows = [row(0, arcs.chain or ())]
    rows += [row(m, chs) for m, chs in arcs.blank_arcs + arcs.emit_arcs]
    return [x for r in rows for x in r]


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor, extra: torch.Tensor,
                     arcs: _plain.WindowArcs, input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> _plain.LatticeResult:
    """``ops.window.forward_backward`` on the card, one launch (alpha and
    beta side by side, or alpha alone without betas) at any U (``plan``). On
    a CPU tensor this is the plain version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, extra, arcs, input_lengths, label_lengths,
                                       compute_betas=compute_betas)
    return launch(lpb, lpe, extra, arcs, input_lengths, label_lengths, compute_betas)


def launch(lpb: torch.Tensor, lpe: torch.Tensor, extra: torch.Tensor, arcs: _plain.WindowArcs,
           input_lengths: torch.Tensor, label_lengths: torch.Tensor, compute_betas: bool = True,
           warps: int = 0) -> _plain.LatticeResult:
    """The kernel on CUDA tensors, ``warps`` a lattice forced (0: the
    plan's rule; the measurement scripts compare the choices)."""
    dev = lpb.device
    require(lpb, "lpb", dev, _LATTICE_DTYPES, 3)
    require(lpe, "lpe", dev, (lpb.dtype,), 3)
    require(extra, "extra", dev, (lpb.dtype,), 4)
    B, T, U = lpb.shape
    C = extra.shape[-1]
    if lpe.shape != lpb.shape or extra.shape[:3] != lpb.shape:
        raise ValueError(f"lpe {tuple(lpe.shape)} and extra {tuple(extra.shape)} must match "
                         f"lpb {tuple(lpb.shape)} on (B, T, U)")
    if T < 1 or U < 1:
        raise ValueError(f"the lattice needs T >= 1 and U >= 1; got T={T}, U={U}")
    _plain.check_arcs(arcs, C)
    p = lattice_plan(lpb, extra, arcs, compute_betas, warps)
    if p is None:
        raise ValueError(f"no launch of the window kernel runs {C} extra channels in "
                         f"{lpb.dtype}: one warp's copy ring of a 32-column pass does not fit "
                         f"the {SMEM_BYTES} bytes of shared memory a block may use")
    il = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    ll = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb) if compute_betas else None
    ll_forward = torch.empty((B,), dtype=lpb.dtype, device=dev)
    ll_backward = torch.empty_like(ll_forward) if compute_betas else None
    hand = torch.empty((p.hand,), dtype=lpb.dtype, device=dev) if p.hand else None
    rings = torch.empty((p.rings,), dtype=lpb.dtype, device=dev) if p.rings else None
    flat = _arc_rows(arcs)
    table = device_table(flat, dev).data_ptr() if p.wide == TABLE else None
    with torch.cuda.device(dev):
        err = lib().wtt_window_stream_warps(
            lpb.data_ptr(), lpe.data_ptr(), extra.data_ptr() if C else None,
            DTYPE_CODES[lpb.dtype], C, (ctypes.c_int * len(flat))(*flat),
            len(arcs.blank_arcs), len(arcs.emit_arcs), table, il.data_ptr(), ll.data_ptr(),
            alphas.data_ptr(), None if betas is None else betas.data_ptr(),
            ll_forward.data_ptr(), None if ll_backward is None else ll_backward.data_ptr(),
            B, T, U, int(compute_betas), warps, None if hand is None else hand.data_ptr(),
            None if rings is None else rings.data_ptr(), stream(dev))
    check(err, "window_stream")
    if not compute_betas:
        return _plain.LatticeResult(alphas, alphas, ll_forward, ll_forward)
    return _plain.LatticeResult(alphas, betas, ll_forward, ll_backward)
