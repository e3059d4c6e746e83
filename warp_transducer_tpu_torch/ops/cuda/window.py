"""Wrapper of the pending-window lattice kernel (``csrc/window_stream.cu``),
the counterpart of ``warp_transducer_tpu/ops/pallas/window_stream.py``.

The kernel plans its launch itself; ``plan`` mirrors that plan in Python for
the CPU tests (``tests/test_torch_window_plan.py``), and a card test holds it
against the C entry ``wtt_window_plan``. Two kernels:

* the warp kernel: G warps walk one lattice (an utterance and a direction)
  row by row, warp g owning the columns g·32·C … (g + 1)·32·C - 1 and its
  lane l the C (odd) consecutive ones from g·32·C + l·C; G is 4 or 2 where a
  chain is solved, U is long and the lattices are few, else 1. A lattice
  keeps in shared memory a ring of COPY_ROWS rows of its channels (copied
  AHEAD rows ahead), alpha a ring of W + 1 rows of departures per arc and
  two staged rows, beta a ring of W + 1 rows of its own values and SLACK
  values, and the warps' exchange of row totals (XCH_WORDS);
* the block kernel, above the warp kernel's cap (``max_cells``), where a
  lattice's rings do not fit a block, or for an arc of three channels (the
  warp kernel reads two a cell; no public loss has one): a block per lattice
  and direction, a thread a column, the ring of W pending rows, one staging
  row and the block scans' totals in shared memory.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import window as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_LATTICE_DTYPES = (torch.float32, torch.float64)

WARP = 32
# The warp kernel (csrc/window_stream.cu): channel rows copied AHEAD rows
# ahead into a ring of COPY_ROWS; at most MAX_WARPS warps a block and MAX_G
# warps a lattice.
AHEAD = 3
COPY_ROWS = AHEAD + 1
MAX_WARPS = 8
MAX_G = 4
# Values after beta's ring that an emit arc's load at the last padded column
# may touch; the exchange: two slots of MAX_G warps' four values.
SLACK = 32
XCH_WORDS = 2 * MAX_G * 4
ROW_PAD = 4  # words after a copied row's channels; the first holds 0
MAX_THREADS = 512  # the block kernel's threads a block
INT_MAX = 2 ** 31 - 1
# What the block kernel keeps in shared memory beside its ring of W rows:
# one row of U values, and the scans' totals (two sets of 32 sums and of 32
# pairs).
_EXTRA_ROWS = 1
_SCAN_TOTALS = 192


def max_cells(elt: int) -> int:
    """The warp kernel's most cells a lane: 17 in f32, 9 in f64 (with one
    warp a lattice, U <= 544 and U <= 288)."""
    return 17 if elt == 4 else 9


def cells(n: int) -> int:
    """C for a warp of n columns: the least odd number with 32·C >= n."""
    c = -(-n // WARP)
    return c + 1 - c % 2


class Plan(NamedTuple):
    warp_mode: bool  # the warp kernel; else the block kernel
    warps: int  # G, warps a lattice (0 in block mode)
    cells: int  # C, cells a lane (0 in block mode)
    per_block: int  # lattices a block
    blocks: int
    threads: int  # a block
    smem: int  # dynamic shared memory a block, bytes
    lattice_words: int  # shared memory of a lattice, values (0 in block mode)


def lattice_words(G: int, C: int, W: int, n_arcs: int, n_extra: int, dirs: int) -> int:
    """Values of one lattice's shared memory: the copy ring of COPY_ROWS rows
    (lpb and lpe of UP = G·32·C values each, then UP·n_extra extras and
    ROW_PAD words), then
    alpha's departure rings (n_arcs × (W + 1) rows of UP) and two staged rows
    or beta's ring of W + 1 rows and SLACK values, then the exchange; the
    larger of alpha's and beta's where the block holds both."""
    up = G * WARP * C
    copy = COPY_ROWS * ((2 + n_extra) * up + ROW_PAD)
    alpha = copy + n_arcs * (W + 1) * up + 2 * up + XCH_WORDS
    beta = copy + (W + 1) * up + SLACK + XCH_WORDS
    return max(alpha, beta) if dirs == 2 else alpha


def plan(B: int, T: int, U: int, elt: int, W: int, n_arcs: int, n_extra: int, has_chain: bool,
         compute_betas: bool, n_sm: int, warps: int = 0) -> Plan:
    """The kernel's launch plan for B lattices of T frames and U labels of
    ``elt``-byte values, a longest duration W, n_arcs blank and emit arcs,
    n_extra extra channels, with or without a chain, on a card of ``n_sm``
    SMs; ``warps`` a lattice forced, or 0 for the rule
    (``csrc/window_stream.cu::plan``)."""
    dirs = 2 if compute_betas else 1
    lattices = B * dirs
    G = warps or next((g for g in (4, 2) if has_chain and U > 2 * WARP * g
                       and lattices * g <= 2 * n_sm), 1)
    C = cells(-(-U // G))
    nbytes = lattice_words(G, C, W, n_arcs, n_extra, dirs) * elt
    if not warps and G > 1 and (C > max_cells(elt) or nbytes > SMEM_BYTES):
        G, C = 1, cells(U)
        nbytes = lattice_words(G, C, W, n_arcs, n_extra, dirs) * elt
    small = (T + AHEAD) * U * max(n_extra, 1) <= INT_MAX
    if (small and U >= 1 and G <= MAX_G and (has_chain or G == 1) and C <= max_cells(elt)
            and nbytes <= SMEM_BYTES):
        cap = min(MAX_WARPS // G, SMEM_BYTES // nbytes)
        per_block = max(1, min(cap, -(-lattices // n_sm)))
        return Plan(True, G, C, per_block, -(-lattices // per_block), WARP * G * per_block,
                    nbytes * per_block, nbytes // elt)
    threads = -(-U // WARP) * WARP if U <= MAX_THREADS else MAX_THREADS
    return Plan(False, 0, 0, 1, B, threads, block_smem(U, W, elt), 0)


def block_smem(U: int, W: int, elt: int) -> int:
    """Shared memory of the block kernel: W + 1 rows of U values and the
    scans' totals."""
    return ((W + _EXTRA_ROWS) * U + _SCAN_TOTALS) * elt


def kernel_plan(B: int, T: int, U: int, dtype: torch.dtype, W: int, n_arcs: int, n_extra: int,
                has_chain: bool, compute_betas: bool, n_sm: int, warps: int = 0) -> Plan:
    """The plan as the C entry ``wtt_window_plan`` computes it."""
    out = (ctypes.c_int * 8)()
    lib().wtt_window_plan(B, T, U, DTYPE_CODES[dtype], W, n_arcs, n_extra, int(has_chain),
                          int(compute_betas), n_sm, warps, out)
    if out[0] < 0:
        raise ValueError(f"the window kernel takes no {dtype}")
    return Plan(bool(out[0]), *out[1:])


def kernel_registers(p: Plan, U: int, dtype: torch.dtype) -> tuple:
    """(registers a thread, local bytes a thread) of the kernel that plan
    ``p`` runs for U labels, as ptxas compiled it; for the measurement
    scripts."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_window_attrs(p.cells if p.warp_mode else 0, U, DTYPE_CODES[dtype],
                                 ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"window_stream: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def _arc_table(arcs: _plain.WindowArcs):
    """The arcs as rows of five ints (m, n, ch0, ch1, ch2): the chain first
    (n = 0: none), then the blank arcs, then the emit arcs."""
    def row(m, chs):
        return [m, len(chs), *chs, *([0] * (_plain.MAX_ARC_CHANNELS - len(chs)))]

    rows = [row(0, arcs.chain or ())]
    rows += [row(m, chs) for m, chs in arcs.blank_arcs + arcs.emit_arcs]
    flat = [x for r in rows for x in r]
    return (ctypes.c_int * len(flat))(*flat)


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor, extra: torch.Tensor,
                     arcs: _plain.WindowArcs, input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> _plain.LatticeResult:
    """``ops.window.forward_backward`` on the card, one launch: the warp
    kernel (alpha and beta side by side, or alpha alone without betas), or
    the block kernel above its cap (``plan``). On a CPU tensor this is the
    plain version."""
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
    W = arcs.window
    # The block kernel takes every U the warp kernel does not; its limit is
    # the wrapper's.
    if block_smem(U, W, lpb.element_size()) > SMEM_BYTES:
        max_u = (SMEM_BYTES // lpb.element_size() - _SCAN_TOTALS) // (W + _EXTRA_ROWS)
        raise ValueError(
            f"U={U} exceeds the window kernel's limit of {max_u} for {lpb.dtype} and a longest "
            f"duration of {W}: {W} + {_EXTRA_ROWS} rows of U values must fit the "
            f"{SMEM_BYTES} bytes of shared memory a block may use")
    il = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    ll = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb) if compute_betas else None
    ll_forward = torch.empty((B,), dtype=lpb.dtype, device=dev)
    ll_backward = torch.empty_like(ll_forward) if compute_betas else None
    table = _arc_table(arcs)
    with torch.cuda.device(dev):
        err = lib().wtt_window_stream_warps(
            lpb.data_ptr(), lpe.data_ptr(), extra.data_ptr() if C else None,
            DTYPE_CODES[lpb.dtype], C, table, len(arcs.blank_arcs), len(arcs.emit_arcs),
            il.data_ptr(), ll.data_ptr(), alphas.data_ptr(),
            None if betas is None else betas.data_ptr(), ll_forward.data_ptr(),
            None if ll_backward is None else ll_backward.data_ptr(),
            B, T, U, int(compute_betas), warps, stream(dev))
    check(err, "window_stream")
    if not compute_betas:
        return _plain.LatticeResult(alphas, alphas, ll_forward, ll_forward)
    return _plain.LatticeResult(alphas, betas, ll_forward, ll_backward)
