"""Wrapper of the pending-window lattice kernel (``csrc/window_stream.cu``),
the counterpart of ``warp_transducer_tpu/ops/pallas/window_stream.py``."""
from __future__ import annotations

import ctypes

import torch

from .. import window as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_LATTICE_DTYPES = (torch.float32, torch.float64)
# What the kernel keeps in shared memory beside the ring of W rows: one row
# of U values, and the scans' totals (two sets of 32 sums and of 32 pairs).
_EXTRA_ROWS = 1
_SCAN_TOTALS = 192


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
    """``ops.window.forward_backward`` on the card: grid (B, 2) (alpha and
    beta side by side) or (B, 1) without betas, at every T. On a CPU tensor
    this is the plain version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, extra, arcs, input_lengths, label_lengths,
                                       compute_betas=compute_betas)
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
    smem = ((W + _EXTRA_ROWS) * U + _SCAN_TOTALS) * lpb.element_size()
    if smem > SMEM_BYTES:
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
        err = lib().wtt_window_stream(
            lpb.data_ptr(), lpe.data_ptr(), extra.data_ptr() if C else None,
            DTYPE_CODES[lpb.dtype], C, table, len(arcs.blank_arcs), len(arcs.emit_arcs),
            il.data_ptr(), ll.data_ptr(), alphas.data_ptr(),
            None if betas is None else betas.data_ptr(), ll_forward.data_ptr(),
            None if ll_backward is None else ll_backward.data_ptr(),
            B, T, U, int(compute_betas), stream(dev))
    check(err, "window_stream")
    if not compute_betas:
        return _plain.LatticeResult(alphas, alphas, ll_forward, ll_forward)
    return _plain.LatticeResult(alphas, betas, ll_forward, ll_backward)
