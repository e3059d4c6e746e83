"""Wrapper of the lattice kernel (``csrc/wavefront.cu``), the counterpart of
``warp_transducer_tpu/ops/pallas/wavefront_stream.py`` and
``ops/pallas/wavefront.py``.

The kernel plans its launch itself; ``plan`` mirrors that plan in Python for
the CPU tests (``tests/test_torch_wavefront_plan.py``), and a card test
holds it against the C entry ``wtt_wavefront_plan``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import lattice as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_LATTICE_DTYPES = (torch.float32, torch.float64)

WARP = 32
# The band kernel (csrc/wavefront.cu): a warp a band of 32 columns, the
# lattice's bands in one block; rows of lpb and lpe copied AHEAD diagonals
# ahead into rings of RING rows, each lpb word then holding its cell's result.
AHEAD = 8
RING = 32 + AHEAD
MAX_LATTICES_PER_BLOCK = 4
MAX_BANDS = 16
MAX_WARPS = 16  # a block (up to 128 registers a thread)
EDGE_BYTES = MAX_LATTICES_PER_BLOCK * 2 * MAX_BANDS * 8  # the bands' edge words
# The band kernel indexes a lattice with 32-bit offsets, up to (T + U + 2·RING)·U.
MAX_OFFSET = 2 ** 31 - 1


class Plan(NamedTuple):
    band_mode: bool  # the band kernel; else the block kernel
    bands: int  # warps a lattice (0 in block mode)
    per_block: int  # lattices a block
    blocks: int
    threads: int  # a block
    smem: int  # dynamic shared memory a block, bytes


def band_bytes(elt: int) -> int:
    """Shared memory of one band: the rings of lpb (then results) and lpe."""
    return 2 * RING * WARP * elt


def max_bands(elt: int) -> int:
    """Bands whose rings fit a block: 16 in f32 (U <= 512), 11 in f64
    (U <= 352); above, the block kernel."""
    return min(MAX_BANDS, (SMEM_BYTES - EDGE_BYTES) // band_bytes(elt))


def plan(B: int, T: int, U: int, elt: int, compute_betas: bool, n_sm: int) -> Plan:
    """The kernel's launch plan for B lattices of T frames and U labels of
    ``elt``-byte values on a card of ``n_sm`` SMs
    (``csrc/wavefront.cu::plan``)."""
    lattices = B * (2 if compute_betas else 1)
    bands = -(-U // WARP)
    small = (T + U + 2 * RING) * U <= MAX_OFFSET
    if small and 1 <= bands <= max_bands(elt):
        cap = min(MAX_LATTICES_PER_BLOCK, MAX_WARPS // bands, max_bands(elt) // bands)
        per_block = max(1, min(cap, -(-lattices // n_sm)))
        return Plan(True, bands, per_block, -(-lattices // per_block), WARP * bands * per_block,
                    band_bytes(elt) * bands * per_block)
    threads = -(-U // WARP) * WARP if U < 1024 else 1024
    return Plan(False, 0, 1, lattices, threads, 2 * U * elt)


def kernel_plan(B: int, T: int, U: int, dtype: torch.dtype, compute_betas: bool,
                n_sm: int) -> Plan:
    """The plan as the C entry ``wtt_wavefront_plan`` computes it."""
    out = (ctypes.c_int * 6)()
    lib().wtt_wavefront_plan(B, T, U, DTYPE_CODES[dtype], int(compute_betas), n_sm, out)
    if out[0] < 0:
        raise ValueError(f"the lattice kernel takes no {dtype}")
    return Plan(bool(out[0]), *out[1:])


def kernel_registers(U: int, dtype: torch.dtype) -> tuple:
    """(registers a thread, local bytes a thread) of the kernel that a
    lattice of U labels runs, as ptxas compiled it; for the measurement
    scripts."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_wavefront_attrs(U, DTYPE_CODES[dtype], ctypes.byref(regs),
                                    ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"wavefront: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> _plain.LatticeResult:
    """``ops.lattice.forward_backward`` on the card: the warps of a block
    walk each lattice, a band of 32 columns each (alpha and beta side by
    side), or the block kernel where U is above the band kernel's cap
    (``plan``). On a CPU tensor this is the plain version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, input_lengths, label_lengths,
                                       compute_betas=compute_betas)
    dev = lpb.device
    require(lpb, "lpb", dev, _LATTICE_DTYPES, 3)
    require(lpe, "lpe", dev, (lpb.dtype,), 3)
    if lpe.shape != lpb.shape:
        raise ValueError(f"lpe shape {tuple(lpe.shape)} != lpb shape {tuple(lpb.shape)}")
    B, T, U = lpb.shape
    max_u = SMEM_BYTES // (2 * lpb.element_size())  # the block kernel: two diagonals of U
    if U > max_u:
        raise ValueError(
            f"U={U} exceeds the lattice kernel's limit of {max_u} for {lpb.dtype}: "
            "two diagonals of U values must fit the 227 KB of shared memory a "
            "block may use")
    il = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    ll = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb) if compute_betas else None
    ll_forward = torch.empty((B,), dtype=lpb.dtype, device=dev)
    ll_backward = torch.empty_like(ll_forward) if compute_betas else None
    with torch.cuda.device(dev):
        err = lib().wtt_wavefront(
            lpb.data_ptr(), lpe.data_ptr(), DTYPE_CODES[lpb.dtype], il.data_ptr(),
            ll.data_ptr(), alphas.data_ptr(),
            None if betas is None else betas.data_ptr(), ll_forward.data_ptr(),
            None if ll_backward is None else ll_backward.data_ptr(),
            B, T, U, int(compute_betas), stream(dev))
    check(err, "wavefront")
    if not compute_betas:
        return _plain.LatticeResult(alphas, alphas, ll_forward, ll_forward)
    return _plain.LatticeResult(alphas, betas, ll_forward, ll_backward)
