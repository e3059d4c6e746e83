"""Wrapper of the lattice kernel (``csrc/wavefront.cu``), the counterpart of
``warp_transducer_tpu/ops/pallas/wavefront_stream.py`` and
``ops/pallas/wavefront.py``.

Two kernels: the band kernel (a lattice's bands in one block) up to the
width one block's shared memory holds (U <= 512 in f32, 352 in f64), and
above it the stripe kernel (the lattice in stripes, the CTAs of a cluster),
at any U. The kernel plans its launch itself; ``plan`` mirrors that plan in
Python for the CPU tests (``tests/test_torch_wavefront_plan.py``), and a
card test holds it against the C entry ``wtt_wavefront_plan``.
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
# The stripe kernel: a lattice wider than one block's rings in stripes, the
# CTAs of a cluster of at most MAX_CLUSTER, handing each stripe's edge column
# over in chunks of CHUNK rows, CHUNKS of them in flight (a ring of
# HAND_ROWS words and 2·CHUNKS mbarriers a CTA).
MAX_CLUSTER = 8
CHUNK = 16
CHUNKS = 4
HAND_ROWS = CHUNK * CHUNKS
HAND_BYTES = HAND_ROWS * 8 + 2 * CHUNKS * 8
# The band kernel keeps a lattice's offsets, up to (T + U + 2·RING)·U, in an
# int where they fit (its step is faster so), else in 64 bits.
MAX_OFFSET = 2 ** 31 - 1


class Plan(NamedTuple):
    bands: int  # warps a lattice (one stripe) or a stripe
    per_block: int  # lattices a block
    blocks: int
    threads: int  # a block
    smem: int  # dynamic shared memory a block, bytes
    stripes: int  # stripes a lattice: 1, the band kernel; more, the stripe kernel
    cluster: int  # CTAs a cluster (the stripe kernel), else 1
    passes: int  # the cluster's passes over the stripes
    wide: bool  # the band kernel with 64-bit offsets


def band_bytes(elt: int) -> int:
    """Shared memory of one band: the rings of lpb (then results) and lpe."""
    return 2 * RING * WARP * elt


def max_bands(elt: int) -> int:
    """Bands whose rings fit a block: 16 in f32 (U <= 512), 11 in f64
    (U <= 352); a wider lattice goes in stripes of at most this many."""
    return min(MAX_BANDS, (SMEM_BYTES - EDGE_BYTES - HAND_BYTES) // band_bytes(elt))


def plan(B: int, T: int, U: int, elt: int, compute_betas: bool, n_sm: int) -> Plan:
    """The kernel's launch plan for B lattices of T frames and U labels of
    ``elt``-byte values on a card of ``n_sm`` SMs
    (``csrc/wavefront.cu::plan``). One stripe: the band kernel, up to four
    lattices a block. More: the stripe kernel, as even stripes as the count
    allows, a cluster of up to MAX_CLUSTER CTAs a lattice, in passes."""
    lattices = B * (2 if compute_betas else 1)
    bands = -(-U // WARP) if U > WARP else 1
    cap = max_bands(elt)
    per_stripe = -(-bands // -(-bands // cap))
    stripes = -(-bands // per_stripe)
    if stripes == 1:
        most = min(MAX_LATTICES_PER_BLOCK, MAX_WARPS // bands, cap // bands)
        per_block = max(1, min(most, -(-lattices // n_sm)))
        cluster = passes = 1
        blocks = -(-lattices // per_block)
        wide = (T + U + 2 * RING) * U > MAX_OFFSET
    else:
        per_block = 1
        cluster = min(stripes, MAX_CLUSTER)
        passes = -(-stripes // cluster)
        blocks = lattices * cluster
        wide = False
    return Plan(per_stripe, per_block, blocks, WARP * per_stripe * per_block,
                band_bytes(elt) * per_stripe * per_block, stripes, cluster, passes, wide)


def kernel_plan(B: int, T: int, U: int, dtype: torch.dtype, compute_betas: bool,
                n_sm: int) -> Plan:
    """The plan as the C entry ``wtt_wavefront_plan`` computes it."""
    out = (ctypes.c_int * len(Plan._fields))()
    lib().wtt_wavefront_plan(B, T, U, DTYPE_CODES[dtype], int(compute_betas), n_sm, out)
    if out[0] < 0:
        raise ValueError(f"the lattice kernel takes no {dtype}")
    return Plan(*out[:-1], bool(out[-1]))


def kernel_registers(U: int, dtype: torch.dtype) -> tuple:
    """(registers a thread, local bytes a thread) of the kernel that a
    lattice of U labels runs (the band kernel, or the stripe kernel), as
    ptxas compiled it; for the measurement scripts."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_wavefront_attrs(U, DTYPE_CODES[dtype], ctypes.byref(regs),
                                    ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"wavefront: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> _plain.LatticeResult:
    """``ops.lattice.forward_backward`` on the card, at any U: the warps of
    a block walk each lattice, a band of 32 columns each (alpha and beta side
    by side), or, above one block's rings, the CTAs of a cluster walk its
    stripes (``plan``), counted under ``wavefront_stripe``. On a CPU tensor
    this is the plain version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, input_lengths, label_lengths,
                                       compute_betas=compute_betas)
    dev = lpb.device
    require(lpb, "lpb", dev, _LATTICE_DTYPES, 3)
    require(lpe, "lpe", dev, (lpb.dtype,), 3)
    if lpe.shape != lpb.shape:
        raise ValueError(f"lpe shape {tuple(lpe.shape)} != lpb shape {tuple(lpb.shape)}")
    B, T, U = lpb.shape
    il = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    ll = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb) if compute_betas else None
    ll_forward = torch.empty((B,), dtype=lpb.dtype, device=dev)
    ll_backward = torch.empty_like(ll_forward) if compute_betas else None
    # The edge columns between a cluster's passes, and their row counts
    # (zero on entry); the stripe count and passes do not depend on the SMs.
    p = plan(B, T, U, lpb.element_size(), compute_betas, 1)
    xedge = xflag = None
    if p.passes > 1:
        between = B * (2 if compute_betas else 1) * (p.passes - 1)
        xedge = torch.empty((between, T), dtype=lpb.dtype, device=dev)
        xflag = torch.zeros((between,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_wavefront(
            lpb.data_ptr(), lpe.data_ptr(), DTYPE_CODES[lpb.dtype], il.data_ptr(),
            ll.data_ptr(), alphas.data_ptr(),
            None if betas is None else betas.data_ptr(), ll_forward.data_ptr(),
            None if ll_backward is None else ll_backward.data_ptr(),
            None if xedge is None else xedge.data_ptr(),
            None if xflag is None else xflag.data_ptr(), B, T, U, int(compute_betas),
            stream(dev))
    check(err, "wavefront_stripe" if p.stripes > 1 else "wavefront")
    if not compute_betas:
        return _plain.LatticeResult(alphas, alphas, ll_forward, ll_forward)
    return _plain.LatticeResult(alphas, betas, ll_forward, ll_backward)
