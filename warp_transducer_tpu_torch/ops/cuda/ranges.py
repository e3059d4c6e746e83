"""Wrapper of the range kernel (``csrc/ranges.cu``), the counterpart of the
whole of ``warp_transducer_tpu/ops/pruned.py::ranges_from_posteriors``: the
posterior argmax and the three scans in one launch. The plain version is
``ops/band.py::ranges_from_posteriors`` (``posterior_peaks``, then
``band_starts``).

The kernel plans its launch itself; ``plan`` mirrors that plan for the CPU
tests (``tests/test_torch_ranges_plan.py`` replays the kernel's argmax and
scans in numpy on it), and a card test holds it against the C entry
``wtt_ranges_plan``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import band as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, int32, lib, require, stream

WARP = 32
MAX_WARPS = 32
LANE_MIN = 4  # a lane of a row's group reads at least this many of the row's elements
SCAN_STEP = 8  # steps of a scan iteration (two 16-byte shared-memory words)
_FLOATS = (torch.float32, torch.float64)


class Plan(NamedTuple):
    group: int  # lanes a row (frame): a power of two up to a warp
    warps: int  # a block (one block an utterance)
    smem: int  # shared memory a block, bytes


def chunk(elt: int) -> int:
    """Elements of one array (α or β) a lane loads at once: 48 bytes."""
    return 48 // elt


def plan(T: int, U: int) -> Plan:
    """The range kernel's launch plan for utterances of T frames and rows of
    U elements (``csrc/ranges.cu::plan``): G, the largest power of two up
    to a warp with G·LANE_MIN <= U (else 1), lanes a row; as many warps as
    T rows need at 32/G rows a warp, up to MAX_WARPS; the T starts in
    shared memory, rounded up to a scan iteration, plus one for the loads
    taken ahead."""
    g = 1
    while g < WARP and 2 * g * LANE_MIN <= U:
        g *= 2
    per_warp = WARP // g
    warps = min(max(-(-T // per_warp), 1), MAX_WARPS)
    return Plan(g, warps, (-(-T // SCAN_STEP) + 1) * SCAN_STEP * 4)


def kernel_plan(T: int, U: int) -> Plan:
    """The plan as the C entry ``wtt_ranges_plan`` computes it."""
    out = (ctypes.c_int * 3)()
    lib().wtt_ranges_plan(T, U, out)
    return Plan(*out)


def kernel_registers(dtype: torch.dtype, U: int) -> tuple:
    """(registers a thread, local bytes a thread) of the range kernel
    instance for ``dtype`` and rows of U elements, as ptxas compiled it."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_ranges_attrs(DTYPE_CODES[dtype], U, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"ranges: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def ranges_from_posteriors(alphas: torch.Tensor, betas: torch.Tensor, ll: torch.Tensor,
                           input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                           s_range: int) -> torch.Tensor:
    """``band.ranges_from_posteriors`` on the card: (B, T) int32 band starts
    from the (B, T, U) alphas and betas and the (B,) ll of one lattice, f32
    or f64, in one launch (a block an utterance). On a CPU tensor this is
    the plain version."""
    if alphas.device.type != "cuda":
        return _plain.ranges_from_posteriors(alphas, betas, ll, input_lengths, label_lengths,
                                             s_range)
    S = int(s_range)
    if S < 2:
        raise ValueError(f"s_range must be >= 2, got {S}")
    dev = alphas.device
    require(alphas, "alphas", dev, _FLOATS, 3)
    require(betas, "betas", dev, (alphas.dtype,), 3)
    require(ll, "ll", dev, (alphas.dtype,), 1)
    B, T, U = alphas.shape
    if tuple(betas.shape) != (B, T, U) or tuple(ll.shape) != (B,):
        raise ValueError(f"betas must be {(B, T, U)} and ll {(B,)}; got "
                         f"{tuple(betas.shape)}, {tuple(ll.shape)}")
    if T < 1 or U < 1:
        raise ValueError(f"the lattice must have T >= 1 frames and U >= 1 rows; got {T}, {U}")
    if plan(T, U).smem > SMEM_BYTES:  # one utterance's T starts
        raise ValueError(f"T={T} exceeds the range kernel's limit of about {SMEM_BYTES // 4} "
                         "frames")
    il, lbl = int32(dev, input_lengths, label_lengths)
    ranges = torch.empty((B, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_ranges(alphas.data_ptr(), betas.data_ptr(), ll.data_ptr(),
                               DTYPE_CODES[alphas.dtype], il.data_ptr(), lbl.data_ptr(),
                               ranges.data_ptr(), B, T, U, S, stream(dev))
    check(err, "ranges")
    return ranges
