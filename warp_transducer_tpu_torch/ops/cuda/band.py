"""Wrappers of the band kernels: ``csrc/band_prep.cu`` (the counterpart of
``warp_transducer_tpu/ops/pallas/band_pipeline.py::_prep_kernel``, on the
tiled row reductions of ``csrc/reduce.cuh``),
``csrc/band_stream.cu`` (``pallas/band_stream.py::_band_kernel``) and
``csrc/band_grad.cu`` (``pallas/band_pipeline.py::_grad_kernel``). The
plain versions are in ``ops/band.py``.

The band lattice kernel plans its launch itself; ``plan`` mirrors that plan
for the CPU tests (``tests/test_torch_band_plan.py``), and a card test holds
it against the C entry ``wtt_band_plan``. Two walks:

* the row walk (S <= MAX_ROW_S, 32-bit offsets): a warp per utterance and
  direction, lane s holding band cell s, alpha and beta of an utterance in
  one block; tiles of TILE_ROWS rows of lpb, lpe and ranges copied
  AHEAD_TILES tiles ahead into a ring of SLOTS tiles, results parked in the
  ring and written out a tile at a time;
* the cells walk (every other band): a block per utterance and direction,
  G warps, C (odd) consecutive cells a lane; one warp while C <= MAX_CELLS,
  else G doubled up to MAX_CELL_WARPS, past which a row goes in chunks of
  32·G·C cells; the last two rows in shared memory, or in device memory
  (4·B·S values, which the wrapper allocates) past what a block holds. No S
  is refused.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import band as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, int32, lib, require, rows, stream

WARP = 32
MAX_ROW_S = 32  # the row walk's widest band
TILE_ROWS = 32
AHEAD_TILES = 2  # tile k + AHEAD_TILES is copied as the walk enters tile k
SLOTS = AHEAD_TILES + 1
ROW_LATTICES = 2  # a block of the row walk: alpha and beta of one utterance
# The row walk indexes a lattice with 32-bit offsets, up to (T + 2·TILE_ROWS)·S;
# the cells walk takes 64-bit ones past (T + 2)·S.
MAX_OFFSET = 2 ** 31 - 1
MAX_CELL_WARPS = 8
MAX_CELLS = 17
CELL_XCH = 2 * MAX_CELL_WARPS * 4  # the exchange of a lattice's warps, values


class Plan(NamedTuple):
    row_mode: bool  # the row walk; else the cells walk
    tile_rows: int  # rows a tile (0 in the cells walk)
    slots: int  # ring slots, tiles (0 in the cells walk)
    ahead: int  # copy distance, tiles (0 in the cells walk)
    per_block: int  # lattices a block
    blocks: int
    threads: int  # a block
    smem: int  # dynamic shared memory a block, bytes
    warps: int  # G, warps a lattice (0 in the row walk)
    cells: int  # C, cells a lane (0 in the row walk)
    chunks: int  # chunks of 32·G·C cells a row (0 in the row walk)
    offsets64: bool  # 64-bit offsets inside a lattice (cells walk)
    rows_device: bool  # the last two rows in device memory (cells walk)


def arr_words(n: int) -> int:
    """Words of one array of a ring slot: n values at a shift of up to three
    words (the source's address modulo 16 bytes), rounded up to 16 bytes."""
    return (n + 6) // 4 * 4


def slot_words(S: int) -> int:
    """A ring slot: one tile's lpb (then its results), lpe and ranges."""
    return 2 * arr_words(TILE_ROWS * S) + arr_words(TILE_ROWS)


def lattice_words(S: int) -> int:
    """Shared memory of one lattice (warp) of the row walk, words."""
    return SLOTS * slot_words(S)


def cells(n: int) -> int:
    """C for n cells a warp: the least odd number with 32·C >= n."""
    c = -(-n // WARP)
    return c + 1 - c % 2


def plan(B: int, T: int, S: int) -> Plan:
    """The band lattice kernel's launch plan for B utterances of T frames and
    a band of S (``csrc/band_stream.cu::plan``)."""
    if S <= MAX_ROW_S and (T + 2 * TILE_ROWS) * S <= MAX_OFFSET:
        return Plan(True, TILE_ROWS, SLOTS, AHEAD_TILES, ROW_LATTICES, B, ROW_LATTICES * WARP,
                    ROW_LATTICES * lattice_words(S) * 4, 0, 0, 0, False, False)
    G, C = 1, cells(S)
    while C > MAX_CELLS and G < MAX_CELL_WARPS:
        G *= 2
        C = cells(-(-S // G))
    C = min(C, MAX_CELLS)
    rows_words = 2 * S + CELL_XCH
    rows_device = rows_words * 4 > SMEM_BYTES
    return Plan(False, 0, 0, 0, 1, 2 * B, WARP * G, (CELL_XCH if rows_device else rows_words) * 4,
                G, C, -(-S // (WARP * G * C)), (T + 2) * S > MAX_OFFSET, rows_device)


def kernel_plan(B: int, T: int, S: int) -> Plan:
    """The plan as the C entry ``wtt_band_plan`` computes it."""
    out = (ctypes.c_int * 13)()
    lib().wtt_band_plan(B, T, S, out)
    v = list(out)
    return Plan(bool(v[0]), *v[1:11], bool(v[11]), bool(v[12]))


def kernel_registers(T: int, S: int) -> tuple:
    """(registers a thread, local bytes a thread) of the kernel instance
    that a band of T rows and S cells runs, as ptxas compiled it; for the
    measurement scripts."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_band_attrs(T, S, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"band_stream: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


def band_prep_registers(dtype: torch.dtype, plan) -> tuple:
    """(registers a thread, local bytes a thread) of the band prep kernel
    instance that ``plan`` (a ``rows.ReducePlan``) runs for ``dtype``."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = lib().wtt_band_prep_attrs(DTYPE_CODES[dtype], plan.mode, plan.vec,
                                    ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"band_prep: cudaFuncGetAttributes failed: cudaError {err}")
    return regs.value, local.value


_F32 = (torch.float32,)
_INT = (torch.int32,)


def band_prep(acts: torch.Tensor, lab_row: torch.Tensor, blank: int) -> _plain.BandPrep:
    """``band.band_prep`` on the card: one read of the (B, T, S, V) band
    (f32, bf16, f16 or f64) gives lpb, lpe and denom in f32, by the tiled
    row reductions of ``csrc/reduce.cuh`` (the kernel plans itself as
    ``rows.reduce_plan`` does). On a CPU tensor this is the plain version."""
    if acts.device.type != "cuda":
        return _plain.band_prep(acts, lab_row, blank)
    return _band_prep(acts, lab_row, blank, None)


def band_prep_planned(acts: torch.Tensor, lab_row: torch.Tensor, blank: int,
                      plan) -> _plain.BandPrep:
    """``band_prep`` on a CUDA tensor with ``plan`` (a ``rows.ReducePlan``)
    in place of the kernel's own: the tile and the warp mode at one V, for
    the card tests and ``scripts/time_band.py``. The kernel refuses a plan
    outside its limits."""
    return _band_prep(acts, lab_row, blank, (ctypes.c_uint * 7)(*plan))


def _band_prep(acts, lab_row, blank, plan):
    dev = acts.device
    require(acts, "acts", dev, DTYPE_CODES, 4)
    require(lab_row, "lab_row", dev, _INT, 3)
    B, T, S, V = acts.shape
    if tuple(lab_row.shape) != (B, T, S):
        raise ValueError(f"lab_row must be {(B, T, S)}; got {tuple(lab_row.shape)}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    if B * T * S >= 2 ** 31:
        raise ValueError(f"B·T·S = {B * T * S} rows exceed the band prep kernel's 2^31")
    lpb = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    lpe = torch.empty_like(lpb)
    denom = torch.empty_like(lpb)
    args = (acts.data_ptr(), DTYPE_CODES[acts.dtype], lab_row.data_ptr(), lpb.data_ptr(),
            lpe.data_ptr(), denom.data_ptr(), B * T * S, V, int(blank))
    with torch.cuda.device(dev):
        if plan is None:
            err = lib().wtt_band_prep(*args, stream(dev))
        else:
            err = lib().wtt_band_prep_planned(*args, plan, stream(dev))
    check(err, "band_prep")
    return _plain.BandPrep(lpb, lpe, denom)


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor, ranges: torch.Tensor,
                     input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor) -> _plain.BandLattice:
    """``band.forward_backward`` on the card, one launch at any S: the row
    walk for S <= 32, the cells walk above (``plan``). On a CPU tensor this
    is the plain version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, ranges, input_lengths, label_lengths)
    dev = lpb.device
    require(lpb, "lpb", dev, _F32, 3)
    require(lpe, "lpe", dev, _F32, 3)
    B, T, S = lpb.shape
    if lpe.shape != lpb.shape:
        raise ValueError(f"lpe shape {tuple(lpe.shape)} != lpb shape {tuple(lpb.shape)}")
    r, il, ll = int32(dev, ranges, input_lengths, label_lengths)
    if tuple(r.shape) != (B, T):
        raise ValueError(f"ranges must be {(B, T)}; got {tuple(r.shape)}")
    if T < 1 or S < 1:
        raise ValueError(f"the band needs T >= 1 and S >= 1; got T={T}, S={S}")
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb)
    ll_forward = torch.empty((B,), dtype=torch.float32, device=dev)
    ll_backward = torch.empty_like(ll_forward)
    row_mem = (torch.empty((4 * B * S,), dtype=torch.float32, device=dev)
               if plan(B, T, S).rows_device else None)
    with torch.cuda.device(dev):
        err = lib().wtt_band_stream(
            lpb.data_ptr(), lpe.data_ptr(), r.data_ptr(), il.data_ptr(), ll.data_ptr(),
            alphas.data_ptr(), betas.data_ptr(), ll_forward.data_ptr(), ll_backward.data_ptr(),
            B, T, S, None if row_mem is None else row_mem.data_ptr(), stream(dev))
    check(err, "band_stream")
    return _plain.BandLattice(alphas, betas, ll_forward, ll_backward)


def band_grad(acts, denom, fields, lab_row, ranges, input_lengths, label_lengths, blank,
              out_dtype):
    """``band.band_grad`` on the card (acts in ``out_dtype``). On a CPU
    tensor this is the plain version."""
    if acts.device.type != "cuda":
        return _plain.band_grad(acts, denom, fields, lab_row, ranges, input_lengths,
                                label_lengths, blank, out_dtype)
    dev = acts.device
    require(acts, "acts", dev, DTYPE_CODES, 4)
    if acts.dtype != out_dtype:
        raise ValueError(f"the band gradient kernel writes acts' dtype {acts.dtype}, "
                         f"not {out_dtype}")
    B, T, S, V = acts.shape
    for name, t in (("denom", denom),) + tuple(zip(fields._fields, fields)):
        require(t, name, dev, _F32, 3)
    require(lab_row, "lab_row", dev, _INT, 3)
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    if B * T * S >= 2 ** 31:
        raise ValueError(f"B·T·S = {B * T * S} rows exceed the band gradient kernel's 2^31")
    r, il, ll = int32(dev, ranges, input_lengths, label_lengths)
    grads = torch.empty_like(acts)
    plan = rows.host_plan(V, acts.element_size(), rows.alignment(acts.data_ptr(), grads.data_ptr()))
    with torch.cuda.device(dev):
        err = lib().wtt_band_grad(
            acts.data_ptr(), DTYPE_CODES[acts.dtype], denom.data_ptr(), fields.coef.data_ptr(),
            fields.cb.data_ptr(), fields.ce.data_ptr(), lab_row.data_ptr(), r.data_ptr(),
            il.data_ptr(), ll.data_ptr(), grads.data_ptr(), B * T * S, T, S, V, int(blank),
            plan, stream(dev))
    check(err, "band_grad")
    return grads
