"""Wrappers of the fused joint kernels: ``csrc/joint_prep.cu``,
``csrc/joint_grad.cu`` with ``csrc/joint_grad_cols.cu``, and
``csrc/dur_head.cu``. They stand for the JAX
package's ``pallas/joint_fused.py``: ``fused_prep`` for its ``fused_prep``,
``fused_prep_mb`` (``extra_cols``) and ``fused_prep_tdt`` (``dur_head``);
``fused_grad`` for ``fused_grad``, ``fused_grad_mb`` (``extra``) and
``fused_grad_tdt`` (``dur_head``); ``dur_head_prep`` and ``dur_head_grad``
for the functions of those names. The plain versions are in
``ops/fused_joint.py``.

The kernels take e, p, bias and the duration head in f32 and W in f32 or
bf16; a bf16 e or p is widened here (exact, and (B, T, H)-sized), and the
gradients come back in the types of e, p, W, bias, Wd. They visit only the
cells inside each utterance's lattice, numbered through running sums of
T_b·U_b that are taken on the card, so nothing here waits for the device;
what they skip is filled here (NEG, or 0 for denom and the duration
logits). They take any joint width H: above 1024 the same kernels stream W
in k-slices and take dh and dW in passes (``joint_plan``)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import fused_joint as _plain
from .. import gradients as _gradients
from .. import prep as _prep
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_F32 = (torch.float32,)
_IN = (torch.float32, torch.bfloat16)
# The row splits of the fused gradient's dWd kernel: two blocks a multiprocessor.
_DUR_BLOCKS_PER_SM = 2
# The fused gradient's chunk of rows: the buffer of their h (joint_grad.cu's
# row kernel writes it, the column kernel reads it) takes at most this, and
# H is padded to a multiple of JOINT_H_ALIGN in it (csrc/joint.cuh, kHAlign).
_H_CHUNK_MB = 32


def _rows(e, p, input_lengths, label_lengths):
    """The numbering of the valid rows: (offsets (B+1,) int64 running sums
    of T_b·U_b, label_lengths int32), both on the card. Without lengths
    every row is valid."""
    dev = e.device
    (B, T), U = e.shape[:2], p.shape[1]
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
        label_lengths = torch.full((B,), U - 1, dtype=torch.int32, device=dev)
    il = input_lengths.to(device=dev, dtype=torch.int64).clamp(0, T)
    ul = (label_lengths.to(device=dev, dtype=torch.int64) + 1).clamp(0, U)
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    torch.cumsum(il * ul, 0, out=offsets[1:])
    return offsets, label_lengths.to(device=dev, dtype=torch.int32).contiguous()


def _check_smem(H, smem_entries):
    """Raise unless each kernel's shared memory at this H, as the C entries
    ``smem_entries`` give it (their h, W and g tiles, or slices of them),
    fits a block: the plan keeps it within 227 KB at every H."""
    for entry in smem_entries:
        need = getattr(lib(), entry)(H)
        if need > SMEM_BYTES:
            raise ValueError(f"H={H} needs {need} bytes of shared memory for {entry}'s tiles; a "
                             f"block may use {SMEM_BYTES} (227 KB)")


def _inputs(e, p, W, bias, labels, input_lengths, label_lengths, blank, smem_entries):
    """Check what the kernels take and bring it to their types: (e32, p32,
    W, bias32, lab_full, offsets, label_lengths32)."""
    dev = e.device
    require(e, "e", dev, _IN, 3)
    require(p, "p", dev, _IN, 3)
    require(W, "W", dev, _IN, 2)
    require(bias, "bias", dev, _IN, 1)
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    if p.shape[0] != B or p.shape[2] != H or W.shape[0] != H or bias.shape[0] != V:
        raise ValueError(f"shapes disagree: e {tuple(e.shape)}, p {tuple(p.shape)}, "
                         f"W {tuple(W.shape)}, bias {tuple(bias.shape)}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    _check_smem(H, smem_entries)
    offsets, ll = _rows(e, p, input_lengths, label_lengths)
    lab = _plain.lab_full(labels.to(dev), U)
    return e.float(), p.float(), W, bias.float(), lab, offsets, ll


def _dur_head(dev, H, Wd, other, what, shape):
    """A duration head as the kernels take it: (Wd32 (H, D), other32), both
    f32 and contiguous on the card; ``other`` is bias_d or g_dur and must
    have ``shape`` + (D,)."""
    Wd32, other32 = _plain._check_dur_head(Wd, other, H, what)
    require(Wd32, "Wd", dev, _F32, 2)
    require(other32, what, dev, _F32, len(shape) + 1)
    if tuple(other32.shape) != tuple(shape) + (Wd32.shape[1],):
        raise ValueError(f"{what} must be {tuple(shape) + (Wd32.shape[1],)}; got "
                         f"{tuple(other32.shape)}")
    return Wd32, other32


def _dur_inputs(e, p, Wd, other, what, per_cell):
    """What the standalone duration-head kernels take: (e32, p32, Wd32,
    other32)."""
    dev = e.device
    require(e, "e", dev, _IN, 3)
    require(p, "p", dev, _IN, 3)
    B, T, H = e.shape
    if p.shape[0] != B or p.shape[2] != H:
        raise ValueError(f"shapes disagree: e {tuple(e.shape)}, p {tuple(p.shape)}")
    # The kernels' shared memory does not depend on H (dur_smem_bytes).
    shape = (B, T, p.shape[1]) if per_cell else ()
    return (e.float(), p.float()) + _dur_head(dev, H, Wd, other, what, shape)


# The plan of csrc/joint.cuh (Plan, plan_tm and the tilings Prep, GradRows,
# GradCols), mirrored for the CPU tests; a card test holds it against
# wtt_joint_plan at every H. Up to JOINT_PASS_H (H padded to a multiple of
# JOINT_H_ALIGN) one k-slice holds all of H and one pass covers dh and dW;
# above it W streams in k-slices of ``JointPlan.ks`` rows and the row and
# column kernels take dh and dW in passes of JOINT_PASS_H columns.
JOINT_WARPS = 8
JOINT_DIM = 16
JOINT_H_ALIGN = 128
JOINT_PASS_H = 1024
JOINT_SLICE = 256  # rows of a k-slice above JOINT_PASS_H with bf16 W (f32: half)
JOINT_PANEL = 8
JOINT_COLS_SLICED_RM = 8  # the column kernel's row tiles above JOINT_PASS_H: 128 rows
# Padding of a tile row, elements: (h, W, g) by W's type (joint.cuh, Mma).
_PADS = {torch.float32: (4, 8, 4), torch.bfloat16: (8, 8, 8)}


class JointPlan(NamedTuple):
    tm: int           # a row tile is 16·tm rows (the column kernel's stripe 16·tm columns)
    hp: int           # H padded to a multiple of JOINT_H_ALIGN
    sliced: int       # 0: one k-slice and one pass; 1: above JOINT_PASS_H
    ks: int           # rows of W (and columns of h) of a k-slice
    slices: int       # k-slices of hp
    passes: int       # passes over H of dh (row kernel) and dW (column kernel)
    prep_hcols: int   # columns of the prep's h tile: hp, or ks (refilled each step)
    prep_stages: int  # W stages of the prep's ring
    rows_hcols: int   # columns of the row kernel's h tile: hp, or ks
    prep_smem: int    # dynamic shared memory of a block, bytes
    rows_smem: int
    cols_smem: int
    chunk_rows: int   # rows of a chunk of the gradient (its h buffer)


def _r16(n):
    return -(-n // 16) * 16


def tile_param(H: int) -> int:
    return 4 if H <= 256 else 2 if H <= 512 else 1


def joint_plan(H: int, dtype: torch.dtype, chunk_mb: int | None = None) -> JointPlan:
    """The fused joint kernels' plan at joint width H >= 1 and W of ``dtype``
    (f32 or bf16), with the gradient's h buffer at most ``chunk_mb`` MB
    (``_H_CHUNK_MB`` when None)."""
    chunk_mb = _H_CHUNK_MB if chunk_mb is None else chunk_mb
    sz = 2 if dtype == torch.bfloat16 else 4
    pad_h, pad_w, pad_g = _PADS[dtype]
    tm = tile_param(H)
    hp = -(-H // JOINT_H_ALIGN) * JOINT_H_ALIGN
    bm = JOINT_DIM * tm
    hmax = JOINT_PASS_H // tm
    # The row tilings (joint.cuh::RowTiles): the prep and the row kernel, V
    # tiles of bn columns (64 with bf16 W or above JOINT_PASS_H; 128 with
    # bf16 W above it).
    sliced = hp > JOINT_PASS_H
    bn = (128 if sliced else 64) if sz == 2 else 64 if sliced else JOINT_DIM * tm
    wn = min(JOINT_WARPS // tm, bn // 8)
    ldw, ldg = bn + pad_w, bn + pad_g

    def prep_bytes(hcols, wrows, stages):
        return (_r16(sz * bm * (hcols + pad_h)) + _r16(sz * stages * wrows * ldw)
                + _r16(4 * 2 * bm) + _r16(4 * 2 * wn * bm) + _r16(4 * 4 * bm))

    def rows_bytes(hcols, wrows, stages, dcols, d_over_h):
        h = _r16(sz * bm * (hcols + pad_h))
        d = 4 * dcols * (bm + 1)
        need = max(d - h, 0) if d_over_h else d
        ring = max(sz * stages * wrows * ldw, need)
        return (h + _r16(ring) + _r16(sz * bm * ldg) + _r16(4 * (4 + 2 * JOINT_PANEL) * bm)
                + _r16(4 * 4 * bm))

    prep_stages = 2 if sliced or (_r16(sz * bm * (hmax + pad_h)) + _r16(sz * 2 * hmax * ldw)
                                  + 4096 <= SMEM_BYTES) else 1
    # The column kernel's tiling (joint.cuh::GradCols): stripes of 16·tm, row
    # tiles of cbm rows.
    cbn = JOINT_DIM * tm
    cldw = cbn + pad_w

    def cols_small(cbm):  # row fields and (b, t, u, label) twice, db, bias, extra index
        return (_r16(4 * 2 * (4 + JOINT_PANEL) * cbm) + _r16(4 * (cbm // JOINT_DIM) * cbn)
                + _r16(4 * 2 * 4 * cbm) + _r16(4 * cbn) + _r16(4 * cbn))

    chunk = max(bm, (chunk_mb << 20) // (hp * sz) // bm * bm)
    if not sliced:
        hbuf = 2 if sz == 4 and (_r16(sz * hmax * cldw) + _r16(sz * 2 * bm * (hmax + pad_h))
                                 + _r16(sz * bm * cldw) + cols_small(bm)) <= SMEM_BYTES else 1
        cols = _r16(sz * hp * cldw) + _r16(sz * hbuf * bm * (hp + pad_h)) + _r16(sz * bm * cldw)
        return JointPlan(tm, hp, 0, hp, 1, 1, hp, prep_stages, hp,
                         prep_bytes(hp, hp, prep_stages), rows_bytes(hp, hp, 1, hp, sz == 2),
                         cols + cols_small(bm), chunk)
    ks = JOINT_SLICE if sz == 2 else JOINT_SLICE // 2  # joint.cuh::kSliceRows
    whole = prep_bytes(hp, ks, 2)
    prep_hcols = hp if whole <= SMEM_BYTES else ks
    whole = rows_bytes(hp, ks, 2, JOINT_PASS_H, sz == 2)
    rows_hcols = hp if whole <= SMEM_BYTES else ks
    cbm = JOINT_DIM * JOINT_COLS_SLICED_RM
    stage = _r16(sz * ks * cldw) + _r16(sz * cbm * (ks + pad_h))
    return JointPlan(tm, hp, 1, ks, -(-hp // ks), -(-hp // JOINT_PASS_H), prep_hcols, 2,
                     rows_hcols, prep_bytes(prep_hcols, ks, 2),
                     rows_bytes(rows_hcols, ks, 2, JOINT_PASS_H, sz == 2 or rows_hcols != hp),
                     2 * stage + _r16(sz * cbm * cldw) + cols_small(cbm), chunk)


def kernel_plan(H: int, dtype: torch.dtype, chunk_mb: int | None = None) -> JointPlan:
    """The plan the kernels take at this H and W type, from the C entry
    (``wtt_joint_plan``); for the card tests and the measurement scripts."""
    chunk_mb = _H_CHUNK_MB if chunk_mb is None else chunk_mb
    out = (ctypes.c_longlong * len(JointPlan._fields))()
    err = lib().wtt_joint_plan(H, DTYPE_CODES[dtype], chunk_mb << 20, out)
    if err != 0:
        raise RuntimeError(f"wtt_joint_plan({H}, {dtype}) failed: cudaError {err}")
    return JointPlan(*out)


# The plan of csrc/dur_head.cu (its constants and prep_ut / prep_tt), mirrored
# for the CPU tests; a card test holds it against wtt_dur_head_plan and
# wtt_dur_head_smem. The prep: a thread a cell, tiles of tt frames × ut
# labels, e and p staged a chunk of DUR_PREP_KC columns at a time in rows of
# DUR_PREP_LD words. The gradient: a block owns DUR_GRAD_KS columns of k of
# one utterance for a share of its frames (DUR_GRAD_SPLITS blocks share
# them), DUR_GRAD_WARPS warps a block deal them DUR_GRAD_TF at a time, labels
# go in chunks of DUR_GRAD_UC, two at a time.
DUR_PREP_THREADS = 256
DUR_PREP_KC = 32
DUR_PREP_LD = DUR_PREP_KC + 4
DUR_GRAD_WARPS = 4
DUR_GRAD_KS = 32
DUR_GRAD_UC = 32
DUR_GRAD_TF = 2
DUR_GRAD_SPLITS = 2
DUR_MAX_D = 8


def dur_prep_tile(U: int) -> tuple:
    """(ut, tt): labels and frames of a prep tile for U >= 1 labels."""
    ut = min(U, DUR_PREP_THREADS)
    return ut, DUR_PREP_THREADS // ut


def dur_head_plan(T: int, U: int, H: int) -> tuple:
    """(ut, tt, prep tiles an utterance, gradient blocks an utterance) at
    T frames, U >= 1 labels and H columns: the prep's grid is (B, tiles),
    the gradient's (B, column slices, DUR_GRAD_SPLITS)."""
    ut, tt = dur_prep_tile(U)
    return ut, tt, -(-T // tt) * -(-U // ut), -(-H // DUR_GRAD_KS) * DUR_GRAD_SPLITS


def dur_smem_bytes() -> int:
    """Static shared memory of a block of the larger of the two kernels:
    the prep's e and p rows (tt + ut <= 257) and Wd's chunk, the gradient's
    p chunk, its warps' dp sums and their frames' g_dur (at D = 8); neither
    depends on H or U."""
    prep = 4 * ((DUR_PREP_THREADS + 1) * DUR_PREP_LD + DUR_PREP_KC * DUR_MAX_D)
    grad = 4 * ((1 + DUR_GRAD_WARPS) * DUR_GRAD_UC * DUR_GRAD_KS
                + DUR_GRAD_WARPS * DUR_GRAD_TF * DUR_GRAD_UC * DUR_MAX_D)
    return max(prep, grad)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _host_cols(cols):
    return (ctypes.c_int * len(cols))(*cols)


def fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank: int,
               extra_cols=(), dur_head=None) -> _prep.PreparedInputs:
    """``fused_joint.fused_prep`` on the card: one launch over the valid
    rows and all of V, whatever the hooks. On a CPU tensor this is the plain
    version."""
    if e.device.type != "cuda":
        return _plain.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank,
                                 extra_cols, dur_head)
    dev = e.device
    e32, p32, W, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
                                                 label_lengths, blank, ("wtt_joint_prep_smem",))
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    cols = _prep.check_extra_cols(extra_cols, V)
    K, D = len(cols), 0
    lpb = torch.full((B, T, U), _prep.NEG, dtype=torch.float32, device=dev)
    lpe = torch.full_like(lpb, _prep.NEG)
    denom = torch.zeros_like(lpb)
    lpX = torch.full((B, T, U, K), _prep.NEG, dtype=torch.float32, device=dev) if K else None
    Wd32 = bias_d32 = dlog = None
    if dur_head is not None:
        Wd32, bias_d32 = _dur_head(dev, H, dur_head[0], dur_head[1], "bias_d", ())
        D = Wd32.shape[1]
        dlog = torch.zeros((B, T, U, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_joint_prep(
            e32.data_ptr(), p32.data_ptr(), W.data_ptr(), DTYPE_CODES[W.dtype], b32.data_ptr(),
            lab.data_ptr(), offsets.data_ptr(), ll.data_ptr(), lpb.data_ptr(), lpe.data_ptr(),
            denom.data_ptr(), _ptr(lpX), _host_cols(cols), K, _ptr(Wd32), _ptr(bias_d32),
            _ptr(dlog), D, B, T, U, H, V, int(blank), stream(dev))
    check(err, "joint_prep")
    return _prep.PreparedInputs(lpb=lpb, lpe=lpe, denom=denom, extras=lpX, dur=dlog)


def _dur_splits(B, T, U, H, dev):
    """Row splits of the fused gradient's dWd kernel: each split walks every
    nsplit-th row tile and owns one partial of dWd."""
    tile = JOINT_DIM * tile_param(H)  # its row tiles are as tall as the column kernel's
    tiles = -(-(B * T * U) // tile)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(_DUR_BLOCKS_PER_SM * sms, tiles))


def fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
               fields: _gradients.Coefficients, blank: int, extra=None, dur_head=None):
    """``fused_joint.fused_grad`` on the card, a chunk of the B·T·U cells at
    a time: the row kernel (de, dp, the duration head's cotangent joining
    dh there; it also writes the chunk's h) and the column kernel (dW, db,
    from that h), each counted under ``joint_grad`` at every launch, and
    with a duration head one more for dWd. On a CPU tensor this is the
    plain version."""
    if e.device.type != "cuda":
        return _plain.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                                 fields, blank, extra, dur_head)
    dev = e.device
    e32, p32, W, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
                                                 label_lengths, blank,
                                                 ("wtt_joint_grad_rows_smem",
                                                  "wtt_joint_grad_cols_smem")
                                                 + (("wtt_joint_grad_dwd_smem",)
                                                    if dur_head is not None else ()))
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    for name, t in (("denom", denom),) + tuple(zip(fields._fields, fields)):
        require(t, name, dev, _F32, 3)
        if tuple(t.shape) != (B, T, U):
            raise ValueError(f"{name} must be {(B, T, U)}; got {tuple(t.shape)}")
    cols, cX, K = (), None, 0
    if extra is not None:
        cols = _prep.check_extra_cols(extra[0], V)
        K = len(cols)
        cX = extra[1]
        require(cX, "the extra fields", dev, _F32, 4)
        if tuple(cX.shape) != (B, T, U, K):
            raise ValueError(f"the extra fields must be {(B, T, U, K)}; got {tuple(cX.shape)}")
    Wd32 = gd = None
    D = 0
    if dur_head is not None:
        Wd32, gd = _dur_head(dev, H, dur_head[0], dur_head[1], "g_dur", (B, T, U))
        D = Wd32.shape[1]
    de = torch.zeros((B, T, H), dtype=torch.float32, device=dev)
    dp = torch.zeros((B, U, H), dtype=torch.float32, device=dev)
    dW = torch.empty((H, V), dtype=torch.float32, device=dev)
    db = torch.empty((V,), dtype=torch.float32, device=dev)
    plan = joint_plan(H, W.dtype)
    stripe = JOINT_DIM * plan.tm
    stripes = -(-V // stripe)
    cells = B * T * U
    chunk = min(plan.chunk_rows, -(-cells // stripe) * stripe)
    # the column kernel's row tiles in a chunk: as tall as a stripe is wide
    # up to JOINT_PASS_H, JOINT_COLS_SLICED_RM sixteens above
    col_tile = JOINT_DIM * JOINT_COLS_SLICED_RM if plan.sliced else stripe
    tiles = -(-chunk // col_tile)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # One wave of the column kernel: as many row splits as its resident
    # blocks leave room for beside the stripes and the passes over dW.
    per_sm = max(1, lib().wtt_joint_grad_cols_occupancy(H, DTYPE_CODES[W.dtype]))
    nsplit = max(1, min(per_sm * sms // (stripes * plan.passes), tiles))
    dW_part = torch.empty((nsplit, H, V), dtype=torch.float32, device=dev) if nsplit > 1 else dW
    db_part = torch.empty((nsplit, V), dtype=torch.float32, device=dev) if nsplit > 1 else db
    h_chunk = torch.empty((chunk, plan.hp), dtype=W.dtype, device=dev)
    inputs = (W.data_ptr(), DTYPE_CODES[W.dtype], b32.data_ptr(), lab.data_ptr(),
              offsets.data_ptr(), ll.data_ptr(), denom.data_ptr(), fields.coef.data_ptr(),
              fields.cb.data_ptr(), fields.ce.data_ptr(), _ptr(cX), _host_cols(cols), K)
    dims = (B, T, U, H, V, int(blank), stream(dev))
    out = ()
    with torch.cuda.device(dev):
        for r0 in range(0, cells, chunk):
            window = (r0, r0 + chunk, h_chunk.data_ptr())
            err = lib().wtt_joint_grad_rows(e32.data_ptr(), p32.data_ptr(), *inputs, _ptr(Wd32),
                                            _ptr(gd), D, de.data_ptr(), dp.data_ptr(), *window,
                                            *dims)
            check(err, "joint_grad")
            err = lib().wtt_joint_grad_cols(*inputs, dW.data_ptr(), db.data_ptr(),
                                            dW_part.data_ptr(), db_part.data_ptr(), nsplit,
                                            *window, int(r0 > 0), *dims)
            check(err, "joint_grad")
        if dur_head is not None:
            nd = _dur_splits(B, T, U, H, dev)
            dWd = torch.empty((H, D), dtype=torch.float32, device=dev)
            dWd_part = torch.empty((nd, H, D), dtype=torch.float32, device=dev)
            err = lib().wtt_joint_grad_dwd(e32.data_ptr(), p32.data_ptr(), offsets.data_ptr(),
                                           ll.data_ptr(), gd.data_ptr(), dWd.data_ptr(),
                                           dWd_part.data_ptr(), nd, B, T, U, H, D, stream(dev))
            check(err, "joint_grad")
            out = (dWd.to(dur_head[0].dtype),)
    return (de.to(e.dtype), dp.to(p.dtype), dW.to(W.dtype), db.to(bias.dtype)) + out


def dur_head_prep(e, p, Wd, bias_d, input_lengths=None, label_lengths=None):
    """``fused_joint.dur_head_prep`` on the card: a tile of cells a block,
    a thread a cell. On a CPU tensor this is the plain version."""
    if e.device.type != "cuda":
        return _plain.dur_head_prep(e, p, Wd, bias_d, input_lengths, label_lengths)
    dev = e.device
    e32, p32, Wd32, bias_d32 = _dur_inputs(e, p, Wd, bias_d, "bias_d", False)
    B, T, H = e.shape
    U, D = p.shape[1], Wd32.shape[1]
    offsets, ll = _rows(e, p, input_lengths, label_lengths)
    dlog = torch.zeros((B, T, U, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_dur_head_prep(e32.data_ptr(), p32.data_ptr(), Wd32.data_ptr(),
                                      bias_d32.data_ptr(), offsets.data_ptr(), ll.data_ptr(),
                                      dlog.data_ptr(), B, T, U, H, D, stream(dev))
    check(err, "dur_head")
    return dlog


def dur_head_grad(e, p, Wd, g_dur, input_lengths=None, label_lengths=None):
    """``fused_joint.dur_head_grad`` on the card: one launch for de2
    (written whole) and the partials of dp2 and dWd, and their sums in a
    fixed order; no atomics, so the three are the same bits on every call.
    On a CPU tensor this is the plain version."""
    if e.device.type != "cuda":
        return _plain.dur_head_grad(e, p, Wd, g_dur, input_lengths, label_lengths)
    dev = e.device
    e32, p32, Wd32, gd = _dur_inputs(e, p, Wd, g_dur, "g_dur", True)
    if gd.data_ptr() % 16:  # the kernel reads a cell's D values as whole vectors
        gd = gd.clone()
    B, T, H = e.shape
    U, D = p.shape[1], Wd32.shape[1]
    offsets, ll = _rows(e, p, input_lengths, label_lengths)
    de = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    dp = torch.empty((B, U, H), dtype=torch.float32, device=dev)
    dWd = torch.empty((H, D), dtype=torch.float32, device=dev)
    part = torch.empty(DUR_GRAD_SPLITS * B * (U * H + H * D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_dur_head_grad(e32.data_ptr(), p32.data_ptr(), Wd32.data_ptr(),
                                      gd.data_ptr(), offsets.data_ptr(), ll.data_ptr(),
                                      de.data_ptr(), dp.data_ptr(), dWd.data_ptr(),
                                      part.data_ptr(), B, T, U, H, D, stream(dev))
    check(err, "dur_head")
    return de.to(e.dtype), dp.to(p.dtype), dWd.to(Wd.dtype)


def kernel_registers(H: int, dtype: torch.dtype) -> dict:
    """{kernel: (registers a thread, local bytes a thread)} of the prep, row
    and column kernels launched at this H with W of ``dtype`` (their sliced
    instances above H = 1024), as ptxas compiled them
    (``cudaFuncGetAttributes``); for the measurement scripts."""
    code = DTYPE_CODES[dtype]
    out = {}
    for name, entry in (("joint_prep_kernel", "wtt_joint_prep_attrs"),
                        ("joint_grad_rows_kernel", "wtt_joint_grad_rows_attrs"),
                        ("joint_grad_cols_kernel", "wtt_joint_grad_cols_attrs")):
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = getattr(lib(), entry)(H, code, ctypes.byref(regs), ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"{name}: cudaFuncGetAttributes failed: cudaError {err}")
        out[name] = (regs.value, local.value)
    return out
