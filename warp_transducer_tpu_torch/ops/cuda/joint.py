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
bf16. The wrappers take what the JAX package takes: e, p, W, bias and the
duration head of any floating type and any layout. Each is brought here to
a contiguous tensor of the kernels' type (``_operands``): W stays bf16 when
it is bf16 (bf16 products) and is f32 otherwise, as the JAX package takes
the products in f32 for every other W; e, p and bias are f32 (a 16-bit one
widened exactly). The gradients come back in the types of e, p, W, bias,
Wd. The kernels visit only the cells inside each utterance's lattice,
numbered through running sums of T_b·U_b that are taken on the card, so
nothing here waits for the device; what they skip is filled here (NEG, or
0 for denom and the duration logits). They take any joint width H: every
product streams its operands through shared memory in k-slices
(``joint_plan``). The scratch the kernels read and write (W's layouts, a
chunk's h, hᵀ, g, gᵀ and db partials) is allocated here, a chunk of rows
at a time."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import fused_joint as _plain
from .. import gradients as _gradients
from .. import prep as _prep
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream
from .prep import col_table

_F32 = (torch.float32,)
_FLOATS = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
# The row splits of the fused gradient's dWd kernel: two blocks a multiprocessor.
_DUR_BLOCKS_PER_SM = 2
# The chunk of rows of the fused prep and gradient: the buffers of a chunk
# (the prep's h; the gradient's h, hᵀ, g, gᵀ and db partials, in W's operand
# type: bf16, or f32 as tf32 hi and lo) take at most this (joint.cuh::plan).
_CHUNK_MB = 128


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


def _operands(dev, **named):
    """Each of the named tensors (given as (tensor, ndim)) as the kernels
    take it: on ``dev``, of a floating type, with ``ndim`` dimensions;
    then contiguous and f32, W bf16 where it is bf16 (the products' type).
    The kernels' own buffers are checked by ``require`` after this."""
    out = []
    for name, (t, ndim) in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in _FLOATS:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernels take {_FLOATS}")
        keep = name == "W" and t.dtype == torch.bfloat16
        t = t.to(torch.bfloat16 if keep else torch.float32).contiguous()
        require(t, name, dev, (t.dtype,), ndim)
        out.append(t)
    return out


def _inputs(e, p, W, bias, labels, input_lengths, label_lengths, blank, smem_entries):
    """Check what the kernels take and bring it to their types: (e32, p32,
    W (bf16 or f32), bias32, lab_full, offsets, label_lengths32)."""
    dev = e.device
    e32, p32, Wk, b32 = _operands(dev, e=(e, 3), p=(p, 3), W=(W, 2), bias=(bias, 1))
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
    return e32, p32, Wk, b32, lab, offsets, ll


def _dur_head(dev, H, Wd, other, what, shape):
    """A duration head as the kernels take it: (Wd32 (H, D), other32), both
    f32 and contiguous on the card (``_operands``); ``other`` is bias_d or
    g_dur and must have ``shape`` + (D,)."""
    _plain._check_dur_head(Wd, other, H, what)
    Wd32, other32 = _operands(dev, Wd=(Wd, 2), **{what: (other, len(shape) + 1)})
    if tuple(other32.shape) != tuple(shape) + (Wd32.shape[1],):
        raise ValueError(f"{what} must be {tuple(shape) + (Wd32.shape[1],)}; got "
                         f"{tuple(other32.shape)}")
    return Wd32, other32


def _dur_inputs(e, p, Wd, other, what, per_cell):
    """What the standalone duration-head kernels take: (e32, p32, Wd32,
    other32)."""
    dev = e.device
    e32, p32 = _operands(dev, e=(e, 3), p=(p, 3))
    B, T, H = e.shape
    if p.shape[0] != B or p.shape[2] != H:
        raise ValueError(f"shapes disagree: e {tuple(e.shape)}, p {tuple(p.shape)}")
    # The kernels' shared memory does not depend on H (dur_smem_bytes).
    shape = (B, T, p.shape[1]) if per_cell else ()
    return (e32, p32) + _dur_head(dev, H, Wd, other, what, shape)


# The plan of csrc/joint.cuh (Plan, plan), mirrored for the CPU tests; a card
# test holds it against wtt_joint_plan. Every product of the token head runs
# on 128 × 128 tiles of C (two warpgroups of 64 rows, wgmma m64n128) over a
# depth that streams through a ring of JOINT_STAGES k-slices; H and V are
# padded to multiples of JOINT_TILE, and a chunk of rows is a whole number
# of JOINT_TILE-row tiles whose buffers take at most the chunk's megabytes.
JOINT_TILE = 128
JOINT_STAGES = 3
JOINT_PANEL = 8
# k of a ring stage by W's type: 128 bytes of a row (bf16 64, f32 32), and
# the arrays an operand takes (f32: tf32 hi and lo).
_KS = {torch.bfloat16: 64, torch.float32: 32}
_PARTS = {torch.bfloat16: 1, torch.float32: 2}


class JointPlan(NamedTuple):
    hp: int           # H padded to a multiple of JOINT_TILE
    vp: int           # V padded to a multiple of JOINT_TILE
    ks: int           # k of a ring stage
    stages: int       # stages of the ring
    prep_smem: int    # dynamic shared memory of a block, bytes: the prep kernel,
    g_smem: int       # the g kernel, the dh kernel and the dW kernel
    dh_smem: int
    dw_smem: int
    prep_rows: int    # rows of a chunk of the prep (its h buffer)
    grad_rows: int    # rows of a chunk of the gradient (its h, hᵀ, g, gᵀ, dh and db partials)


def _r16(n):
    return -(-n // 16) * 16


def _pad(n):
    return -(-n // JOINT_TILE) * JOINT_TILE


def joint_plan(H: int, V: int, dtype: torch.dtype, chunk_mb: int | None = None) -> JointPlan:
    """The fused joint kernels' plan at joint width H >= 1, V >= 1 columns
    and W of ``dtype`` (f32 or bf16), with each chunk's buffers at most
    ``chunk_mb`` MB (``_CHUNK_MB`` when None)."""
    chunk_mb = _CHUNK_MB if chunk_mb is None else chunk_mb
    elt = (2 if dtype == torch.bfloat16 else 4) * _PARTS[dtype]
    hp, vp, t = _pad(H), _pad(V), JOINT_TILE
    # the ring (A and B tiles of 128 rows × 128 bytes a stage) and its mbarriers
    ring = JOINT_STAGES * _PARTS[dtype] * 2 * t * 128 + _r16(8 * JOINT_STAGES)
    prep = ring + _r16(4 * 4 * t) * 2
    g = ring + _r16(4 * (4 + JOINT_PANEL) * t) + _r16(4 * 4 * t) + _r16(4 * t) + _r16(4 * t)
    budget = chunk_mb << 20
    prep_rows = max(t, budget // (elt * hp) // t * t)
    grad_rows = max(t, budget // (elt * 2 * (hp + vp) + 4 * hp + vp // 32) // t * t)
    return JointPlan(hp, vp, _KS[dtype], JOINT_STAGES, prep, g, ring, ring, prep_rows, grad_rows)


def kernel_plan(H: int, V: int, dtype: torch.dtype, chunk_mb: int | None = None) -> JointPlan:
    """The plan the kernels take at this H, V and W type, from the C entry
    (``wtt_joint_plan``); for the card tests and the measurement scripts."""
    chunk_mb = _CHUNK_MB if chunk_mb is None else chunk_mb
    out = (ctypes.c_longlong * len(JointPlan._fields))()
    err = lib().wtt_joint_plan(H, V, DTYPE_CODES[dtype], chunk_mb << 20, out)
    if err != 0:
        raise RuntimeError(f"wtt_joint_plan({H}, {V}, {dtype}) failed: cudaError {err}")
    return JointPlan(*out)


def dwd_tile(H: int) -> int:
    """Sixteens of rows of a row tile of the dWd kernel (joint.cuh::dwd_tile)."""
    return 4 if H <= 256 else 2 if H <= 512 else 1


# The plan of csrc/dur_head.cu (its constants and prep_ut / prep_tt), mirrored
# for the CPU tests; a card test holds it against wtt_dur_head_plan and
# wtt_dur_head_smem. The prep: a thread a cell, tiles of tt frames × ut
# labels, e and p staged a chunk of DUR_PREP_KC columns at a time in rows of
# DUR_PREP_LD words. The gradient: a block owns DUR_GRAD_KS columns of k of
# one utterance for a share of its frames (DUR_GRAD_SPLITS blocks share
# them), DUR_GRAD_WARPS warps a block deal them DUR_GRAD_TF at a time, labels
# go in chunks of DUR_GRAD_UC, two at a time. A head has any D: the kernels
# are instances of D = 1 … DUR_GROUP_D; a wider head's prep runs in groups of
# DUR_GROUP_D columns (blockIdx.z), its gradient in one kernel
# (dur_grad_many_kernel) on the same blocks, whose warps step through units
# of DUR_MANY_TF frames × DUR_MANY_UL labels a chunk of DUR_MANY_C columns at
# a time, their sums of dWd in shared memory (past what a block holds, in the
# scratch).
DUR_PREP_THREADS = 256
DUR_PREP_KC = 32
DUR_PREP_LD = DUR_PREP_KC + 4
DUR_GRAD_WARPS = 4
DUR_GRAD_KS = 32
DUR_GRAD_UC = 32
DUR_GRAD_TF = 2
DUR_GRAD_SPLITS = 2
DUR_GROUP_D = 8
DUR_MANY_TF = 4
DUR_MANY_UL = 4
DUR_MANY_C = 4


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
    p chunk, its warps' dp sums and their frames' g_dur (at D = 8, which the
    prep's groups of a wider head take too; the wider gradient's is
    ``dur_many_smem``); neither depends on H or U."""
    prep = 4 * ((DUR_PREP_THREADS + 1) * DUR_PREP_LD + DUR_PREP_KC * DUR_GROUP_D)
    grad = 4 * ((1 + DUR_GRAD_WARPS) * DUR_GRAD_UC * DUR_GRAD_KS
                + DUR_GRAD_WARPS * DUR_GRAD_TF * DUR_GRAD_UC * DUR_GROUP_D)
    return max(prep, grad)


def dur_many_width(D: int) -> int:
    """Columns of the wide gradient's sums and Wd slice: D up to whole chunks."""
    return -(-D // DUR_MANY_C) * DUR_MANY_C


def dur_many_smem(D: int) -> tuple:
    """(static, dynamic) shared memory of a block of the gradient past
    DUR_GROUP_D columns and whether its warps' sums of dWd lie in device
    memory: the p chunk and the warps' dp sums; the warps' staged g_dur, and
    the sums and Wd's slice while a block holds them."""
    static = 4 * (1 + DUR_GRAD_WARPS) * DUR_GRAD_UC * DUR_GRAD_KS
    g = 4 * DUR_GRAD_WARPS * DUR_MANY_TF * DUR_MANY_UL * DUR_MANY_C
    sums = 4 * (DUR_GRAD_WARPS + 1) * dur_many_width(D) * DUR_GRAD_KS
    in_device = static + g + sums > SMEM_BYTES
    return static, g if in_device else g + sums, in_device


def dur_part_floats(B: int, T: int, U: int, H: int, D: int) -> int:
    """Values of the duration-head gradient's f32 scratch
    (``dur_head.cu::dur_part_floats``): a partial of dp2 and of dWd an
    utterance and frame split, whatever D; past DUR_GROUP_D columns where a
    block's shared memory does not hold them, the warps' sums of dWd too."""
    bh = B * H
    sums = 0
    if D > DUR_GROUP_D and dur_many_smem(D)[2]:
        sums = DUR_GRAD_SPLITS * B * -(-H // DUR_GRAD_KS) * DUR_GRAD_WARPS \
            * dur_many_width(D) * DUR_GRAD_KS
    return DUR_GRAD_SPLITS * (bh * U + bh * D) + sums


def _ptr(t):
    return None if t is None else t.data_ptr()


def _host_cols(cols):
    return (ctypes.c_int * len(cols))(*cols)


def _scratch(n, W):
    """n elements of W's operand type, by W's type: bf16, or f32 as two
    arrays (tf32 hi, then lo)."""
    return torch.empty(n * _PARTS[W.dtype], dtype=W.dtype, device=W.device)


def fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank: int,
               extra_cols=(), dur_head=None) -> _prep.PreparedInputs:
    """``fused_joint.fused_prep`` on the card: Wᵀ laid out once, then a
    chunk of rows at a time its h and the prep kernel over all of V, all in
    one counted launch of the C entry, whatever the hooks. On a CPU tensor
    this is the plain version."""
    if e.device.type != "cuda":
        return _plain.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank,
                                 extra_cols, dur_head)
    dev = e.device
    e32, p32, Wk, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
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
    plan = joint_plan(H, V, Wk.dtype)
    chunk = min(plan.prep_rows, _pad(B * T * U))
    wt = _scratch(plan.vp * plan.hp, Wk)
    h = _scratch(chunk * plan.hp, Wk)
    with torch.cuda.device(dev):
        err = lib().wtt_joint_prep(
            e32.data_ptr(), p32.data_ptr(), Wk.data_ptr(), DTYPE_CODES[Wk.dtype], b32.data_ptr(),
            lab.data_ptr(), offsets.data_ptr(), ll.data_ptr(), lpb.data_ptr(), lpe.data_ptr(),
            denom.data_ptr(), _ptr(lpX), _host_cols(cols), K, col_table(cols, dev), _ptr(Wd32),
            _ptr(bias_d32),
            _ptr(dlog), D, wt.data_ptr(), h.data_ptr(), chunk, B, T, U, H, V, int(blank),
            stream(dev))
    check(err, "joint_prep")
    return _prep.PreparedInputs(lpb=lpb, lpe=lpe, denom=denom, extras=lpX, dur=dlog)


def _dur_splits(B, T, U, H, dev):
    """Row splits of the fused gradient's dWd kernel: each split walks every
    nsplit-th row tile and owns one partial of dWd."""
    tiles = -(-(B * T * U) // (16 * dwd_tile(H)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(_DUR_BLOCKS_PER_SM * sms, tiles))


# Shared memory of a multiprocessor (228 KB): with a kernel's, it says how
# many of its blocks a multiprocessor holds.
_SM_SHARED = 233472


def grad_splits(plan: JointPlan, chunk: int, sms: int) -> tuple:
    """(dh_split, dw_split): the spans of dh's sum over V (whole 128-column
    tiles) and of dW's sum over a chunk's row tiles, so that each grid fills
    one wave of the blocks that ``sms`` multiprocessors hold at once (two a
    multiprocessor with bf16 W's shared memory, one with f32's) where its
    tiles alone would not; 1 where they do."""
    target = max(1, _SM_SHARED // (plan.dh_smem + 1024)) * sms  # a block reserves 1 KB
    row_tiles, h_tiles, v_tiles = chunk // JOINT_TILE, plan.hp // JOINT_TILE, plan.vp // JOINT_TILE
    dh = max(1, min(v_tiles, -(-target // (row_tiles * h_tiles))))
    dw = max(1, min(row_tiles, -(-target // (h_tiles * v_tiles))))
    return dh, dw


def tile_order(rows: int, cols: int, dtype: torch.dtype) -> torch.Tensor:
    """Where each element (r, k) of an operand of ``rows`` (a multiple of
    JOINT_TILE) × ``cols`` (a multiple of the stage's k) lies in its tiled
    layout (joint.cuh::tiled): an int64 (rows, cols) tensor of element
    indices. Tiles of 128 rows × ``ks`` columns, row tile by row tile and
    along k, each in wgmma's core-matrix order (8 rows × 16 bytes)."""
    ks = _KS[dtype]
    E = 16 // (2 if dtype == torch.bfloat16 else 4)
    r = torch.arange(rows, dtype=torch.int64)[:, None]
    k = torch.arange(cols, dtype=torch.int64)[None, :]
    return (((r >> 7) * (cols // ks) + k // ks) * (JOINT_TILE * ks)
            + ((((r & 127) >> 3) * 8 + (k % ks) // E) * 8 + (r & 7)) * E + k % E)


def fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
               fields: _gradients.Coefficients, blank: int, extra=None, dur_head=None):
    """``fused_joint.fused_grad`` on the card, a chunk of the B·T·U cells at
    a time: the row launch (h and hᵀ, g and gᵀ with db's partials, dh into
    de and dp, the duration head's cotangent joining dh there; the first
    chunk's also lays W out) and the column launch (dW and db from them),
    each counted under ``joint_grad``, and with a duration head one more for
    dWd. On a CPU tensor this is the plain version."""
    if e.device.type != "cuda":
        return _plain.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                                 fields, blank, extra, dur_head)
    dev = e.device
    e32, p32, Wk, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
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
    plan = joint_plan(H, V, Wk.dtype)
    cells = B * T * U
    chunk = min(plan.grad_rows, _pad(cells))
    dh_split, dw_split = grad_splits(
        plan, chunk, torch.cuda.get_device_properties(dev).multi_processor_count)
    wt, wp = _scratch(plan.vp * plan.hp, Wk), _scratch(plan.hp * plan.vp, Wk)
    h, ht = _scratch(chunk * plan.hp, Wk), _scratch(plan.hp * chunk, Wk)
    g, gt = _scratch(chunk * plan.vp, Wk), _scratch(plan.vp * chunk, Wk)
    db_part = torch.empty((chunk // JOINT_TILE, plan.vp), dtype=torch.float32, device=dev)
    dh_part = torch.empty((dh_split, chunk, plan.hp), dtype=torch.float32, device=dev)
    dW_part = (torch.empty((dw_split, H, V), dtype=torch.float32, device=dev)
               if dw_split > 1 else None)
    code = DTYPE_CODES[Wk.dtype]
    inputs = (Wk.data_ptr(), code, b32.data_ptr(), lab.data_ptr(), offsets.data_ptr(),
              ll.data_ptr(), denom.data_ptr(), fields.coef.data_ptr(), fields.cb.data_ptr(),
              fields.ce.data_ptr(), _ptr(cX), _host_cols(cols), K, col_table(cols, dev))
    scratch = tuple(x.data_ptr() for x in (wt, wp, h, ht, g, gt, db_part, dh_part))
    out = ()
    with torch.cuda.device(dev):
        for r0 in range(0, cells, chunk):
            err = lib().wtt_joint_grad_rows(e32.data_ptr(), p32.data_ptr(), *inputs, _ptr(Wd32),
                                            _ptr(gd), D, de.data_ptr(), dp.data_ptr(), r0, chunk,
                                            dh_split, *scratch, B, T, U, H, V, int(blank),
                                            stream(dev))
            check(err, "joint_grad")
            err = lib().wtt_joint_grad_cols(offsets.data_ptr(), ll.data_ptr(), code,
                                            ht.data_ptr(), gt.data_ptr(), db_part.data_ptr(),
                                            dW.data_ptr(), _ptr(dW_part), db.data_ptr(), r0,
                                            chunk, dw_split, int(r0 > 0),
                                            int(r0 + chunk >= cells), B, T, U, H, V, stream(dev))
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
    part = torch.empty(dur_part_floats(B, T, U, H, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_dur_head_grad(e32.data_ptr(), p32.data_ptr(), Wd32.data_ptr(),
                                      gd.data_ptr(), offsets.data_ptr(), ll.data_ptr(),
                                      de.data_ptr(), dp.data_ptr(), dWd.data_ptr(),
                                      part.data_ptr(), B, T, U, H, D, stream(dev))
    check(err, "dur_head")
    return de.to(e.dtype), dp.to(p.dtype), dWd.to(Wd.dtype)


# The kernels of the fused joint by their C entries' attribute queries:
# (entry, which) → the kernel's name as the profiler shows it.
_ATTRS = (("joint_w_kernel", "wtt_joint_prep_attrs", 0),
          ("joint_h_kernel", "wtt_joint_prep_attrs", 1),
          ("joint_prep_kernel", "wtt_joint_prep_attrs", 2),
          ("joint_grad_g_kernel", "wtt_joint_grad_rows_attrs", 0),
          ("joint_grad_dh_kernel", "wtt_joint_grad_rows_attrs", 1),
          ("joint_grad_dw_kernel", "wtt_joint_grad_cols_attrs", None))


def kernel_registers(dtype: torch.dtype) -> dict:
    """{kernel: (registers a thread, local bytes a thread)} of the fused
    joint's kernels with W of ``dtype`` (one instance each, whatever H), as
    ptxas compiled them (``cudaFuncGetAttributes``); for the measurement
    scripts."""
    code = DTYPE_CODES[dtype]
    out = {}
    for name, entry, which in _ATTRS:
        regs, local = ctypes.c_int(), ctypes.c_int()
        args = (code,) if which is None else (which, code)
        err = getattr(lib(), entry)(*args, ctypes.byref(regs), ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"{name}: cudaFuncGetAttributes failed: cudaError {err}")
        out[name] = (regs.value, local.value)
    return out
