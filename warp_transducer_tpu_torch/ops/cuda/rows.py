"""The tile planners of the row passes (``csrc/rows.cuh``) and of the row
reductions (``csrc/reduce.cuh``), pure Python.

``plan(V, elt, align)`` chooses how a kernel sweeps rows of ``V`` elements
of ``elt`` bytes: a tile of ``rows`` consecutive rows a block (small V), or
a warp a row (large V); the vector width (16 bytes of elements where both
base pointers are 16-byte aligned, else one element); and the magic numbers
of the 32-bit division of a tile offset by V. The kernels take the plan as
a host array of five unsigned (``host_plan``) and check it again.

``reduce_plan(V, elt, align)`` plans the reductions the same way and adds
the threads that reduce a row of a tile from shared memory (``group``) and
the row stride there (``stride``). ``csrc/reduce.cuh::plan`` is its mirror
in C, which the prep kernel's C entry applies itself; a card test holds the
two against each other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

TILE, WARP = 0, 1
THREADS = 256  # a block, in both modes
VECS_PER_THREAD = 4  # tile mode: the vectors a thread holds in flight
MAX_TILE_ROWS = 512  # tile mode: the rows whose scalars a block stages
WARP_ROWS = THREADS // 32
# The switch point: rows of at most this many elements go by tiles. Chosen
# by scripts/tune_rows.py on an H100 (PERF.md): the tiles were ahead or even
# up to V = 768 in f32 and bf16, a warp a row ahead in bf16 from V = 1024.
TILE_MAX_V = 768


class RowPlan(NamedTuple):
    mode: int  # TILE or WARP
    rows: int  # rows a block
    vec: int  # elements a load or store
    div_mul: int  # n // V == (n * div_mul >> 32) >> div_shr for 0 <= n < 2**31, V > 1
    div_shr: int


def division_magic(d: int) -> tuple:
    """(mul, shr) of the round-up method: n // d == ((n * mul) >> 32) >> shr
    for 0 <= n < 2**31 and 2 <= d < 2**31; (0, 0) for d = 1, which the
    kernel divides by returning n."""
    if d == 1:
        return 0, 0
    log2 = (d - 1).bit_length()  # ceil(log2 d)
    p = 31 + log2
    return ((1 << p) + d - 1) // d, p - 32


@functools.lru_cache(maxsize=None)
def plan(V: int, elt: int, align: int = 16) -> RowPlan:
    """The plan for rows of ``V`` elements of ``elt`` bytes (2, 4 or 8),
    ``align`` the largest power of two (at most 16) that divides both base
    addresses in bytes. A tile holds at most THREADS·VECS_PER_THREAD
    vectors and MAX_TILE_ROWS rows, and rows·V is a multiple of the vector
    width, so that every tile starts aligned."""
    if V < 1 or elt not in (2, 4, 8):
        raise ValueError(f"no row plan for V={V}, element size {elt}")
    vec = 16 // elt if align % 16 == 0 else 1
    mul, shr = division_magic(V)
    if V > TILE_MAX_V:
        return RowPlan(WARP, WARP_ROWS, vec, mul, shr)
    rows = min(MAX_TILE_ROWS, THREADS * VECS_PER_THREAD * vec // V)
    step = vec // math.gcd(V, vec)  # rows·V % vec == 0
    rows -= rows % step
    return RowPlan(TILE, rows, vec, mul, shr)


def alignment(*ptrs: int) -> int:
    """The largest power of two, at most 16, that divides every address."""
    a = 16
    for p in ptrs:
        while p % a:
            a //= 2
    return a


@functools.lru_cache(maxsize=None)
def host_plan(V: int, elt: int, align: int = 16):
    """``plan`` as the kernels take it: a host array of five unsigned."""
    return (ctypes.c_uint * 5)(*plan(V, elt, align))


# The reductions' switch point (csrc/reduce.cuh::kTileMaxV): rows of at most
# this many elements go by tiles. Chosen by scripts/tune_prep.py on an H100
# (PERF.md): the tiles were ahead up to V = 256 in f32 and bf16, a warp a
# row from V = 384.
REDUCE_TILE_MAX_V = 256
# A thread of a tile's group reduces at least this many bytes of its row:
# the group is the largest power of two, at most a warp, that leaves it so
# many (16 f32 or 32 bf16 elements; the fastest groups of the same sweep).
GROUP_BYTES = 64
WARP_LANES = 32


class ReducePlan(NamedTuple):
    mode: int  # TILE or WARP
    rows: int  # rows a block
    vec: int  # elements a load
    div_mul: int  # n // V as in RowPlan
    div_shr: int
    group: int  # tile: threads a row (a power of two up to a warp); warp: 32
    stride: int  # tile: elements between rows in shared memory; warp: V


@functools.lru_cache(maxsize=None)
def reduce_plan(V: int, elt: int, align: int = 16) -> ReducePlan:
    """The plan of the row reductions for rows of ``V`` elements of ``elt``
    bytes at base alignment ``align``. The tile is sized as ``plan`` sizes
    it; ``group`` is the largest power of two, at most a warp, with
    group·GROUP_BYTES <= V·elt (else 1); ``stride`` the least multiple of ``group``
    at or above V whose quotient by ``group`` is odd (any for a group of a
    warp), so that the rows one warp reduces at once start ``group`` banks
    apart."""
    if V < 1 or elt not in (2, 4, 8):
        raise ValueError(f"no row plan for V={V}, element size {elt}")
    vec = 16 // elt if align % 16 == 0 else 1
    mul, shr = division_magic(V)
    warp = ReducePlan(WARP, WARP_ROWS, vec, mul, shr, WARP_LANES, V)
    if V > REDUCE_TILE_MAX_V:
        return warp
    rows = min(MAX_TILE_ROWS, THREADS * VECS_PER_THREAD * vec // V)
    rows -= rows % (vec // math.gcd(V, vec))
    if rows < 1:
        return warp
    group = 1
    while group < WARP_LANES and 2 * group * GROUP_BYTES <= V * elt:
        group *= 2
    m = -(-V // group)
    if group < WARP_LANES and m % 2 == 0:
        m += 1
    return ReducePlan(TILE, rows, vec, mul, shr, group, m * group)


def reduce_smem_bytes(p: ReducePlan, acc: int) -> int:
    """Dynamic shared memory of a tile launch: the rows at their stride in
    the accumulation type (``acc`` bytes), then a value a row."""
    return p.rows * (p.stride + 1) * acc if p.mode == TILE else 0


# Past eight extra columns the prep's block emits its rows' K extras as one
# run (csrc/prep.cu::ManyPrepOp): each thread takes 16-byte vectors of it,
# RUN_UNROLL at a time, the values before the run's first 16-byte boundary
# and after its last one a value a thread; the column table's first
# RUN_SHARED_COLS entries are in shared memory.
RUN_SHARED_COLS = 4096
RUN_UNROLL = 2
# Raw in a tile, a thread a row emits its row's K extras itself where the
# tile's warps of rows times K are at most this many (csrc/prep.cu::
# many_by_row; chosen by scripts/tune_prep.py --many on an H100).
RUN_ROW_STEPS = 40


def prep_many_by_row(p: ReducePlan, K: int) -> bool:
    """Whether the raw prep past eight extra columns has a thread a row emit
    its row's extras (else the block's run)."""
    return p.mode == TILE and -(-p.rows // WARP_LANES) * K <= RUN_ROW_STEPS


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def reduce_run_offset(p: ReducePlan, reduce: bool, acc: int) -> int:
    """Where a run's shared memory starts: raw (``reduce``,
    ``reduce.cuh::run_offset``) past the tile and its rows' values, or past
    the block's rows' values in the warp mode; on log-probs
    (``prep_many_lp_kernel``, in either mode) at 0."""
    if not reduce:
        return 0
    return _round16(reduce_smem_bytes(p, acc) if p.mode == TILE else WARP_ROWS * acc)


def reduce_run_smem(p: ReducePlan, reduce: bool, acc: int, K: int) -> int:
    """Dynamic shared memory of a launch with a run of K columns: the body's,
    then the table's first RUN_SHARED_COLS entries."""
    return reduce_run_offset(p, reduce, acc) + _round16(4 * min(K, RUN_SHARED_COLS))
