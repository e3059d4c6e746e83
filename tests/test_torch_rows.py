"""The tile planners of the row passes (``ops/cuda/rows.py::plan``, which the
kernels of csrc/grad.cu and csrc/band_grad.cu take as their launch plan)
and of the row reductions (``rows.reduce_plan``, which csrc/prep.cu applies
through its C mirror in csrc/reduce.cuh), pure Python, on the CPU.

The two modes' index loops of ``csrc/rows.cuh`` (``tile_body``,
``warp_body``) are mirrored here with numpy: for every V from 1 to 600 (and
V on both sides of the switch to a warp a row) and each input type, every element of every row is written exactly once, every
vector access starts on a multiple of its width (so, with aligned bases, on
a 16-byte boundary), and the multiply-high division by V that finds an
element's row is exact over a tile. The reductions' loops of
``csrc/reduce.cuh`` (``tile_body``: the loads, their scatter into shared
memory, a group of threads a row; ``warp_body``) are mirrored the same way:
every element is loaded once and lands in its own slot of its row, every
element of every row falls in exactly one group's reduction, the vectors
are aligned, the reads of one warp's step are free of bank conflicts, and
the group and shared memory stay within the kernel's limits, also for f64
rows reduced in f32 (the band prep). Exact checks, no tolerance.
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch.ops.cuda import SMEM_BYTES
from warp_transducer_tpu_torch.ops.cuda import rows as R

DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16]
# Every V up to 600, then each side of the switch to a warp a row and V of
# the published shapes and their neighbours.
V_RANGE = list(range(1, 601)) + [R.TILE_MAX_V - 1, R.TILE_MAX_V, R.TILE_MAX_V + 1,
                                  R.TILE_MAX_V + 7, 1000, 1003, 4999, 5000, 5001]


def _tile_accesses(p, V, n_rows):
    """(vector starts, scalar indices) of tile_body over n_rows rows."""
    vecs, scalars = [], []
    vi = (np.arange(R.THREADS)[:, None] + np.arange(R.VECS_PER_THREAD)[None, :] * R.THREADS)
    vi = vi.ravel()
    for row0 in range(0, n_rows, p.rows):
        n = min(p.rows, n_rows - row0) * V
        nv = n // p.vec * p.vec
        e = vi * p.vec
        vecs.append(row0 * V + e[e < nv])
        tail = nv + np.arange(R.THREADS)
        scalars.append(row0 * V + tail[tail < n])
    return np.concatenate(vecs), np.concatenate(scalars)


def _warp_accesses(p, V, n_rows):
    """(vector starts, scalar indices) of warp_body over n_rows rows."""
    vecs, scalars = [], []
    for ri in range(n_rows):
        base = ri * V
        head = min(V, (p.vec - base % p.vec) % p.vec)
        assert head <= 32  # one element a lane
        nvec = (V - head) // p.vec
        vecs.append(base + head + np.arange(nvec) * p.vec)
        scalars.append(base + np.arange(head))
        scalars.append(base + np.arange(head + nvec * p.vec, V))
    return np.concatenate(vecs), np.concatenate(scalars)


def _div(n, p, V):
    """rows.cuh::div_v: n / V by the plan's multiply-high."""
    return n if V == 1 else ((n * p.div_mul) >> 32) >> p.div_shr


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("align", [16, 8])
def test_plan_covers_every_element_once(dtype, align):
    elt = torch.empty((), dtype=dtype).element_size()
    for V in V_RANGE:
        p = R.plan(V, elt, align)
        assert p.vec == (16 // elt if align == 16 else 1), V
        if p.mode == R.TILE:
            assert V <= R.TILE_MAX_V and 1 <= p.rows <= R.MAX_TILE_ROWS, V
            assert p.rows * V <= R.THREADS * R.VECS_PER_THREAD * p.vec, V
            n_rows = 2 * p.rows + p.rows // 2 + 1  # a last, partial tile
            vecs, scalars = _tile_accesses(p, V, n_rows)
        else:
            assert p.mode == R.WARP and V > R.TILE_MAX_V and p.rows == R.WARP_ROWS, V
            n_rows = 17  # every start residue of a row modulo the width
            vecs, scalars = _warp_accesses(p, V, n_rows)
        assert np.all(vecs % p.vec == 0), f"unaligned vector at V={V}"
        hits = np.zeros(n_rows * V, np.int64)
        np.add.at(hits, (vecs[:, None] + np.arange(p.vec)[None, :]).ravel(), 1)
        np.add.at(hits, scalars, 1)
        assert hits.min() == 1 and hits.max() == 1, f"V={V}: elements covered {hits.min()}..{hits.max()} times"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_division_is_exact_over_a_tile(dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    for V in V_RANGE:
        p = R.plan(V, elt)
        assert 0 <= p.div_mul < 2 ** 32 and 0 <= p.div_shr < 32
        n = np.arange(max(p.rows, 64) * V, dtype=np.uint64)
        assert np.array_equal(_div(n, p, V), n // V), V
    # and at the edge of the kernels' 32-bit range
    for d in (2, 3, 7, 28, 50, 601, 5000, 2 ** 20 + 1, 2 ** 31 - 1):
        mul, shr = R.division_magic(d)
        n = np.array([0, d - 1, d, 2 ** 31 - d, 2 ** 31 - 2, 2 ** 31 - 1], dtype=np.uint64)
        assert np.array_equal(((n * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shr), n // d)


def test_plan_modes_and_limits():
    assert R.plan(28, 4) == R.plan(28, 4, 16)
    assert R.plan(28, 4).mode == R.TILE and R.plan(5000, 4).mode == R.WARP
    assert R.plan(R.TILE_MAX_V, 2).mode == R.TILE and R.plan(R.TILE_MAX_V + 1, 2).mode == R.WARP
    assert R.alignment(0, 256) == 16 and R.alignment(4096 + 4) == 4 and R.alignment(8, 2) == 2
    assert list(R.host_plan(28, 4)) == list(R.plan(28, 4))
    for bad in ((0, 4), (10, 3)):
        with pytest.raises(ValueError, match="no row plan"):
            R.plan(*bad)


# Every V up to 600, the switch point and its neighbours, and the large V
# of the published shapes.
REDUCE_V = list(range(1, 601)) + [R.REDUCE_TILE_MAX_V - 1, R.REDUCE_TILE_MAX_V,
                                  R.REDUCE_TILE_MAX_V + 1, 5000]


def _check_reduce_tile(p, V, acc):
    """reduce.cuh::tile_body over a full and a partial tile, elements of
    ``acc`` bytes in shared memory."""
    G, S = p.group, p.stride
    assert 1 <= G <= 32 and G & (G - 1) == 0 and R.THREADS % G == 0, V
    assert S >= V and S % G == 0 and (G == 32 or (S // G) % 2 == 1), V
    smem = R.reduce_smem_bytes(p, acc)
    # Under the default 48 KB, so no launch asks for more.
    assert smem == p.rows * (S + 1) * acc and smem <= 48 * 1024 <= SMEM_BYTES, V
    t = np.arange(R.THREADS)
    q, g = t // G, t % G
    steps = -(-V // G)
    c = g[:, None] + G * np.arange(steps)[None, :]
    for nrows in (p.rows, p.rows // 2 + 1):
        n = nrows * V
        # The loads: vectors of the flat range, then the scalar tail, each
        # element once (the coverage test of the row passes, one tile).
        vecs, scalars = _tile_accesses(p._replace(rows=nrows), V, nrows)
        assert np.all(vecs % p.vec == 0), V
        e = np.concatenate([(vecs[:, None] + np.arange(p.vec)[None, :]).ravel(), scalars])
        assert np.array_equal(np.sort(e), np.arange(n)), V
        # The scatter: an element's row by the multiply-high, its slot.
        r = _div(e.astype(np.uint64), p, V).astype(np.int64)
        assert np.array_equal(r, e // V), V
        slot = r * S + e - r * V
        assert len(np.unique(slot)) == n and slot.max() < p.rows * S, V
        # The groups: every round, every thread; a row's elements once.
        seen = np.zeros((nrows, V), np.int64)
        for base in range(0, nrows, R.THREADS // G):
            row = base + q
            act = (row[:, None] < nrows) & (c < V)
            rr, cc = np.broadcast_to(row[:, None], c.shape)[act], c[act]
            np.add.at(seen, (rr, cc), 1)
            # One step of one warp (8-byte words: of a half-warp) reads
            # each bank at one address at most.
            banks, unit = (32, t // 32) if acc == 4 else (16, t // 16)
            addr = row[:, None] * S + c
            key = np.broadcast_to(unit[:, None] * steps + np.arange(steps), c.shape)[act]
            a = addr[act]
            n_addr = len(np.unique(key * (p.rows * S) + a))
            n_bank = len(np.unique(key * banks + a % banks))
            assert n_addr == n_bank, f"bank conflict at V={V}, group {G}, stride {S}"
        assert seen.min() == 1 and seen.max() == 1, V


@pytest.mark.parametrize("align", [16, 4, 2])
@pytest.mark.parametrize("elt", [2, 4, 8])
def test_reduce_plan_covers_every_element_once(elt, align):
    acc = 8 if elt == 8 else 4  # f64 accumulates in f64, the others in f32
    for V in REDUCE_V:
        p = R.reduce_plan(V, elt, align)
        assert p.vec == (16 // elt if align == 16 else 1), V
        assert (p.div_mul, p.div_shr) == R.division_magic(V), V
        if V > R.REDUCE_TILE_MAX_V:
            assert p.mode == R.WARP and p.rows == R.WARP_ROWS and p.stride == V, V
            assert R.reduce_smem_bytes(p, acc) == 0
            vecs, scalars = _warp_accesses(p, V, 17)
            assert np.all(vecs % p.vec == 0), V
            hits = np.zeros(17 * V, np.int64)
            np.add.at(hits, (vecs[:, None] + np.arange(p.vec)[None, :]).ravel(), 1)
            np.add.at(hits, scalars, 1)
            assert hits.min() == 1 and hits.max() == 1, V
            continue
        assert p.mode == R.TILE and 1 <= p.rows <= R.MAX_TILE_ROWS, V
        assert p.rows * V % p.vec == 0 and p.rows * V <= R.THREADS * R.VECS_PER_THREAD * p.vec, V
        # the gradient's tile at the same V, where it has one
        if V <= R.TILE_MAX_V:
            assert p.rows == R.plan(V, elt, align).rows, V
        _check_reduce_tile(p, V, acc)


@pytest.mark.parametrize("align", [16, 8])
def test_reduce_plan_f64_input_f32_accumulator(align):
    """The band prep (csrc/band_prep.cu) reduces f64 rows in f32: the plan
    made for 8-byte elements, with a tile of 4-byte values in shared memory,
    still loads every element once into its own slot, reads free of bank
    conflicts and stays within the shared memory it is given."""
    for V in REDUCE_V:
        p = R.reduce_plan(V, 8, align)
        if p.mode == R.TILE:
            assert R.reduce_smem_bytes(p, 4) * 2 == R.reduce_smem_bytes(p, 8), V
            _check_reduce_tile(p, V, 4)
        else:
            assert V > R.REDUCE_TILE_MAX_V and R.reduce_smem_bytes(p, 4) == 0, V


def test_reduce_plan_groups():
    # f32: a thread at least 16 elements of its row; bf16 32; f64 8
    assert [R.reduce_plan(V, 4).group for V in (1, 28, 31, 32, 50, 127, 128, 256)] == \
        [1, 1, 1, 2, 2, 4, 8, 16]
    assert [R.reduce_plan(V, 2).group for V in (28, 64, 128, 256)] == [1, 2, 4, 8]
    assert [R.reduce_plan(V, 8).group for V in (15, 16, 50, 256)] == [1, 2, 4, 32]
    assert R.reduce_plan(R.REDUCE_TILE_MAX_V + 1, 4).mode == R.WARP
    assert R.reduce_plan(28, 4).stride == 29 and R.reduce_plan(32, 4).stride == 34
    for bad in ((0, 4), (10, 3)):
        with pytest.raises(ValueError, match="no row plan"):
            R.reduce_plan(*bad)
