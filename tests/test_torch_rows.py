"""The tile planner of the row passes (``ops/cuda/rows.py::plan``, which the
kernels of csrc/grad.cu and csrc/band_grad.cu take as their launch plan),
pure Python, on the CPU.

The two modes' index loops of ``csrc/rows.cuh`` (``tile_body``,
``warp_body``) are mirrored here with numpy: for every V from 1 to 600 (and
V on both sides of the switch to a warp a row) and each input type, every element of every row is written exactly once, every
vector access starts on a multiple of its width (so, with aligned bases, on
a 16-byte boundary), and the multiply-high division by V that finds an
element's row is exact over a tile. Exact checks, no tolerance.
"""
import numpy as np
import pytest
import torch

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
