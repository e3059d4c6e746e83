"""The tiling of the standalone duration-head kernels (csrc/dur_head.cu),
pure Python, on the CPU.

The kernels plan their grids themselves; ``ops/cuda/joint.py`` mirrors the
plan (``dur_head_plan``, ``dur_prep_tile``, ``dur_smem_bytes``; a card test
holds it against the C entries). Here the kernels' index loops are mirrored
with numpy over that plan, for ragged lengths that reach every edge (U_b
beyond a prep tile of 256 labels and beyond a gradient chunk of 32, T_b = 1,
U_b = 1, an utterance without labels or frames, no lengths at all):

* the prep visits every valid cell (t < T_b, u < U_b) exactly once and no
  other, and a tile's rows fit its shared memory;
* the gradient's blocks of every column slice (two frame splits) visit
  every valid cell of their utterance exactly once; de2[b, t, k] and each
  split's partial of dp2[b, u, k] are each first written by one thread
  (later u chunks add to de2 by the same thread), so every entry has one
  owner and needs no atomic;
* every column k < H is owned by exactly one block for each b;
* the shared memory stays within a block's 227 KB (and the 48 KB of static
  shared memory) for H up to 1024 and U up to 1000.

Exact checks, no tolerance.
"""
import numpy as np
import pytest

from warp_transducer_tpu_torch.ops.cuda import SMEM_BYTES
from warp_transducer_tpu_torch.ops.cuda import joint as J

# T, U, input lengths, label lengths (U_b = label length + 1).
CASES = {
    "fused_like": (15, 21, [15, 8, 11, 15], [20, 10, 14, 13]),
    "U301": (4, 301, [4, 3, 2], [300, 170, 255]),
    "U1000": (3, 1000, [3, 2, 3], [999, 511, 32]),
    "chunk_edges": (5, 200, [5, 5, 5, 5, 4], [31, 32, 63, 64, 30]),
    "T1_U1": (5, 4, [1, 5, 1], [0, 3, 2]),
    "zero_labels_inside": (6, 4, [6, 5, 4], [3, 0, 2]),
    "zero_frames": (6, 4, [6, 0, 4], [3, 2, 0]),
    "U1_long_T": (600, 1, [600, 257, 256], [0, 0, 0]),
    "no_lengths": (13, 7, None, None),
}
H_VALUES = [1, 4, 31, 32, 33, 200, 256, 1000, 1024]


def _lengths(T, U, il, ll):
    """(T_b, U_b) as the kernels derive them: U_b = clamp(ll + 1, 0, U),
    T_b from the running sums of clamp(il, 0, T)·U_b."""
    if il is None:
        il, ll = [T] * 2, [U - 1] * 2
    Ub = np.clip(np.asarray(ll) + 1, 0, U)
    cells = np.clip(np.asarray(il), 0, T) * Ub
    Tb = np.where(Ub > 0, cells // np.maximum(Ub, 1), 0)
    return Tb, Ub


def _prep_visits(T, U, Tb, Ub, H=256):
    """Visits of each cell (b, t, u) by the threads of dur_prep_kernel."""
    visits = np.zeros((len(Tb), T, U), dtype=np.int64)
    ut_host, _, tiles, _ = J.dur_head_plan(T, U, H)
    tiles_u = -(-U // ut_host)
    tid = np.arange(J.DUR_PREP_THREADS)
    for b, (tb, ub) in enumerate(zip(Tb, Ub)):
        if tb == 0:
            continue
        ut, tt = J.dur_prep_tile(ub)
        for y in range(tiles):
            t0, u0 = (y // tiles_u) * tt, (y % tiles_u) * ut
            if t0 >= tb or u0 >= ub:
                continue
            nt, nu = min(tt, tb - t0), min(ut, ub - u0)
            assert nt + nu <= J.DUR_PREP_THREADS + 1  # the rows of shared memory
            tl, ul = tid // nu, tid % nu
            on = tl < nt
            np.add.at(visits, (b, t0 + tl[on], u0 + ul[on]), 1)
    return visits


def _valid(T, U, Tb, Ub):
    t, u = np.arange(T)[None, :, None], np.arange(U)[None, None, :]
    return (t < np.asarray(Tb)[:, None, None]) & (u < np.asarray(Ub)[:, None, None])


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_prep_visits_every_valid_cell_once(case):
    T, U, il, ll = CASES[case]
    Tb, Ub = _lengths(T, U, il, ll)
    visits = _prep_visits(T, U, Tb, Ub)
    np.testing.assert_array_equal(visits, _valid(T, U, Tb, Ub).astype(np.int64))


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_grad_visits_every_valid_cell_once_and_owns_its_outputs(case):
    """One column slice (all slices run the same loops over the cells): the
    cells the warps of its frame splits visit, and the first and the later
    writes of de2 and of each split's partial of dp2 by thread (warp)."""
    T, U, il, ll = CASES[case]
    Tb, Ub = _lengths(T, U, il, ll)
    W, UC, TF, S = J.DUR_GRAD_WARPS, J.DUR_GRAD_UC, J.DUR_GRAD_TF, J.DUR_GRAD_SPLITS
    visits = np.zeros((len(Tb), T, U), dtype=np.int64)
    for b, (tb, ub) in enumerate(zip(Tb, Ub)):
        de_first, de_owner = np.zeros(T, dtype=np.int64), np.full(T, -1)
        dp_writes = np.zeros((S, U), dtype=np.int64)  # each split's partial
        for z in range(S):
            for u0 in range(0, ub, UC):
                nu = min(UC, ub - u0)
                nu2 = nu + nu % 2  # labels go in pairs; the padding label is zero
                assert nu2 <= UC  # the padding row lies inside the chunk's shared memory
                for w in range(W):
                    for t0 in range(TF * (z * W + w), tb, TF * W * S):
                        for t in range(t0, min(t0 + TF, tb)):  # frames beyond T_b add zeros
                            for ul in range(0, nu, 2):
                                visits[b, t, u0 + ul:u0 + min(ul + 2, nu)] += 1
                            if u0 == 0:  # a plain store; later chunks add to it
                                de_first[t] += 1
                                de_owner[t] = z * W + w
                            assert de_owner[t] == z * W + w  # the same thread adds the rest
                dp_writes[z, u0:u0 + nu] += 1  # the sum across warps, a thread an entry
            for w in range(W):  # zeros outside the lattice: de2 by the first split
                if z == 0:
                    de_first[(tb if ub > 0 else 0) + w:T:W] += 1
                dp_writes[z, ub + w:U:W] += 1
        np.testing.assert_array_equal(de_first, np.ones(T, dtype=np.int64))
        np.testing.assert_array_equal(dp_writes, np.ones((S, U), dtype=np.int64))
    np.testing.assert_array_equal(visits, _valid(T, U, Tb, Ub).astype(np.int64))


@pytest.mark.parametrize("H", H_VALUES)
def test_every_column_has_one_owner(H):
    slices = J.dur_head_plan(1, 1, H)[3] // J.DUR_GRAD_SPLITS
    k = (np.arange(slices)[:, None] * J.DUR_GRAD_KS + np.arange(32)[None, :]).ravel()
    owned = np.bincount(k[k < H], minlength=H)
    np.testing.assert_array_equal(owned, np.ones(H, dtype=np.int64))
    assert (slices - 1) * J.DUR_GRAD_KS < H  # no block without a column


@pytest.mark.parametrize("U", [1, 2, 21, 64, 65, 255, 256, 257, 301, 1000])
def test_prep_tile_fills_the_block(U):
    ut, tt = J.dur_prep_tile(U)
    assert 1 <= ut * tt <= J.DUR_PREP_THREADS and ut + tt <= J.DUR_PREP_THREADS + 1
    assert ut == U or ut == J.DUR_PREP_THREADS
    assert ut * (tt + 1) > J.DUR_PREP_THREADS  # no room for one more frame


@pytest.mark.parametrize("U", [1, 21, 301, 1000])
@pytest.mark.parametrize("H", [1, 200, 256, 1024])
def test_shared_memory_within_a_block(H, U):
    # The plan at (H, U) stages at most 257 rows of e and p and a chunk of
    # 32 labels, whatever H and U are.
    ut, tt, _, _ = J.dur_head_plan(4, U, H)
    uc = min(U + U % 2, J.DUR_GRAD_UC)
    prep = 4 * ((ut + tt) * J.DUR_PREP_LD + J.DUR_PREP_KC * J.DUR_GROUP_D)
    grad = 4 * ((1 + J.DUR_GRAD_WARPS) * uc * J.DUR_GRAD_KS
                + J.DUR_GRAD_WARPS * J.DUR_GRAD_TF * uc * J.DUR_GROUP_D)
    assert max(prep, grad) <= J.dur_smem_bytes() <= min(SMEM_BYTES, 48 * 1024)
