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
  shared memory) for H up to 1024 and U up to 1000;
* the gradient past 8 columns (dur_grad_many_kernel: units of 4 frames × 4
  labels, chunks of 4 columns, g_dur staged a step ahead): replayed step by
  step in float64, every output entry written and equal to its sum taken
  directly (de2 whole, each split's partials of dp2 and dWd, the warps'
  sums added in order), every (cell, column) of a step staged by exactly
  one lane's load; its shared memory and scratch (``dur_part_floats``, the
  by-value formula unless the warps' sums pass a block) as the C side
  counts them.

Exact checks, no tolerance, but for the replay's float64 sums (1e-12).
"""
import numpy as np
import pytest

from warp_transducer_tpu_torch.ops.cuda import SMEM_BYTES
from warp_transducer_tpu_torch.ops.cuda import joint as J
import torch_threads  # noqa: F401  (one torch thread a process)

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


def _many_grad_replay(e, p, Wd, g, Tb, Ub):
    """dur_grad_many_kernel's loops in float64, a block (b, column slice,
    split) and warp at a time, the 32 lanes as a vector: (de2, dp2
    partials (S, B, U, H), dWd partials (S, B, H, D)), NaN where nothing
    was written."""
    B, T, H = e.shape
    U, D = p.shape[1], Wd.shape[1]
    W, UC, KS, S = J.DUR_GRAD_WARPS, J.DUR_GRAD_UC, J.DUR_GRAD_KS, J.DUR_GRAD_SPLITS
    TF, UL, C = J.DUR_MANY_TF, J.DUR_MANY_UL, J.DUR_MANY_C
    DC, step = J.dur_many_width(D), TF * W * S
    de = np.full((B, T, H), np.nan)
    dp = np.full((S, B, U, H), np.nan)
    dwd = np.full((S, B, H, D), np.nan)
    lane = np.arange(KS)
    vals = np.arange(TF * UL * C)  # a step's values: v = q·C + c, lane v % 32
    assert sorted(v % KS for v in vals) == sorted(list(range(KS)) * (len(vals) // KS))
    for b in range(B):
        tb, ub = int(Tb[b]), int(Ub[b])
        for y in range(-(-H // KS)):
            k = y * KS + lane
            kin = k < H
            kk = np.minimum(k, H - 1)
            wd = np.where(kin[None, :], Wd[kk].T, 0.0)  # (D, 32)
            wd = np.concatenate([wd, np.zeros((DC - D, KS))])
            for z in range(S):
                acc = np.zeros((W, DC, KS))
                for u0 in range(0, ub, UC):
                    nu = min(UC, ub - u0)
                    nun = -(-nu // UL) * UL
                    sp = np.zeros((UC, KS))
                    sp[:nu] = np.where(kin, p[b, u0:u0 + nu][:, kk], 0.0)
                    sdp = np.zeros((W, UC, KS))
                    for w in range(W):
                        for t0 in range(TF * (z * W + w), tb, step):
                            ev = np.array([np.where(kin, e[b, t0 + f, kk], 0.0) if t0 + f < tb
                                           else np.zeros(KS) for f in range(TF)])
                            de_t = np.zeros((TF, KS))
                            for ul0 in range(0, nun, UL):
                                q = np.arange(TF * UL)
                                f_q, j_q = q // UL, q % UL
                                h = np.tanh(ev[f_q] + sp[ul0 + j_q])  # (16, 32)
                                dh = np.zeros((TF * UL, KS))
                                for c0 in range(0, DC, C):
                                    # the step's staging from its lanes' loads
                                    t_v, u_v = t0 + vals // C // UL, ul0 + vals // C % UL
                                    c_v = c0 + vals % C
                                    ok = (t_v < tb) & (u_v < nu) & (c_v < D)
                                    gw = np.zeros(len(vals))
                                    gw[ok] = g[b, t_v[ok], u0 + u_v[ok], c_v[ok]]
                                    gq = gw.reshape(TF * UL, C)
                                    dh += gq @ wd[c0:c0 + C]
                                    acc[w, c0:c0 + C] += gq.T @ h
                                d = dh * (1.0 - h * h)
                                np.add.at(de_t, f_q, d)
                                np.add.at(sdp[w], ul0 + j_q, d)
                            for f in range(TF):
                                t = t0 + f
                                if t < tb:
                                    sel = kin
                                    prev = np.zeros(KS) if u0 == 0 else de[b, t, kk]
                                    de[b, t, k[sel]] = (prev + de_t[f])[sel]
                    dp[z, b, u0:u0 + nu][:, k[kin]] = sdp[:, :nu].sum(0)[:, kin]
                # zeros outside the lattice; the warps' sums of dWd in order
                if z == 0:
                    de[b, (tb if ub > 0 else 0):, k[kin]] = 0.0
                dp[z, b, ub:, k[kin]] = 0.0
                dwd[z, b, k[kin]] = acc.sum(0)[:D].T[kin]
    return de, dp, dwd


@pytest.mark.parametrize("D", [9, 13, 33])
@pytest.mark.parametrize("case", ["fused_like", "chunk_edges", "T1_U1", "zero_labels_inside",
                                  "zero_frames", "no_lengths"])
def test_many_grad_replay_writes_every_entry(case, D):
    T, U, il, ll = CASES[case]
    Tb, Ub = _lengths(T, U, il, ll)
    B, H = len(Tb), 33  # two column slices, the second with one live lane
    rng = np.random.default_rng(D)
    e = rng.standard_normal((B, T, H)) * 0.5
    p = rng.standard_normal((B, U, H)) * 0.5
    Wd = rng.standard_normal((H, D))
    g = rng.standard_normal((B, T, U, D)) * _valid(T, U, Tb, Ub)[..., None]
    de, dp, dwd = _many_grad_replay(e, p, Wd, g, Tb, Ub)
    assert not (np.isnan(de).any() or np.isnan(dp).any() or np.isnan(dwd).any())
    h = np.tanh(e[:, :, None, :] + p[:, None, :, :])  # (B, T, U, H)
    d = (g @ Wd.T) * (1.0 - h * h) * _valid(T, U, Tb, Ub)[..., None]
    np.testing.assert_allclose(de, d.sum(2), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dp.sum(0), d.sum(1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dwd.sum((0, 1)), np.einsum("btuh,btud->hd", h, g),
                               rtol=1e-12, atol=1e-12)


def test_many_shared_memory_and_scratch():
    """Below the largest D whose warps' sums fit a block, the scratch is the
    by-value one; past it the sums' slots are added and shared memory holds
    only the staged g_dur; every launch fits a block."""
    last = max(D for D in range(9, 2000) if not J.dur_many_smem(D)[2])
    assert 300 < last < 400
    for D in list(range(9, 40)) + [last, last + 1, 1000]:
        static, dyn, in_device = J.dur_many_smem(D)
        assert static <= 48 * 1024 and static + dyn <= SMEM_BYTES, D
        assert in_device == (D > last), D
        for B, T, U, H in ((3, 9, 5, 200), (64, 150, 21, 256), (4, 7, 300, 2048)):
            by_value = J.DUR_GRAD_SPLITS * B * H * (U + D)
            slots = J.DUR_GRAD_SPLITS * B * -(-H // J.DUR_GRAD_KS) * J.DUR_GRAD_WARPS \
                * J.dur_many_width(D) * J.DUR_GRAD_KS
            assert J.dur_part_floats(B, T, U, H, D) == by_value + (slots if in_device else 0)
