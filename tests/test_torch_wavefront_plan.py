"""The schedule of the lattice kernel (csrc/wavefront.cu), pure Python, on
the CPU.

The kernel plans its launch itself; ``ops/cuda/wavefront.py::plan`` mirrors
that plan (a card test holds it against the C entry). Here:

* the plan: bands (warps) a lattice, lattices a block, shared memory, and
  the switch to the block kernel above the cap (f32 U > 512, f64 U > 352)
  or for 32-bit offsets;
* a numpy emulation of the band kernel over that plan: bands of 32 lanes
  stepping through the diagonals together; rows of lpb and lpe copied into
  each band's input ring AHEAD diagonals before lane 0 needs them, with the
  kernel's predicates; results parked in the output ring and written out a
  row at a time; one shuffle a diagonal (``__shfl_up_sync`` for alpha,
  ``__shfl_down_sync`` for beta) and the edge words the bands trade, double
  buffered; each lattice stopping at its own N_b = T_b + U_b - 1 and the
  bands beyond U_b not walking; then the NEG fill of the cells outside
  (t < T_b) & (u < U_b). Every ring read is checked to find the row it
  wants, copied at least AHEAD steps before (the kernel's
  cp.async.wait_group); every cell must be written exactly once; the result
  must equal the plain ``ops/lattice.forward_backward`` and the JAX
  package's ``ops/lattice.forward_backward`` on ragged shapes that reach
  every edge: T_b = 1, U_b = 1, U_b = U, U at 31/32/33, 320/321 and the cap
  ± 1.

This is the only check of the kernel's index arithmetic where no card is
present. Tolerances: f64 (the kernel's f64 path computes the same log-sum-exp
as ``wtt::lse``), 1e-12 against the plain version, 1e-10 against JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import lattice as JL
from warp_transducer_tpu_torch.ops import lattice as TL
from warp_transducer_tpu_torch.ops import prep as TP
from warp_transducer_tpu_torch.ops.cuda import wavefront as W

NEG = -1.0e30
N_SM = 132  # an H100's SMs
K, R = W.AHEAD, W.RING
RESULT = 10 ** 7  # the tag of a result word in the lpb ring


def _lse(a, b):
    m = np.maximum(a, b)
    with np.errstate(invalid="ignore", over="ignore"):
        return m + np.log1p(np.exp(-np.abs(a - b)))


def _extent(Tb, Ub, T, U):
    Tv, Uv = min(max(Tb, 0), T), min(max(Ub, 0), U)
    steps = Tv + Uv - 1 if Tv > 0 and Uv > 0 else 0
    return Tv, Uv, steps, 1 <= Tb <= T and 1 <= Ub <= U


class _Ring:
    """A band's ring of rows in shared memory, [band, slot, lane], with the
    row and the step of each word's copy, to check every read."""

    def __init__(self, bands, rows):
        self.rows = rows
        self.value = np.full((bands, rows, W.WARP), np.nan)
        self.row = np.full((bands, rows, W.WARP), -10 ** 9)
        self.step = np.zeros((bands, rows, W.WARP), np.int64)

    def write(self, r, values, mask, step, tag=0):
        """Lane (band, l) writes its word of row r[band, l] where mask, the
        word tagged r + tag (tag RESULT: the cell's result)."""
        r = np.broadcast_to(r, mask.shape)
        band, lane = np.nonzero(mask)
        slot = r[band, lane] % self.rows
        self.value[band, slot, lane] = values[band, lane]
        self.row[band, slot, lane] = r[band, lane] + tag
        self.step[band, slot, lane] = step

    def read(self, r, need, step=None, ahead=0, tag=0):
        """Lane (band, l) reads its word of row r[band, l]; where ``need``,
        it must hold that row (tagged r + tag), copied ``ahead`` steps before
        ``step`` (the walk's direction is in the sign of ``ahead``)."""
        band, lane = np.indices(r.shape)
        slot = r % self.rows
        got = self.value[band, slot, lane]
        assert np.all(self.row[band, slot, lane][need] == r[need] + tag), \
            "a ring read the wrong row"
        if step is not None:
            age = (step - self.step[band, slot, lane]) * np.sign(ahead)
            assert np.all(age[need] >= abs(ahead)), "a row read before its copy completed"
        return np.where(need, got, np.nan)


def _walk(pb, pe, T, U, Tb, Ub, is_beta):
    """One lattice as the band kernel walks it: (field, ll)."""
    Tv, Uv, steps, terminal = _extent(Tb, Ub, T, U)
    bands_all = -(-U // W.WARP)
    bands = -(-Uv // W.WARP)  # the bands that walk
    c0 = np.arange(bands)[:, None] * W.WARP
    lane = np.arange(W.WARP)[None, :]
    u = c0 + lane  # (bands, 32)
    out = np.full(T * U, np.nan)
    writes = np.zeros(T * U, np.int64)
    clamp = lambda x: np.maximum(x, NEG)  # noqa: E731

    def store(cells, values, mask):
        np.add.at(writes, cells[mask], 1)
        out[cells[mask]] = values[mask]

    def fill():
        for b in range(bands_all):
            cu = b * W.WARP + np.arange(W.WARP)
            cu = cu[cu < U]
            full = min(b * W.WARP + W.WARP, U) <= Uv
            for t in range(Tv if full else 0, T):
                m = (t >= Tv) | (cu >= Uv)
                store(t * U + cu, np.full(len(cu), NEG), m)

    ll = NEG
    if bands and steps:
        ring_b, ring_e = _Ring(bands, R), _Ring(bands, R)  # ring_b: lpb, then results
        edge = np.full((2, bands), np.nan)
        if not is_beta:
            def copy(r, step):  # lpe of row r at column u-1, lpb of row r-1 at column u
                r = np.broadcast_to(r, (bands,))[:, None] + 0 * lane
                me = (r >= 0) & (r < Tv) & (u >= 1) & (u - 1 < Uv)
                mb = (r >= 1) & (r - 1 < Tv) & (u < Uv)
                rc, uc = np.clip(r, 0, T - 1), np.clip(u, 0, U - 1)
                ring_e.write(r, pe[rc, np.clip(u - 1, 0, U - 1)], me, step)
                ring_b.write(r, pb[np.clip(r - 1, 0, T - 1), uc], mb, step)

            a = np.where(u == 0, 0.0, NEG)
            for r in range(0, K + 1):  # band 0's prime; the others' rows are < 0
                copy(np.where(c0[:, 0] == 0, r, -1), -10 ** 6)
            ring_b.write(0, a, u == 0, 0, RESULT)
            edge[0] = a[:, -1]
            for n in range(1, steps):
                t = n - u
                valid = (t >= 0) & (t < Tv) & (u < Uv)
                # read at the end of the step before, after its copy
                lpb_v = ring_b.read(t, valid & (t >= 1), n, K)
                lpe_v = ring_e.read(t, valid & (u >= 1), n, K)
                ro = (n - c0[:, 0] - W.WARP)[:, None] + 0 * lane  # complete a step ago
                m = (ro >= 0) & (ro < Tv) & (u < Uv)
                done = ring_b.read(ro, m, tag=RESULT)
                left = np.concatenate([np.full((bands, 1), np.nan), a[:, :-1]], axis=1)
                left[:, 0] = np.concatenate([[NEG], edge[(n - 1) & 1, :-1]])
                no_emit = np.where(t >= 1, a + clamp(lpb_v), NEG)
                emit = np.where(u >= 1, left + clamp(lpe_v), NEG)
                x = _lse(no_emit, emit)
                copy(n + K - c0[:, 0], n)
                a = np.where(valid, x, NEG)
                ring_b.write(t, x, np.ones_like(valid), n, RESULT)  # over the lpb it used
                store(ro * U + u, done, m)
                edge[n & 1] = a[:, -1]
            for b in range(bands):  # the rows completed at the last diagonals
                for r in range(max(steps - b * W.WARP - W.WARP, 0), Tv):
                    need = np.zeros((bands, W.WARP), bool)
                    need[b] = u[b] < Uv
                    got = ring_b.read(np.full((bands, W.WARP), r), need, tag=RESULT)
                    store(r * U + u[b], got[b], need[b])
            if terminal:
                ll = a.reshape(-1)[Uv - 1] + clamp(pb[Tv - 1, Uv - 1])
        else:
            def copy(r, step):
                r = np.broadcast_to(r, (bands,))[:, None] + 0 * lane
                m = (r >= 0) & (r < Tv) & (u < Uv)
                rc, uc = np.clip(r, 0, T - 1), np.clip(u, 0, U - 1)
                ring_b.write(r, pb[rc, uc], m, step)
                ring_e.write(r, pe[rc, uc], m, step)

            bv = np.full((bands, W.WARP), NEG)
            first = steps - 1
            if terminal:
                seed = clamp(pb[Tv - 1, Uv - 1])
                bv.reshape(-1)[Uv - 1] = seed
                first -= 1
            top = first - c0[:, 0] - (W.WARP - 1) - K
            for d in range(1, W.WARP + K):
                copy(top + d, 10 ** 6)
            if terminal:  # after the prime's copies have landed
                ring_b.write(Tv - 1, bv, u == Uv - 1, first, RESULT)
            edge[(first + 1) & 1] = bv[:, 0]
            for n in range(first, -1, -1):
                t = n - u
                valid = (t >= 0) & (t < Tv) & (u < Uv)
                # read at the end of the step before, after its copy
                lpb_v = ring_b.read(t, valid, n, -K)
                lpe_v = ring_e.read(t, valid & (u + 1 < U), n, -K)
                ro = (n - c0[:, 0] + 1)[:, None] + 0 * lane  # complete a step ago
                m = (ro >= 0) & (ro < Tv) & (u < Uv)
                done = ring_b.read(ro, m, tag=RESULT)
                right = np.concatenate([bv[:, 1:], np.full((bands, 1), np.nan)], axis=1)
                right[:, -1] = np.concatenate([edge[(n + 1) & 1, 1:], [NEG]])
                no_emit = np.where(t + 1 < T, bv + clamp(lpb_v), NEG)
                emit = np.where(u + 1 < U, right + clamp(lpe_v), NEG)
                x = _lse(no_emit, emit)
                copy(n - c0[:, 0] - (W.WARP - 1) - K, n)
                bv = np.where(valid, x, NEG)
                ring_b.write(t, x, np.ones_like(valid), n, RESULT)
                store(ro * U + u, done, m)
                edge[n & 1] = bv[:, 0]
            # band 0's row 0, complete at the last diagonal
            m = (u == np.arange(W.WARP)[None, :]) & (u < Uv) & (Tv > 0) & (c0 == 0)
            store(0 * u + u, ring_b.read(np.zeros_like(u), m, tag=RESULT), m)
            ll = bv[0, 0]
    fill()
    assert np.all(writes == 1), "a cell written other than once"
    return out.reshape(T, U), ll


def emulate(lpb, lpe, il, ll, compute_betas=True, elt=8):
    """(alphas, betas, ll_forward, ll_backward) of the band kernel's plan for
    ``elt``-byte values, computed in float64 numpy."""
    B, T, U = lpb.shape
    p = W.plan(B, T, U, elt, compute_betas, N_SM)
    assert p.band_mode
    out = {"alphas": [], "betas": [], "ll_forward": [], "ll_backward": []}
    for b in range(B):
        for is_beta in ((False, True) if compute_betas else (False,)):
            field, llv = _walk(lpb[b].astype(np.float64), lpe[b].astype(np.float64), T, U,
                               int(il[b]), int(ll[b]) + 1, is_beta)
            out["betas" if is_beta else "alphas"].append(field)
            out["ll_backward" if is_beta else "ll_forward"].append(llv)
    return {k: np.array(v) for k, v in out.items() if v}


# B, T, U, input lengths, label lengths (U_b = label length + 1), element bytes.
CASES = {
    "U31": (4, 5, 31, [5, 1, 3, 4], [30, 0, 29, 12], 8),
    "U32": (3, 4, 32, [4, 2, 4], [31, 31, 0], 8),
    "U33": (3, 4, 33, [4, 3, 1], [32, 5, 32], 8),
    "U320": (2, 3, 320, [3, 2], [319, 200], 4),
    "U321": (3, 3, 321, [3, 1, 3], [320, 320, 160], 4),
    "f32_cap": (2, 3, 512, [3, 2], [511, 100], 4),
    "f64_cap": (2, 3, 256, [3, 3], [255, 254], 8),
    "T1_U1": (3, 6, 5, [1, 6, 1], [0, 4, 2], 8),
    "long_t": (3, 40, 3, [40, 17, 1], [2, 0, 1], 8),
    "headline_like": (5, 12, 41, [12, 6, 9, 12, 7], [40, 20, 33, 25, 40], 4),
}


def _inputs(B, T, U, il, ll, seed):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, U, 6)) * 2.0, dtype=torch.float64)
    labels = torch.tensor(rng.integers(1, 6, (B, max(U - 1, 1))), dtype=torch.int32)
    p = TP.prepare(acts, labels, 0, False)
    lpb, lpe = p.lpb.numpy().copy(), p.lpe.numpy().copy()
    lpb[0, 0, U - 1] = -1e35  # below NEG: the clamp
    return lpb, lpe, np.asarray(il, np.int32), np.asarray(ll, np.int32)


def _valid(T, U, il, ll):
    t, u = np.arange(T)[None, :, None], np.arange(U)[None, None, :]
    return (t < il[:, None, None]) & (u < ll[:, None, None] + 1)


@pytest.mark.parametrize("betas", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain_and_jax(case, betas):
    B, T, U, il, ll, elt = CASES[case]
    lpb, lpe, il, ll = _inputs(B, T, U, il, ll, seed=len(case))
    plan = W.plan(B, T, U, elt, betas, N_SM)
    assert plan.band_mode and plan.bands * W.WARP >= U
    got = emulate(lpb, lpe, il, ll, betas, elt)
    want = TL.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(il),
                               torch.tensor(ll), compute_betas=betas)
    names = ("alphas", "betas") if betas else ("alphas",)
    for name in names:  # every cell, NEG outside the lattice in both
        np.testing.assert_allclose(got[name], getattr(want, name).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    lls = ("ll_forward", "ll_backward") if betas else ("ll_forward",)
    for name in lls:
        np.testing.assert_allclose(got[name], getattr(want, name).numpy(), rtol=1e-12,
                                   err_msg=name)
    # The XLA engine does not clamp its inputs (the Pallas kernels and the
    # port do): it gets them clamped.
    ref = JL.forward_backward(jnp.asarray(np.maximum(lpb, NEG)), jnp.asarray(np.maximum(lpe, NEG)),
                              jnp.asarray(il), jnp.asarray(ll), compute_betas=betas)
    mask = _valid(T, U, il, ll)
    for name in names:
        np.testing.assert_allclose(got[name][mask], np.asarray(getattr(ref, name))[mask],
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(got["ll_forward"], np.asarray(ref.ll_forward), rtol=1e-10)


@pytest.mark.parametrize("elt,cap", [(4, 512), (8, 352)])
def test_switch_to_block_kernel_above_the_cap(elt, cap):
    for U in (1, 31, 32, 33, cap - 1, cap):
        p = W.plan(16, 1500, U, elt, True, N_SM)
        assert p.band_mode and p.bands == -(-U // W.WARP) <= W.max_bands(elt)
        assert p.smem + W.EDGE_BYTES <= W.SMEM_BYTES and p.threads <= 1024
    for U in (cap + 1, 1100, 14000):
        p = W.plan(16, 1500, U, elt, True, N_SM)
        assert not p.band_mode and p.blocks == 32 and p.per_block == 1
        assert p.threads == min(1024, -(-U // W.WARP) * W.WARP) and p.smem == 2 * U * elt


def test_switch_to_block_kernel_beyond_32_bit_offsets():
    """The band kernel indexes a lattice with 32-bit offsets: (T + U + 2·RING)·U
    must stay below 2^31."""
    U = 300
    T_max = W.MAX_OFFSET // U - U - 2 * R
    assert W.plan(4, T_max, U, 4, True, N_SM).band_mode
    assert not W.plan(4, T_max + 1, U, 4, True, N_SM).band_mode


@pytest.mark.parametrize("elt,bands,per_warp", [(4, 16, 10240), (8, 11, 20480)])
def test_rings_fit_a_block(elt, bands, per_warp):
    assert W.band_bytes(elt) == per_warp and W.max_bands(elt) == bands
    assert bands * per_warp + W.EDGE_BYTES <= W.SMEM_BYTES
    # the input ring outlives a row: copied AHEAD steps before lane 0's use,
    # overwritten RING steps after its copy, after lane 31's use
    assert R - K > W.WARP - 1


@pytest.mark.parametrize("B,U,betas,per_block", [
    (128, 41, True, 2), (128, 41, False, 1), (32, 21, True, 1), (16, 301, True, 1),
    (1, 5, False, 1), (200, 41, True, 4), (1000, 21, True, 4), (1000, 301, True, 1),
    (1000, 200, True, 2), (67, 33, True, 2), (128, 301, True, 1)])
def test_lattices_a_block(B, U, betas, per_block):
    p = W.plan(B, 150, U, 4, betas, N_SM)
    lattices = B * (2 if betas else 1)
    assert p.per_block == per_block and p.threads == W.WARP * p.bands * per_block
    assert p.blocks == -(-lattices // per_block)
    assert (p.blocks - 1) * p.per_block < lattices <= p.blocks * p.per_block
    assert p.threads <= 1024 and p.smem + W.EDGE_BYTES <= W.SMEM_BYTES
    assert p.per_block <= W.MAX_LATTICES_PER_BLOCK  # one named barrier each, ids 1..4


def test_walk_stops_at_each_utterances_length():
    """A lattice's walk takes N_b diagonals (alpha N_b - 1 after its seed),
    not T + U - 1."""
    T, U = 9, 7
    for Tb, Ub in ((9, 7), (4, 7), (9, 2), (1, 1), (0, 3), (12, 9)):
        Tv, Uv, steps, terminal = _extent(Tb, Ub, T, U)
        assert steps == (Tv + Uv - 1 if Tv else 0)
        assert terminal == (1 <= Tb <= T and 1 <= Ub <= U)
