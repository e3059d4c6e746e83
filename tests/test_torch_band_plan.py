"""The schedule of the band lattice kernel (csrc/band_stream.cu), pure
Python, on the CPU.

The kernel plans its launch itself; ``ops/cuda/band.py::plan`` mirrors that
plan (a card test holds it against the C entry). Here:

* the plan: tile rows, ring slots, copy distance, the block of two warps
  (alpha and beta of one utterance), shared memory, and the switch to the
  cells walk above S = 32 or past 32-bit offsets; the cells walk's warps,
  cells, chunks, offsets and where its rows lie;
* a numpy emulation of the row walk over that plan, lane by lane: tiles of
  TILE_ROWS rows of lpb, lpe and ranges copied into a ring of SLOTS tiles,
  AHEAD_TILES tiles ahead (the kernel's copy_words: 16-byte chunks where
  both sides are aligned, words at the edges, a tile keeping its address
  modulo 16 bytes in shared memory), one commit group a tile and the
  kernel's cp.async.wait_group; each row step's reads, a step ahead, of
  the next row's lpb, the range after it and the lpe three rows ahead
  (beta: the rows below); the exclusive prefix c by a shifted Hillis–Steele
  scan; the chain in natural units and the plain version's order of adds
  (alpha: the scan's levels from the second, α = c + z, + lpb, two shuffles
  by δ of cells s and s - 1, NEG outside the band, - c, and their
  log-sum-exp, the next row's first scan level; beta the mirror: β = z - c,
  cells s and s + 1, + lpb, + c); results parked over the consumed lpb
  words and written out a tile behind, the rows beyond T_b filled with
  NEG. Every ring read that a result depends on is
  checked to find the word it wants (its array, row and cell, not yet
  overwritten), copied in a group that the last wait covered, and (beyond
  the first AHEAD_TILES tiles, copied before the walk starts) at least
  (AHEAD_TILES - 1)·TILE_ROWS - 2 row steps after the copy was issued;
  every cell must be written exactly once; each lattice must take exactly
  its T_b row steps.
* The emulation must equal the plain ``ops/band.py::forward_backward`` and
  the JAX package's ``ops/pruned.py::_band_lattice`` on ragged shapes that
  reach every edge: T_b = 1 (and 0), U_b = 1, an infeasible band, δ = 0 and
  δ = S - 1 steps, T not a multiple of the tile, several laps of the ring,
  S = 1, 2, 5, 31 and 32. One small case also equals the Pallas kernel
  ``pallas/band_stream.py::band_forward_backward`` in interpret mode.
* a numpy emulation of the cells walk (S > 32): G warps, lane l of warp g
  holding C cells from g·32·C + l·C, a row in chunks of 32·G·C; each step's
  inputs loaded two steps ahead; the chain's prefix within each warp's
  frame; the no-emit terms read from the two rows at s ± δ, each read
  checked to find the row it wants written before the last sync and no
  word overwritten before the sync after its read; the (max, sum) pair
  scans, the warps' exchange and the chunks' carry moved between frames by
  the chain totals; every cell written once. At S = 33, 41 (the full band
  of the headline shape), 100, 600 (two warps), 1100 (four) and 4400 (two
  chunks of 8 warps) it must equal the plain version (and, at the full
  band, the JAX package's engine).

This is the only check of the row walk's index arithmetic where no card is
present. Tolerances: the emulation computes in float64 with the plain
version's log-sum-exp (the kernel takes exp and log on the SFU; otherwise
the same arithmetic):
rtol/atol 1e-10 against the plain version and JAX in float64; the Pallas
kernel computes in f32, so against it f32 rtol/atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_programs import release_compiled_programs  # noqa: F401
from warp_transducer_tpu.ops import pruned as JPR
from warp_transducer_tpu.ops.pallas import band_stream as K4
from warp_transducer_tpu_torch.ops import band as TB
from warp_transducer_tpu_torch.ops.cuda import band as KB

NEG = -1.0e30
CLAMP = -1.0e4
WARP = KB.WARP
R, AHEAD, SLOTS = KB.TILE_ROWS, KB.AHEAD_TILES, KB.SLOTS
# A tile copied during the walk is first read this many row steps later at
# least: AHEAD_TILES·TILE_ROWS - 3 where the tiles walked in between are full,
# (AHEAD_TILES - 1)·TILE_ROWS - 2 where beta's first tile holds one row.
MIN_AGE = (AHEAD - 1) * R - 2
LANE = np.arange(WARP)
F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-5, atol=1e-5)
LPB, LPE, RNG, RES = 1, 2, 3, 4  # what a ring word holds: inputs, or a parked result


def _lse(a, b):
    with np.errstate(invalid="ignore", over="ignore"):
        return np.maximum(a, b) + np.log1p(np.exp(-np.abs(a - b)))


def _shfl(x, src):
    return x[np.asarray(src) & (WARP - 1)]


def _shfl_up(x, k):
    return np.where(LANE >= k, x[np.maximum(LANE - k, 0)], x)


def _shfl_down(x, k):
    return np.where(LANE + k < WARP, x[np.minimum(LANE + k, WARP - 1)], x)


def _steps(S):
    return max(0, (S - 1).bit_length())


def _excl_sum(x, L2):
    with np.errstate(invalid="ignore"):
        for i in range(L2):
            x = np.where(LANE >= 1 << i, x + _shfl_up(x, 1 << i), x)
    return np.where(LANE == 0, 0.0, _shfl_up(x, 1))


def _chunks(dst, src, n):
    """copy_words / store_words of the kernel: the words [0, head) and
    [head + body, n) one at a time, [head, head + body) in 16-byte chunks;
    ``dst``, ``src``: the word addresses of the two sides' starts."""
    head = min(n, -src % 4)
    if (dst + head) % 4:
        head = n
    body = max(n - head, 0) // 4 * 4
    for i in range(head, head + body, 4):  # both sides of every chunk 16-byte aligned
        assert (dst + i) % 4 == 0 and (src + i) % 4 == 0
    return head, body


class _Lattice:
    """One lattice's ring and counters, as a warp of the row walk holds them."""

    def __init__(self, S, T, Tb, g_in, g_rng, g_out):
        self.S, self.T, self.Tb, self.Tw = S, T, Tb, min(max(Tb, 0), T)
        self.aw = KB.arr_words(R * S)
        n = KB.lattice_words(S)
        self.value = np.full(n, np.nan)
        self.tag = np.zeros((n, 3), np.int64)  # kind, row, cell
        self.group = np.full(n, 10 ** 9)
        self.issued = np.full(n, 10 ** 9)
        self.g_in, self.g_rng, self.g_out = g_in, g_rng, g_out  # global word offsets
        self.shb = self.she = g_in % 4
        self.shr = g_rng % 4
        self.step = 0  # row steps taken
        self.groups = 0  # commit groups
        self.landed = 0  # groups the last wait covered

    def word(self, kind, t, s=0):
        base = (t // R % SLOTS) * KB.slot_words(self.S)
        if kind in (LPB, RES):
            w = base + self.shb + (t % R) * self.S + s
        elif kind == LPE:
            w = base + self.aw + self.she + (t % R) * self.S + s
        else:
            w = base + 2 * self.aw + self.shr + t % R
        assert np.all((0 <= w) & (w < len(self.value)))
        return w

    def rows(self, tile):
        return min(R, self.Tw - tile * R)

    def copy_tile(self, tile, lpb, lpe, ranges, before_walk=False):
        """Copy a tile; ``before_walk``: one of the first AHEAD_TILES, which
        the walk waits for before its first row."""
        t0, n = tile * R, self.rows(tile)
        if n <= 0:
            return
        for kind, src, g in ((LPB, lpb, self.g_in), (LPE, lpe, self.g_in),
                             (RNG, ranges, self.g_rng)):
            width = 1 if kind == RNG else self.S
            dst = self.word(kind, t0)
            _chunks(dst, g + t0 * width, n * width)
            flat = np.asarray(src[t0:t0 + n], np.float64).reshape(-1)
            w = dst + np.arange(n * width)
            self.value[w] = flat
            self.tag[w] = np.stack([np.full(n * width, kind), t0 + np.arange(n * width) // width,
                                    np.arange(n * width) % width], axis=1)
            self.group[w] = self.groups + 1  # the group of the next commit
            self.issued[w] = -10 ** 9 if before_walk else self.step

    def commit(self):
        self.groups += 1

    def wait(self):  # cp.async.wait_group AHEAD - 1
        self.landed = self.groups - (AHEAD - 1)

    def range(self, t, need):
        """Row t's range, read by every lane; where not ``need``, whatever the
        word holds (0 for a word never written)."""
        r = self.read(RNG, t, 0, np.full(WARP, need))[0]
        return int(r) if np.isfinite(r) else 0

    def read(self, kind, t, s, need):
        """Lanes' reads of row t (cells s, or its range); where ``need``, the
        word must hold that input, landed, copied MIN_AGE row steps ago."""
        w = self.word(kind, t, s)
        w = np.broadcast_to(w, need.shape)
        want = np.stack(np.broadcast_arrays(kind, t, 0 if kind == RNG else s), axis=-1)
        want = np.broadcast_to(want, need.shape + (3,))
        assert np.all(self.tag[w][need] == want[need]), f"a ring read missed {kind} row {t}"
        assert np.all(self.group[w][need] <= self.landed), "a ring read before its wait"
        assert np.all(self.step - self.issued[w][need] >= MIN_AGE), "a row copied too late"
        return self.value[w]

    def park(self, t, values, cells):
        w = self.word(RES, t, LANE)[cells]
        self.value[w] = values[cells]
        self.tag[w] = np.stack([np.full(len(w), RES), np.full(len(w), t), LANE[cells]], axis=1)

    def write_tile(self, tile, out, writes):
        t0, n = tile * R, self.rows(tile)
        S = self.S
        src = self.word(RES, t0)
        _chunks(self.g_out + t0 * S, src, n * S)
        w = src + np.arange(n * S)
        rows, cells = t0 + np.arange(n * S) // S, np.arange(n * S) % S
        assert np.all(self.tag[w] == np.stack([np.full(n * S, RES), rows, cells], axis=1)), \
            "a tile written out before its rows were walked"
        out[rows, cells] = self.value[w]
        writes[rows, cells] += 1

    def fill(self, out, writes):
        _chunks(self.g_out + self.Tw * self.S, 0, (self.T - self.Tw) * self.S)
        out[self.Tw:] = NEG
        writes[self.Tw:] += 1


def _scan_up(y, first, L2):
    for i in range(first, L2):
        y = np.where(LANE >= 1 << i, _lse(y, _shfl_up(y, 1 << i)), y)
    return y


def _scan_down(y, first, L2, S):
    for i in range(first, L2):
        y = np.where(LANE + (1 << i) < S, _lse(y, _shfl_down(y, 1 << i)), y)
    return y


def _clamped_prefix(e, cell, L2):
    return _excl_sum(np.where(cell, np.maximum(e, CLAMP), 0.0), L2)


def _alpha(lat, lpb, lpe, ranges, Ub):
    S, Tw, L2 = lat.S, lat.Tw, _steps(lat.S)
    sc, cell = np.minimum(LANE, S - 1), LANE < S
    out = np.full((lat.T, S), np.nan)
    writes = np.zeros((lat.T, S), np.int64)
    tiles = -(-Tw // R)
    for tile in range(AHEAD):
        lat.copy_tile(tile, lpb, lpe, ranges, before_walk=True)
        lat.commit()
    y = c0 = c1 = b = e2 = np.zeros(WARP)
    r0 = r1 = r_last = 0
    a_last, b_last = np.full(WARP, NEG), np.zeros(WARP)
    for k in range(tiles):
        if k > 0:
            lat.write_tile(k - 1, out, writes)
        if k + AHEAD < tiles:
            lat.copy_tile(k + AHEAD, lpb, lpe, ranges)
        lat.commit()
        lat.wait()
        if k == 0:  # row 0's inputs and first scan level
            r0, r1 = lat.range(0, True), lat.range(1, Tw > 1)
            c0 = _clamped_prefix(lat.read(LPE, 0, sc, cell), cell, L2)
            c1 = _clamped_prefix(lat.read(LPE, 1, sc, cell & (Tw > 1)), cell, L2)
            b = lat.read(LPB, 0, sc, cell)
            e2 = lat.read(LPE, 2, sc, cell & (Tw > 2))
            y = _scan_up(np.where(LANE == 0, 0.0, NEG) - c0, 0, min(L2, 1))
        for t in range(k * R, k * R + lat.rows(k)):
            c1m = _shfl_up(c1, 1)
            bc = np.maximum(b, NEG)
            d1 = r1 - r0
            a = c0 + _scan_up(y, 1, L2)  # the chain
            p = a + bc
            n0, n1 = _shfl(p, LANE + d1), _shfl(p, LANE + d1 - 1)
            a = np.where(r0 + LANE < Ub, a, NEG)
            lat.park(t, a, cell)
            a_last, b_last, r_last = a, bc, r0
            c2 = _clamped_prefix(e2, cell, L2)
            # the next step's inputs, read in this one
            b = lat.read(LPB, t + 1, sc, cell & (t + 1 < Tw))
            r2 = lat.range(t + 2, t + 2 < Tw)
            e2 = lat.read(LPE, t + 3, sc, cell & (t + 3 < Tw))
            with np.errstate(invalid="ignore"):
                y = np.where(LANE + d1 < S, n0, NEG) - c1
                if L2 > 0:
                    y = _lse(y, np.where((LANE >= 1) & (LANE + d1 - 1 < S), n1, NEG) - c1m)
            c0, c1, r0, r1 = c1, c2, r1, r2
            lat.step += 1
    if tiles:
        lat.write_tile(tiles - 1, out, writes)
    lat.fill(out, writes)
    s_star = Ub - 1 - r_last
    feasible = Tw > 0 and lat.Tb == Tw and 0 <= s_star < S
    ll = (a_last + b_last)[s_star & (WARP - 1)] if feasible else NEG
    assert lat.step == Tw and np.all(writes == 1), "a cell written other than once"
    return out, ll


def _beta(lat, lpb, lpe, ranges, Ub):
    S, Tw, L2 = lat.S, lat.Tw, _steps(lat.S)
    sc, cell = np.minimum(LANE, S - 1), LANE < S
    out = np.full((lat.T, S), np.nan)
    writes = np.zeros((lat.T, S), np.int64)
    tiles = -(-Tw // R)
    top = tiles - 1
    for tile in range(top, top - AHEAD, -1):
        if tile >= 0:
            lat.copy_tile(tile, lpb, lpe, ranges, before_walk=True)
        lat.commit()
    y, c0, c1, b1, e2 = np.zeros((5, WARP))
    r0 = r1 = 0
    b00 = NEG
    for k in range(top, -1, -1):
        if k < top:
            lat.write_tile(k + 1, out, writes)
        if k - AHEAD >= 0:
            lat.copy_tile(k - AHEAD, lpb, lpe, ranges)
        lat.commit()
        lat.wait()
        t_top = k * R + lat.rows(k) - 1
        if k == top:  # row Tw-1's inputs, the seed, its first scan level
            r0, r1 = lat.range(t_top, True), lat.range(max(t_top - 1, 0), t_top >= 1)
            c0 = _clamped_prefix(lat.read(LPE, t_top, sc, cell), cell, L2)
            c1 = _clamped_prefix(lat.read(LPE, max(t_top - 1, 0), sc, cell & (t_top >= 1)),
                                 cell, L2)
            seed = (lat.Tb == Tw) & (LANE == Ub - 1 - r0)
            bt = np.maximum(lat.read(LPB, t_top, sc, cell), NEG)
            y = _scan_down(np.where(seed, bt, NEG + bt) + c0, 0, min(L2, 1), S)
            b1 = lat.read(LPB, max(t_top - 1, 0), sc, cell & (t_top >= 1))
            e2 = lat.read(LPE, max(t_top - 2, 0), sc, cell & (t_top >= 2))
        for t in range(t_top, k * R - 1, -1):
            bc1 = np.maximum(b1, NEG)
            bc1n, c1n = _shfl_down(bc1, 1), _shfl_down(c1, 1)
            d = r0 - r1
            bv = _scan_down(y, 1, L2, S) - c0  # the chain
            n0, n1 = _shfl(bv, LANE - d), _shfl(bv, LANE + 1 - d)
            bv = np.where(r0 + LANE < Ub, bv, NEG)
            lat.park(t, bv, cell)
            b00 = bv[0]
            c2 = _clamped_prefix(e2, cell, L2)
            # the next step's inputs, read in this one
            b1 = lat.read(LPB, max(t - 2, 0), sc, cell & (t >= 2))
            r2 = lat.range(max(t - 2, 0), t >= 2)
            e2 = lat.read(LPE, max(t - 3, 0), sc, cell & (t >= 3))
            with np.errstate(invalid="ignore"):
                y = (np.where(LANE - d >= 0, n0, NEG) + bc1) + c1
                if L2 > 0:
                    y1 = (np.where((LANE + 1 < S) & (LANE + 1 - d >= 0), n1, NEG) + bc1n) + c1n
                    y = _lse(y, y1)
            c0, c1, r0, r1 = c1, c2, r1, r2
            lat.step += 1
    if tiles:
        lat.write_tile(0, out, writes)
    lat.fill(out, writes)
    assert lat.step == Tw and np.all(writes == 1), "a cell written other than once"
    return out, b00


def emulate(lpb, lpe, ranges, il, ll, offsets=(0, 0, 0)):
    """(alphas, betas, ll_forward, ll_backward) of the row walk in float64;
    ``offsets``: the word offsets modulo 4 of the lpb/lpe, ranges and output
    tensors' starts (the alignment the kernel's copies see)."""
    B, T, S = lpb.shape
    p = KB.plan(B, T, S)
    assert p.row_mode and p.per_block == 2 and p.blocks == B
    g_in, g_rng, g_out = offsets
    res = {k: [] for k in ("alphas", "betas", "ll_forward", "ll_backward")}
    for b in range(B):
        args = (lpb[b], lpe[b], ranges[b], int(ll[b]) + 1)
        for walk, field, name in ((_alpha, "alphas", "ll_forward"),
                                  (_beta, "betas", "ll_backward")):
            lat = _Lattice(S, T, int(il[b]), g_in + b * T * S, g_rng + b * T, g_out + b * T * S)
            out, llv = walk(lat, *args)
            res[field].append(out)
            res[name].append(llv)
    return {k: np.array(v) for k, v in res.items()}


def _problem(seed, B, T, S, il, ll, jumps=()):
    """Band inputs in float64: lpb, lpe from the plain band prep of random
    acts and labels (lpe NEG past the labels, an lpb below NEG), and ranges
    with random steps in [0, S), steps of S - 1 at the frames ``jumps``,
    clamped to each utterance's labels."""
    rng = np.random.default_rng(seed)
    U = max(ll) + 1
    il, ll = np.asarray(il, np.int32), np.asarray(ll, np.int32)
    steps = rng.integers(0, S, (B, T))
    steps[:, list(jumps)] = S - 1
    steps[:, 0] = 0
    ranges = np.minimum(np.cumsum(steps, axis=1), np.maximum(ll[:, None] + 1 - S, 0))
    ranges = ranges.astype(np.int32)
    labels = torch.tensor(rng.integers(1, 7, (B, max(U - 1, 1))), dtype=torch.int32)
    acts = torch.tensor(rng.standard_normal((B, T, S, 7)) * 2.0, dtype=torch.float64)
    lab_row = TB.label_rows(*TB.band_labels(labels, torch.tensor(ranges), S))
    p = TB.band_prep(acts, lab_row, 0)
    lpb, lpe = p.lpb.double().numpy(), p.lpe.double().numpy()
    lpb[-1, 0, S - 1] = -1e35  # below NEG: the clamp
    return lpb, lpe, ranges, il, ll


# B, T, S, input lengths, label lengths (U_b = label length + 1), frames
# with a step of S - 1, the word offsets modulo 4 of (lpb/lpe, ranges, out).
CASES = {
    "S5_pruned": (4, 45, 5, [45, 30, 1, 17], [40, 20, 0, 5], (5, 6, 40), (0, 0, 0)),
    "S5_laps": (2, 200, 5, [200, 131], [180, 100], (3, 64, 65, 150), (1, 2, 3)),
    "S1": (3, 40, 1, [40, 1, 33], [39, 0, 20], (), (0, 0, 0)),
    "S2_infeasible": (3, 33, 2, [33, 1, 32], [32, 4, 10], (1, 2, 32), (3, 1, 2)),
    "S31": (2, 70, 31, [70, 64], [90, 40], (2, 33, 64), (2, 3, 0)),
    "S32": (3, 64, 32, [64, 63, 1], [60, 30, 31], (1, 31, 32, 63), (0, 0, 0)),
    "T1": (3, 1, 5, [1, 1, 0], [3, 0, 6], (), (1, 0, 1)),
    "T32_T33": (3, 33, 4, [32, 33, 31], [20, 25, 2], (31, 32), (0, 1, 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_matches_plain_and_jax(case):
    B, T, S, il, ll, jumps, offsets = CASES[case]
    lpb, lpe, ranges, il, ll = _problem(len(case), B, T, S, il, ll, jumps)
    d = np.diff(ranges, axis=1)
    assert np.all((d >= 0) & (d <= S - 1))
    got = emulate(lpb, lpe, ranges, il, ll, offsets)
    want = TB.forward_backward(*map(torch.tensor, (lpb, lpe, ranges, il, ll)))
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):  # every cell
        np.testing.assert_allclose(got[name], getattr(want, name).numpy(), err_msg=name, **F64)
    # The XLA engine does not clamp its inputs (the kernels and the plain
    # version do): it gets them clamped.
    ref = JPR._band_lattice(*map(jnp.asarray, (np.maximum(lpb, NEG), lpe, ranges, il, ll)),
                            implementation="xla")
    mask = TB.band_valid(torch.tensor(ranges), torch.tensor(il), torch.tensor(ll), S).numpy()
    for name in ("alphas", "betas"):
        np.testing.assert_allclose(got[name][mask], np.asarray(getattr(ref, name))[mask],
                                   err_msg=name, **F64)
    for name in ("ll_forward", "ll_backward"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)), err_msg=name, **F64)


def test_edges_are_reached():
    """The cases above hold every edge the kernel has."""
    seen = set()
    for case, (B, T, S, il, ll, jumps, offsets) in CASES.items():
        lpb, lpe, ranges, il, ll = _problem(len(case), B, T, S, il, ll, jumps)
        d = np.diff(ranges, axis=1)
        seen |= {("T_b=1", bool((il == 1).any())), ("T_b=0", bool((il == 0).any())),
                 ("U_b=1", bool((ll == 0).any())), ("delta=0", bool((d == 0).any())),
                 ("delta=S-1", bool((d == S - 1).any()) and S > 1),
                 ("T%R", T % R != 0), ("laps", T > SLOTS * R), ("unaligned", any(offsets))}
        lat = TB.forward_backward(*map(torch.tensor, (lpb, lpe, ranges, il, ll)))
        seen.add(("infeasible", bool((lat.ll_forward.numpy() <= NEG / 2).any())))
    for edge in ("T_b=1", "T_b=0", "U_b=1", "delta=0", "delta=S-1", "T%R", "laps", "unaligned",
                 "infeasible"):
        assert (edge, True) in seen, edge


def test_emulation_matches_the_pallas_kernel():
    """A small case against pallas/band_stream.py in interpret mode, set up
    as tests/test_pruned.py runs it (f32 inputs)."""
    lpb, lpe, ranges, il, ll = _problem(9, 3, 40, 5, [40, 22, 1], [30, 12, 0], (4, 33))
    lpb, lpe = lpb.astype(np.float32), lpe.astype(np.float32)
    got = emulate(lpb.astype(np.float64), lpe.astype(np.float64), ranges, il, ll)
    a, b, llf, llb = K4.band_forward_backward(*map(jnp.asarray, (lpb, lpe, ranges, il, ll)),
                                              interpret=True)
    mask = TB.band_valid(torch.tensor(ranges), torch.tensor(il), torch.tensor(ll), 5).numpy()
    for name, ref in (("alphas", a), ("betas", b)):
        np.testing.assert_allclose(got[name][mask], np.asarray(ref)[mask], err_msg=name, **F32)
    np.testing.assert_allclose(got["ll_forward"], np.asarray(llf), **F32)
    np.testing.assert_allclose(got["ll_backward"], np.asarray(llb), **F32)


@pytest.mark.parametrize("S,row_mode", [(1, True), (2, True), (5, True), (31, True), (32, True),
                                        (33, False), (41, False), (70, False)])
def test_switch_to_the_chunk_kernel_above_32(S, row_mode):
    """The row walk up to S = 32; above, the cells walk: a block per lattice,
    one warp of C = 3 (S = 33 … 96) cells a lane, its two rows and the
    warps' exchange in shared memory."""
    p = KB.plan(128, 1500, S)
    assert p.row_mode == row_mode
    if row_mode:
        assert (p.tile_rows, p.slots, p.ahead) == (R, SLOTS, AHEAD)
        assert p.per_block == 2 and p.blocks == 128 and p.threads == 2 * WARP
        assert p.smem == 2 * KB.lattice_words(S) * 4 <= KB.SMEM_BYTES
        assert (p.warps, p.cells, p.chunks) == (0, 0, 0)
    else:
        assert (p.tile_rows, p.slots, p.ahead) == (0, 0, 0)
        assert p.per_block == 1 and p.blocks == 256 and p.threads == WARP
        assert (p.warps, p.cells, p.chunks) == (1, 3, 1)
        assert p.smem == (2 * S + KB.CELL_XCH) * 4 and not p.rows_device and not p.offsets64


def test_switch_to_the_chunk_kernel_beyond_32_bit_offsets():
    """The row walk indexes a lattice with 32-bit offsets: (T + 2·TILE_ROWS)·S
    must stay below 2^31; past it the cells walk (one warp, one cell a lane)
    with 32-bit offsets while (T + 2)·S fits, else its 64-bit instance."""
    S = 5
    T_max = KB.MAX_OFFSET // S - 2 * R
    assert KB.plan(4, T_max, S).row_mode
    p = KB.plan(4, T_max + 1, S)
    assert not p.row_mode and (p.warps, p.cells, p.chunks) == (1, 1, 1) and not p.offsets64
    assert KB.plan(4, KB.MAX_OFFSET // S - 2, S).offsets64 is False
    assert KB.plan(4, KB.MAX_OFFSET // S - 1, S).offsets64 is True


@pytest.mark.parametrize("S,G,C,chunks,rows_device", [
    (33, 1, 3, 1, False), (41, 1, 3, 1, False), (100, 1, 5, 1, False), (544, 1, 17, 1, False),
    (545, 2, 9, 1, False), (600, 2, 11, 1, False), (1089, 4, 9, 1, False),
    (4352, 8, 17, 1, False), (4353, 8, 17, 2, False), (20000, 8, 17, 5, False),
    (29000, 8, 17, 7, False), (29100, 8, 17, 7, True), (100_000, 8, 17, 23, True)])
def test_cells_walk_plan(S, G, C, chunks, rows_device):
    """Warps doubled while a lane would hold more than 17 cells, up to 8;
    past 8·32·17 cells a row, chunks; the two rows in device memory past
    what a block holds. No S is refused."""
    p = KB.plan(128, 150, S)
    assert not p.row_mode and (p.warps, p.cells, p.chunks, p.rows_device) == \
        (G, C, chunks, rows_device)
    assert (chunks - 1) * WARP * G * C < S <= chunks * WARP * G * C
    assert p.threads == WARP * G and p.blocks == 256 and p.smem <= KB.SMEM_BYTES


# ---- the cells walk --------------------------------------------------------

def _join(a, b):
    """(m, s) ⊕ (m, s) as csrc/band_stream.cu::join, elementwise."""
    (am, as_), (bm, bs) = a, b
    with np.errstate(over="ignore", invalid="ignore"):
        d = am - bm
        e = np.exp(-np.abs(d))
    ge = d >= 0
    return np.where(ge, am, bm), np.where(ge, bs * e + as_, as_ * e + bs)


def _lanes_up(x, d):
    """__shfl_up_sync along the lanes of (G, 32) arrays: lane l gets lane
    l - d's value; lanes < d their own."""
    y = x.copy()
    y[:, d:] = x[:, :-d]
    return y


def _lanes_down(x, d):
    y = x.copy()
    y[:, :-d] = x[:, d:]
    return y


def _pick(c, a, b):
    return np.where(c, a[0], b[0]), np.where(c, a[1], b[1])


def _shift(p, by):
    return p[0] + by, p[1]


EMPTY = (-np.finfo(np.float64).max, 0.0)


class _Rows:
    """The lattice's two rows (w.rows): each word with the row it holds,
    the sync epoch that wrote it and the last epoch that read it; a read
    must find the row it wants written before the last sync, a write must
    not meet a read of the same epoch."""

    def __init__(self, S):
        self.value = np.full((2, S), np.nan)
        self.row = np.full((2, S), -10 ** 9)
        self.wepoch = np.full((2, S), -10 ** 9)
        self.repoch = np.full((2, S), -10 ** 9)
        self.epoch = 0

    def read(self, t, idx, mask):
        i = idx[mask]
        assert np.all(self.row[t & 1, i] == t), "a row read the wrong row"
        assert np.all(self.wepoch[t & 1, i] < self.epoch), "a row read before the sync"
        self.repoch[t & 1, i] = self.epoch
        out = np.full(mask.shape, np.nan)
        out[mask] = self.value[t & 1, i]
        return out

    def write(self, t, idx, values, mask):
        i = idx[mask]
        assert np.all(self.repoch[t & 1, i] < self.epoch), "a row overwritten before the sync"
        self.value[t & 1, i] = values[mask]
        self.row[t & 1, i] = t
        self.wepoch[t & 1, i] = self.epoch


def _warp_chain(e, s, S):
    """csrc/band_stream.cu::warp_chain on (G, 32, C): c within each warp's
    frame and each warp's total."""
    x = np.where(s < S, np.maximum(e, CLAMP), 0.0)
    C = x.shape[-1]
    c = np.zeros_like(x)
    run = np.zeros(x.shape[:2])
    for j in range(C):
        c[..., j] = run
        run = run + x[..., j]
    incl = run.copy()
    sh = 1
    while sh < WARP:
        incl = np.where(LANE >= sh, incl + _lanes_up(incl, sh), incl)
        sh *= 2
    ex = _lanes_up(incl, 1)
    ex[:, 0] = 0.0
    return c + ex[..., None], incl[:, -1]


def _cells_walk(lpb, lpe, ranges, T, S, Tb, Ub, G, C, is_beta):
    """One lattice as the G warps of the cells walk take it, C cells a lane,
    a row in chunks of 32·G·C: (field (T, S), ll)."""
    CW = WARP * G * C
    nch = -(-S // CW)
    Tw = min(max(Tb, 0), T)
    u0 = (np.arange(G)[:, None, None] * WARP * C + LANE[None, :, None] * C
          + np.arange(C)[None, None, :])
    rows = _Rows(S)
    out = np.full((T, S), np.nan)
    writes = np.zeros((T, S), int)
    neg = NEG

    def step_of(i):
        return (Tw - 1 - i // nch, nch - 1 - i % nch) if is_beta else (i // nch, i % nch)

    def load(i):  # the inputs of step i, as load_inputs reads them
        t, k = step_of(i)
        if i >= Tw * nch or not 0 <= t < Tw:
            return None
        s = k * CW + u0
        on = s < S
        sc = np.where(on, s, 0)
        return (t, k, np.where(on, lpb[t, sc], 0.0), np.where(on, lpe[t, sc], 0.0), ranges[t])

    queue = [load(0), load(1)]
    chunk = EMPTY
    r_row = delta = 0
    ll = neg
    for i in range(Tw * nch):
        t, k = step_of(i)
        got = queue.pop(0)
        queue.append(load(i + 2))  # two steps ahead
        assert got[:2] == (t, k), "a step consumed another step's inputs"
        _, _, b, e, r = got
        first = k == (nch - 1 if is_beta else 0)
        has_next = t + 1 < Tw
        if first:
            if i > 0:
                rows.epoch += 1  # lattice_sync: the last row is in w.rows
            if is_beta:
                delta = r_row - r if has_next else 0
            else:
                delta = r - r_row if t > 0 else 0
            r_row = r
            chunk = EMPTY
        s = k * CW + u0
        c, ctot = _warp_chain(e, s, S)
        if not is_beta:
            src = s + delta
            m = (t > 0) & (src < S)
            ne = np.where(m, rows.read(t - 1, np.where(m, src, 0), m), neg)
            if t == 0:
                ne = np.where(s == 0, 0.0, neg)
            p = (ne - c, np.ones_like(c))
            for j in range(1, C):
                p[0][..., j], p[1][..., j] = _join((p[0][..., j - 1], p[1][..., j - 1]),
                                                   (p[0][..., j], p[1][..., j]))
            tot = (p[0][..., -1].copy(), p[1][..., -1].copy())
            sh = 1
            while sh < WARP:
                o = (_lanes_up(tot[0], sh), _lanes_up(tot[1], sh))
                tot = _pick(LANE >= sh, _join(o, tot), tot)
                sh *= 2
            carry = [_lanes_up(tot[0], 1), _lanes_up(tot[1], 1)]
            carry[0][:, 0], carry[1][:, 0] = EMPTY
            wtot = (tot[0][:, -1], tot[1][:, -1])
            before = []
            acc = chunk
            for h in range(G):  # the exchange: frames moved by the chain totals
                before.append(acc)
                acc = _shift(_join(acc, (wtot[0][h], wtot[1][h])), ctot[h])
            chunk = acc
            bm = np.array([x[0] for x in before])[:, None]
            bs = np.array([x[1] for x in before])[:, None]
            carry = _join((bm, bs), carry)
            with np.errstate(divide="ignore"):
                jm, js = _join((carry[0][..., None], carry[1][..., None]), p)
                a = c + jm + np.log(js)
            av = np.where(r + s < Ub, a, neg)
            bc = np.maximum(b, neg)
            on = s < S
            out[t, s[on]] = av[on]
            writes[t, s[on]] += 1
            rows.write(t, np.where(on, s, 0), av + bc, on)
            hit = on & (t == Tb - 1) & (r + s == Ub - 1)
            if hit.any():
                ll = float((av + bc)[hit][0])
        else:
            src = s - delta
            m = has_next & (src >= 0) & (src < S)
            bc = np.maximum(b, neg)
            nb = np.where(m, rows.read(t + 1, np.where(m, src, 0), m), neg) + bc
            nb = np.where((t == Tb - 1) & (r + s == Ub - 1), bc, nb)
            on = s < S
            p = (np.where(on, nb + c, EMPTY[0]), np.where(on, 1.0, 0.0))
            for j in range(C - 2, -1, -1):
                p[0][..., j], p[1][..., j] = _join((p[0][..., j + 1], p[1][..., j + 1]),
                                                   (p[0][..., j], p[1][..., j]))
            tot = (p[0][..., 0].copy(), p[1][..., 0].copy())
            sh = 1
            while sh < WARP:
                o = (_lanes_down(tot[0], sh), _lanes_down(tot[1], sh))
                tot = _pick(LANE + sh < WARP, _join(o, tot), tot)
                sh *= 2
            carry = [_lanes_down(tot[0], 1), _lanes_down(tot[1], 1)]
            carry[0][:, -1], carry[1][:, -1] = EMPTY
            wtot = (tot[0][:, 0], tot[1][:, 0])
            after = [None] * G
            acc = chunk
            for h in range(G - 1, -1, -1):
                acc = _shift(acc, ctot[h])
                after[h] = acc
                acc = _join(acc, (wtot[0][h], wtot[1][h]))
            chunk = acc
            am = np.array([x[0] for x in after])[:, None]
            as_ = np.array([x[1] for x in after])[:, None]
            carry = _join((am, as_), carry)
            with np.errstate(divide="ignore"):
                jm, js = _join((carry[0][..., None], carry[1][..., None]), p)
                bv = jm + np.log(js) - c
            ov = np.where(r + s < Ub, bv, neg)
            out[t, s[on]] = ov[on]
            writes[t, s[on]] += 1
            rows.write(t, np.where(on, s, 0), ov, on)
            if t == 0 and k == 0:
                ll = float(ov[0, 0, 0])
    out[Tw:] = neg
    writes[Tw:] += 1
    assert np.all(writes == 1), "a cell written other than once"
    if not is_beta:
        s_star = Ub - 1 - r_row
        if not (Tw > 0 and Tb == Tw and 0 <= s_star < S):
            ll = neg
    return out, ll


def emulate_cells(lpb, lpe, ranges, il, ll):
    """(alphas, betas, ll_forward, ll_backward) of the cells walk's plan in
    float64."""
    B, T, S = lpb.shape
    p = KB.plan(B, T, S)
    assert not p.row_mode and p.blocks == 2 * B
    res = {k: [] for k in ("alphas", "betas", "ll_forward", "ll_backward")}
    for b in range(B):
        for is_beta, field, name in ((False, "alphas", "ll_forward"),
                                     (True, "betas", "ll_backward")):
            out, llv = _cells_walk(lpb[b], lpe[b], ranges[b], T, S, int(il[b]), int(ll[b]) + 1,
                                   p.warps, p.cells, is_beta)
            res[field].append(out)
            res[name].append(llv)
    return {k: np.array(v) for k, v in res.items()}


# The cells walk: B, T, S, input lengths, label lengths, frames with a step
# of S - 1, whether the JAX engine is compared too (its compile costs
# seconds a shape).
CELLS_CASES = {
    "S33": (3, 20, 33, [20, 1, 12], [40, 0, 20], (3, 17), False),
    "S41_full_band": (3, 12, 41, [12, 7, 12], [40, 30, 2], (), True),
    "S100": (2, 9, 100, [9, 4], [130, 60], (2, 5), False),
    "S600_two_warps": (2, 5, 600, [5, 3], [700, 640], (1, 3), False),
    "S1100_four_warps": (1, 4, 1100, [4], [1300], (2,), False),
    "S4400_two_chunks": (1, 3, 4400, [3], [4500], (1,), False),
}


@pytest.mark.parametrize("case", sorted(CELLS_CASES))
def test_cells_walk_matches_plain_and_jax(case):
    B, T, S, il, ll, jumps, with_jax = CELLS_CASES[case]
    lpb, lpe, ranges, il, ll = _problem(len(case), B, T, S, il, ll, jumps)
    p = KB.plan(B, T, S)
    assert not p.row_mode
    got = emulate_cells(lpb, lpe, ranges, il, ll)
    want = TB.forward_backward(*map(torch.tensor, (lpb, lpe, ranges, il, ll)))
    for name in ("alphas", "betas", "ll_forward", "ll_backward"):  # every cell
        np.testing.assert_allclose(got[name], getattr(want, name).numpy(), err_msg=name, **F64)
    if not with_jax:
        return
    ref = JPR._band_lattice(*map(jnp.asarray, (np.maximum(lpb, NEG), lpe, ranges, il, ll)),
                            implementation="xla")
    mask = TB.band_valid(torch.tensor(ranges), torch.tensor(il), torch.tensor(ll), S).numpy()
    for name in ("alphas", "betas"):
        np.testing.assert_allclose(got[name][mask], np.asarray(getattr(ref, name))[mask],
                                   err_msg=name, **F64)
    for name in ("ll_forward", "ll_backward"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)), err_msg=name, **F64)


def test_the_ring_covers_the_walk():
    """A slot is rewritten only after its tile was written out: the walk
    reads tiles k and k ± 1 while tile k ± AHEAD_TILES is copied, and the
    slot the copy takes is that of tile k ∓ 1, written out just before."""
    assert AHEAD >= 2 and SLOTS == AHEAD + 1 and R % 4 == 0 and R & (R - 1) == 0
    for k in range(10):
        held = {(k + j) % SLOTS for j in range(AHEAD)}  # tiles k .. k + AHEAD - 1
        assert (k + AHEAD) % SLOTS not in held and (k + AHEAD) % SLOTS == (k - 1) % SLOTS
    for S in (1, 5, 32):  # every array of a slot starts at a 16-byte boundary
        assert KB.arr_words(R * S) % 4 == 0 and KB.slot_words(S) % 4 == 0
        assert KB.arr_words(R * S) >= R * S + 3 and KB.arr_words(R) >= R + 3
