"""The schedule of the band lattice kernel (csrc/band_stream.cu), pure
Python, on the CPU.

The kernel plans its launch itself; ``ops/cuda/band.py::plan`` mirrors that
plan (a card test holds it against the C entry). Here:

* the plan: tile rows, ring slots, copy distance, the block of two warps
  (alpha and beta of one utterance), shared memory, and the switch to the
  chunk kernel above S = 32 or for 32-bit offsets;
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
  S = 1, 2, 5, 31 and 32; S = 33 takes the chunk kernel. One small case
  also equals the Pallas kernel ``pallas/band_stream.py::
  band_forward_backward`` in interpret mode.

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
    p = KB.plan(128, 1500, S)
    assert p.row_mode == row_mode
    if row_mode:
        assert (p.tile_rows, p.slots, p.ahead) == (R, SLOTS, AHEAD)
        assert p.per_block == 2 and p.blocks == 128 and p.threads == 2 * WARP
        assert p.smem == 2 * KB.lattice_words(S) * 4 <= KB.SMEM_BYTES
    else:
        assert (p.tile_rows, p.slots, p.ahead) == (0, 0, 0)
        assert p.per_block == 1 and p.blocks == 256 and p.threads == WARP
        assert p.smem == 3 * S * 4


def test_switch_to_the_chunk_kernel_beyond_32_bit_offsets():
    """The row walk indexes a lattice with 32-bit offsets: (T + 2·TILE_ROWS)·S
    must stay below 2^31."""
    S = 5
    T_max = KB.MAX_OFFSET // S - 2 * R
    assert KB.plan(4, T_max, S).row_mode
    assert not KB.plan(4, T_max + 1, S).row_mode


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
