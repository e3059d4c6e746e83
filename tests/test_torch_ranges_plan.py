"""The range kernel's plan and schedule (``csrc/ranges.cu``), replayed in
numpy on the CPU against the plain ``ops/band.py::ranges_from_posteriors``
(``posterior_peaks``, then ``band_starts``).

The kernel cannot run here, so its index loops are mirrored step for step
(``ops/cuda/ranges.py::plan`` is the launch plan; a card test holds it
against the C entry):

* the argmax: which warp and group take which frame, each lane's elements
  in its order and in chunks (the loads past the row predicated off), the
  (value, first index) pairs kept in f32 (or f64) with the
  kernel's rounding, (α + β) − ll, and the xor-shuffle combine of a group.
  It must return the first maximum for every position of planted ties,
  NaNs and rows of one repeated value, at the lane layouts the plan gives
  at U = 1, 2, 21, 31, 32, 33 and 301, and every frame whose peak counts
  must be parked once;
* the three scans: the frames walked and read for each T_b (0, 1, inside
  T, T itself and beyond it), the chunks of SCAN_STEP steps with their
  loads taken ahead (every read inside the block's shared memory), the
  kLow fill past the walked frames, the forced last frame and the held
  tail.

Exact comparisons, no tolerance: the argmax's order is total and the scans
are integer arithmetic. No JAX (the JAX function is held against the
plain one in ``tests/test_torch_pruned.py``).
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch.ops import band
from warp_transducer_tpu_torch.ops.cuda import SMEM_BYTES
from warp_transducer_tpu_torch.ops.cuda import ranges as R
import torch_threads  # noqa: F401  (one torch thread a process)

K_LOW = -(2 ** 31) // 2
U_LAYOUTS = [1, 2, 21, 31, 32, 33, 301]


def _first_max(v, i, w, j):
    """csrc/ranges.cu::first_max: (v, i) comes before (w, j)."""
    vn, wn = np.isnan(v), np.isnan(w)
    if vn:
        return (not wn) or i < j
    return (not wn) and (v > w or (v == w and i < j))


def _row_argmax(a, b, ll, G, ftype):
    """csrc/ranges.cu::row_argmax for one frame's group of G lanes: each
    lane's pair over its elements g, g + G, ..., kChunk loads at once (those
    past the row predicated off), from (-inf, g), an element taken only when
    strictly larger (or a NaN over a number); then the xor butterfly by
    first_max; every lane's final pair (all equal)."""
    U = len(a)
    kchunk = R.chunk(np.dtype(ftype).itemsize)
    pairs = []
    for g in range(G):
        best, bi = ftype(-np.inf), g
        for c0 in range(g, U, kchunk * G):
            cols = [c0 + k * G for k in range(kchunk)]
            va = [ftype(a[c]) if c < U else ftype(0) for c in cols]  # the loads
            vb = [ftype(b[c]) if c < U else ftype(0) for c in cols]
            for k, c in enumerate(cols):
                x = ftype(ftype(va[k] + vb[k]) - ftype(ll))
                if c < U and (x > best or (np.isnan(x) and not np.isnan(best))):
                    best, bi = x, c
        pairs.append((best, bi))
    o = G // 2
    while o > 0:
        nxt = []
        for g in range(G):
            (ob, oi), (mb, mi) = pairs[g ^ o], pairs[g]
            nxt.append((ob, oi) if _first_max(ob, oi, mb, mi) else (mb, mi))
        pairs = nxt
        o //= 2
    assert len({p[1] for p in pairs}) == 1  # a total order: every lane agrees
    return pairs[0][1]


def _peaks(alphas, betas, ll, n, T, U):
    """The argmax phase of one block: {frame: parked best_u} for the frames
    0 .. n-1, with every frame parked once by its group's first lane."""
    p = R.plan(T, U)
    G, per_warp, ftype = p.group, R.WARP // p.group, alphas.dtype.type
    parked = {}
    for w in range(p.warps):
        t0 = w * per_warp
        while t0 < n:
            for q in range(per_warp):  # the groups of the warp, each lane g of it
                t = min(t0 + q, n - 1)
                bi = _row_argmax(alphas[t], betas[t], ll, G, ftype)
                if t0 + q < n:
                    assert t0 + q not in parked
                    parked[t0 + q] = bi
            t0 += p.warps * per_warp
    assert sorted(parked) == list(range(n))
    return parked


class _Smem:
    """The block's shared memory, words, with every access bounds-checked."""

    def __init__(self, T, U):
        self.w = np.zeros(R.plan(T, U).smem // 4, np.int64)

    def __getitem__(self, t):
        assert 0 <= t < len(self.w), t
        return int(self.w[t])

    def __setitem__(self, t, v):
        assert 0 <= t < len(self.w), t
        assert K_LOW - 2 ** 20 < v < 2 ** 31, v  # no int32 overflow
        self.w[t] = v


def _scans(row, n, m, force, hi, step, half):
    """csrc/ranges.cu::scans over the block's shared memory."""
    K = R.SCAN_STEP

    def load(k):  # a chunk of K words, as two int4 loads
        return [row[k + j] for j in range(K)]

    def store(k, x):
        for j in range(K):
            row[k + j] = x[j]

    r, a = 0, load(0)
    for k in range(0, n, K):
        b = load(k + K)  # ahead
        x = list(a)
        for j in range(K):
            raw = min(max(x[j] - half, 0), hi)
            r = min(max(raw, r), r + step)
            x[j] = r
        store(k, x)
        a = b
    if force:
        row[n] = hi
    end = -(-m // K) * K
    for t in range(m, end):
        row[t] = K_LOW
    r, k = K_LOW, end - K
    a = load(k)
    while k >= 0:
        b = load(k - K if k >= K else 0)  # ahead, below
        x = list(a)
        for j in range(K - 1, -1, -1):
            r = max(x[j], r - step)
            x[j] = r
        store(k, x)
        a = b
        k -= K
    row[0] = 0
    r, a = 0, load(0)
    for k in range(0, m, K):
        b = load(k + K)
        x = list(a)
        for j in range(K):
            r = min(max(x[j], r), r + step)
            x[j] = r
        store(k, x)
        a = b


def _kernel(alphas, betas, ll, il, lbl, S):
    """The whole kernel, block by block: (B, T) int32 band starts."""
    B, T, U = alphas.shape
    out = np.zeros((B, T), np.int32)
    for b in range(B):
        Tb, hi = int(il[b]), max(int(lbl[b]) + 1 - S, 0)
        force = 1 <= Tb <= T
        m = 0 if Tb <= 0 else min(Tb, T)
        n = m - 1 if force else m
        row = _Smem(T, U)
        for t, bi in _peaks(alphas[b], betas[b], ll[b], n, T, U).items():
            row[t] = bi
        if m > 0:
            _scans(row, n, m, force, hi, S - 1, (S - 1) // 2)
        held = row[m - 1] if m > 0 else 0
        out[b] = [row[t] if t < m else held for t in range(T)]
    return out


def _plain(alphas, betas, ll, il, lbl, S):
    return band.ranges_from_posteriors(*(torch.from_numpy(np.asarray(x))
                                         for x in (alphas, betas, ll, il, lbl)), S).numpy()


def test_plan_layouts():
    groups = {U: R.plan(1500, U).group for U in U_LAYOUTS + [7, 8, 15, 16, 127, 128, 5000]}
    assert groups == {1: 1, 2: 1, 21: 4, 31: 4, 32: 8, 33: 8, 301: 32, 7: 1, 8: 2, 15: 2,
                      16: 4, 127: 16, 128: 32, 5000: 32}
    assert R.plan(1500, 301).warps == 32 and R.plan(150, 21).warps == 19
    assert R.plan(1, 1).warps == 1 and R.plan(33, 1).warps == 2
    assert R.plan(1500, 301).smem == (188 + 1) * 8 * 4
    assert R.plan(1, 5).smem == 2 * 8 * 4
    for T in (1, 7, 8, 9, 1500, 56000):
        p = R.plan(T, 301)
        assert p.smem % 16 == 0 and p.smem >= (T + R.SCAN_STEP) * 4, T
    assert R.plan(56000, 301).smem <= SMEM_BYTES


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("U", U_LAYOUTS)
def test_argmax_first_maximum_at_every_tie(U, dtype):
    """Two equal maxima at every pair of positions of a row that the lane
    layout can separate (all pairs up to U = 33, then the first, middle and
    last with each other and with a spread of others), a NaN, and a row of
    one repeated value: the replay returns what torch.argmax returns."""
    rng = np.random.default_rng(U)
    G = R.plan(1500, U).group
    positions = range(U) if U <= 33 else sorted({0, 1, U // 2, U - 2, U - 1}
                                                | set(range(0, U, 7)))
    cases = []
    for i in positions:
        for j in positions:
            if i < j:
                cases.append((i, j))
    cases += [(i, i) for i in positions]  # one maximum
    for i, j in cases:
        a = rng.integers(-40, 0, U).astype(dtype)
        b = rng.integers(-40, 0, U).astype(dtype)
        a[i], b[i], a[j], b[j] = 3, 4, 5, 2  # 7 at both
        want = int(torch.argmax(torch.from_numpy((a + b) - dtype(-3.0))))
        assert want == min(i, j)
        assert _row_argmax(a, b, dtype(-3.0), G, dtype) == want, (i, j)
    for i in positions:  # a NaN ranks above every number; the first NaN wins
        a = rng.standard_normal(U).astype(dtype)
        b = np.zeros(U, dtype)
        a[i] = np.nan
        a[-1] = np.nan
        want = int(torch.argmax(torch.from_numpy((a + b) - dtype(1.0))))
        assert _row_argmax(a, b, dtype(1.0), G, dtype) == want == i
    for v in (-np.inf, -1e30, 0.0):  # every value equal: the first
        a = np.full(U, v, dtype)
        assert _row_argmax(a, a, dtype(-2.0), G, dtype) == 0


def test_argmax_rounds_as_the_plain_version():
    """(α + β) − ll in f32, in that order: values that tie only after the
    rounding of that order tie in the replay too."""
    a = np.array([1.0, 1e8, 3.0], np.float32)
    b = np.array([1e8, 1.0, -1e8 + 1], np.float32)  # 1e8 + 1 rounds to 1e8
    ll = np.float32(0.5)
    want = int(torch.argmax(torch.from_numpy(a) + torch.from_numpy(b) - ll))
    assert _row_argmax(a, b, ll, 1, np.float32) == want == 0


def _lengths_case(rng, B, T, U):
    il = rng.integers(1, T + 1, B)
    lbl = rng.integers(0, U, B)
    il[0], lbl[0] = T, U - 1
    edge = [0, 1, 2, T - 1, T, T + 3, -1]
    il[1:1 + len(edge)] = edge[:B - 1]
    lbl[-1] = 0
    return il.astype(np.int32), lbl.astype(np.int32)


@pytest.mark.parametrize("seed,B,T,U,S", [
    (0, 9, 40, 12, 3), (1, 8, 1, 4, 2), (2, 9, 300, 61, 5), (3, 9, 20, 30, 7),
    (4, 9, 17, 21, 5), (5, 9, 64, 33, 32), (6, 9, 9, 2, 2)])
def test_kernel_replay_equals_plain(seed, B, T, U, S):
    """The whole kernel (argmax, scans, hold) against posterior_peaks +
    band_starts: integer-valued posteriors full of ties, and random ones
    whose peaks jump about and drive every clamp; lengths with T_b = 0, 1,
    2, T - 1, T, beyond T and negative, U_b = 1 and U_b = U."""
    rng = np.random.default_rng(seed)
    il, lbl = _lengths_case(rng, B, T, U)
    for dtype in (np.float32, np.float64):
        ties = [rng.integers(-3, 1, (B, T, U)).astype(dtype) for _ in range(2)]
        noise = [(rng.standard_normal((B, T, U)) * 5).astype(dtype), np.zeros((B, T, U), dtype)]
        ll = rng.standard_normal(B).astype(dtype)
        for alphas, betas in (ties, noise):
            got = _kernel(alphas, betas, ll, il, lbl, S)
            np.testing.assert_array_equal(got, _plain(alphas, betas, ll, il, lbl, S))


def test_frames_past_the_last_are_not_read():
    """Peaks at frames T_b - 1 and beyond change nothing the plain version
    returns, which is why the kernel reads frames 0 .. T_b - 2 only."""
    rng = np.random.default_rng(7)
    B, T, U, S = 9, 50, 40, 4
    il, lbl = _lengths_case(rng, B, T, U)
    alphas = (rng.standard_normal((B, T, U)) * 5).astype(np.float32)
    betas = np.zeros_like(alphas)
    ll = np.zeros(B, np.float32)
    want = _plain(alphas, betas, ll, il, lbl, S)
    for b in range(B):
        if 1 <= il[b] <= T:
            alphas[b, il[b] - 1:] = rng.standard_normal((T - il[b] + 1, U)) * 50
        elif il[b] <= 0:
            alphas[b] = rng.standard_normal((T, U)) * 50
    np.testing.assert_array_equal(_plain(alphas, betas, ll, il, lbl, S), want)
