"""The schedule of the lattice kernels (csrc/wavefront.cu), pure Python, on
the CPU.

The kernel plans its launch itself; ``ops/cuda/wavefront.py::plan`` mirrors
that plan (a card test holds it against the C entry). Here:

* the plan: bands (warps) a lattice or a stripe, lattices a block, shared
  memory; above one block's rings (f32 U > 512, f64 U > 352) stripes as even
  as the count allows, a cluster of at most MAX_CLUSTER CTAs a lattice, and
  passes beyond one cluster's reach; the band kernel's 64-bit offsets beyond
  an int's reach;
* a numpy emulation of both kernels over that plan: bands of 32 lanes
  stepping through the diagonals together; rows of lpb and lpe copied into
  each band's input ring AHEAD diagonals before lane 0 needs them, with the
  kernel's predicates; results parked in the output ring and written out a
  row at a time; one shuffle a diagonal (``__shfl_up_sync`` for alpha,
  ``__shfl_down_sync`` for beta) and the edge words the bands trade, double
  buffered; each lattice stopping at its own N_b = T_b + U_b - 1 and the
  bands beyond U_b not walking; then the NEG fill of the cells outside
  (t < T_b) & (u < U_b). With stripes, each CTA of the cluster walks its
  stripes pass after pass, each stripe only the diagonals of its cells; the
  stripes' edge columns go through the receiving CTA's ring in chunks on
  full and empty mbarriers (modelled by their phases and transaction
  counts: the sender's async stores count their bytes off the receiver's
  full mbarrier, which the receiver arms with an arrive expecting a chunk's
  bytes, in either order; a parity wait must find the very phase it means
  completed), and between passes through a
  column in device memory behind a row count. The CTAs run interleaved in a
  seeded random order with random skew, and a round in which none can move
  is a deadlock. Every ring read is checked to find the row it wants,
  copied at least AHEAD steps before (the kernel's cp.async.wait_group);
  every edge row must be handed over exactly once, in order; every cell
  must be written exactly once; the result must equal the plain
  ``ops/lattice.forward_backward`` and the JAX package's
  ``ops/lattice.forward_backward`` on ragged shapes that reach every edge:
  T_b = 1, U_b = 1, U_b = U, U at 31/32/33, 320/321, the one-block cap ± 1,
  U_b just before, on and just after a stripe's and a cluster's edge.

This is the only check of the kernels' index arithmetic and of the
handoff's protocol where no card is present. Tolerances: f64 (the kernel's
f64 path computes the same log-sum-exp as ``wtt::lse``), 1e-12 against the
plain version, 1e-10 against JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import lattice as JL
from warp_transducer_tpu_torch.ops import lattice as TL
from warp_transducer_tpu_torch.ops import prep as TP
from warp_transducer_tpu_torch.ops.cuda import wavefront as W
import torch_threads  # noqa: F401  (one torch thread a process)

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
        self.band, self.lane = np.indices((bands, W.WARP))

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
        at = (self.band, r % self.rows, self.lane)
        got = self.value[at]
        assert np.all(self.row[at][need] == r[need] + tag), "a ring read the wrong row"
        if step is not None:
            age = (step - self.step[at]) * np.sign(ahead)
            assert np.all(age[need] >= abs(ahead)), "a row read before its copy completed"
        return np.where(need, got, np.nan)


class _MBar:
    """An mbarrier of arrival count 1 with a transaction count: a phase
    completes when its one arrival has come and its transaction count is
    back at zero (bytes expected by an arrive, counted off as they land,
    in either order); ``done`` counts the completed phases."""

    def __init__(self):
        self.done, self.pending, self.tx = 0, 1, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.done, self.pending = self.done + 1, 1

    def arrive(self, expect=0):
        assert self.pending == 1, "a second arrive in one phase"
        self.pending, self.tx = 0, self.tx + expect
        self._check()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._check()

    def wait(self, m):
        """try_wait.parity for completion number m (parity m & 1): whether it
        succeeds, and where it does, that it found completion m and no
        later one (the parity cannot tell them apart)."""
        ok = (self.done & 1) != (m & 1)
        if ok:
            assert self.done == m + 1, f"a parity wait found phase {self.done}, meant {m + 1}"
        return ok


class _Cta:
    """A CTA's handoff state: its ring of HAND_ROWS (tag, value) words and
    its full and empty mbarriers. ``elt``: bytes a word."""

    def __init__(self):
        self.ring = [None] * W.HAND_ROWS
        self.full = [_MBar() for _ in range(W.CHUNKS)]
        self.empty = [_MBar() for _ in range(W.CHUNKS)]


class _Hand:
    """One CTA's handoff in one pass (Hand<T> of the kernel): receive from
    ``recv`` (0 none, 1 the cluster neighbour rank - 1, 2 the column in
    device memory at boundary ``b_in``) and send to ``send`` likewise;
    ``chunk_in`` and ``chunk_out`` count the chunks of earlier passes. The
    walks call ``recv`` and ``send`` as generators that yield False while
    they wait."""

    def __init__(self, ctas, rank, columns, recv, send, b_in, b_out, chunk_in, chunk_out, rows,
                 elt):
        self.ctas, self.rank, self.columns, self.elt = ctas, rank, columns, elt
        self.recv_kind, self.send_kind = recv, send
        self.b_in, self.b_out = b_in, b_out
        self.chunk_in, self.chunk_out, self.rows = chunk_in, chunk_out, rows
        self.got, self.sent = [], []

    def recv(self, i, row):
        self.got.append(i)
        if self.recv_kind == 1:
            me, up = self.ctas[self.rank], self.ctas[self.rank - 1]
            c = self.chunk_in + i // W.CHUNK
            slot = c % W.CHUNKS
            if i % W.CHUNK == 0:  # arm the chunk's phase with its bytes, then wait
                me.full[slot].arrive(expect=min(W.CHUNK, self.rows - i) * self.elt)
                while not me.full[slot].wait(c // W.CHUNKS):
                    yield False
            tag, v = me.ring[slot * W.CHUNK + i % W.CHUNK]
            assert tag == (c, i, row), "the ring held another row"
            if i % W.CHUNK == W.CHUNK - 1 or i == self.rows - 1:
                up.empty[slot].arrive()
            return v
        column = self.columns.setdefault(self.b_in, {"count": 0})
        while column["count"] <= i:
            yield False
        return column[row]

    def send(self, i, row, v):
        self.sent.append(i)
        last = i % W.CHUNK == W.CHUNK - 1 or i == self.rows - 1
        if self.send_kind == 1:
            me, down = self.ctas[self.rank], self.ctas[self.rank + 1]
            c = self.chunk_out + i // W.CHUNK
            slot = c % W.CHUNKS
            if i % W.CHUNK == 0 and c >= W.CHUNKS:
                while not me.empty[slot].wait(c // W.CHUNKS - 1):
                    yield False
            # an async store: lands in the ring and counts its bytes off the
            # receiver's full mbarrier, whichever comes first, its arrive or this
            down.ring[slot * W.CHUNK + i % W.CHUNK] = ((c, i, row), v)
            down.full[slot].complete_tx(self.elt)
        else:
            column = self.columns.setdefault(self.b_out, {"count": 0})
            assert row not in column, "a row of the device column written twice"
            column[row] = v
            if last:
                column["count"] = i + 1


def _stripe(pb, pe, T, U, ext, is_beta, c0s, c1, hand, store):
    """One stripe of one lattice as its walking bands step it: a generator
    that yields True after every diagonal and False while it waits on the
    handoff; it returns the lattice's ll where the stripe holds it (else
    None). ``hand`` is None for the band kernel (one stripe)."""
    Tv, Uv, steps, terminal = ext
    bands = -(-(c1 - c0s) // W.WARP)
    c0 = c0s + np.arange(bands)[:, None] * W.WARP
    lane = np.arange(W.WARP)[None, :]
    u = c0 + lane  # (bands, 32)
    takes = hand is not None and hand.recv_kind != 0
    gives = hand is not None and hand.send_kind != 0
    clamp = lambda x: np.maximum(x, NEG)  # noqa: E731
    ring_b, ring_e = _Ring(bands, R), _Ring(bands, R)  # ring_b: lpb, then results
    edge = np.full((2, bands), np.nan)
    ll = None
    if not is_beta:
        def copy(r, step):  # lpe of row r at column u-1, lpb of row r-1 at column u
            r = np.broadcast_to(r, (bands,))[:, None] + 0 * lane
            me = (r >= 0) & (r < Tv) & (u >= 1) & (u - 1 < Uv)
            mb = (r >= 1) & (r - 1 < Tv) & (u < Uv)
            rc, uc = np.clip(r, 0, T - 1), np.clip(u, 0, U - 1)
            ring_e.write(r, pe[rc, np.clip(u - 1, 0, U - 1)], me, step)
            ring_b.write(r, pb[np.clip(r - 1, 0, T - 1), uc], mb, step)

        n0 = 1 if c0s == 0 else c0s
        n_end = Tv + c1 - 1
        a = np.where(u == 0, 0.0, NEG)
        for r in range(0, n0 + K - c0s):  # the stripe's first band's prime
            copy(np.where(c0[:, 0] == c0s, r, -1), -10 ** 6)
        ring_b.write(0, a, u == 0, 0, RESULT)
        edge[(n0 - 1) & 1] = a[:, -1]
        r_in, r_out = n0 - c0s, n0 - c1 + 1
        edge_in = NEG
        if takes and 0 <= r_in < Tv:
            edge_in = yield from hand.recv(r_in, r_in)
        for n in range(n0, n_end):
            nxt = NEG
            if takes and 0 <= r_in + 1 < Tv:
                nxt = yield from hand.recv(r_in + 1, r_in + 1)
            t = n - u
            valid = (t >= 0) & (t < Tv) & (u < Uv)
            # read at the end of the step before, after its copy
            lpb_v = ring_b.read(t, valid & (t >= 1), n, K)
            lpe_v = ring_e.read(t, valid & (u >= 1), n, K)
            ro = (n - c0[:, 0] - W.WARP)[:, None] + 0 * lane  # complete a step ago
            m = (ro >= 0) & (ro < Tv) & (u < Uv)
            done = ring_b.read(ro, m, tag=RESULT)
            left = np.concatenate([np.full((bands, 1), np.nan), a[:, :-1]], axis=1)
            left[:, 0] = np.concatenate([[edge_in], edge[(n - 1) & 1, :-1]])
            no_emit = np.where(t >= 1, a + clamp(lpb_v), NEG)
            emit = np.where(u >= 1, left + clamp(lpe_v), NEG)
            x = _lse(no_emit, emit)
            copy(n + K - c0[:, 0], n)
            a = np.where(valid, x, NEG)
            ring_b.write(t, x, np.ones_like(valid), n, RESULT)  # over the lpb it used
            store(ro * U + u, done, m)
            edge[n & 1] = a[:, -1]
            if gives and 0 <= r_out < Tv:
                yield from hand.send(r_out, r_out, a[-1, -1])
            edge_in = nxt
            r_in, r_out = r_in + 1, r_out + 1
            yield True
        for b in range(bands):  # the rows completed at the last diagonals
            for r in range(max(n_end - int(c0[b, 0]) - W.WARP, 0), Tv):
                need = np.zeros((bands, W.WARP), bool)
                need[b] = u[b] < Uv
                got = ring_b.read(np.full((bands, W.WARP), r), need, tag=RESULT)
                store(r * U + u[b], got[b], need[b])
        if terminal and c0s <= Uv - 1 < c1:
            ll = a.reshape(-1)[Uv - 1 - c0s] + clamp(pb[Tv - 1, Uv - 1])
    else:
        def copy(r, step):
            r = np.broadcast_to(r, (bands,))[:, None] + 0 * lane
            m = (r >= 0) & (r < Tv) & (u < Uv)
            rc, uc = np.clip(r, 0, T - 1), np.clip(u, 0, U - 1)
            ring_b.write(r, pb[rc, uc], m, step)
            ring_e.write(r, pe[rc, uc], m, step)

        bv = np.full((bands, W.WARP), NEG)
        first = Tv + c1 - 2
        seeded = terminal and c1 == Uv
        if seeded:
            bv.reshape(-1)[Uv - 1 - c0s] = clamp(pb[Tv - 1, Uv - 1])
            first -= 1
        top = first - c0[:, 0] - (W.WARP - 1) - K
        for d in range(1, W.WARP + K):
            copy(top + d, 10 ** 6)
        if seeded:  # after the prime's copies have landed
            ring_b.write(Tv - 1, bv, u == Uv - 1, first, RESULT)
        edge[(first + 1) & 1] = bv[:, 0]
        r_out, r_in = first + 1 - c0s, first + 1 - c1
        if gives and 0 <= r_out < Tv:
            yield from hand.send(Tv - 1 - r_out, r_out, bv[0, 0])
        edge_in = NEG
        if takes and 0 <= r_in < Tv:
            edge_in = yield from hand.recv(Tv - 1 - r_in, r_in)
        for n in range(first, c0s - 1, -1):
            r_out, r_in = r_out - 1, r_in - 1
            nxt = NEG
            if takes and 0 <= r_in < Tv:
                nxt = yield from hand.recv(Tv - 1 - r_in, r_in)
            t = n - u
            valid = (t >= 0) & (t < Tv) & (u < Uv)
            # read at the end of the step before, after its copy
            lpb_v = ring_b.read(t, valid, n, -K)
            lpe_v = ring_e.read(t, valid & (u + 1 < U), n, -K)
            ro = (n - c0[:, 0] + 1)[:, None] + 0 * lane  # complete a step ago
            m = (ro >= 0) & (ro < Tv) & (u < Uv)
            done = ring_b.read(ro, m, tag=RESULT)
            right = np.concatenate([bv[:, 1:], np.full((bands, 1), np.nan)], axis=1)
            right[:, -1] = np.concatenate([edge[(n + 1) & 1, 1:], [edge_in]])
            no_emit = np.where(t + 1 < T, bv + clamp(lpb_v), NEG)
            emit = np.where(u + 1 < U, right + clamp(lpe_v), NEG)
            x = _lse(no_emit, emit)
            copy(n - c0[:, 0] - (W.WARP - 1) - K, n)
            bv = np.where(valid, x, NEG)
            ring_b.write(t, x, np.ones_like(valid), n, RESULT)
            store(ro * U + u, done, m)
            edge[n & 1] = bv[:, 0]
            if gives and 0 <= r_out < Tv:
                yield from hand.send(Tv - 1 - r_out, r_out, bv[0, 0])
            edge_in = nxt
            yield True
        # the stripe's first band's row 0, complete at the last diagonal
        m = (c0 == c0s) & (u < Uv) & (Tv > 0) & (lane >= 0)
        store(0 * u + u, ring_b.read(np.zeros_like(u), m, tag=RESULT), m)
        if c0s == 0:
            ll = bv[0, 0]
    return ll


def _fill(T, U, Tv, Uv, store):
    """NEG into the cells outside (t < Tv) & (u < Uv), band by band."""
    for b in range(-(-U // W.WARP)):
        cu = b * W.WARP + np.arange(W.WARP)
        cu = cu[cu < U]
        full = min(b * W.WARP + W.WARP, U) <= Uv
        for t in range(Tv if full else 0, T):
            m = (t >= Tv) | (cu >= Uv)
            store(t * U + cu, np.full(len(cu), NEG), m)


def _lattice(pb, pe, T, U, Tb, Ub, is_beta, plan, rng, elt):
    """One lattice as its kernel walks it: (field, ll). The band kernel
    walks one stripe; the stripe kernel's CTAs walk theirs pass after pass,
    interleaved in a random order with random skew."""
    ext = _extent(Tb, Ub, T, U)
    Tv, Uv, steps, _ = ext
    out = np.full(T * U, np.nan)
    writes = np.zeros(T * U, np.int64)

    def store(cells, values, mask):
        np.add.at(writes, cells[mask], 1)
        out[cells[mask]] = values[mask]

    ll = [NEG]
    width = plan.bands * W.WARP
    walking = -(-(-(-Uv // W.WARP)) // plan.bands) if steps else 0

    def walks(k):
        return 0 <= k < plan.stripes and (plan.stripes - 1 - k if is_beta else k) < walking

    def keep(v):
        if v is not None:
            ll[0] = v

    if plan.stripes == 1:
        if steps:
            gen = _stripe(pb, pe, T, U, ext, is_beta, 0, Uv, None, store)
            try:
                while True:
                    assert next(gen), "the band kernel waited"
            except StopIteration as stop:
                keep(stop.value)
    else:
        ctas = [_Cta() for _ in range(plan.cluster)]
        columns = {}
        per_pass = -(-Tv // W.CHUNK)

        def cta(rank):
            chunk_in = chunk_out = 0
            for p in range(plan.passes):
                k = p * plan.cluster + rank
                if k >= plan.stripes:
                    return
                stripe = plan.stripes - 1 - k if is_beta else k
                walk = walks(k)
                recv = (1 if rank > 0 else 2) if walk and walks(k - 1) else 0
                send = (1 if rank + 1 < plan.cluster else 2) if walk and walks(k + 1) else 0
                hand = _Hand(ctas, rank, columns, recv, send, p - 1, p, chunk_in, chunk_out, Tv,
                             elt)
                if walk:
                    c0s = stripe * width
                    keep((yield from _stripe(pb, pe, T, U, ext, is_beta, c0s,
                                             min(c0s + width, Uv), hand, store)))
                if recv:  # every row of the column once, in the walk's order
                    assert hand.got == list(range(Tv)), "an edge row taken other than once"
                if send:
                    assert hand.sent == list(range(Tv)), "an edge row given other than once"
                chunk_in += per_pass if recv == 1 else 0
                chunk_out += per_pass if send == 1 else 0

        alive = {r: cta(r) for r in range(plan.cluster)}
        while alive:
            moved = False
            for r in rng.permutation(sorted(alive)):
                for _ in range(int(rng.integers(1, 4))):
                    try:
                        moved |= next(alive[r])
                    except StopIteration:
                        del alive[r]
                        moved = True
                        break
            assert moved, "the cluster's CTAs deadlocked"
    _fill(T, U, Tv, Uv, store)
    assert np.all(writes == 1), "a cell written other than once"
    return out.reshape(T, U), ll[0]


def emulate(lpb, lpe, il, ll, compute_betas=True, elt=8, seed=0):
    """(alphas, betas, ll_forward, ll_backward) of the kernel's plan for
    ``elt``-byte values, computed in float64 numpy; the stripe kernel's CTAs
    interleaved in an order drawn from ``seed``."""
    B, T, U = lpb.shape
    p = W.plan(B, T, U, elt, compute_betas, N_SM)
    rng = np.random.default_rng(seed)
    out = {"alphas": [], "betas": [], "ll_forward": [], "ll_backward": []}
    for b in range(B):
        for is_beta in ((False, True) if compute_betas else (False,)):
            field, llv = _lattice(lpb[b].astype(np.float64), lpe[b].astype(np.float64), T, U,
                                  int(il[b]), int(ll[b]) + 1, is_beta, p, rng, elt)
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
    # Stripes (the stripe kernel): U_b just before, on and just after a
    # stripe's edge (f32 U = 513: stripes of 288 columns; 601: 320; f64 353:
    # 192; 700: 352) and a cluster's (f32 4097: 480 columns a stripe, 3840 a
    # cluster; 5000: 4096; f64 2817: 2560), T_b = 1 and L_b = 0.
    "f32_U513": (4, 4, 513, [4, 1, 3, 4], [512, 286, 287, 288], 4),
    "f32_U601": (5, 5, 601, [5, 3, 1, 5, 4], [600, 318, 319, 320, 0], 4),
    "f32_U4097": (2, 3, 4097, [3, 1], [4096, 3839], 4),
    "f32_U5000": (2, 3, 5000, [3, 2], [4999, 4096], 4),
    "f64_U353": (4, 4, 353, [4, 1, 3, 2], [352, 190, 191, 192], 8),
    "f64_U700": (3, 4, 700, [4, 2, 1], [699, 351, 352], 8),
    "f64_U2817": (4, 3, 2817, [3, 1, 2, 3], [2816, 2558, 2559, 2560], 8),
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


# The JAX engine's scan takes seconds a lattice at U in the thousands: the
# widest cases are held against the plain version alone, which
# tests/test_torch_lattice.py holds against the JAX package.
JAX_MAX_U = 1024
# Alpha alone (compute_betas=False) for every case of one block and a few
# of the stripes: the walks are the same, only the lattices a block differ.
ALPHA_ALONE = ("f32_U601", "f64_U353")


@pytest.mark.parametrize("case,betas", [(c, b) for c in sorted(CASES) for b in (True, False)
                                        if b or CASES[c][2] <= 512 or c in ALPHA_ALONE])
def test_emulation_matches_plain_and_jax(case, betas):
    B, T, U, il, ll, elt = CASES[case]
    lpb, lpe, il, ll = _inputs(B, T, U, il, ll, seed=len(case))
    plan = W.plan(B, T, U, elt, betas, N_SM)
    assert plan.stripes * plan.bands * W.WARP >= U
    assert (plan.stripes > 1) == (U > W.max_bands(elt) * W.WARP)
    got = emulate(lpb, lpe, il, ll, betas, elt, seed=len(case))
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
    if U > JAX_MAX_U:
        return
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
def test_stripes_above_the_cap(elt, cap):
    """Up to the cap one block holds a lattice (the band kernel); above it
    the stripe kernel: stripes as even as the count allows, each within one
    block's shared memory, a cluster of at most MAX_CLUSTER CTAs a lattice,
    in passes beyond it. No U refuses."""
    for U in (1, 31, 32, 33, cap - 1, cap):
        p = W.plan(16, 1500, U, elt, True, N_SM)
        assert p.stripes == 1 and p.cluster == 1 and p.passes == 1
        assert p.bands == max(1, -(-U // W.WARP)) <= W.max_bands(elt)
        assert p.smem + W.EDGE_BYTES <= W.SMEM_BYTES and p.threads <= 1024
    for U in (cap + 1, 601, 1100, 4097, 14000, 40000, 10 ** 6):
        p = W.plan(16, 1500, U, elt, True, N_SM)
        bands = -(-U // W.WARP)
        assert p.stripes > 1 and p.per_block == 1
        assert (p.stripes - 1) * p.bands < bands <= p.stripes * p.bands
        assert p.bands <= W.max_bands(elt) and p.bands - 1 <= -(-bands // p.stripes) <= p.bands
        assert p.cluster == min(p.stripes, W.MAX_CLUSTER)
        assert p.passes == -(-p.stripes // p.cluster)
        assert p.blocks == 32 * p.cluster and p.threads == W.WARP * p.bands <= 512
        assert p.smem + W.EDGE_BYTES + W.HAND_BYTES <= W.SMEM_BYTES


def test_64_bit_offsets_beyond_an_int():
    """The band kernel keeps a lattice's offsets, up to (T + U + 2·RING)·U,
    in an int where they fit and in 64 bits beyond (the same kernel, another
    instantiation; nothing switches to another kernel); the stripe kernel's
    are 64-bit at every size."""
    U = 300
    T_max = W.MAX_OFFSET // U - U - 2 * R
    narrow, wide = W.plan(4, T_max, U, 4, True, N_SM), W.plan(4, T_max + 1, U, 4, True, N_SM)
    assert not narrow.wide and wide.wide and narrow._replace(wide=True) == wide
    assert wide.stripes == 1
    assert W.plan(2, 10 ** 6, 5000, 4, True, N_SM) == W.plan(2, 8, 5000, 4, True, N_SM)
    assert not W.plan(2, 10 ** 6, 5000, 4, True, N_SM).wide


@pytest.mark.parametrize("elt,bands,per_warp", [(4, 16, 10240), (8, 11, 20480)])
def test_rings_fit_a_block(elt, bands, per_warp):
    assert W.band_bytes(elt) == per_warp and W.max_bands(elt) == bands
    assert bands * per_warp + W.EDGE_BYTES + W.HAND_BYTES <= W.SMEM_BYTES
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
