"""The port's Viterbi alignments (``ops/alignment.py``) on the CPU, held
against the JAX package's (``warp_transducer_tpu/ops/alignment.py``) on the
same numpy inputs, against brute-force path enumeration, and against the
port's own losses.

Tolerances: f64 scores rtol/atol 1e-10, with ``path``, ``emit_frames`` and
``emit_durations`` equal (random f64 inputs have no ties); f32 scores rtol
1e-5, atol 1e-5 (the two packages' preps round differently, so only the
scores are compared); the brute forces rtol 1e-9 (f64). Ties: inputs of all
zeros make every arc of a step equal, and the paths must still be the JAX
package's. Each JAX function is jitted once a shape and static arguments.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warp_transducer_tpu_torch as W
from jax_programs import release_compiled_programs  # noqa: F401
from warp_transducer_tpu.ops import alignment as JA

F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-5, atol=1e-5)
BRUTE = dict(rtol=1e-9, atol=1e-9)

_J_DENSE = jax.jit(JA.rnnt_viterbi_align, static_argnames=("blank", "log_probs_input"))
_J_TDT = jax.jit(JA.tdt_viterbi_align, static_argnames=("durations", "blank", "sigma"))
_J_MB = jax.jit(JA.multiblank_viterbi_align,
                static_argnames=("big_blank_durations", "blank", "big_blank_indices", "sigma"))


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def _problem(seed, B, T, U, V, dtype=np.float64, D=3, label_range=None, zeros=False):
    """Token logits (B, T, U, V), duration logits (B, T, U, D), labels and
    ragged lengths (the first utterance full, one at label length 0 when
    B > 2)."""
    rng = np.random.default_rng(seed)
    acts = rng.standard_normal((B, T, U, V)) * 2.0
    dur = rng.standard_normal((B, T, U, D)) * 2.0
    if zeros:
        acts, dur = np.zeros_like(acts), np.zeros_like(dur)
    lo, hi = label_range or (1, V)
    labels = rng.integers(lo, hi, (B, max(U - 1, 0))).astype(np.int32)
    il = rng.integers(max(1, T // 2), T + 1, B).astype(np.int32)
    ll = rng.integers(0, U, B).astype(np.int32)
    il[0], ll[0] = T, U - 1
    if B > 2:
        ll[2] = 0
    return acts.astype(dtype), dur.astype(dtype), labels, il, ll


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [torch.tensor(x) for x in xs]


def _check(got, want, exact, tol):
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), **tol)
    assert got.score.dtype == (torch.float64 if tol is F64 else torch.float32)
    if exact:
        for field in got._fields[1:]:
            g, w = getattr(got, field), np.asarray(getattr(want, field))
            assert g.dtype == torch.int32 and g.shape == w.shape, field
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)


# ---- each function against its JAX twin ------------------------------------------------------

DENSE_CASES = {
    "ragged_f64": dict(shape=(4, 9, 5, 7), kw={}),
    "blank_last_f64": dict(shape=(3, 8, 4, 6), kw=dict(blank=5), label_range=(0, 5)),
    "log_probs_f64": dict(shape=(3, 7, 4, 5), kw=dict(log_probs_input=True)),
    "one_row_f64": dict(shape=(3, 6, 1, 5), kw={}),
    "ragged_f32": dict(shape=(4, 12, 6, 8), kw={}, dtype=np.float32),
    "zeros_tie_f64": dict(shape=(2, 6, 4, 5), kw={}, zeros=True),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_matches_jax(case):
    c = DENSE_CASES[case]
    dtype = c.get("dtype", np.float64)
    acts, _, labels, il, ll = _problem(len(case), *c["shape"], dtype=dtype,
                                       label_range=c.get("label_range"), zeros=c.get("zeros"))
    if c["kw"].get("log_probs_input"):
        acts = _log_softmax(acts)
    want = _J_DENSE(*_jax(acts, labels, il, ll), **c["kw"])
    got = W.rnnt_viterbi_align(*_torch(acts, labels, il, ll), **c["kw"])
    _check(got, want, dtype == np.float64, F64 if dtype == np.float64 else F32)


def test_dense_tie_goes_to_emit():
    """All arcs equal: from the terminal cell the backtrace takes the emit
    arc whenever one exists, so every label is emitted on the last frame."""
    B, T, U, V = 2, 6, 4, 5
    acts, _, labels, _, _ = _problem(0, B, T, U, V, zeros=True)
    il, ll = np.array([6, 4], np.int32), np.array([3, 2], np.int32)
    got = W.rnnt_viterbi_align(*_torch(acts, labels, il, ll))
    for b in range(B):
        Tb, Lb = int(il[b]), int(ll[b])
        assert got.emit_frames[b, :Lb].tolist() == [Tb - 1] * Lb
        assert got.path[b, :Tb + Lb - 1].tolist() == [0] * (Tb - 1) + [1] * Lb
        assert (got.path[b, Tb + Lb - 1:] == -1).all()


TDT_CASES = {
    "d0_f64": dict(shape=(4, 9, 5, 7), durs=(0, 1, 2), kw=dict(sigma=0.05)),
    "no_d0_f64": dict(shape=(3, 10, 4, 6), durs=(1, 2, 4), kw={}),
    "blank_last_f64": dict(shape=(3, 8, 4, 6), durs=(0, 1, 2, 3), kw=dict(blank=5),
                           label_range=(0, 5)),
    "one_row_f64": dict(shape=(3, 7, 1, 5), durs=(0, 1, 2), kw={}),
    "ragged_f32": dict(shape=(4, 12, 6, 8), durs=(0, 1, 2, 4), kw=dict(sigma=0.05),
                       dtype=np.float32),
    "zeros_tie_f64": dict(shape=(2, 7, 4, 5), durs=(0, 1, 2), kw={}, zeros=True),
}


@pytest.mark.parametrize("case", sorted(TDT_CASES))
def test_tdt_matches_jax(case):
    c = TDT_CASES[case]
    dtype, durs = c.get("dtype", np.float64), c["durs"]
    tok, dur, labels, il, ll = _problem(len(case), *c["shape"], dtype=dtype, D=len(durs),
                                        label_range=c.get("label_range"), zeros=c.get("zeros"))
    want = _J_TDT(*_jax(tok, dur, labels, il, ll), durations=durs, **c["kw"])
    got = W.tdt_viterbi_align(*_torch(tok, dur, labels, il, ll), durs, **c["kw"])
    _check(got, want, dtype == np.float64, F64 if dtype == np.float64 else F32)


def test_tdt_infeasible_scores_minus_inf():
    """Durations (2, 4) cannot consume an odd frame count: the score is an
    exact -inf on both sides (the port's finite sentinel is turned into
    -inf before the max-plus pass)."""
    tok, dur, labels, _, ll = _problem(3, 2, 7, 3, 5, D=2)
    il = np.array([7, 6], np.int32)
    want = _J_TDT(*_jax(tok, dur, labels, il, ll), durations=(2, 4))
    got = W.tdt_viterbi_align(*_torch(tok, dur, labels, il, ll), (2, 4))
    assert np.isneginf(np.asarray(want.score[0])) and torch.isneginf(got.score[0])
    _check(got, want, True, F64)


MB_CASES = {
    "k2_f64": dict(shape=(4, 9, 5, 8), durs=(2, 3), kw=dict(sigma=0.05), label_range=(1, 6)),
    "k0_f64": dict(shape=(3, 8, 4, 6), durs=(), kw={}),
    "indices_blank_last_f64": dict(shape=(3, 10, 4, 8), durs=(2, 4),
                                   kw=dict(blank=7, big_blank_indices=(0, 3)),
                                   label_range=(4, 7)),
    "one_row_f64": dict(shape=(3, 7, 1, 6), durs=(2, 3), kw={}),
    "ragged_f32": dict(shape=(4, 12, 6, 8), durs=(2, 4), kw=dict(sigma=0.05), dtype=np.float32,
                       label_range=(1, 6)),
    "zeros_tie_f64": dict(shape=(2, 7, 4, 6), durs=(2, 3), kw={}, zeros=True,
                          label_range=(1, 4)),
}


@pytest.mark.parametrize("case", sorted(MB_CASES))
def test_multiblank_matches_jax(case):
    c = MB_CASES[case]
    dtype, durs = c.get("dtype", np.float64), c["durs"]
    acts, _, labels, il, ll = _problem(len(case), *c["shape"], dtype=dtype,
                                       label_range=c.get("label_range"), zeros=c.get("zeros"))
    want = _J_MB(*_jax(acts, labels, il, ll), big_blank_durations=durs, **c["kw"])
    got = W.multiblank_viterbi_align(*_torch(acts, labels, il, ll), durs, **c["kw"])
    _check(got, want, dtype == np.float64, F64 if dtype == np.float64 else F32)


# ---- brute-force path enumeration (after tests/test_alignment.py:18,
# tests/test_tdt.py:332 and tests/test_multiblank.py:293) ----------------------------------------


def _dense_brute_force(lp, labels, T, U, blank):
    """Every monotonic (t, u) path; (best score, emit frames)."""
    best = (-np.inf, None)
    n_moves = (T - 1) + (U - 1)
    for emit_positions in itertools.combinations(range(n_moves), U - 1):
        t, u, score, frames = 0, 0, 0.0, []
        for k in range(n_moves):
            if k in emit_positions:
                score += lp[t, u, labels[u]]
                frames.append(t)
                u += 1
            else:
                score += lp[t, u, blank]
                t += 1
        score += lp[T - 1, U - 1, blank]
        if score > best[0]:
            best = (score, frames)
    return best


def _tdt_brute_force(lp_tok, lp_dur, labels, durs, blank=0):
    """Every complete TDT path; (best score, [(frame, duration)] of its
    tokens)."""
    T, U, _ = lp_tok.shape
    best = [-np.inf, None]

    def go(t, u, s, emits):
        for j, d in enumerate(durs):
            if u == U - 1 and d >= 1 and t + d == T:
                cand = s + lp_tok[t, u, blank] + lp_dur[t, u, j]
                if cand > best[0]:
                    best[0], best[1] = cand, list(emits)
            if d >= 1 and t + d <= T - 1:
                go(t + d, u, s + lp_tok[t, u, blank] + lp_dur[t, u, j], emits)
            if u < U - 1 and t + d <= T - 1:
                go(t + d, u + 1, s + lp_tok[t, u, labels[u]] + lp_dur[t, u, j],
                   emits + [(t, d)])

    go(0, 0, 0.0, [])
    return best


def _mb_brute_force(lp, labels, durs, idx, blank=0):
    """Every complete multi-blank path; (best score, emit frames, path
    codes)."""
    T, U, _ = lp.shape
    best = [-np.inf, None, None]

    def go(t, u, s, emits, steps):
        if t == T - 1 and u == U - 1 and s + lp[t, u, blank] > best[0]:
            best[0], best[1], best[2] = s + lp[t, u, blank], list(emits), steps + [1]
        for k, m in enumerate(durs):
            if u == U - 1 and t + m == T and s + lp[t, u, idx[k]] > best[0]:
                best[0], best[1], best[2] = s + lp[t, u, idx[k]], list(emits), steps + [m]
        if t + 1 <= T - 1:
            go(t + 1, u, s + lp[t, u, blank], emits, steps + [1])
        for k, m in enumerate(durs):
            if t + m <= T - 1:
                go(t + m, u, s + lp[t, u, idx[k]], emits, steps + [m])
        if u < U - 1:
            go(t, u + 1, s + lp[t, u, labels[u]], emits + [t], steps + [0])

    go(0, 0, 0.0, [], [])
    return best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_matches_brute_force(seed):
    acts, _, labels, il, ll = _problem(seed, 3, 5, 4, 5)
    got = W.rnnt_viterbi_align(*_torch(acts, labels, il, ll))
    for b in range(3):
        Tb, Ub = int(il[b]), int(ll[b]) + 1
        score, frames = _dense_brute_force(_log_softmax(acts[b]), labels[b], Tb, Ub, 0)
        np.testing.assert_allclose(got.score[b].item(), score, **BRUTE)
        assert got.emit_frames[b, :Ub - 1].tolist() == frames


@pytest.mark.parametrize("durs", [(0, 1, 2), (1, 2)])
def test_tdt_matches_brute_force(durs):
    tok, dur, labels, _, _ = _problem(4, 3, 6, 3, 5, D=len(durs))
    il, ll = np.array([6, 4, 5], np.int32), np.array([2, 1, 2], np.int32)
    got = W.tdt_viterbi_align(*_torch(tok, dur, labels, il, ll), durs, sigma=0.03)
    for b in range(3):
        t, u = int(il[b]), int(ll[b]) + 1
        score, emits = _tdt_brute_force(_log_softmax(tok[b, :t, :u]) - 0.03,
                                        _log_softmax(dur[b, :t, :u]), labels[b], durs)
        np.testing.assert_allclose(got.score[b].item(), score, **BRUTE)
        assert list(zip(got.emit_frames[b, :u - 1].tolist(),
                        got.emit_durations[b, :u - 1].tolist())) == emits
        assert (got.emit_frames[b, u - 1:] == -1).all()


def test_multiblank_matches_brute_force():
    durs = (2, 3)
    acts, _, labels, _, _ = _problem(5, 3, 6, 3, 7, label_range=(1, 5))
    il, ll = np.array([6, 4, 5], np.int32), np.array([2, 1, 2], np.int32)
    got = W.multiblank_viterbi_align(*_torch(acts, labels, il, ll), durs, sigma=0.05)
    for b in range(3):
        t, u = int(il[b]), int(ll[b]) + 1
        score, emits, steps = _mb_brute_force(_log_softmax(acts[b, :t, :u]) - 0.05, labels[b],
                                              durs, (5, 6))
        np.testing.assert_allclose(got.score[b].item(), score, **BRUTE)
        assert got.emit_frames[b, :u - 1].tolist() == emits
        assert got.path[b, :len(steps)].tolist() == steps
        assert (got.path[b, len(steps):] == -1).all()


# ---- against the port's losses ---------------------------------------------------------------


def test_scores_bounded_by_the_losses():
    """The best path's log-prob <= the log-likelihood over all paths."""
    acts, dur, labels, il, ll = _problem(21, 4, 9, 5, 8, D=3, label_range=(1, 6))
    a, d, lab, i, n = _torch(acts, dur, labels, il, ll)
    dense = W.rnnt_viterbi_align(a, lab, i, n).score
    assert (dense <= -W.rnnt_score(a, lab, i, n) + 1e-9).all()
    tdt = W.tdt_viterbi_align(a, d, lab, i, n, (0, 1, 2), sigma=0.05).score
    assert (tdt <= -W.rnnt_loss_tdt(a, d, lab, i, n, (0, 1, 2), sigma=0.05,
                                    reduction="none") + 1e-9).all()
    mb = W.multiblank_viterbi_align(a, lab, i, n, (2, 4), sigma=0.05).score
    assert (mb <= -W.rnnt_loss_multiblank(a, lab, i, n, (2, 4), sigma=0.05,
                                          reduction="none") + 1e-9).all()


def test_multiblank_k0_is_the_dense_alignment():
    """Without big blanks the multi-blank lattice is the dense one: equal
    scores and emit frames, and the same path in the other encoding (the
    multi-blank path adds the terminal blank as its last step)."""
    acts, _, labels, il, ll = _problem(5, 3, 7, 4, 6)
    args = _torch(acts, labels, il, ll)
    mb, dn = W.multiblank_viterbi_align(*args, ()), W.rnnt_viterbi_align(*args)
    np.testing.assert_allclose(mb.score.numpy(), dn.score.numpy(), rtol=1e-12)
    assert torch.equal(mb.emit_frames, dn.emit_frames)
    for b in range(3):
        n = int(il[b] + ll[b]) - 1
        assert mb.path[b, :n].tolist() == (1 - dn.path[b, :n]).tolist()
        assert mb.path[b, n].item() == 1 and (mb.path[b, n + 1:] == -1).all()


def test_full_label_rows_match_jax():
    """Every utterance at L_b = U - 1: the last lpe column holds the port
    prep's finite sentinel where the JAX prep has -inf. Neither the forward
    nor the backtrace reads it, so the paths agree."""
    acts, _, labels, il, _ = _problem(8, 4, 9, 5, 7)
    ll = np.full(4, 4, np.int32)
    want = _J_DENSE(*_jax(acts, labels, il, ll))
    got = W.rnnt_viterbi_align(*_torch(acts, labels, il, ll))
    _check(got, want, True, F64)


def test_cuda_route_needs_cuda_tensors():
    acts, dur, labels, il, ll = _torch(*_problem(0, 2, 4, 3, 5))
    with pytest.raises(ValueError, match="CUDA"):
        W.rnnt_viterbi_align(acts, labels, il, ll, implementation="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        W.tdt_viterbi_align(acts, dur, labels, il, ll, (0, 1, 2), implementation="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        W.multiblank_viterbi_align(acts, labels, il, ll, (2,), implementation="cuda")
