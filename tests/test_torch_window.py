"""The pending-window lattice of warp_transducer_tpu_torch (ops/window.py,
the CPU twin of csrc/window_stream.cu) against the JAX package: the XLA
engines ``_multiblank_lattice`` / ``_tdt_lattice`` and the Pallas kernel K7
(``window_stream._window_kernel``) in interpret mode.

The same channels (log-probs of random logits, made with numpy from a seed)
go to both. Cells outside (t < T_b) & (u < U_b), and cells no path reaches,
hold the finite sentinel NEG in every engine; they are compared as
"<= -1e29" and the rest by value.

Tolerances: f64 1e-9 (rounding only: the engines add in different orders);
f32 rtol 1e-5 / atol 2e-5 (the prefix form c + LSE(ne − c) cancels against
|c|, the summed chain weights of a row, ~20 here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops.multiblank import _multiblank_lattice
from warp_transducer_tpu.ops.pallas import window_stream as JW
from warp_transducer_tpu.ops.tdt import _tdt_lattice
from warp_transducer_tpu_torch.ops import lattice as TL
from warp_transducer_tpu_torch.ops import window as TW
from warp_transducer_tpu_torch.ops.prep import NEG
from jax_programs import release_compiled_programs  # noqa: F401

TOL = {np.float64: dict(rtol=1e-9, atol=1e-9), np.float32: dict(rtol=1e-5, atol=2e-5)}
MULTIBLANK = [(), (2,), (2, 4), (2, 3, 8)]
TDT = [(0, 1, 2, 4), (1, 2, 3), (0, 1, 3), (1, 2), (2,)]


def _channels(B, T, U, C, seed, dtype=np.float64):
    """lpb, lpe (column U-1 NEG), C extra channels and ragged lengths."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, U, 3 + C)) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    lpe = lp[..., 1].copy()
    lpe[:, :, U - 1] = NEG
    il = rng.integers(max(1, T - 4), T + 1, size=B).astype(np.int32)
    ll = rng.integers(0, U, size=B).astype(np.int32)
    il[0], ll[0] = T, U - 1
    return (lp[..., 0].astype(dtype), lpe.astype(dtype),
            np.ascontiguousarray(lp[..., 3:]).astype(dtype), il, ll)


def _port(arcs, lpb, lpe, extra, il, ll, **kw):
    return TW.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(extra), arcs,
                               torch.tensor(il), torch.tensor(ll), **kw)


def _check(port, ref, dtype):
    """ref: (alphas, betas, ll_forward, ll_backward) of a JAX engine."""
    for got, want in zip(port, ref):
        got, want = got.numpy(), np.asarray(want)
        live = want > -1e29
        assert np.all(got[~live] <= -1e29)
        np.testing.assert_allclose(got[live], want[live], **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("durations", MULTIBLANK, ids=str)
def test_multiblank_lattice_matches_jax(durations, dtype):
    lpb, lpe, lpB, il, ll = _channels(3, 12, 5, len(durations), seed=1, dtype=dtype)
    ref = _multiblank_lattice(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpB), durations,
                              jnp.asarray(il), jnp.asarray(ll))
    port = _port(TW.multiblank_arcs(durations), lpb, lpe, lpB, il, ll)
    assert port.alphas.dtype == torch.tensor(lpb).dtype
    _check(port, ref, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("durations", TDT, ids=str)
def test_tdt_lattice_matches_jax(durations, dtype):
    """(1, 2, 3) and (1, 2) have no d = 0 and so no chain; (2,) leaves the
    utterances of odd T_b without a path (ll_forward = NEG)."""
    lpb, lpe, lpd, il, ll = _channels(4, 11, 4, len(durations), seed=2, dtype=dtype)
    ref = _tdt_lattice(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpd), durations,
                       jnp.asarray(il), jnp.asarray(ll))
    port = _port(TW.tdt_arcs(durations), lpb, lpe, lpd, il, ll)
    _check(port, ref, dtype)
    if durations == (2,):
        assert float(port.ll_forward[0]) <= -1e29  # T_b = 11


@pytest.mark.parametrize("durations", MULTIBLANK[1:], ids=str)
def test_multiblank_lattice_matches_pallas_k7(durations):
    lpb, lpe, lpB, il, ll = _channels(3, 9, 5, len(durations), seed=3, dtype=np.float32)
    ref = JW.multiblank_forward_backward(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpB),
                                         durations, jnp.asarray(il), jnp.asarray(ll),
                                         interpret=True)
    _check(_port(TW.multiblank_arcs(durations), lpb, lpe, lpB, il, ll), ref, np.float32)


@pytest.mark.parametrize("durations", [(0, 1, 2, 4), (1, 2, 3), (2,)], ids=str)
def test_tdt_lattice_matches_pallas_k7(durations):
    lpb, lpe, lpd, il, ll = _channels(3, 9, 4, len(durations), seed=4, dtype=np.float32)
    ref = JW.tdt_forward_backward(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpd),
                                  durations, jnp.asarray(il), jnp.asarray(ll), interpret=True)
    _check(_port(TW.tdt_arcs(durations), lpb, lpe, lpd, il, ll), ref, np.float32)


@pytest.mark.parametrize("W", [2, 3, 5, 8])
def test_arc_as_long_as_the_window(W):
    """One big blank of duration W: the arc sent from row t lands on row
    t + W, the pending slot that row t itself just left."""
    lpb, lpe, lpB, il, ll = _channels(2, 2 * W + 3, 3, 1, seed=5 + W)
    ref = _multiblank_lattice(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpB), (W,),
                              jnp.asarray(il), jnp.asarray(ll))
    arcs = TW.multiblank_arcs((W,))
    assert arcs.window == W
    _check(_port(arcs, lpb, lpe, lpB, il, ll), ref, np.float64)
    # and as a TDT duration, where the emit arc of m = W moves one u as well
    ref = _tdt_lattice(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpB), (W,),
                       jnp.asarray(il), jnp.asarray(ll))
    _check(_port(TW.tdt_arcs((W,)), lpb, lpe, lpB, il, ll), ref, np.float64)


def test_terminal_arcs_by_hand():
    """B = 1, U = 1, T = 4, big blank of 4: two ways to end at T from t = 0
    beside the mixed ones; with durations (2, 4) the paths are 1+1+1+1, 2+2,
    1+1+2 (three orders) and 4."""
    lpb, lpe, lpB, il, ll = _channels(1, 4, 1, 2, seed=9)
    il[:], ll[:] = 4, 0
    b, B2, B4 = lpb[0, :, 0], lpB[0, :, 0, 0], lpB[0, :, 0, 1]
    paths = [b[0] + b[1] + b[2] + b[3], B2[0] + B2[2], B2[0] + b[2] + b[3],
             b[0] + B2[1] + b[3], b[0] + b[1] + B2[2], B4[0]]
    want = np.logaddexp.reduce(paths)
    port = _port(TW.multiblank_arcs((2, 4)), lpb, lpe, lpB, il, ll)
    np.testing.assert_allclose(port.ll_forward.numpy(), [want], rtol=1e-12)
    np.testing.assert_allclose(port.ll_backward.numpy(), [want], rtol=1e-12)
    assert float(port.alphas[0, 0, 0]) == 0.0  # the start cell


def test_tdt_has_no_standard_blank():
    """TDT's ll_forward starts at NEG: with T_b = 1 only a d = 1 blank ends
    the path, and durations without 1 leave it infeasible."""
    lpb, lpe, lpd, il, ll = _channels(1, 1, 1, 2, seed=10)
    port = _port(TW.tdt_arcs((0, 1)), lpb, lpe, lpd, il, ll)
    np.testing.assert_allclose(port.ll_forward.numpy(), [lpb[0, 0, 0] + lpd[0, 0, 0, 1]],
                               rtol=1e-12)
    port = _port(TW.tdt_arcs((0, 2)), lpb, lpe, lpd, il, ll)
    assert float(port.ll_forward[0]) <= -1e29 and float(port.ll_backward[0]) <= -1e29


def test_no_chain_leaks_no_path():
    """Without d = 0 no cell is reached inside its row: alpha(0, u >= 1) and
    every cell a path cannot reach hold NEG itself, not NEG plus a clamped
    chain weight."""
    lpb, lpe, lpd, il, ll = _channels(2, 7, 4, 2, seed=11)
    port = _port(TW.tdt_arcs((1, 2)), lpb, lpe, lpd, il, ll)
    assert torch.all(port.alphas[:, 0, 1:] == NEG)
    assert torch.all(port.alphas[:, 1, 2:] == NEG)  # one emit a row at most
    ref = _tdt_lattice(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(lpd), (1, 2),
                       jnp.asarray(il), jnp.asarray(ll))
    assert np.all((np.asarray(ref.alphas) <= -1e29) == (port.alphas.numpy() <= -1e29))


@pytest.mark.parametrize("arcs", [TW.multiblank_arcs((2, 4)), TW.tdt_arcs((0, 1, 2)),
                                  TW.tdt_arcs((1, 3))], ids=["multiblank", "tdt", "tdt_no_d0"])
def test_invalid_cells_hold_neg_and_ll_backward_is_beta00(arcs):
    lpb, lpe, extra, il, ll = _channels(3, 9, 5, 3, seed=12)
    il[1], ll[1] = 5, 2
    port = _port(arcs, lpb, lpe, extra, il, ll)
    t = torch.arange(9)[None, :, None]
    u = torch.arange(5)[None, None, :]
    invalid = (t >= torch.tensor(il)[:, None, None]) | (u > torch.tensor(ll)[:, None, None])
    assert torch.all(port.alphas[invalid] == NEG) and torch.all(port.betas[invalid] == NEG)
    assert torch.equal(port.ll_backward, port.betas[:, 0, 0])
    np.testing.assert_allclose(port.ll_forward.numpy(), port.ll_backward.numpy(), rtol=1e-10)


def test_score_only_skips_beta():
    lpb, lpe, lpB, il, ll = _channels(2, 8, 4, 2, seed=13)
    arcs = TW.multiblank_arcs((2, 3))
    full = _port(arcs, lpb, lpe, lpB, il, ll)
    score = _port(arcs, lpb, lpe, lpB, il, ll, compute_betas=False)
    assert score.betas is score.alphas and score.ll_backward is score.ll_forward
    assert torch.equal(score.alphas, full.alphas)
    assert torch.equal(score.ll_forward, full.ll_forward)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_without_big_blanks_is_the_dense_lattice(dtype):
    """K = 0: W = 1, one blank arc, the label chain — the lattice of
    ``rnnt_loss`` (ops/lattice.py, the wavefront recursion)."""
    lpb, lpe, empty, il, ll = _channels(3, 9, 5, 0, seed=14, dtype=dtype)
    arcs = TW.multiblank_arcs(())
    assert arcs == TW.WindowArcs(chain=(1,), blank_arcs=((1, (0,)),), emit_arcs=())
    port = _port(arcs, lpb, lpe, empty, il, ll)
    dense = TL.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(il),
                                torch.tensor(ll))
    for got, want in zip(port, dense):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[dtype])


def test_inputs_below_neg_are_clamped():
    lpb, lpe, lpB, il, ll = _channels(2, 6, 3, 1, seed=15)
    want = _port(TW.multiblank_arcs((2,)), lpb, lpe, lpB, il, ll)
    lpe_inf = lpe.copy()
    lpe_inf[:, :, -1] = -np.inf
    got = _port(TW.multiblank_arcs((2,)), lpb, lpe_inf, lpB, il, ll)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_arc_tables():
    """The tables of window_stream.py:398-401 and :417-425."""
    assert TW.multiblank_arcs((2, 4)) == TW.WindowArcs(
        chain=(1,), blank_arcs=((1, (0,)), (2, (2,)), (4, (3,))), emit_arcs=())
    assert TW.tdt_arcs((0, 1, 2, 4)) == TW.WindowArcs(
        chain=(1, 2), blank_arcs=((1, (0, 3)), (2, (0, 4)), (4, (0, 5))),
        emit_arcs=((1, (1, 3)), (2, (1, 4)), (4, (1, 5))))
    no_d0 = TW.tdt_arcs((1, 2))
    assert no_d0.chain is None and no_d0.window == 2
    assert TW.multiblank_arcs(()).window == 1


def test_check_arcs_errors():
    ok = TW.multiblank_arcs((2,))
    TW.check_arcs(ok, 1)
    with pytest.raises(ValueError, match="channels"):
        TW.check_arcs(ok, 0)  # channel 2 needs one extra channel
    with pytest.raises(ValueError, match="distinct"):
        TW.check_arcs(TW.WindowArcs(chain=None, blank_arcs=((1, (0, 0)),), emit_arcs=()), 0)
    with pytest.raises(ValueError, match="at least one blank arc"):
        TW.check_arcs(TW.WindowArcs(chain=(1,), blank_arcs=(), emit_arcs=()), 0)
    with pytest.raises(ValueError, match="at least one frame"):
        TW.check_arcs(TW.WindowArcs(chain=None, blank_arcs=((0, (0,)),), emit_arcs=()), 0)
    with pytest.raises(ValueError, match="1 to 3 channels"):
        TW.check_arcs(TW.WindowArcs(chain=(0, 1, 0, 1), blank_arcs=((1, (0,)),), emit_arcs=()), 0)
    # no cap on the arcs or the channels: ten blank arcs, nine extra channels
    TW.check_arcs(TW.WindowArcs(chain=None, blank_arcs=((1, (0,)),) * 10, emit_arcs=()), 0)
    lpb = torch.zeros((1, 2, 2))
    res = TW.forward_backward(lpb, lpb, torch.zeros((1, 2, 2, 9)), ok, torch.tensor([2]),
                              torch.tensor([1]))
    assert bool(torch.isfinite(res.ll_forward).all())
