"""``rnnt_loss_pruned_fused`` of warp_transducer_tpu_torch on the CPU, held
against the JAX package's ``rnnt_loss_pruned_fused`` — its XLA engine and the
Pallas band kernel in interpret mode, on both routes (the chunked sweeps and
the materialised band) — against the unfused composition, and against the
dense fused loss on a full band.

Inputs are made with numpy from a seed and given to both as the same arrays.
Tolerances, as tests/test_pruned_fused.py: costs rtol 1e-5, gradients atol
2e-5 (the band's log-sum-exps and the products are summed in another
order). The JAX package reads its route threshold from the environment at
each call; the port's is one module constant, patched here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import pruned_fused as JPF
from warp_transducer_tpu_torch import (gather_banded, rnnt_loss_fused_joint, rnnt_loss_pruned,
                                       rnnt_loss_pruned_fused)
from warp_transducer_tpu_torch.ops import fused_joint, pruned_fused
import torch_threads  # noqa: F401  (one torch thread a process)

NAMES = ("de", "dp", "dW", "db")
ROUTES = {"sweep": 0, "materialise": 4096}


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    """Both routes, in the port and in the JAX package."""
    monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", ROUTES[request.param])
    monkeypatch.setenv("WTT_PRUNED_FUSED_MAT_MB", str(ROUTES[request.param]))
    return request.param


@pytest.fixture
def sweep(monkeypatch):
    monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", 0)
    monkeypatch.setenv("WTT_PRUNED_FUSED_MAT_MB", "0")


def _ranges(rng, B, T, S, il, ll):
    """Random contract-abiding band starts (tests/test_pruned_fused.py)."""
    steps = rng.integers(0, S, (B, T)).astype(np.int32)
    steps[:, 0] = 0
    hi = np.maximum(ll + 1 - S, 0)[:, None]
    ranges = np.minimum(np.cumsum(steps, axis=1), hi).astype(np.int32)
    ranges[np.arange(B), np.maximum(il - 1, 0)] = hi[:, 0]
    for b in range(B):
        for t in range(il[b] - 1, 0, -1):
            ranges[b, t - 1] = max(ranges[b, t - 1], ranges[b, t] - (S - 1))
        ranges[b, il[b]:] = ranges[b, il[b] - 1]
    ranges[:, 0] = 0
    return ranges


def _problem(seed=0, B=2, T=7, U=5, V=6, H=8, S=3, ragged=True, blank=0):
    rng = np.random.default_rng(seed)
    e = (rng.standard_normal((B, T, H)) * 0.5).astype(np.float32)
    p = (rng.standard_normal((B, U, H)) * 0.5).astype(np.float32)
    W = (rng.standard_normal((H, V)) / np.sqrt(H)).astype(np.float32)
    bias = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(0, V - 1, (B, U - 1))
    labels = (labels + (labels >= blank)).astype(np.int32)
    if ragged:
        il = np.array([T] + list(rng.integers(max(T - 2, 1), T + 1, B - 1)), np.int32)
        ll = np.array([U - 1] + list(rng.integers(max(U - 3, 0), U, B - 1)), np.int32)
    else:
        il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    return (e, p, W, bias), (_ranges(rng, B, T, S, il, ll), labels, il, ll), S


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _torch(floats, ints, S, fn=rnnt_loss_pruned_fused, **kw):
    leaves = [x.requires_grad_(True) for x in _t(*floats)]
    costs = fn(*leaves, *_t(*ints), S, reduction="none", **kw)
    grads = torch.autograd.grad(costs.sum(), leaves)
    return costs.detach().numpy(), [g.numpy() for g in grads]


def _jax(floats, ints, S, impl="xla", **kw):
    jints = [jnp.asarray(x) for x in ints]

    def total(*a):
        costs = JPF.rnnt_loss_pruned_fused(*a, *jints, s_range=S, reduction="none",
                                           implementation=impl, **kw)
        return jnp.sum(costs), costs

    (_, costs), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(x) for x in floats])
    return np.asarray(costs), [np.asarray(g) for g in grads]


def _assert_same(got, want, atol=2e-5):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(NAMES, got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_matches_jax(seed, impl, route):
    prob = _problem(seed=seed)
    _assert_same(_torch(*prob), _jax(*prob, impl))


def _unfused(e, p, W, bias, ranges, labels, il, ll, S, reduction, **kw):
    acts = torch.tanh(e[:, :, None, :] + gather_banded(p, ranges, S)) @ W + bias
    return rnnt_loss_pruned(acts, ranges, labels, il, ll, reduction=reduction, **kw)


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_unfused_composition(seed, sweep):
    prob = _problem(seed=seed, T=9, U=6, V=8)
    _assert_same(_torch(*prob), _torch(*prob, fn=_unfused))


def test_routes_agree(monkeypatch):
    floats, ints, S = _problem(seed=5)
    out = {}
    for name, mb in ROUTES.items():
        monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", mb)
        out[name] = _torch(floats, ints, S)
    _assert_same(out["sweep"], out["materialise"])


def test_full_band_equals_dense_fused(sweep):
    """S = U, ranges = 0: the band covers the lattice, so the loss and all
    four gradients equal the dense fused joint's."""
    floats, (_, labels, il, ll), _ = _problem(seed=6, ragged=False)
    B, T, _ = floats[0].shape
    U = floats[1].shape[1]
    got = _torch(floats, (np.zeros((B, T), np.int32), labels, il, ll), U)
    leaves = [x.requires_grad_(True) for x in _t(*floats)]
    dense = rnnt_loss_fused_joint(*leaves, *_t(labels, il, ll), reduction="none")
    grads = torch.autograd.grad(dense.sum(), leaves)
    _assert_same(got, (dense.detach().numpy(), [g.numpy() for g in grads]))


@pytest.mark.parametrize("kw", [{"fastemit_lambda": 0.4}, {"blank": 5}, {"delay_penalty": 0.2}],
                         ids=["fastemit", "blank_last", "delay"])
def test_options_match_jax(kw, route):
    prob = _problem(seed=7, blank=kw.get("blank", 0))
    _assert_same(_torch(*prob, **kw), _jax(*prob, **kw))


def test_several_t_chunks(sweep, monkeypatch):
    """Chunks of 5 frames over T = 12 (a ragged last chunk), and one frame
    per chunk, give what one chunk gives."""
    prob = _problem(seed=8, T=12)
    want = _torch(*prob)
    monkeypatch.setattr(pruned_fused, "_t_chunk", lambda *a: 5)
    five = _torch(*prob)
    monkeypatch.undo()
    monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", 0)
    monkeypatch.setattr(fused_joint, "_T_CHUNK_MB", 0)
    assert pruned_fused._t_chunk(2, 12, 3, 8, 6) == 1
    one = _torch(*prob)
    for got in (five, one):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        for name, a, b in zip(NAMES, got[1], want[1]):
            np.testing.assert_allclose(a, b, atol=2e-6, err_msg=name)


def test_infeasible_band(route):
    """U_b - 1 = 7 > T_b·(S - 1) = 3: no path inside the band reaches the
    terminal cell. The cost is about 1e30 and finite, every gradient exactly
    zero and free of NaN; a feasible utterance beside it is untouched."""
    B, T, U, V, H, S = 2, 3, 8, 6, 8, 2
    (e, p, W, bias), _, _ = _problem(seed=9, B=B, T=T, U=U, V=V, H=H, S=S)
    rng = np.random.default_rng(9)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il = np.array([T, T], np.int32)
    ll = np.array([U - 1, 2], np.int32)
    ranges = np.array([[0, 1, 2], [0, 0, 1]], np.int32)
    costs, grads = _torch((e, p, W, bias), (ranges, labels, il, ll), S)
    assert np.isfinite(costs).all() and costs[0] > 1e29 and costs[1] < 1e3
    assert all(np.isfinite(g).all() for g in grads)
    assert np.count_nonzero(grads[0][0]) == 0 and np.count_nonzero(grads[1][0]) == 0
    alone = _torch((e[1:], p[1:], W, bias), (ranges[1:], labels[1:], il[1:], ll[1:]), S)
    np.testing.assert_allclose(costs[1:], alone[0], rtol=1e-6)
    for name, a, b in zip(NAMES[2:], grads[2:], alone[1][2:]):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)


def test_bf16_weights(sweep):
    """bf16 e, p, W through the sweep: close to the f32 loss, gradients in
    the types of their inputs."""
    (e, p, W, bias), ints, S = _problem(seed=10, ragged=False)
    leaves = [x.to(torch.bfloat16).requires_grad_(True) for x in _t(e, p, W)]
    leaves.append(torch.tensor(bias, requires_grad=True))
    costs = rnnt_loss_pruned_fused(*leaves, *_t(*ints), S, reduction="none")
    grads = torch.autograd.grad(costs.sum(), leaves)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32]
    f32 = rnnt_loss_pruned_fused(*[x.detach().float() for x in leaves], *_t(*ints), S,
                                 reduction="none")
    np.testing.assert_allclose(costs.detach().float().numpy(), f32.numpy(), rtol=3e-2)


def test_reductions_and_validation():
    floats, ints, S = _problem(seed=11)
    ten, args = _t(*floats), _t(*ints)
    none = rnnt_loss_pruned_fused(*ten, *args, S, reduction="none")
    assert none.shape == (floats[0].shape[0],)
    total = rnnt_loss_pruned_fused(*ten, *args, S, reduction="sum")
    mean = rnnt_loss_pruned_fused(*ten, *args, s_range=S)
    np.testing.assert_allclose(float(total), float(none.sum()), rtol=1e-6)
    np.testing.assert_allclose(float(mean), float(none.mean()), rtol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        rnnt_loss_pruned_fused(*ten, *args, S, reduction="avg")
    with pytest.raises(ValueError, match="s_range"):
        rnnt_loss_pruned_fused(*ten, *args, 1)
    with pytest.raises(ValueError, match="ranges"):
        rnnt_loss_pruned_fused(*ten, args[0][:, :2], *args[1:], S)
    with pytest.raises(ValueError, match="fastemit"):
        rnnt_loss_pruned_fused(*ten, *args, S, fastemit_lambda=-1)
    with pytest.raises(ValueError, match="delay_penalty"):
        rnnt_loss_pruned_fused(*ten, *args, S, delay_penalty=-1)
    with pytest.raises(ValueError, match="expected"):
        rnnt_loss_pruned_fused(ten[0][0], *ten[1:], *args, S)
    with pytest.raises(ValueError, match="disagree"):
        rnnt_loss_pruned_fused(ten[0], ten[1][:, :, :4], *ten[2:], *args, S)
    with pytest.raises(ValueError, match="labels must be"):
        rnnt_loss_pruned_fused(*ten, args[0], args[1][:, :1], *args[2:], S)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_pruned_fused(*ten, *args, S, implementation="cuda")


def test_products_are_ieee_f32_under_a_global_tf32_setting(route, monkeypatch):
    """``torch.set_float32_matmul_precision("high")`` reaches neither route:
    every ``torch.matmul`` of the sweeps and of the materialised band, its
    backward included, runs with the CUDA switch at "ieee", the results do
    not move, and the caller's setting is what it was afterwards."""
    seen = []
    matmul = torch.matmul

    def recording(*a, **kw):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return matmul(*a, **kw)

    floats, ints, S = _problem(seed=7)
    want = _torch(floats, ints, S)
    old = torch.get_float32_matmul_precision()
    monkeypatch.setattr(torch, "matmul", recording)
    try:
        torch.set_float32_matmul_precision("high")
        got = _torch(floats, ints, S)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision(old)
    # the sweep: two prep and grad products a chunk; the band: forward and backward
    assert len(seen) >= 3 and set(seen) == {"ieee"}, seen
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
