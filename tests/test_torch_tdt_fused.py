"""``rnnt_loss_tdt_fused_joint`` of warp_transducer_tpu_torch
(ops/tdt_fused.py) on the CPU, held against the JAX package's function of
that name with its XLA engine and with its Pallas kernels in interpret mode
(the integrated ``fused_prep_tdt`` / ``fused_grad_tdt``), against the port's
own unfused composition (``rnnt_loss_tdt`` on the materialised heads), and
its two routes, integrated and composed, against each other.

The same inputs, made with numpy from a seed, go to both packages; the port
runs its plain PyTorch versions here (CPU tensors). Tolerances, as
tests/test_tdt.py: costs rtol 1e-5, all six gradients rtol 1e-4 / atol 1e-5
(sums over rows and V in another order; exp(α + β − ll) turns the lattice's
rounding into a relative error of the gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import tdt_fused as JTF
from warp_transducer_tpu_torch import rnnt_loss_tdt, rnnt_loss_tdt_fused_joint
from warp_transducer_tpu_torch.ops import tdt_fused

COST = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
NAMES = ("de", "dp", "dW", "db", "dWd", "dbd")
DURS = (0, 1, 2, 4)


def _problem(seed, B=3, T=9, U=4, V=11, H=8, durs=DURS, ragged=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    D = len(durs)
    floats = (f(B, T, H, scale=0.5), f(B, U, H, scale=0.5), f(H, V, scale=1 / np.sqrt(H)),
              f(V, scale=0.1), f(H, D, scale=1 / np.sqrt(H)), f(D, scale=0.1))
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    if ragged:
        il = rng.integers(max(2, T - 4), T + 1, B).astype(np.int32)
        ll = rng.integers(0, U, B).astype(np.int32)
        il[0], ll[0], ll[-1] = T, U - 1, 0  # one full utterance, one without labels
    else:
        il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    return floats, (labels, il, ll)


def _port(floats, ints, durs=DURS, fn=rnnt_loss_tdt_fused_joint, scale=None, **kw):
    leaves = [torch.tensor(x).requires_grad_(True) for x in floats]
    costs = fn(*leaves, *map(torch.tensor, ints), durations=durs, reduction="none", **kw)
    weighted = costs if scale is None else costs * torch.tensor(scale)
    grads = torch.autograd.grad(weighted.sum(), leaves)
    return costs.detach().numpy(), [g.numpy() for g in grads]


def _jax(floats, ints, impl, durs=DURS, scale=None, **kw):
    ints = [jnp.asarray(x) for x in ints]
    w = 1.0 if scale is None else jnp.asarray(scale)

    def total(*a):
        costs = JTF.rnnt_loss_tdt_fused_joint(*a, *ints, durations=durs, reduction="none",
                                              implementation=impl, **kw)
        return jnp.sum(costs * w), costs

    (_, costs), grads = jax.value_and_grad(total, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(x) for x in floats])
    return np.asarray(costs), [np.asarray(g) for g in grads]


def _unfused(e, p, W, bias, Wd, bias_d, labels, il, ll, durations, reduction, **kw):
    h = torch.tanh(e[:, :, None, :] + p[:, None, :, :])
    return rnnt_loss_tdt(h @ W + bias, h @ Wd + bias_d, labels, il, ll, durations,
                         reduction=reduction, **kw)


def _assert_same(got, want, cost=COST, grad=GRAD):
    np.testing.assert_allclose(got[0], want[0], **cost)
    for name, a, b in zip(NAMES, got[1], want[1]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **grad)


@pytest.fixture(params=["integrated", "composed"])
def route(request, monkeypatch):
    """Both routes of the port, through the predicate that picks one."""
    monkeypatch.setattr(tdt_fused, "_tdt_single_chunk",
                        lambda *a: request.param == "integrated")
    return request.param


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,ragged", [(0, 2, 6, 4, 9, 16, False),
                                                   (1, 3, 9, 5, 11, 8, True),
                                                   (2, 2, 9, 3, 300, 16, True)])
def test_matches_jax(seed, B, T, U, V, H, ragged, impl, route):
    prob = _problem(seed, B, T, U, V, H, ragged=ragged)
    _assert_same(_port(*prob), _jax(*prob, impl))


# durations, sigma, FastEmit λ, delay penalty: the grid of tests/test_tdt.py
GRID = [((0, 1, 2, 4), 0.05, 0.0, 0.0), ((1, 2, 3), 0.0, 0.25, 0.0),
        ((0, 1, 3), 0.05, 0.1, 0.02), ((0, 1, 2, 3, 4), 0.0, 0.0, 0.2)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("durs,sigma,lam,delay", GRID, ids=str)
def test_options_match_jax(durs, sigma, lam, delay, impl, route):
    prob = _problem(3, durs=durs)
    kw = dict(durs=durs, sigma=sigma, fastemit_lambda=lam, delay_penalty=delay,
              scale=np.array([0.5, 1.0, 2.0], np.float32))
    _assert_same(_port(*prob, **kw), _jax(*prob, impl, **kw))


@pytest.mark.parametrize("durs,sigma,lam,delay", GRID, ids=str)
def test_matches_unfused_composition(durs, sigma, lam, delay, route):
    """The port's own identity: ``rnnt_loss_tdt`` on both materialised heads."""
    prob = _problem(4, durs=durs)
    kw = dict(durs=durs, sigma=sigma, fastemit_lambda=lam, delay_penalty=delay)
    _assert_same(_port(*prob, **kw), _port(*prob, fn=_unfused, **kw))


def test_routes_agree(monkeypatch):
    """Integrated and composed: the same costs to the bit (the duration
    logits come from the same products), the gradients to rounding."""
    prob = _problem(5, B=3, T=10, U=5, V=40, H=16)
    kw = dict(sigma=0.05, fastemit_lambda=0.1, delay_penalty=0.02)
    out = {}
    for integrated in (True, False):
        monkeypatch.setattr(tdt_fused, "_tdt_single_chunk", lambda *a: integrated)
        out[integrated] = _port(*prob, **kw)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    _assert_same(out[True], out[False], grad=dict(rtol=1e-5, atol=1e-6))


def test_route_predicate_is_asked_with_the_inputs(monkeypatch):
    """``_tdt_single_chunk(e, p, W)`` keeps the JAX package's name and
    arguments and decides once per call."""
    (e, p, W, *rest), ints = _problem(6)
    seen = []

    def predicate(*a):
        seen.append([tuple(x.shape) for x in a])
        return False

    monkeypatch.setattr(tdt_fused, "_tdt_single_chunk", predicate)
    _port((e, p, W, *rest), ints)
    assert seen == [[e.shape, p.shape, W.shape]]
    assert isinstance(tdt_fused._tdt_single_chunk.__name__, str)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_reductions_match_jax(reduction, route):
    floats, ints = _problem(7)
    got = rnnt_loss_tdt_fused_joint(*map(torch.tensor, floats + ints), durations=DURS,
                                    reduction=reduction)
    want = JTF.rnnt_loss_tdt_fused_joint(*map(jnp.asarray, floats + ints), durations=DURS,
                                         reduction=reduction, implementation="xla")
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COST)


def test_infeasible_utterance(route):
    """Durations (2, 4) and T_b = 5: no path consumes the frames. The cost is
    the finite sentinel and all six gradients are exactly zero, by a select
    and never 0·inf (tests/test_tdt.py::TestTDTFusedJoint::
    test_infeasible_zero_grads); the feasible utterance beside it (T_b = 4)
    keeps its gradients."""
    floats, (labels, _, _) = _problem(8, B=2, T=5, U=2, V=6, H=4, durs=(2, 4))
    ints = (labels, np.array([5, 4], np.int32), np.array([1, 1], np.int32))
    costs, grads = _port(floats, ints, durs=(2, 4), scale=np.array([1.0, 0.0], np.float32))
    assert costs[0] > 1e29 and np.isfinite(costs).all() and costs[1] < 1e29
    for name, g in zip(NAMES, grads):
        assert not g.any(), name
    want = _jax(floats, ints, "xla", durs=(2, 4))
    np.testing.assert_allclose(costs, want[0], rtol=1e-5)
    both = _port(floats, ints, durs=(2, 4))
    for name, a, b in zip(NAMES, both[1], want[1]):
        assert np.isfinite(a).all() and a.any(), name
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


def test_bf16_inputs(route):
    """bf16 e, p, W: close to the f32 loss (rtol 3e-2, as the fused-joint
    tests), close to the JAX package's bf16 result; gradients come back in
    the types of their inputs, the duration head's in f32."""
    floats, ints = _problem(9, ragged=False)
    bf = torch.bfloat16
    leaves = [torch.tensor(x).to(bf if i < 3 else torch.float32).requires_grad_(True)
              for i, x in enumerate(floats)]
    costs = rnnt_loss_tdt_fused_joint(*leaves, *map(torch.tensor, ints), durations=DURS,
                                      reduction="none")
    grads = torch.autograd.grad(costs.sum(), leaves)
    assert costs.dtype == bf
    assert [g.dtype for g in grads] == [bf] * 3 + [torch.float32] * 3
    f32 = rnnt_loss_tdt_fused_joint(*[x.detach().float() for x in leaves],
                                    *map(torch.tensor, ints), durations=DURS, reduction="none")
    np.testing.assert_allclose(costs.detach().float().numpy(), f32.numpy(), rtol=3e-2)
    ref = JTF.rnnt_loss_tdt_fused_joint(
        *[jnp.asarray(x, jnp.bfloat16) for x in floats[:3]], *map(jnp.asarray, floats[3:]),
        *map(jnp.asarray, ints), durations=DURS, reduction="none", implementation="xla")
    np.testing.assert_allclose(costs.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2)


def test_no_grad_and_partial_grads():
    """Without a leaf that needs a gradient no betas are computed; with
    only some leaves, the others' gradients are not asked for."""
    floats, ints = _problem(10)
    args = [torch.tensor(x) for x in floats + ints]
    with torch.no_grad():
        a = rnnt_loss_tdt_fused_joint(*args, durations=DURS, reduction="none")
    args[4].requires_grad_(True)  # Wd only
    b = rnnt_loss_tdt_fused_joint(*args, durations=DURS, reduction="none")
    np.testing.assert_array_equal(a.numpy(), b.detach().numpy())
    (g,) = torch.autograd.grad(b.sum(), [args[4]])
    want = _port(floats, ints)[1][4]
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-7)


def test_validation():
    """Each ValueError of the JAX function's validation, and the port's own
    for ``implementation``."""
    floats, ints = _problem(11)
    e, p, W, bias, Wd, bias_d = map(torch.tensor, floats)
    labels, il, ll = map(torch.tensor, ints)
    call = rnnt_loss_tdt_fused_joint
    with pytest.raises(ValueError, match="reduction"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, DURS, reduction="avg")
    with pytest.raises(ValueError, match="expected"):
        call(e[0], p, W, bias, Wd, bias_d, labels, il, ll, DURS)
    with pytest.raises(ValueError, match="expected Wd"):
        call(e, p, W, bias, Wd[0], bias_d, labels, il, ll, DURS)
    with pytest.raises(ValueError, match="disagree"):
        call(e, p[:, :, :4], W, bias, Wd, bias_d, labels, il, ll, DURS)
    with pytest.raises(ValueError, match="hidden/duration dims disagree"):
        call(e, p, W, bias, Wd[:4], bias_d, labels, il, ll, DURS)
    with pytest.raises(ValueError, match="hidden/duration dims disagree"):
        call(e, p, W, bias, Wd, bias_d[:3], labels, il, ll, DURS)
    with pytest.raises(ValueError, match="4 columns for 3 durations"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, (0, 1, 2))
    with pytest.raises(ValueError, match="durations must be >= 0"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, (0, 1, -2, 4))
    with pytest.raises(ValueError, match="distinct"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, (0, 1, 1, 4))
    with pytest.raises(ValueError, match="at least one duration"):
        call(e, p, W, bias, Wd[:, :1], bias_d[:1], labels, il, ll, (0,))
    with pytest.raises(ValueError, match="fastemit_lambda"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, DURS, fastemit_lambda=-1.0)
    with pytest.raises(ValueError, match="delay_penalty"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, DURS, delay_penalty=-1.0)
    with pytest.raises(ValueError, match="implementation must be"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, DURS, implementation="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call(e, p, W, bias, Wd, bias_d, labels, il, ll, DURS, implementation="cuda")
    with pytest.raises(ValueError, match="labels must be"):
        call(e, p, W, bias, Wd, bias_d, labels[:, :1], il, ll, DURS)
