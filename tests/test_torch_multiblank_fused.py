"""``rnnt_loss_multiblank_fused_joint`` of warp_transducer_tpu_torch
(ops/multiblank_fused.py) on the CPU, held against the JAX package's
function of that name with its XLA engine and with its Pallas kernels in
interpret mode (``fused_prep_mb`` / ``fused_grad_mb``), and against the
port's own unfused composition (``rnnt_loss_multiblank`` on the materialised
logits).

The same inputs, made with numpy from a seed, go to both packages; the port
runs its plain PyTorch versions here (CPU tensors). Tolerances, as
tests/test_tdt.py for the fused duration-arc losses: costs rtol 1e-5, all
four gradients rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import multiblank_fused as JMF
from warp_transducer_tpu_torch import (rnnt_loss_fused_joint, rnnt_loss_multiblank,
                                       rnnt_loss_multiblank_fused_joint)
from jax_programs import release_compiled_programs  # noqa: F401

COST = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
NAMES = ("de", "dp", "dW", "db")


def _problem(seed, B=3, T=9, U=4, V=11, H=8, K=2, ragged=True, blank=0):
    """Labels stay off the blank and off the last K columns."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    floats = (f(B, T, H, scale=0.5), f(B, U, H, scale=0.5), f(H, V, scale=1 / np.sqrt(H)),
              f(V, scale=0.1))
    labels = rng.integers(0, V - K - 1, (B, U - 1))
    labels = (labels + (labels >= blank)).astype(np.int32)
    if ragged:
        il = rng.integers(max(2, T - 4), T + 1, B).astype(np.int32)
        ll = rng.integers(0, U, B).astype(np.int32)
        il[0], ll[0], ll[-1] = T, U - 1, 0  # one full utterance, one without labels
    else:
        il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    return floats, (labels, il, ll)


def _port(floats, ints, durs, fn=rnnt_loss_multiblank_fused_joint, scale=None, **kw):
    leaves = [torch.tensor(x).requires_grad_(True) for x in floats]
    costs = fn(*leaves, *map(torch.tensor, ints), durs, reduction="none", **kw)
    weighted = costs if scale is None else costs * torch.tensor(scale)
    grads = torch.autograd.grad(weighted.sum(), leaves)
    return costs.detach().numpy(), [g.numpy() for g in grads]


def _jax(floats, ints, durs, impl, scale=None, **kw):
    ints = [jnp.asarray(x) for x in ints]
    w = 1.0 if scale is None else jnp.asarray(scale)

    def total(*a):
        costs = JMF.rnnt_loss_multiblank_fused_joint(*a, *ints, durs, reduction="none",
                                                     implementation=impl, **kw)
        return jnp.sum(costs * w), costs

    (_, costs), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(x) for x in floats])
    return np.asarray(costs), [np.asarray(g) for g in grads]


def _unfused(e, p, W, bias, labels, il, ll, durs, reduction, **kw):
    acts = torch.tanh(e[:, :, None, :] + p[:, None, :, :]) @ W + bias
    return rnnt_loss_multiblank(acts, labels, il, ll, durs, reduction=reduction, **kw)


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **COST)
    for name, a, b in zip(NAMES, got[1], want[1]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,durs,ragged", [
    (0, 2, 6, 4, 9, 16, (2, 3), False),
    (1, 3, 9, 5, 11, 8, (2, 4), True),
    (2, 2, 9, 3, 300, 16, (2, 3, 5), True),
    (3, 2, 8, 4, 12, 8, (3,), True),
], ids=["uniform", "ragged", "V300_K3", "K1"])
def test_matches_jax(seed, B, T, U, V, H, durs, ragged, impl):
    prob = _problem(seed, B, T, U, V, H, K=len(durs), ragged=ragged)
    _assert_same(_port(*prob, durs), _jax(*prob, durs, impl))


OPTIONS = [{"sigma": 0.05}, {"fastemit_lambda": 0.3}, {"delay_penalty": 0.2},
           {"sigma": 0.05, "fastemit_lambda": 0.2, "delay_penalty": 0.1},
           {"blank": 4, "sigma": 0.05}]
OPTION_IDS = ["sigma", "fastemit", "delay", "all", "blank4"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kw", OPTIONS, ids=OPTION_IDS)
def test_options_match_jax(kw, impl):
    prob = _problem(4, blank=kw.get("blank", 0))
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    _assert_same(_port(*prob, (2, 4), scale=scale, **kw),
                 _jax(*prob, (2, 4), impl, scale=scale, **kw))


@pytest.mark.parametrize("kw", OPTIONS, ids=OPTION_IDS)
def test_matches_unfused_composition(kw):
    """The port's own identity: ``rnnt_loss_multiblank`` on the
    materialised joint logits."""
    prob = _problem(5, blank=kw.get("blank", 0))
    _assert_same(_port(*prob, (2, 4), **kw), _port(*prob, (2, 4), fn=_unfused, **kw))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_explicit_big_blank_indices(impl):
    """Big blanks on columns of the caller's choice, in the caller's order."""
    floats, (labels, il, ll) = _problem(6, V=12, K=0)
    labels = np.where(np.isin(labels, (3, 7)), 9, labels).astype(np.int32)
    prob = (floats, (labels, il, ll))
    kw = dict(big_blank_indices=(7, 3), sigma=0.05)
    got = _port(*prob, (2, 4), **kw)
    _assert_same(got, _jax(*prob, (2, 4), impl, **kw))
    _assert_same(got, _port(*prob, (2, 4), fn=_unfused, **kw))
    swapped = _port(*prob, (2, 4), big_blank_indices=(3, 7), sigma=0.05)
    assert not np.allclose(got[0], swapped[0], rtol=1e-4)


def test_no_big_blanks_is_the_fused_joint_loss():
    """K = 0: the standard lattice through the same stages; as the JAX
    function at K = 0, and equal to ``rnnt_loss_fused_joint``."""
    prob = _problem(7, K=0)
    got = _port(*prob, ())
    _assert_same(got, _jax(*prob, (), "xla"))

    def fused(e, p, W, bias, labels, il, ll, durs, reduction):
        return rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, reduction=reduction)

    _assert_same(got, _port(*prob, (), fn=fused))
    _assert_same(_port(*prob, (), sigma=0.05), _jax(*prob, (), "xla", sigma=0.05))


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_reductions_match_jax(reduction):
    floats, ints = _problem(8)
    got = rnnt_loss_multiblank_fused_joint(*map(torch.tensor, floats + ints), (2, 4),
                                           reduction=reduction, sigma=0.05)
    want = JMF.rnnt_loss_multiblank_fused_joint(*map(jnp.asarray, floats + ints), (2, 4),
                                                reduction=reduction, sigma=0.05,
                                                implementation="xla")
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COST)


def test_bf16_inputs():
    """bf16 e, p, W: close to the f32 loss (rtol 3e-2, as the fused-joint
    tests), closer to the JAX package's bf16 result, and gradients in the
    types of their inputs."""
    floats, ints = _problem(9, ragged=False)
    bf = torch.bfloat16
    leaves = [torch.tensor(x).to(bf if i < 3 else torch.float32).requires_grad_(True)
              for i, x in enumerate(floats)]
    costs = rnnt_loss_multiblank_fused_joint(*leaves, *map(torch.tensor, ints), (2, 4),
                                             reduction="none", sigma=0.05)
    grads = torch.autograd.grad(costs.sum(), leaves)
    assert costs.dtype == bf
    assert [g.dtype for g in grads] == [bf] * 3 + [torch.float32]
    f32 = rnnt_loss_multiblank_fused_joint(*[x.detach().float() for x in leaves],
                                           *map(torch.tensor, ints), (2, 4), reduction="none",
                                           sigma=0.05)
    np.testing.assert_allclose(costs.detach().float().numpy(), f32.numpy(), rtol=3e-2)
    ref = JMF.rnnt_loss_multiblank_fused_joint(
        *[jnp.asarray(x, jnp.bfloat16) for x in floats[:3]], jnp.asarray(floats[3]),
        *map(jnp.asarray, ints), (2, 4), reduction="none", sigma=0.05, implementation="xla")
    np.testing.assert_allclose(costs.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2)


def test_no_grad_gives_the_same_costs():
    floats, ints = _problem(10)
    args = [torch.tensor(x) for x in floats + ints]
    with torch.no_grad():
        a = rnnt_loss_multiblank_fused_joint(*args, (2, 4), reduction="none")
    np.testing.assert_array_equal(a.numpy(), _port(floats, ints, (2, 4))[0])


def test_validation():
    """Each ValueError of the JAX function's validation (``_resolve_indices``
    included), and the port's own for ``implementation``."""
    floats, ints = _problem(11)
    e, p, W, bias = map(torch.tensor, floats)
    labels, il, ll = map(torch.tensor, ints)
    call = rnnt_loss_multiblank_fused_joint
    with pytest.raises(ValueError, match="reduction"):
        call(e, p, W, bias, labels, il, ll, (2, 4), reduction="avg")
    with pytest.raises(ValueError, match="expected"):
        call(e[0], p, W, bias, labels, il, ll, (2, 4))
    with pytest.raises(ValueError, match="disagree"):
        call(e, p[:, :, :4], W, bias, labels, il, ll, (2, 4))
    with pytest.raises(ValueError, match="fastemit_lambda"):
        call(e, p, W, bias, labels, il, ll, (2, 4), fastemit_lambda=-1.0)
    with pytest.raises(ValueError, match="delay_penalty"):
        call(e, p, W, bias, labels, il, ll, (2, 4), delay_penalty=-1.0)
    with pytest.raises(ValueError, match="all be >= 2"):
        call(e, p, W, bias, labels, il, ll, (1, 4))
    with pytest.raises(ValueError, match="distinct"):
        call(e, p, W, bias, labels, il, ll, (2, 2))
    with pytest.raises(ValueError, match="1 entries for 2 durations"):
        call(e, p, W, bias, labels, il, ll, (2, 4), big_blank_indices=(9,))
    with pytest.raises(ValueError, match="distinct in-range and != blank"):
        call(e, p, W, bias, labels, il, ll, (2, 4), big_blank_indices=(0, 9))
    with pytest.raises(ValueError, match="distinct in-range and != blank"):
        call(e, p, W, bias, labels, il, ll, (2, 4), big_blank_indices=(9, 11))
    # nine big blanks compute (the duration set has no cap)
    nine = call(e, p, W, bias, labels, il, ll, tuple(range(2, 11)),
                big_blank_indices=tuple(range(1, 10)), reduction="none")
    assert bool(torch.isfinite(nine).all())
    with pytest.raises(ValueError, match="implementation must be"):
        call(e, p, W, bias, labels, il, ll, (2, 4), implementation="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call(e, p, W, bias, labels, il, ll, (2, 4), implementation="cuda")
    with pytest.raises(ValueError, match="labels must be"):
        call(e, p, W, bias, labels[:, :1], il, ll, (2, 4))
