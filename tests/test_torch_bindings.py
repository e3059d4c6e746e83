"""The port's ``warprnnt_pytorch`` surface (``bindings/torch_binding.py``) on
CPU tensors: every name against the port's entry point under the binding's
conventions (shape (1,) for "sum" / "mean", "mean" over B), against the JAX
package's function of the same family, and ``rnnt_loss`` / ``RNNTLoss``
against the JAX package's own binding (``backend="jax"``, and
``backend="native"`` where its C++ library is built); the multi-blank
loss on log-probs through torch's log_softmax against the JAX package's
raw-activation loss (and against its binding's native log-probs mode where
built); and the binding's ``TypeError`` / ``ValueError`` cases.

Inputs are made with numpy from a seed. Tolerances: against the port's
entry point, equal up to the one division of "mean" (rtol 1e-6); against
the JAX package, f32 costs rtol 1e-5 and gradients rtol 1e-4 / atol 1e-5
(sums taken in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warp_transducer_tpu as J
import warp_transducer_tpu_torch as W
from jax_programs import release_compiled_programs  # noqa: F401
from warp_transducer_tpu.bindings import native
from warp_transducer_tpu.bindings import torch_binding as jax_binding
from warp_transducer_tpu_torch.bindings import torch_binding as tb

COST = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
SAME = dict(rtol=1e-6, atol=0)
B, T, L, V, H, S = 3, 6, 3, 7, 5, 2
BIG_BLANKS = (2, 3)
DURATIONS = (0, 1, 2)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    steps = rng.integers(0, 2, (B, T))
    steps[:, 0] = 0
    ll = np.array([L, L - 1, L - 2], np.int32)
    return {
        "acts": f(B, T, L + 1, V), "dur": f(B, T, L + 1, len(DURATIONS)),
        "am": f(B, T, V), "lm": f(B, L + 1, V), "band": f(B, T, S, V),
        "e": f(B, T, H) * 0.5, "p": f(B, L + 1, H) * 0.5, "W": f(H, V) / np.sqrt(H),
        "bias": f(V) * 0.1, "Wd": f(H, len(DURATIONS)) / np.sqrt(H),
        "bias_d": f(len(DURATIONS)) * 0.1,
        # labels below V - 2, off the multi-blank loss's two big blanks
        "labels": rng.integers(1, V - 2, (B, L)).astype(np.int32),
        "il": np.array([T, T - 1, T - 2], np.int32), "ll": ll,
        "ranges": np.minimum(np.cumsum(steps, 1), np.maximum(ll[:, None] + 1 - S, 0))
        .astype(np.int32),
    }


# name: (differentiable inputs, other inputs, keyword arguments, fused?)
FAMILIES = {
    "rnnt_loss": (("acts",), (), dict(fastemit_lambda=0.1), False),
    "rnnt_loss_simple": (("am", "lm"), (), {}, False),
    "rnnt_loss_fused_joint": (("e", "p", "W", "bias"), (), {}, True),
    "rnnt_loss_pruned": (("band",), ("ranges",), {}, False),
    "rnnt_loss_pruned_fused": (("e", "p", "W", "bias"), ("ranges",), dict(s_range=S), True),
    "rnnt_loss_multiblank": (("acts",), (), dict(big_blank_durations=BIG_BLANKS, sigma=0.05),
                             False),
    "rnnt_loss_tdt": (("acts", "dur"), (), dict(durations=DURATIONS), False),
    "rnnt_loss_multiblank_fused": (("e", "p", "W", "bias"), (),
                                   dict(big_blank_durations=BIG_BLANKS, sigma=0.05), True),
    "rnnt_loss_tdt_fused": (("e", "p", "W", "bias", "Wd", "bias_d"), (),
                            dict(durations=DURATIONS), True),
}
# The port's and the JAX package's entry point of each family.
PORT = {"rnnt_loss": W.rnnt_loss, "rnnt_loss_simple": W.rnnt_loss_simple,
        "rnnt_loss_fused_joint": W.rnnt_loss_fused_joint, "rnnt_loss_pruned": W.rnnt_loss_pruned,
        "rnnt_loss_pruned_fused": W.rnnt_loss_pruned_fused,
        "rnnt_loss_multiblank": W.rnnt_loss_multiblank, "rnnt_loss_tdt": W.rnnt_loss_tdt,
        "rnnt_loss_multiblank_fused": W.rnnt_loss_multiblank_fused_joint,
        "rnnt_loss_tdt_fused": W.rnnt_loss_tdt_fused_joint}
JAX = {"rnnt_loss": J.rnnt_loss, "rnnt_loss_simple": J.rnnt_loss_simple,
       "rnnt_loss_fused_joint": J.rnnt_loss_fused_joint, "rnnt_loss_pruned": J.rnnt_loss_pruned,
       "rnnt_loss_pruned_fused": J.rnnt_loss_pruned_fused,
       "rnnt_loss_multiblank": J.rnnt_loss_multiblank, "rnnt_loss_tdt": J.rnnt_loss_tdt,
       "rnnt_loss_multiblank_fused": J.rnnt_loss_multiblank_fused_joint,
       "rnnt_loss_tdt_fused": J.rnnt_loss_tdt_fused_joint}


def _call(fn, name, problem, reduction, wrap, **extra):
    grads, others, kw, _ = FAMILIES[name]
    args = [wrap(problem[k], True) for k in grads] + [wrap(problem[k], False) for k in others]
    ints = [wrap(problem[k], False) for k in ("labels", "il", "ll")]
    return args, fn(*args, *ints, reduction=reduction, **kw, **extra)


def _torch(x, grad):
    t = torch.tensor(x)
    return t.requires_grad_(True) if grad else t


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_binding_matches_the_port_and_jax(name):
    problem = _problem()
    fused = FAMILIES[name][3]
    binding = getattr(tb, name)
    # against the port's entry point: "none" equal, "sum" and "mean" of shape (1,)
    _, port_costs = _call(PORT[name], name, problem, "none", _torch)
    if not fused:
        _, costs = _call(binding, name, problem, "none", _torch)
        np.testing.assert_allclose(costs.detach().numpy(), port_costs.detach().numpy(), **SAME)
    for reduction, scale in (("sum", 1.0), ("mean", 1.0 / B)):
        args, got = _call(binding, name, problem, reduction, _torch)
        assert got.shape == (1,)
        np.testing.assert_allclose(got.detach().numpy(),
                                   [float(port_costs.detach().sum()) * scale], **SAME)
        got.backward()
        port_args, want = _call(PORT[name], name, problem, reduction, _torch)
        want.backward()
        for a, b in zip(args, port_args):
            if a.requires_grad:
                np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6, atol=1e-7)
    # against the JAX function of the same family: the costs and the gradient of their sum
    grads_at = FAMILIES[name][0]

    def jax_sum(*diff):
        sub = dict(problem) | dict(zip(grads_at, diff))
        _, c = _call(JAX[name], name, sub, "none", lambda x, g: jnp.asarray(x),
                     implementation="xla")
        return jnp.sum(c), c

    (_, want_costs), want_grads = jax.value_and_grad(jax_sum, argnums=tuple(
        range(len(grads_at))), has_aux=True)(*(jnp.asarray(problem[k]) for k in grads_at))
    args, got = _call(binding, name, problem, "sum", _torch)
    got.backward()
    np.testing.assert_allclose(port_costs.detach().numpy(), np.asarray(want_costs), **COST)
    for a, g in zip(args, want_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("from_log_probs", [False, True])
def test_rnnt_loss_matches_the_jax_binding(reduction, from_log_probs):
    """``rnnt_loss`` and ``RNNTLoss`` against the JAX package's binding
    (``backend="jax"``, and ``backend="native"`` where its library is
    built): values and gradients under every reduction."""
    problem = _problem(1)
    acts = problem["acts"]
    if from_log_probs:
        acts = np.asarray(torch.log_softmax(torch.tensor(acts), -1))
    ints = [torch.tensor(problem[k]) for k in ("labels", "il", "ll")]
    backends = ["jax"] + (["native"] if native.available() else [])
    kw = dict(blank=0, reduction=reduction, from_log_probs=from_log_probs, fastemit_lambda=0.1)
    for module in (False, True):
        a = torch.tensor(acts, requires_grad=True)
        got = tb.RNNTLoss(**kw)(a, *ints) if module else tb.rnnt_loss(a, *ints, **kw)
        got.sum().backward()
        for backend in backends:
            r = torch.tensor(acts, requires_grad=True)
            want = (jax_binding.RNNTLoss(**kw, backend=backend)(r, *ints) if module
                    else jax_binding.rnnt_loss(r, *ints, **kw, backend=backend))
            want.sum().backward()
            assert got.shape == want.shape
            np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **COST)
            np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), **GRAD)


@functools.lru_cache(maxsize=None)
def _jax_multiblank_reference():
    """The JAX package's multi-blank loss on raw activations (XLA engine,
    jitted): its costs and the gradient of their sum, on ``_problem(2)``."""
    problem = _problem(2)
    ints = [jnp.asarray(problem[k]) for k in ("labels", "il", "ll")]

    def total(a):
        c = J.rnnt_loss_multiblank(a, *ints, BIG_BLANKS, reduction="none",
                                   implementation="xla", **MB_LOG_PROBS_KW)
        return jnp.sum(c), c

    (_, costs), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(problem["acts"]))
    return np.asarray(costs), np.asarray(grad)


MB_LOG_PROBS_KW = dict(sigma=0.05, fastemit_lambda=0.1, delay_penalty=0.01)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_multiblank_log_probs_matches_the_jax_package(reduction):
    """``rnnt_loss_multiblank(from_log_probs=True)`` on log_softmax(acts),
    differentiated back through torch's log_softmax into acts, is the JAX
    package's raw-activation loss of acts, values and gradients; and the
    JAX binding's log-probs mode on the same log-probs (its native engine)
    where that library is built."""
    problem = _problem(2)
    ints = [torch.tensor(problem[k]) for k in ("labels", "il", "ll")]
    kw = dict(reduction=reduction, from_log_probs=True, **MB_LOG_PROBS_KW)
    x = torch.tensor(problem["acts"], requires_grad=True)
    got = tb.rnnt_loss_multiblank(torch.log_softmax(x, -1), *ints, BIG_BLANKS, **kw)
    got.sum().backward()
    costs, grad = _jax_multiblank_reference()
    scale = 1.0 / B if reduction == "mean" else 1.0
    want = costs if reduction == "none" else [costs.sum() * scale]
    assert got.shape == ((B,) if reduction == "none" else (1,))
    np.testing.assert_allclose(got.detach().numpy(), want, **COST)
    np.testing.assert_allclose(x.grad.numpy(), grad * scale, **GRAD)
    if native.available():
        lp = torch.log_softmax(torch.tensor(problem["acts"]), -1)
        a, r = lp.clone().requires_grad_(True), lp.clone().requires_grad_(True)
        got = tb.rnnt_loss_multiblank(a, *ints, BIG_BLANKS, **kw)
        want = jax_binding.rnnt_loss_multiblank(r, *ints, BIG_BLANKS, **kw)
        got.sum().backward()
        want.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **COST)
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), **GRAD)


def test_rnnt_loss_module_attributes():
    loss = tb.RNNTLoss(blank=2, reduction="sum", from_log_probs=True, fastemit_lambda=0.5,
                       delay_penalty=0.25)
    assert (loss.blank, loss.reduction, loss.from_log_probs, loss.fastemit_lambda,
            loss.delay_penalty) == (2, "sum", True, 0.5, 0.25)


def _misuse(problem):
    acts = torch.tensor(problem["acts"])
    labels, il, ll = (torch.tensor(problem[k]) for k in ("labels", "il", "ll"))
    return {
        "acts_3d": (ValueError, "4-D", lambda: tb.rnnt_loss(acts[0], labels, il, ll)),
        "labels_1d": (ValueError, "2-D", lambda: tb.rnnt_loss(acts, labels[0], il, ll)),
        "labels_int64": (TypeError, "labels", lambda: tb.rnnt_loss(acts, labels.long(), il, ll)),
        "act_lens_float": (TypeError, "act_lens",
                           lambda: tb.rnnt_loss(acts, labels, il.float(), ll)),
        "label_lens_int64": (TypeError, "label_lens",
                             lambda: tb.rnnt_loss(acts, labels, il, ll.long())),
        "not_contiguous": (ValueError, "contiguous",
                           lambda: tb.rnnt_loss(acts.transpose(1, 2), labels, il, ll)),
        "bad_reduction": (ValueError, "reduction",
                          lambda: tb.rnnt_loss(acts, labels, il, ll, reduction="avg")),
        "tdt_labels_int64": (TypeError, "labels", lambda: tb.rnnt_loss_tdt(
            acts, torch.tensor(problem["dur"]), labels.long(), il, ll, DURATIONS)),
        "multiblank_3d": (ValueError, "4-D", lambda: tb.rnnt_loss_multiblank(
            acts[0], labels, il, ll, BIG_BLANKS)),
        # a valid label on a big-blank column (V - 1), refused on CPU tensors
        "multiblank_log_probs": (ValueError, "big-blank", lambda: tb.rnnt_loss_multiblank(
            torch.log_softmax(acts, -1), torch.cat((labels[:, :1] * 0 + V - 1, labels[:, 1:]), 1),
            il, ll, BIG_BLANKS, from_log_probs=True)),
        "fused_none": (ValueError, "sum|mean", lambda: tb.rnnt_loss_fused_joint(
            *(torch.tensor(problem[k]) for k in ("e", "p", "W", "bias")), labels, il, ll,
            reduction="none")),
        "tdt_fused_none": (ValueError, "sum|mean", lambda: tb.rnnt_loss_tdt_fused(
            *(torch.tensor(problem[k]) for k in ("e", "p", "W", "bias", "Wd", "bias_d")),
            labels, il, ll, DURATIONS, reduction="none")),
        "simple_bad_reduction": (ValueError, "reduction", lambda: tb.rnnt_loss_simple(
            torch.tensor(problem["am"]), torch.tensor(problem["lm"]), labels, il, ll,
            reduction="max")),
    }


@pytest.mark.parametrize("case", sorted(_misuse(_problem())))
def test_misuse_raises(case):
    exc, match, call = _misuse(_problem())[case]
    with pytest.raises(exc, match=match):
        call()
