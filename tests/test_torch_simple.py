"""``rnnt_loss_simple`` of warp_transducer_tpu_torch (the additive joiner
without the (B, T, U, V) tensor) on the CPU, held against the JAX package's
``rnnt_loss_simple`` (``implementation="xla"``) and against the port's own
dense ``rnnt_loss`` on am ⊕ lm.

Inputs are made with numpy from a seed and given to both as the same arrays.
Tolerances: costs rtol 1e-5 / atol 1e-5 (the normaliser product and the
lattice's log-sum-exps round in another order in the two frameworks);
gradients rtol 1e-4 / atol 1e-5, the CPU values of tests/test_pruned.py,
because exp(α + β − ll) turns the lattice's absolute rounding into a
relative error of the gradient, and the products sum V or T terms in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import pruned as JPR
from warp_transducer_tpu.ops import simple as JS
from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_simple, rnnt_prune_ranges
import torch_threads  # noqa: F401  (one torch thread a process)

COST = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _problem(seed, B=3, T=6, U=4, V=7, ragged=True):
    rng = np.random.default_rng(seed)
    am = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    lm = (rng.standard_normal((B, U, V)) * 2).astype(np.float32)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    if ragged:
        il = rng.integers(2, T + 1, B).astype(np.int32)
        ll = rng.integers(1, U, B).astype(np.int32)
        il[0], ll[0] = T, U - 1
    else:
        il = np.full(B, T, np.int32)
        ll = np.full(B, U - 1, np.int32)
    return am, lm, labels, il, ll


def _jax(am, lm, labels, il, ll, reduction, **kw):
    def f(a, m):
        out = JS.rnnt_loss_simple(a, m, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                                  reduction=reduction, implementation="xla", **kw)
        return jnp.sum(out), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(am), jnp.asarray(lm))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(am, lm, labels, il, ll, reduction, **kw):
    a = torch.tensor(am, requires_grad=True)
    m = torch.tensor(lm, requires_grad=True)
    out = rnnt_loss_simple(a, m, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                           reduction=reduction, **kw)
    out.sum().backward()
    return out.detach().numpy(), [a.grad.numpy(), m.grad.numpy()]


def _check(port, ref):
    np.testing.assert_allclose(port[0], ref[0], **COST)
    for g, g_ref, name in zip(port[1], ref[1], ("am", "lm")):
        np.testing.assert_allclose(g, g_ref, err_msg=name, **GRAD)


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_matches_jax(reduction, ragged):
    args = _problem(1, ragged=ragged)
    _check(_port(*args, reduction), _jax(*args, reduction))


@pytest.mark.parametrize("kw", [dict(fastemit_lambda=0.3), dict(delay_penalty=0.05),
                                dict(fastemit_lambda=0.1, delay_penalty=0.02)],
                         ids=["fastemit", "delay", "both"])
def test_regularisers_match_jax(kw):
    args = _problem(2)
    _check(_port(*args, "sum", **kw), _jax(*args, "sum", **kw))


def test_blank_last_and_bf16_match_jax():
    am, lm, labels, il, ll = _problem(3, V=6)
    labels = np.where(labels == 5, 1, labels).astype(np.int32)
    ref = _jax(am, lm, labels, il, ll, "mean", blank=5)
    _check(_port(am, lm, labels, il, ll, "mean", blank=5), ref)
    # bf16 inputs compute in f32 in both; costs and gradients come back in
    # bf16, rounded once from the same f32 values: within a bf16 ulp.
    bf = [x.astype(jnp.bfloat16) for x in (jnp.asarray(am), jnp.asarray(lm))]
    ref16 = JS.rnnt_loss_simple(*bf, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                                blank=5, reduction="none", implementation="xla")
    got16 = rnnt_loss_simple(*(torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
                               for x in bf),
                             torch.tensor(labels), torch.tensor(il), torch.tensor(ll), blank=5,
                             reduction="none")
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(ref16.astype(jnp.float32)),
                               rtol=2 ** -8)


@pytest.mark.parametrize("seed", [0, 1])
def test_equals_port_dense_loss(seed):
    """Same lattice, same math: the simple loss is the dense loss on the
    broadcast sum, and its gradients are the dense gradient's marginals."""
    am, lm, labels, il, ll = _problem(seed)
    a = torch.tensor(am, requires_grad=True)
    m = torch.tensor(lm, requires_grad=True)
    lab, il_t, ll_t = torch.tensor(labels), torch.tensor(il), torch.tensor(ll)
    dense = rnnt_loss(a[:, :, None, :] + m[:, None, :, :], lab, il_t, ll_t, reduction="none")
    ga, gm = torch.autograd.grad(dense.sum(), (a, m))
    simple = rnnt_loss_simple(a, m, lab, il_t, ll_t, reduction="none")
    sa, sm = torch.autograd.grad(simple.sum(), (a, m))
    np.testing.assert_allclose(simple.detach().numpy(), dense.detach().numpy(), **COST)
    np.testing.assert_allclose(sa.numpy(), ga.numpy(), **GRAD)
    np.testing.assert_allclose(sm.numpy(), gm.numpy(), **GRAD)


def test_prune_range_matches_rnnt_prune_ranges():
    """The ranges of the tuple form come from the loss's own lattice and
    equal the standalone entry point's; the loss is unchanged and its
    gradient flows through the tuple's first element."""
    am, lm, labels, il, ll = _problem(8, B=3, T=9, U=5, V=6)
    args = (torch.tensor(labels), torch.tensor(il), torch.tensor(ll))
    a = torch.tensor(am, requires_grad=True)
    loss, ranges = rnnt_loss_simple(a, torch.tensor(lm), *args, reduction="sum", prune_range=3)
    (g,) = torch.autograd.grad(loss, a)
    loss_ref = rnnt_loss_simple(a, torch.tensor(lm), *args, reduction="sum")
    (g_ref,) = torch.autograd.grad(loss_ref, a)
    assert ranges.dtype == torch.int32 and ranges.shape == (3, 9)
    assert not ranges.requires_grad
    torch.testing.assert_close(ranges, rnnt_prune_ranges(a.detach(), torch.tensor(lm), *args, 3))
    np.testing.assert_allclose(loss.item(), loss_ref.item(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-6)
    # ... and the JAX package's (the same lattice rounds alike here: no ties).
    ref = JPR.rnnt_prune_ranges(*(jnp.asarray(x) for x in (am, lm, labels, il, ll)), 3,
                                implementation="xla")
    np.testing.assert_array_equal(ranges.numpy(), np.asarray(ref))


def test_default_precision_on_cpu_is_exact():
    """``precision="default"`` allows TF32 on the card only; on the CPU it
    is the IEEE product, and the flag is restored after the call."""
    args = [torch.tensor(x) for x in _problem(4)]
    before = torch.backends.cuda.matmul.allow_tf32
    hi = rnnt_loss_simple(*args, reduction="none")
    lo = rnnt_loss_simple(*args, reduction="none", precision="default")
    assert torch.backends.cuda.matmul.allow_tf32 == before
    torch.testing.assert_close(lo, hi, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["am_2d", "vocab", "labels_short", "reduction", "fastemit",
                                  "delay", "precision", "prune_range", "implementation"])
def test_validation(case):
    """The validation of warp_transducer_tpu/ops/simple.py:255-270, and the
    port's own arguments."""
    am, lm = torch.zeros(2, 5, 7), torch.zeros(2, 3, 7)
    labels = torch.zeros(2, 2, dtype=torch.int32)
    il, ll = torch.full((2,), 5), torch.full((2,), 2)
    args, kw = [am, lm, labels, il, ll], {}
    if case == "am_2d":
        args[0] = am[0]
    elif case == "vocab":
        args[1] = lm[:, :, :5]
    elif case == "labels_short":
        args[2] = labels[:, :1]
    else:
        kw = {"reduction": dict(reduction="avg"), "fastemit": dict(fastemit_lambda=-1.0),
              "delay": dict(delay_penalty=-1.0), "precision": dict(precision="tf32"),
              "prune_range": dict(prune_range=1),
              "implementation": dict(implementation="cuda")}[case]
    with pytest.raises(ValueError):
        rnnt_loss_simple(*args, **kw)


def test_new_tf32_switch_set_by_the_caller():
    """A caller that has used PyTorch's new TF32 switch
    (``torch.backends.cuda.matmul.fp32_precision``) can still call the simple
    loss and the range search: reading the legacy ``allow_tf32`` after it
    raises, so the port's precision helper must not. The switch holds what
    the caller set after each call."""
    flags = torch.backends.cuda.matmul
    old = flags.fp32_precision
    args = [torch.tensor(x) for x in _problem(5)]
    want = rnnt_loss_simple(*args, reduction="none")
    want_ranges = rnnt_prune_ranges(*args, 3)
    try:
        flags.fp32_precision = "tf32"
        for precision in ("highest", "default"):
            got = rnnt_loss_simple(*args, reduction="none", precision=precision)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert flags.fp32_precision == "tf32"
        torch.testing.assert_close(rnnt_prune_ranges(*args, 3), want_ranges, rtol=0, atol=0)
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = old
