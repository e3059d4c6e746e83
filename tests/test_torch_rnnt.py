"""The whole dense slice of warp_transducer_tpu_torch — ``rnnt_loss``,
``rnnt_loss_and_grad``, ``rnnt_score``, ``rnnt_forward_backward``,
``forward_backward_mismatch`` and ``RNNTLoss`` — on the CPU, held against
the JAX package (``implementation="xla"``) and the reference's golden values
(tests/golden.py).

Inputs are made with numpy from a seed and given to both as the same
arrays. Tolerances: f32 costs rtol 1e-5 (online vs two-pass logsumexp,
and log1p vs logaddexp in the lattice, over T+U-1 diagonals); f32
gradients atol 1e-6 plus rtol 1e-4, because exp(alpha + beta - ll) turns
the lattice's absolute rounding (about |ll|·1e-7 per diagonal) into a
relative error of the gradient; golden values 1e-5 as tests/test_golden.py;
f64 1e-10; bf16 gradients within one bf16 ulp (both round one f32 result
to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden as G
from warp_transducer_tpu.ops import rnnt as JR
from warp_transducer_tpu.utils.options import RNNTOptions as JaxOptions
from warp_transducer_tpu_torch import (LatticeResult, RNNTLoss, RNNTOptions,
                                       forward_backward_mismatch, rnnt_forward_backward,
                                       rnnt_loss, rnnt_loss_and_grad, rnnt_score)
import torch_threads  # noqa: F401  (one torch thread a process)

COST = dict(rtol=1e-5)
GRAD = dict(atol=1e-6, rtol=1e-4)


def _problem(B=3, T=6, U=4, V=7, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    acts = rng.standard_normal((B, T, U, V)).astype(dtype)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il = rng.integers(1, T + 1, B).astype(np.int32)
    il[0] = T
    ll = rng.integers(0, U, B).astype(np.int32)
    ll[0] = U - 1
    return acts, labels, il, ll


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _golden_torch(dtype=torch.float32, big=True):
    src = ((G.BIG_ACTS, G.BIG_LABELS, G.BIG_INPUT_LENGTHS, G.BIG_LABEL_LENGTHS) if big else
           (G.SMALL_ACTS, G.SMALL_LABELS, G.SMALL_INPUT_LENGTHS, G.SMALL_LABEL_LENGTHS))
    return [torch.tensor(src[0], dtype=dtype)] + _t(*src[1:])


# ---- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_rnnt_loss_and_autograd_match_jax(reduction):
    acts, labels, il, ll = _problem(seed=1)
    ref = JR.rnnt_loss(*_j(acts, labels, il, ll), reduction=reduction, implementation="xla")
    ref_grad = jax.grad(lambda a: jnp.sum(JR.rnnt_loss(
        a, *_j(labels, il, ll), reduction=reduction, implementation="xla")))(jnp.asarray(acts))
    a = torch.tensor(acts, requires_grad=True)
    out = rnnt_loss(a, *_t(labels, il, ll), reduction=reduction)
    (grad,) = torch.autograd.grad(out.sum(), a)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **COST)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), **GRAD)


@pytest.mark.parametrize("log_probs_input", [False, True])
def test_loss_and_grad_matches_jax(log_probs_input):
    acts, labels, il, ll = _problem(seed=2)
    if log_probs_input:
        acts = torch.log_softmax(torch.tensor(acts), -1).numpy()
    c_ref, g_ref = JR.rnnt_loss_and_grad(*_j(acts, labels, il, ll),
                                         log_probs_input=log_probs_input, implementation="xla")
    c, g = rnnt_loss_and_grad(*_t(acts, labels, il, ll), log_probs_input=log_probs_input)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), **COST)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **GRAD)


def test_score_forward_backward_and_mismatch_match_jax():
    acts, labels, il, ll = _problem(seed=3)
    s = rnnt_score(*_t(acts, labels, il, ll))
    np.testing.assert_allclose(
        s.numpy(), np.asarray(JR.rnnt_score(*_j(acts, labels, il, ll), implementation="xla")), **COST)
    res = rnnt_forward_backward(*_t(acts, labels, il, ll))
    ref = JR.rnnt_forward_backward(*_j(acts, labels, il, ll), implementation="xla")
    assert isinstance(res, LatticeResult) and res.alphas.shape == (3, 6, 4)
    for name in ("ll_forward", "ll_backward"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(ref, name)), **COST)
    live = np.isfinite(np.asarray(ref.alphas))
    np.testing.assert_allclose(res.alphas.numpy()[live], np.asarray(ref.alphas)[live],
                               rtol=1e-5, atol=1e-5)
    mism = forward_backward_mismatch(*_t(acts, labels, il, ll))
    assert mism.shape == (3,) and float(mism.max()) < 1e-3


def test_f64_matches_jax():
    acts, labels, il, ll = _problem(seed=4, dtype=np.float64)
    c_ref, g_ref = JR.rnnt_loss_and_grad(*_j(acts, labels, il, ll), implementation="xla")
    c, g = rnnt_loss_and_grad(*_t(acts, labels, il, ll))
    assert c.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-10)


def test_bf16_matches_jax_on_rounded_inputs():
    acts, labels, il, ll = _problem(seed=5)
    a_bf = torch.tensor(acts).to(torch.bfloat16)
    j_bf = jnp.asarray(a_bf.float().numpy(), jnp.bfloat16)  # the same bf16 values
    c_ref, g_ref = JR.rnnt_loss_and_grad(j_bf, *_j(labels, il, ll), implementation="xla")
    c, g = rnnt_loss_and_grad(a_bf, *_t(labels, il, ll))
    assert c.dtype == g.dtype == torch.bfloat16
    np.testing.assert_allclose(c.float().numpy(), np.asarray(c_ref, np.float32), rtol=2 ** -8)
    np.testing.assert_allclose(g.float().numpy(), np.asarray(g_ref, np.float32),
                               rtol=2 ** -8, atol=1e-6)


def test_fastemit_matches_jax():
    acts, labels, il, ll = _problem(seed=6)
    c_ref, g_ref = JR.rnnt_loss_and_grad(*_j(acts, labels, il, ll), fastemit_lambda=0.25,
                                         implementation="xla")
    c, g = rnnt_loss_and_grad(*_t(acts, labels, il, ll), fastemit_lambda=0.25)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), **COST)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **GRAD)
    a = torch.tensor(acts, requires_grad=True)
    rnnt_loss(a, *_t(labels, il, ll), reduction="sum", fastemit_lambda=0.25).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(g_ref), **GRAD)


def test_delay_penalty_matches_jax():
    acts, labels, il, ll = _problem(seed=7)
    ref = JR.rnnt_loss(*_j(acts, labels, il, ll), reduction="sum", delay_penalty=0.1,
                       implementation="xla")
    ref_grad = jax.grad(lambda x: JR.rnnt_loss(x, *_j(labels, il, ll), reduction="sum",
                                               delay_penalty=0.1, implementation="xla"))(
        jnp.asarray(acts))
    a = torch.tensor(acts, requires_grad=True)
    out = rnnt_loss(a, *_t(labels, il, ll), reduction="sum", delay_penalty=0.1)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), **COST)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref_grad), **GRAD)


def test_module_kwargs_and_options():
    acts, labels, il, ll = _golden_torch()
    np.testing.assert_allclose(float(RNNTLoss(reduction="sum")(acts, labels, il, ll)),
                               G.BIG_COSTS.sum(), **COST)
    mod = RNNTLoss(options=RNNTOptions(reduction="none", implementation="torch"))
    np.testing.assert_allclose(mod(acts, labels, il, ll).numpy(), G.BIG_COSTS, **COST)
    out = rnnt_loss(acts, labels, il, ll, reduction="none",
                    options=RNNTOptions(reduction="sum"))
    assert out.shape == ()  # options.reduction won


def test_int64_labels_and_lengths_accepted():
    acts, labels, il, ll = _golden_torch()
    out = rnnt_loss(acts, labels.long(), il.long(), ll.long(), reduction="none")
    np.testing.assert_allclose(out.numpy(), G.BIG_COSTS, **COST)


# ---- golden values of the reference -------------------------------------------

def test_small_test():
    c, g = rnnt_loss_and_grad(*_golden_torch(big=False))
    np.testing.assert_allclose(c.numpy(), [G.SMALL_COST], rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), G.SMALL_GRADS_ACTS, atol=1e-5)
    np.testing.assert_allclose(rnnt_score(*_golden_torch(big=False)).numpy(), [G.SMALL_COST],
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-9)])
def test_options_test_acts_convention(dtype, tol):
    acts, labels, il, ll = _golden_torch(dtype)
    acts.requires_grad_(True)
    loss = rnnt_loss(acts, labels, il, ll, reduction="sum")
    loss.backward()
    np.testing.assert_allclose(loss.item(), G.BIG_COSTS.sum(), rtol=tol)
    np.testing.assert_allclose(acts.grad.numpy(), G.BIG_GRADS_ACTS, atol=1e-5)
    loss_mean = rnnt_loss(acts, labels, il, ll, reduction="mean")
    (g_mean,) = torch.autograd.grad(loss_mean, acts)
    np.testing.assert_allclose(g_mean.numpy(), G.BIG_GRADS_ACTS / 2.0, atol=1e-6)


def test_options_test_log_probs_convention():
    acts, labels, il, ll = _golden_torch()
    lp = torch.log_softmax(acts, -1)
    c, g = rnnt_loss_and_grad(lp, labels, il, ll, log_probs_input=True)
    np.testing.assert_allclose(c.numpy(), G.BIG_COSTS, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), G.BIG_GRADS_LOGPROBS, atol=1e-5)


# ---- numerics (tests/test_numerics.py) --------------------------------------------

def _reference_problem(rng, B, T, U, V):
    acts = rng.uniform(0, 1, size=(B, T, U, V)).astype(np.float32)
    labels = rng.randint(1, V, size=(B, U - 1)).astype(np.int32)
    if U - 1 >= 3:
        labels[:, (U - 1) // 2] = labels[:, (U - 1) // 2 - 1]
    return acts, labels, np.full((B,), T, np.int32), np.full((B,), U - 1, np.int32)


def test_inf_test_reference_shape():
    """T=50, L=10, V=15 un-normalised acts: finite cost, NaN-free grads, and
    the same values as the JAX package (test_cpu.cpp:181-240)."""
    acts, labels, il, ll = _reference_problem(np.random.RandomState(0), 1, 50, 10, 15)
    c, g = rnnt_loss_and_grad(*_t(acts, labels, il, ll))
    assert torch.isfinite(c).all() and not torch.isnan(g).any()
    c_ref, g_ref = JR.rnnt_loss_and_grad(*_j(acts, labels, il, ll), implementation="xla")
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), **COST)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **GRAD)


def test_central_difference_f64():
    """fp64 central differences of rnnt_score against the analytic gradient,
    with the reference CPU tolerance 1e-4 (test_cpu.cpp:345)."""
    acts, labels, il, ll = _reference_problem(np.random.RandomState(4), 1, 5, 4, 4)
    acts = acts.astype(np.float64)
    lab, ilt, llt = _t(labels, il, ll)
    _, grads = rnnt_loss_and_grad(torch.tensor(acts), lab, ilt, llt)
    eps, num, flat = 1e-4, np.zeros_like(acts), acts.reshape(-1)
    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig + eps
        cp = float(rnnt_score(torch.tensor(acts), lab, ilt, llt).sum())
        flat[i] = orig - eps
        cm = float(rnnt_score(torch.tensor(acts), lab, ilt, llt).sum())
        flat[i] = orig
        num.reshape(-1)[i] = (cp - cm) / (2 * eps)
    grads = grads.numpy()
    rel = np.sqrt(((grads - num) ** 2).sum()) / np.sqrt((grads ** 2).sum())
    assert rel < 1e-4, f"relative grad error {rel}"


# ---- options and validation (tests/test_api.py) -----------------------------------

def test_fwd_bwd_check_warns():
    """A negative tol always trips the self-check (|ll_fwd - ll_bwd| >= 0)."""
    acts, labels, il, ll = _golden_torch()
    with pytest.warns(RuntimeWarning, match="likelihood mismatch"):
        out = rnnt_loss(acts, labels, il, ll,
                        options=RNNTOptions(reduction="sum", fwd_bwd_check_tol=-1.0))
    np.testing.assert_allclose(float(out), G.BIG_COSTS.sum(), **COST)


def test_fwd_bwd_check_silent_when_consistent(recwarn):
    acts, labels, il, ll = _golden_torch()
    acts.requires_grad_(True)
    rnnt_loss(acts, labels, il, ll,
              options=RNNTOptions(reduction="sum", fwd_bwd_check_tol=0.1)).backward()
    assert not [w for w in recwarn if "likelihood mismatch" in str(w.message)]


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a, l, i, j: (a[0], l, i, j), ValueError, "4-D"),
    (lambda a, l, i, j: (a, l[0], i, j), ValueError, "2-D"),
    (lambda a, l, i, j: (a, l, i[:1], j), ValueError, "batch"),
    (lambda a, l, i, j: (a, l, i.float(), j), TypeError, "integer"),
    (lambda a, l, i, j: (a, l[:, :1], i, j), ValueError, "labels length"),
    (lambda a, l, i, j: (a.transpose(1, 2).contiguous().transpose(1, 2), l, i, j),
     ValueError, "contiguous"),
], ids=["rank", "labels_rank", "batch", "float_lengths", "short_labels", "non_contiguous"])
def test_validation_errors(mutate, exc, match):
    with pytest.raises(exc, match=match):
        rnnt_loss(*mutate(*_golden_torch()))


@pytest.mark.parametrize("kwargs,match", [
    (dict(reduction="max"), "reduction"),
    (dict(implementation="xla"), "implementation"),
    (dict(implementation="pallas"), "implementation"),
    (dict(fastemit_lambda=-1.0), "fastemit"),
    (dict(delay_penalty=-1.0), "delay_penalty"),
])
def test_bad_options_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        rnnt_loss(*_golden_torch(), **kwargs)


@pytest.mark.parametrize("entry", [rnnt_loss, rnnt_loss_and_grad, rnnt_score,
                                   rnnt_forward_backward])
def test_cuda_implementation_on_cpu_raises(entry):
    with pytest.raises(ValueError, match="CUDA"):
        entry(*_golden_torch(), implementation="cuda")


@pytest.mark.parametrize("how", ["kwargs", "options"])
def test_module_attributes_match_jax(how):
    """``RNNTLoss`` carries the JAX class's plain attributes beside
    ``.options``, read from the options as the JAX class reads them."""
    kw = dict(blank=3, reduction="sum", log_probs_input=True, implementation="torch")
    if how == "kwargs":
        mod, ref = RNNTLoss(**kw), JR.RNNTLoss(**kw)
    else:
        mod = RNNTLoss(options=RNNTOptions(**kw))
        ref = JR.RNNTLoss(options=JaxOptions(**kw))
    for name in ("blank", "reduction", "log_probs_input", "implementation"):
        assert getattr(mod, name) == getattr(ref, name) == kw[name], name
    assert mod.options.blank == 3
    # plain attributes, not parameters or buffers
    assert not list(mod.parameters()) and not list(mod.buffers())
