"""The dense loss's backward through the engine's ``grad_wrt_acts`` /
``grad_wrt_log_probs`` (on the card the lattice mode of csrc/grad.cu, on the
CPU its plain version), held against the JAX package's ``grad_wrt_acts`` /
``grad_wrt_log_probs`` on the same numpy-seeded inputs.

* The engine's gradient, given the very same prep and lattice arrays (from
  the JAX XLA engine): f32 rtol 1e-5 (atol 1e-7), f64 rtol 1e-10 (atol
  1e-13); the same closed form in another order of operations.
* The entry points (``rnnt_loss`` backward, ``rnnt_loss_and_grad``) with a
  cotangent scale, FastEmit and the delay penalty, each side running its own
  prep and lattice: f64 rtol 1e-10 (atol 1e-13); f32 rtol 1e-4 (atol 1e-6),
  because exp(α + β − ll) turns the lattice's absolute rounding, about
  |ll|·1e-7 a diagonal, into a relative error of the gradient.
* The route itself: the backward calls the engine's ``grad_wrt_acts`` /
  ``grad_wrt_log_probs`` once and neither the fields-mode pass nor
  ``gradients.coefficients``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import gradients as JG
from warp_transducer_tpu.ops import lattice as JL
from warp_transducer_tpu.ops import prep as JP
from warp_transducer_tpu.ops import rnnt as JR
from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_and_grad
from warp_transducer_tpu_torch.ops import gradients as TG
from warp_transducer_tpu_torch.ops import rnnt as TR
import torch_threads  # noqa: F401  (one torch thread a process)

B, T, U, V = 4, 7, 5, 9
IL = np.array([7, 1, 5, 6], np.int32)  # utterance 1: T_b = 1
LL = np.array([4, 2, 0, 3], np.int32)  # utterance 2: U_b = 1
SCALE = [0.5, 1.0, 2.0, 1.25]
ENGINE_TOL = {np.float32: dict(rtol=1e-5, atol=1e-7), np.float64: dict(rtol=1e-10, atol=1e-13)}
ENTRY_TOL = {np.float32: dict(rtol=1e-4, atol=1e-6), np.float64: dict(rtol=1e-10, atol=1e-13)}


def _inputs(dtype, log_probs_input, seed, blank=0):
    rng = np.random.default_rng(seed)
    acts = (rng.standard_normal((B, T, U, V)) * 2.0).astype(dtype)
    if log_probs_input:
        acts = torch.log_softmax(torch.tensor(acts), -1).numpy()
    labels = rng.integers(0, V, (B, U - 1)).astype(np.int32)
    labels[labels == blank] = (blank + 1) % V
    labels[0, 1] = blank  # a label equal to blank
    return acts, labels


def _lattice(acts, labels, dtype, log_probs_input, blank, delay_penalty=0.0):
    cd = jnp.float64 if dtype == np.float64 else jnp.float32
    p = JP.prepare(jnp.asarray(acts), jnp.asarray(labels), blank, log_probs_input,
                   compute_dtype=cd)
    lpe = JP.delay_shift(p.lpe, jnp.asarray(IL), delay_penalty) if delay_penalty else p.lpe
    res = JL.forward_backward(p.lpb, lpe, jnp.asarray(IL), jnp.asarray(LL))
    args = dict(lpb=p.lpb, lpe=lpe, alphas=res.alphas, betas=res.betas, ll=res.ll_forward,
                labels_u=jnp.asarray(np.pad(labels, ((0, 0), (0, 1)))),
                input_lengths=jnp.asarray(IL), label_lengths=jnp.asarray(LL))
    return p, args, {k: torch.tensor(np.asarray(v)) for k, v in args.items()}


def _scale(scale, dtype):
    if scale is None:
        return None, None
    return jnp.asarray(scale, dtype), torch.tensor(np.asarray(scale, dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scale,lam,dp,blank", [(None, 0.0, 0.0, 0), (SCALE, 0.0, 0.0, 0),
                                                (None, 0.3, 0.0, V - 1), (SCALE, 0.1, 0.05, 0)],
                         ids=["plain", "scale", "fastemit_blank_last", "all"])
def test_engine_grad_wrt_acts_matches_jax(dtype, scale, lam, dp, blank):
    acts, labels = _inputs(dtype, False, seed=1, blank=blank)
    p, ja, ta = _lattice(acts, labels, dtype, False, blank, dp)
    js, ts = _scale(scale, dtype)
    ref = JG.grad_wrt_acts(jnp.asarray(acts), p.denom, blank=blank, scale=js,
                           fastemit_lambda=lam, **ja)
    got = TR._KERNELS.grad_wrt_acts(torch.tensor(acts), torch.tensor(np.asarray(p.denom)),
                                    blank=blank, scale=ts, fastemit_lambda=lam, **ta)
    assert got.dtype == torch.tensor(acts).dtype and got.shape == (B, T, U, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ENGINE_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scale,lam,blank", [(None, 0.0, 0), (SCALE, 0.2, V - 1)],
                         ids=["plain", "scale_fastemit_blank_last"])
def test_engine_grad_wrt_log_probs_matches_jax(dtype, scale, lam, blank):
    acts, labels = _inputs(dtype, True, seed=2, blank=blank)
    _, ja, ta = _lattice(acts, labels, dtype, True, blank)
    js, ts = _scale(scale, dtype)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    ref = JG.grad_wrt_log_probs(blank=blank, shape_v=V, out_dtype=jdt, scale=js,
                                fastemit_lambda=lam, **ja)
    got = TR._KERNELS.grad_wrt_log_probs(blank=blank, shape_v=V, out_dtype=tdt, scale=ts,
                                         fastemit_lambda=lam, **ta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ENGINE_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("log_probs_input", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("lam,dp", [(0.0, 0.0), (0.25, 0.0), (0.0, 0.1), (0.1, 0.05)],
                         ids=["plain", "fastemit", "delay", "both"])
def test_entry_points_match_jax(dtype, log_probs_input, lam, dp):
    acts, labels = _inputs(dtype, log_probs_input, seed=3)
    j = [jnp.asarray(x) for x in (labels, IL, LL)]
    t = [torch.tensor(x) for x in (labels, IL, LL)]
    kw = dict(log_probs_input=log_probs_input, fastemit_lambda=lam, delay_penalty=dp)
    w = np.asarray(SCALE, dtype)
    ref_grad = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * JR.rnnt_loss(
        a, *j, reduction="none", implementation="xla", **kw)))(jnp.asarray(acts))
    c_ref, g_ref = JR.rnnt_loss_and_grad(jnp.asarray(acts), *j, implementation="xla", **kw)
    a = torch.tensor(acts, requires_grad=True)
    (rnnt_loss(a, *t, reduction="none", **kw) * torch.tensor(w)).sum().backward()
    c, g = rnnt_loss_and_grad(torch.tensor(acts), *t, **kw)
    tol = ENTRY_TOL[dtype]
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref_grad), **tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **tol)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=tol["rtol"])


@pytest.mark.parametrize("log_probs_input", [False, True], ids=["dense", "sparse"])
def test_backward_takes_the_lattice_route(monkeypatch, log_probs_input):
    """One call of the engine's lattice-mode function; the fields-mode pass
    and ``coefficients`` are not called by the route (the plain
    ``grad_wrt_acts`` computes its own coefficients inside)."""
    calls = []
    name = "grad_wrt_log_probs" if log_probs_input else "grad_wrt_acts"
    inner = getattr(TR._KERNELS, name)

    def spy(*args, **kwargs):
        calls.append(name)
        monkeypatch.setattr(TG, "coefficients", real_coefficients)
        return inner(*args, **kwargs)

    def refuse(*_, **__):
        raise AssertionError("the dense backward called a fields-mode function")

    real_coefficients = TG.coefficients
    monkeypatch.setattr(TR._KERNELS, name, spy)
    monkeypatch.setattr(TR._KERNELS, "dense_grad", refuse)
    monkeypatch.setattr(TG, "coefficients", refuse)
    acts, labels = _inputs(np.float32, log_probs_input, seed=4)
    a = torch.tensor(acts, requires_grad=True)
    t = [torch.tensor(x) for x in (labels, IL, LL)]
    rnnt_loss(a, *t, reduction="sum", log_probs_input=log_probs_input).backward()
    assert calls == [name] and torch.isfinite(a.grad).all()
    monkeypatch.setattr(TG, "coefficients", refuse)
    rnnt_loss_and_grad(torch.tensor(acts), *t, log_probs_input=log_probs_input)
    assert calls == [name, name]
