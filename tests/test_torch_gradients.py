"""The gradient pass of warp_transducer_tpu_torch against the JAX package:
the plain PyTorch ``grad_wrt_acts`` / ``grad_wrt_log_probs`` (the CPU twin
of csrc/grad.cu, with ``coefficients``) vs ``ops.gradients``.

Both get the very same prep and lattice arrays (from the JAX XLA engine,
-inf at invalid cells), so only the gradient pass is under test.

Tolerances: f32 atol 1e-6 (same closed form, different op order; the
gradient entries are probabilities of size <= 1); f64 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import gradients as JG
from warp_transducer_tpu.ops import lattice as JL
from warp_transducer_tpu.ops import prep as JP
from warp_transducer_tpu_torch.ops import gradients as TG
import torch_threads  # noqa: F401  (one torch thread a process)

B, T, U, V = 3, 6, 4, 7
IL = np.array([6, 4, 5], np.int32)
LL = np.array([3, 1, 2], np.int32)


def _state(log_probs_input, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    acts = rng.standard_normal((B, T, U, V)).astype(dtype)
    if log_probs_input:
        acts = torch.log_softmax(torch.tensor(acts), -1).numpy()
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    labels[1, 0] = 0  # a label equal to blank
    cd = jnp.float64 if dtype == np.float64 else jnp.float32
    p = JP.prepare(jnp.asarray(acts), jnp.asarray(labels), 0, log_probs_input, compute_dtype=cd)
    res = JL.forward_backward(p.lpb, p.lpe, jnp.asarray(IL), jnp.asarray(LL))
    labels_u = np.pad(labels, ((0, 0), (0, 1)))
    jax_args = dict(lpb=p.lpb, lpe=p.lpe, alphas=res.alphas, betas=res.betas,
                    ll=res.ll_forward, labels_u=jnp.asarray(labels_u),
                    input_lengths=jnp.asarray(IL), label_lengths=jnp.asarray(LL))
    torch_args = {k: torch.tensor(np.asarray(v)) for k, v in jax_args.items()}
    return acts, p, jax_args, torch_args


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale,lam", [(None, 0.0), ([0.5, 1.0, 2.0], 0.0), (None, 0.3),
                                       ([1.5, 0.25, 1.0], 0.1)])
def test_grad_wrt_acts(dtype, scale, lam):
    acts, p, ja, ta = _state(False, dtype)
    js = None if scale is None else jnp.asarray(scale, dtype)
    ts = None if scale is None else torch.tensor(scale, dtype=torch.float64 if dtype == np.float64 else torch.float32)
    ref = JG.grad_wrt_acts(jnp.asarray(acts), p.denom, blank=0, scale=js,
                           fastemit_lambda=lam, **ja)
    port = TG.grad_wrt_acts(torch.tensor(acts), torch.tensor(np.asarray(p.denom)), blank=0,
                            scale=ts, fastemit_lambda=lam, **ta)
    assert port.dtype == torch.tensor(acts).dtype
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=0)


@pytest.mark.parametrize("scale,lam", [(None, 0.0), ([0.5, 1.0, 2.0], 0.2)])
def test_grad_wrt_log_probs(scale, lam):
    acts, p, ja, ta = _state(True, seed=1)
    js = None if scale is None else jnp.asarray(scale, jnp.float32)
    ts = None if scale is None else torch.tensor(scale, dtype=torch.float32)
    ref = JG.grad_wrt_log_probs(blank=0, shape_v=V, out_dtype=jnp.float32, scale=js,
                                fastemit_lambda=lam, **ja)
    port = TG.grad_wrt_log_probs(blank=0, shape_v=V, out_dtype=torch.float32, scale=ts,
                                 fastemit_lambda=lam, **ta)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # The label overwrites blank where they coincide (utterance 1, u=0).
    assert np.all(port.numpy()[1, : IL[1], 0, 1:] == 0)


def test_beta_shifts_and_valid_cells():
    _, _, ja, ta = _state(False, np.float64, seed=2)
    jt, ju = JG._beta_shifts(ja["betas"], ja["alphas"], ja["input_lengths"], ja["label_lengths"])
    tt, tu = TG._beta_shifts(ta["betas"], ta["input_lengths"], ta["label_lengths"])
    valid = np.asarray(JG._valid_cells((B, T, U), ja["input_lengths"], ja["label_lengths"]))
    port_valid = TG._valid_cells((B, T, U), ta["input_lengths"], ta["label_lengths"], "cpu")
    assert np.array_equal(port_valid.numpy(), valid)
    for port, ref in ((tt, jt), (tu, ju)):
        ref = np.asarray(ref)
        live = np.isfinite(ref)  # -inf in JAX, -inf or NEG in the port
        np.testing.assert_allclose(port.numpy()[live], ref[live], rtol=1e-12)
        assert np.all(port.numpy()[~live] <= -1e29)
