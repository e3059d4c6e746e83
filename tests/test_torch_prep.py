"""Prep of warp_transducer_tpu_torch against the JAX package: the plain
PyTorch ``prepare`` (the CPU twin of csrc/prep.cu) vs ``ops.prep.prepare``
and vs the Pallas prep kernel K3 (``prep_fused._kernel``) in interpret mode.

The same inputs, made with numpy from a seed, go to both. Column U-1 of lpe
holds the sentinel: -inf in the JAX XLA prep, the finite NEG in K3 and the
port, so it is compared only as "<= -1e29".

Tolerances: f32 rtol 1e-5 / atol 1e-6 (the JAX one-pass online reduction
and the port's two-pass logsumexp round differently, ~1e-7 relative); f64
1e-10 (rounding only); bf16 inputs are compared in f32 on the same
bf16-rounded values, so the f32 tolerance holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import prep as JP
from warp_transducer_tpu.ops.pallas import prep_fused as JPF
from warp_transducer_tpu_torch.ops import prep as TP
import torch_threads  # noqa: F401  (one torch thread a process)

F32 = dict(rtol=1e-5, atol=1e-6)
F64 = dict(rtol=1e-10, atol=1e-10)


def _inputs(B, T, U, V, seed, blank=0):
    rng = np.random.default_rng(seed)
    acts = (rng.standard_normal((B, T, U, V)) * 3.0).astype(np.float32)
    labels = rng.integers(0, V, (B, max(U - 1, 1))).astype(np.int32)
    labels[labels == blank] = (blank + 1) % V
    return acts, labels


def _check(port, ref, U, tol):
    np.testing.assert_allclose(port.lpb.numpy(), np.asarray(ref.lpb), **tol)
    if ref.denom is None:
        assert port.denom is None
    else:
        np.testing.assert_allclose(port.denom.numpy(), np.asarray(ref.denom), **tol)
    np.testing.assert_allclose(port.lpe[:, :, : U - 1].numpy(),
                               np.asarray(ref.lpe)[:, :, : U - 1], **tol)
    assert np.all(port.lpe[:, :, U - 1].numpy() <= -1e29)


@pytest.mark.parametrize("B,T,U,V,blank", [(2, 5, 4, 7, 0), (3, 4, 3, 6, 5), (1, 3, 1, 5, 0)])
def test_prepare_matches_jax_f32(B, T, U, V, blank):
    acts, labels = _inputs(B, T, U, V, seed=B * 10 + U, blank=blank)
    ref = JP.prepare(jnp.asarray(acts), jnp.asarray(labels), blank, False)
    port = TP.prepare(torch.tensor(acts), torch.tensor(labels), blank, False)
    assert port.lpb.dtype == torch.float32
    _check(port, ref, U, F32)


def test_prepare_matches_jax_f64():
    acts, labels = _inputs(2, 5, 4, 7, seed=1)
    acts = acts.astype(np.float64)
    ref = JP.prepare(jnp.asarray(acts), jnp.asarray(labels), 0, False,
                     compute_dtype=jnp.float64)
    port = TP.prepare(torch.tensor(acts), torch.tensor(labels), 0, False)
    assert port.lpb.dtype == torch.float64
    _check(port, ref, 4, F64)


def test_prepare_bf16_input():
    acts, labels = _inputs(2, 4, 3, 8, seed=2)
    acts_bf = torch.tensor(acts).to(torch.bfloat16)
    rounded = acts_bf.float().numpy()  # exact: bf16 -> f32
    ref = JP.prepare(jnp.asarray(rounded, jnp.bfloat16), jnp.asarray(labels), 0, False)
    port = TP.prepare(acts_bf, torch.tensor(labels), 0, False)
    assert port.lpb.dtype == torch.float32
    _check(port, ref, 3, F32)


def test_prepare_log_probs_input():
    acts, labels = _inputs(2, 4, 3, 6, seed=3)
    lp = torch.log_softmax(torch.tensor(acts), -1).numpy()
    ref = JP.prepare(jnp.asarray(lp), jnp.asarray(labels), 0, True)
    port = TP.prepare(torch.tensor(lp), torch.tensor(labels), 0, True)
    _check(port, ref, 3, F32)


@pytest.mark.parametrize("blank", [0, 7])
def test_prepare_matches_pallas_k3(blank):
    """K3 (prep_fused._kernel) in interpret mode: the kernel csrc/prep.cu
    replaces. Both write NEG at lpe column U-1, so all columns compare."""
    B, T, U, V = 2, 3, 4, 8
    acts, labels = _inputs(B, T, U, V, seed=4 + blank, blank=blank)
    labels_full = jnp.pad(jnp.asarray(labels), ((0, 0), (0, 1)))
    lpb, lpe, denom = JPF.fused_prep(jnp.asarray(acts), labels_full, blank, interpret=True)
    port = TP.prepare(torch.tensor(acts), torch.tensor(labels), blank, False)
    np.testing.assert_allclose(port.lpb.numpy(), np.asarray(lpb), **F32)
    np.testing.assert_allclose(port.lpe.numpy(), np.asarray(lpe), **F32)
    np.testing.assert_allclose(port.denom.numpy(), np.asarray(denom), **F32)


def test_label_rows_pad_and_truncate():
    labels = torch.tensor([[3, 1, 2, 4], [5, 6, 0, 0]])
    assert TP.label_rows(labels, 3).tolist() == [[3, 1, 0], [5, 6, 0]]
    assert TP.label_rows(labels[:, :1], 4).tolist() == [[3, 0, 0, 0], [5, 0, 0, 0]]
    assert TP.label_rows(labels, 3).dtype == torch.int32


def test_delay_shift_matches_jax():
    rng = np.random.default_rng(5)
    lpe = rng.standard_normal((3, 6, 4)).astype(np.float32)
    il = np.array([6, 3, 5], np.int32)
    ref = JP.delay_shift(jnp.asarray(lpe), jnp.asarray(il), 0.25)
    port = TP.delay_shift(torch.tensor(lpe), torch.tensor(il), 0.25)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32)
