"""The lattice of warp_transducer_tpu_torch against the JAX package: the plain
PyTorch ``forward_backward`` (the CPU twin of csrc/wavefront.cu) vs the XLA
engine ``ops.lattice.forward_backward``, vs the Pallas kernel K2
(``pallas/wavefront.py::_kernel``) and vs K1
(``pallas/wavefront_stream.py::_stream_kernel``), both in interpret mode.

Inputs are made with numpy from a seed and go through the JAX prep; the
same lpb/lpe arrays feed every engine. Alphas and betas are compared at
valid cells only: the XLA engine holds -inf elsewhere, the Pallas kernels
and the port the finite NEG. ll_forward and ll_backward are compared for
every utterance.

Tolerances: f32 rtol 1e-5 / atol 1e-5 (log-sum-exp in another form and
order over at most T+U-1 diagonals); f64 1e-10 (rounding only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import lattice as JL
from warp_transducer_tpu.ops import prep as JP
from warp_transducer_tpu.ops.pallas import wavefront as K2
from warp_transducer_tpu.ops.pallas import wavefront_stream as K1
from warp_transducer_tpu_torch.ops import lattice as TL
import torch_threads  # noqa: F401  (one torch thread a process)

ENGINES = {
    "xla": JL.forward_backward,
    "k2": lambda *a, **k: K2.forward_backward(*a, interpret=True, **k),
    "k1": lambda *a, **k: K1.forward_backward(*a, interpret=True, **k),
}

CASES = {
    "ragged": (4, 7, 5, [7, 4, 6, 2], [4, 1, 3, 0]),
    "batch_one": (1, 6, 4, [6], [3]),
    "t_one": (2, 1, 3, [1, 1], [2, 1]),
    "u_one": (3, 5, 1, [5, 3, 1], [0, 0, 0]),
}


def _lattice_inputs(B, T, U, il, ll, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    acts = rng.standard_normal((B, T, U, 6)).astype(dtype)
    labels = rng.integers(1, 6, (B, max(U - 1, 1))).astype(np.int32)
    cd = jnp.float64 if dtype == np.float64 else jnp.float32
    p = JP.prepare(jnp.asarray(acts), jnp.asarray(labels), 0, False, compute_dtype=cd)
    return np.asarray(p.lpb), np.asarray(p.lpe), np.asarray(il, np.int32), np.asarray(ll, np.int32)


def _valid(B, T, U, il, ll):
    t = np.arange(T)[None, :, None]
    u = np.arange(U)[None, None, :]
    return (t < il[:, None, None]) & (u < ll[:, None, None] + 1)


def _compare(port, ref, mask, tol, betas=True):
    np.testing.assert_allclose(port.ll_forward.numpy(), np.asarray(ref.ll_forward), **tol)
    np.testing.assert_allclose(port.ll_backward.numpy(), np.asarray(ref.ll_backward), **tol)
    names = ("alphas", "betas") if betas else ("alphas",)
    for name in names:
        np.testing.assert_allclose(getattr(port, name).numpy()[mask],
                                   np.asarray(getattr(ref, name))[mask], err_msg=name, **tol)
        assert np.all(getattr(port, name).numpy()[~mask] <= -1e29), name


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_backward_matches(engine, case):
    B, T, U, il, ll = CASES[case]
    lpb, lpe, il, ll = _lattice_inputs(B, T, U, il, ll, seed=len(case))
    ref = ENGINES[engine](jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(il), jnp.asarray(ll))
    port = TL.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(il),
                               torch.tensor(ll))
    _compare(port, ref, _valid(B, T, U, il, ll), dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_score_only_matches(engine):
    B, T, U, il, ll = CASES["ragged"]
    lpb, lpe, il, ll = _lattice_inputs(B, T, U, il, ll, seed=9)
    ref = ENGINES[engine](jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(il),
                          jnp.asarray(ll), compute_betas=False)
    port = TL.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(il),
                               torch.tensor(ll), compute_betas=False)
    assert port.betas is port.alphas
    _compare(port, ref, _valid(B, T, U, il, ll), dict(rtol=1e-5, atol=1e-5), betas=False)


def test_f64_matches_xla():
    B, T, U, il, ll = CASES["ragged"]
    lpb, lpe, il, ll = _lattice_inputs(B, T, U, il, ll, seed=11, dtype=np.float64)
    ref = JL.forward_backward(jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(il),
                              jnp.asarray(ll))
    port = TL.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(il),
                               torch.tensor(ll))
    assert port.alphas.dtype == torch.float64
    _compare(port, ref, _valid(B, T, U, il, ll), dict(rtol=1e-10, atol=1e-10))


def test_ll_forward_equals_ll_backward():
    """The recursions meet: ll_fwd == ll_bwd (cpu_rnnt.h:167-169)."""
    B, T, U, il, ll = CASES["ragged"]
    lpb, lpe, il, ll = _lattice_inputs(B, T, U, il, ll, seed=12, dtype=np.float64)
    port = TL.forward_backward(torch.tensor(lpb), torch.tensor(lpe), torch.tensor(il),
                               torch.tensor(ll))
    np.testing.assert_allclose(port.ll_forward.numpy(), port.ll_backward.numpy(), rtol=1e-12)
