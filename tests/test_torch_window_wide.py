"""The duration-arc losses of warp_transducer_tpu_torch at U = 601 against
the JAX package, on the CPU: ``rnnt_loss_multiblank`` (big blanks of 2 and
4 frames) and ``rnnt_loss_tdt`` (durations (0, 1, 2, 4), and (1, 2, 4)
without the label chain), costs and gradients.

U = 601 is a character-level model's label count on long utterances; on
the card these lattices once took the earlier block kernel and now take
the window walk with two to four warps a lattice (f32) or passes (f64
TDT; tests/test_torch_window_plan.py replays those schedules). Here the
port runs its plain PyTorch versions (CPU tensors), the JAX package its own
CPU engines, on the same inputs made with numpy from a seed, in float64:
rtol 1e-10, rounding only (atol 1e-10 beside it for gradients near 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu import rnnt_loss_multiblank as jax_multiblank
from warp_transducer_tpu import rnnt_loss_tdt as jax_tdt
from warp_transducer_tpu_torch import rnnt_loss_multiblank, rnnt_loss_tdt
from jax_programs import release_compiled_programs  # noqa: F401

F64 = dict(rtol=1e-10, atol=1e-10)
B, T, U, V = 1, 2, 601, 5


def _lengths():
    return np.array([T], np.int32), np.array([U - 1], np.int32)


def test_multiblank_u601_matches_jax():
    durations = (2, 4)
    rng = np.random.default_rng(601)
    acts = rng.standard_normal((B, T, U, V)) * 2.0
    labels = rng.integers(1, V - len(durations), (B, U - 1)).astype(np.int32)
    il, ll = _lengths()
    a = torch.tensor(acts, requires_grad=True)
    costs = rnnt_loss_multiblank(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                                 durations, reduction="none")
    costs.sum().backward()

    def f(x):
        return jax_multiblank(x, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                              durations, reduction="none")

    jc, vjp = jax.vjp(f, jnp.asarray(acts, jnp.float64))
    (jg,) = vjp(jnp.ones_like(jc))
    assert np.all(np.isfinite(costs.detach().numpy()))
    np.testing.assert_allclose(costs.detach().numpy(), np.asarray(jc), **F64)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg), **F64)


@pytest.mark.parametrize("durations", [(0, 1, 2, 4), (1, 2, 4)], ids=str)
def test_tdt_u601_matches_jax(durations):
    rng = np.random.default_rng(602 + len(durations))
    tok = rng.standard_normal((B, T, U, V)) * 2.0
    dur = rng.standard_normal((B, T, U, len(durations))) * 2.0
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il, ll = _lengths()
    if 0 not in durations:  # each label takes a frame: fewer labels than T + 1
        ll[:] = T
    t = torch.tensor(tok, requires_grad=True)
    d = torch.tensor(dur, requires_grad=True)
    costs = rnnt_loss_tdt(t, d, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                          durations, reduction="none")
    costs.sum().backward()

    def f(x, y):
        return jax_tdt(x, y, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll), durations,
                       reduction="none")

    jc, vjp = jax.vjp(f, jnp.asarray(tok, jnp.float64), jnp.asarray(dur, jnp.float64))
    jgt, jgd = vjp(jnp.ones_like(jc))
    assert np.all(np.isfinite(costs.detach().numpy()))
    np.testing.assert_allclose(costs.detach().numpy(), np.asarray(jc), **F64)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), **F64)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), **F64)
