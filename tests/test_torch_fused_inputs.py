"""The inputs the four fused losses take, on the CPU: e, p, W, bias (and the
TDT loss's duration head) in f16 and f64, a transposed W and time-major e
and p (tests/fused_inputs.py). The JAX package computes all of them (its
products in f32 for every W that is not bf16, the gradients cast back to the
inputs' types), and so do both routes of the port:

* the plain route (``implementation="torch"``), here: each variant against
  the same loss on the same values as contiguous f32 tensors, and, for
  ``rnnt_loss_fused_joint`` in f16 and f64, against the JAX package;
* the card route: its wrappers accept exactly these inputs and bring them to
  the kernels' types and layouts (``ops/cuda/joint.py::_operands``), which
  runs here on CPU tensors; the kernels themselves run on them in
  tests/test_torch_cuda_fused.py and test_torch_cuda_fused_variants.py.

Tolerances (tests/fused_inputs.py): by the type the results come back in;
f32 and f64 costs rtol 1e-5 and gradients 1e-4 by relative norm, f16 costs
2^-10 and gradients 1e-3 (each element rounded to f16). Against JAX: the
same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fused_inputs as FI
from warp_transducer_tpu.ops import fused_joint as JF
from warp_transducer_tpu_torch import (rnnt_loss_fused_joint, rnnt_loss_multiblank_fused_joint,
                                       rnnt_loss_pruned_fused, rnnt_loss_simple,
                                       rnnt_loss_tdt_fused_joint)
from warp_transducer_tpu_torch.ops.cuda import joint as kjoint

B, T, U, V, H, S = 3, 7, 4, 13, 16, 3


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda x, dt=torch.float32: torch.tensor(x, dtype=dt)  # noqa: E731
    e = t(rng.standard_normal((B, T, H)) * 0.5)
    p = t(rng.standard_normal((B, U, H)) * 0.5)
    W = t(rng.standard_normal((H, V)) / np.sqrt(H))
    bias = t(rng.standard_normal(V) * 0.1)
    Wd = t(rng.standard_normal((H, 4)) / np.sqrt(H))
    bias_d = t(rng.standard_normal(4) * 0.1)
    labels = t(rng.integers(1, V - 2, (B, U - 1)), torch.int32)
    il = t([T, 5, 3], torch.int32)
    ll = t([U - 1, 2, 1], torch.int32)
    am = t(rng.standard_normal((B, T, V)))
    lm = t(rng.standard_normal((B, U, V)))
    _, ranges = rnnt_loss_simple(am, lm, labels, il, ll, prune_range=S)
    return (e, p, W, bias), (Wd, bias_d), (labels, il, ll), ranges


def _losses(head, ints, ranges):
    """name → (loss, how many leading inputs it takes, the arguments after
    them, keyword arguments)."""
    return {
        "fused": (rnnt_loss_fused_joint, 4, ints, {}),
        "multiblank_fused": (rnnt_loss_multiblank_fused_joint, 4, ints + ((2, 3),),
                             {"sigma": 0.05}),
        "tdt_fused": (rnnt_loss_tdt_fused_joint, 6, ints, {"durations": (0, 1, 2, 4)}),
        "pruned_fused": (rnnt_loss_pruned_fused, 4, (ranges,) + ints + (S,), {}),
    }


@pytest.mark.parametrize("variant", FI.VARIANTS)
@pytest.mark.parametrize("loss", ["fused", "multiblank_fused", "tdt_fused", "pruned_fused"])
def test_plain_route_takes_every_input(loss, variant):
    token, head, ints, ranges = _problem()
    fn, n, args, kw = _losses(head, ints, ranges)[loss]
    leaves = FI.variant(variant, *token, *head)[:n]
    got = FI.step(fn, leaves, *args, implementation="torch", **kw)
    # the same values as contiguous f32 tensors
    f32 = [x.float().contiguous() for x in leaves]
    want = FI.step(fn, f32, *args, implementation="torch", **kw)
    FI.assert_close(f"{loss} {variant}", got, want)


@pytest.mark.parametrize("variant", FI.VARIANTS)
def test_card_route_takes_every_input(variant):
    """The wrappers' acceptance (``_operands``, the whole of it, on CPU
    tensors): every variant the plain route takes comes out contiguous, of
    the kernels' types, with the same values; bf16 W stays bf16."""
    token, head, _, _ = _problem()
    e, p, W, bias, Wd, bias_d = FI.variant(variant, *token, *head)
    cpu = torch.device("cpu")
    got = kjoint._operands(cpu, e=(e, 3), p=(p, 3), W=(W, 2), bias=(bias, 1), Wd=(Wd, 2),
                           bias_d=(bias_d, 1))
    for x, y in zip(got, (e, p, W, bias, Wd, bias_d)):
        assert x.dtype == torch.float32 and x.is_contiguous()
        torch.testing.assert_close(x, y.float(), rtol=0, atol=0)
    (W16,) = kjoint._operands(cpu, W=(token[2].to(torch.bfloat16).t().contiguous().t(), 2))
    assert W16.dtype == torch.bfloat16 and W16.is_contiguous()
    for bad, match in (((token[0].int(), 3), "dtype"), ((token[0][0], 3), "3-D")):
        with pytest.raises(ValueError, match=match):
            kjoint._operands(cpu, e=bad)


def _jax_fused(e, p, W, bias, labels, il, ll):
    ints = [jnp.asarray(x.numpy()) for x in (labels, il, ll)]

    def total(*a):
        costs = JF.rnnt_loss_fused_joint(*a, *ints, reduction="none", implementation="xla")
        return jnp.sum(costs.astype(jnp.float64)), costs

    args = [jnp.asarray(x.numpy()) for x in (e, p, W, bias)]
    (_, costs), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return (torch.tensor(np.asarray(costs, np.float64)),
            [torch.tensor(np.asarray(g, np.float64)) for g in grads])


@pytest.mark.parametrize("variant", ["f16", "f64"])
def test_fused_loss_types_match_jax(variant):
    token, _, ints, _ = _problem(seed=1)
    leaves = FI.variant(variant, *token)
    costs, grads = FI.step(rnnt_loss_fused_joint, leaves, *ints, implementation="torch")
    want_costs, want_grads = _jax_fused(*leaves, *ints)
    torch.testing.assert_close(costs.double(), want_costs, **FI.COST_TOL[costs.dtype])
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert FI.rel(g, w) <= FI.GRAD_REL[g.dtype], (i, FI.rel(g, w))
