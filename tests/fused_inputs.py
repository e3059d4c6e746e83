"""Inputs of the four fused losses that the JAX package takes and that the
card's wrappers bring to the kernels' types (``ops/cuda/joint.py::_operands``):
e, p, W, bias (and a duration head) in f16 or f64, W in a transposed layout
(``linear.weight.t()``), e and p time-major (a (T, B, H) buffer seen as
(B, T, H)). Shared by the CPU test (tests/test_torch_fused_inputs.py) and the
card tests (tests/test_torch_cuda_fused.py, test_torch_cuda_fused_variants.py);
imports torch alone.
"""
import torch

VARIANTS = ("f16", "f64", "W_t", "time_major")
# The losses' gradients by relative norm, by the type they come back in: f32
# 1e-4 (sums in another order, the fused kernels' de and dp with atomics),
# as f64 (the kernels compute in f32 and widen), f16 1e-3 (each element
# then rounded to f16, 2^-11 relative at most). Costs: rtol and atol 1e-5,
# f16 2^-10 (the cost rounded to f16).
GRAD_REL = {torch.float32: 1e-4, torch.float64: 1e-4, torch.float16: 1e-3}
COST_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.float64: dict(rtol=1e-5, atol=1e-5),
            torch.float16: dict(rtol=2 ** -10, atol=1e-5)}


def _dense_not_contiguous(x, dims):
    """x with the same values in a layout whose dims are swapped in memory:
    dense (a clone keeps it) and not contiguous."""
    out = x.transpose(*dims).contiguous().transpose(*dims)
    assert not out.is_contiguous() and torch.equal(out, x)
    return out


def variant(name, e, p, W, bias, *head):
    """(e, p, W, bias) + head (Wd, bias_d) as the variant ``name``."""
    if name in ("f16", "f64"):
        dtype = torch.float16 if name == "f16" else torch.float64
        return tuple(x.to(dtype) for x in (e, p, W, bias) + head)
    if name == "W_t":
        return (e, p, _dense_not_contiguous(W, (0, 1)), bias) + head
    assert name == "time_major"
    return (_dense_not_contiguous(e, (0, 1)), _dense_not_contiguous(p, (0, 1)), W, bias) + head


def rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def step(fn, leaves, *args, **kw):
    """(costs, the gradient of their sum to each leaf) of one loss call; the
    leaves keep their types and layouts."""
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    costs = fn(*leaves, *args, reduction="none", **kw)
    grads = torch.autograd.grad(costs.sum(), leaves)
    for x, g in zip(leaves, grads):
        assert g.dtype == x.dtype and g.shape == x.shape, (g.dtype, x.dtype)
    assert costs.dtype == leaves[0].dtype
    return costs.detach(), list(grads)


def assert_close(name, got, want):
    """One route's (costs, grads) against another's, at the tolerances of
    the types they come back in."""
    costs, grads = got
    torch.testing.assert_close(costs.double(), want[0].double(), **COST_TOL[costs.dtype],
                               msg=lambda m: f"{name} costs: {m}")
    for i, (g, w) in enumerate(zip(grads, want[1])):
        assert torch.isfinite(g.double()).all(), (name, i)
        assert rel(g, w) <= GRAD_REL[g.dtype], (name, i, rel(g, w))
