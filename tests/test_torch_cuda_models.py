"""The training surface on the card, at a small configuration: each of the
eight train steps of ``models/transducer.py`` on the kernels against the
same step through the plain versions (a twin with the same weights and
batch), with its kernel launches counted, and the ``warprnnt_pytorch``
binding (``bindings/torch_binding.py``) on CUDA tensors against the port's
entry points on the CPU.

Every test here needs a CUDA device; without one each skips (the ``dev``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_models.py --noconftest``
(tests/conftest.py imports JAX). Imports no JAX.

Tolerances: losses rtol 1e-5; every parameter's gradient within a relative
norm error of 1e-3 with f32 activations (the lattices' sums run in another
order) or 2e-2 with bf16 ones (every product of the backward is rounded to
bf16, so gradients that differ in the last f32 bits at the loss reach the
deepest layers about a bf16 ulp apart; the fused kernels also take bf16
products), each error measured against at least 1e-3 of the whole
gradient's norm (the attention's key bias has a zero gradient in exact
arithmetic).
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_tdt
from warp_transducer_tpu_torch.bindings import torch_binding as tb
from warp_transducer_tpu_torch.models import transducer as tm
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import rnnt as rnnt_module
from warp_transducer_tpu_torch.ops import tdt_fused

pytestmark = pytest.mark.cuda

SMALL = dict(encoder_dim=64, encoder_layers=2, encoder_heads=2, conv_kernel=4, prediction_dim=48,
             joint_dim=64, input_dim=12)
B, T, L, S = 4, 24, 6, 3
BIG_BLANKS = (2, 4)
DURATIONS = (0, 1, 2, 4)
# step: (make_*, its arguments, vocabulary, the counters it must raise)
STEPS = {
    "dense": ("make_train_step", {}, 24, ("prep", "wavefront", "grad")),
    "fused": ("make_fused_train_step", {}, 40, ("joint_prep", "wavefront", "joint_grad")),
    "pruned": ("make_pruned_train_step", dict(s_range=S), 40,
               ("wavefront", "ranges", "band_prep", "band_stream", "band_grad")),
    "pruned_fused": ("make_pruned_fused_train_step", dict(s_range=S), 40,
                     ("wavefront", "ranges", "band_stream")),
    "tdt": ("make_tdt_train_step", {}, 24, ("prep", "window_stream", "grad_fields")),
    "tdt_fused": ("make_tdt_fused_train_step", dict(sigma=0.05), 40,
                  ("joint_prep", "joint_grad", "window_stream")),
    "multiblank": ("make_multiblank_train_step", dict(big_blank_durations=BIG_BLANKS), 24,
                   ("prep", "window_stream", "grad_fields")),
    "multiblank_fused": ("make_multiblank_fused_train_step",
                         dict(big_blank_durations=BIG_BLANKS, sigma=0.05), 40,
                         ("joint_prep", "joint_grad", "window_stream")),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(V, dev, seed, n_cols=0):
    rng = np.random.default_rng(seed)
    il = rng.integers(T // 2, T + 1, B)
    ll = rng.integers(L // 2, L + 1, B)
    il[0], ll[0] = T, L
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    return {"feats": torch.tensor(rng.standard_normal((B, T, SMALL["input_dim"])),
                                  dtype=torch.float32, device=dev),
            "feat_lengths": i32(il), "labels": i32(rng.integers(1, V - n_cols, (B, L))),
            "label_lengths": i32(ll)}


def _plain_stages():
    """Wrap every plain stage of the losses (``ops/rnnt.py::_PLAIN``) with a
    counter; returns (calls, restore)."""
    saved, calls = dict(vars(rnnt_module._PLAIN)), []

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(rnnt_module._PLAIN, name, counted(name, fn))
    return calls, lambda: [setattr(rnnt_module._PLAIN, n, f) for n, f in saved.items()]


def _grads(model):
    return {n: None if q.grad is None else q.grad.clone() for n, q in model.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_on_the_kernels(dev, name, dtype):
    maker, kw, V, kernels = STEPS[name]
    if name == "tdt_fused" and not tdt_fused._tdt_single_chunk(None, None, None):
        kernels = kernels + ("dur_head",)  # the module's rule: the composed route
    cfg = tm.TransducerConfig(vocab_size=V, dtype=dtype,
                              tdt_durations=DURATIONS if "tdt" in name else (), **SMALL)
    models = [tm.Transducer(cfg, device=dev, generator=torch.Generator().manual_seed(3))
              for _ in range(2)]
    steps = [getattr(tm, maker)(m, torch.optim.Adam(m.parameters(), lr=1e-3),
                                implementation=impl, **kw)
             for m, impl in zip(models, ("auto", "torch"))]
    batch = _batch(V, dev, seed=len(name), n_cols=2 if "multiblank" in name else 0)
    K.reset_launches()
    calls, restore = _plain_stages()
    try:
        loss = steps[0](batch)
    finally:
        restore()
    torch.cuda.synchronize()
    assert all(K.launches[k] > 0 for k in kernels), dict(K.launches)
    assert not calls, calls
    K.reset_launches()
    twin_loss = steps[1](batch)
    torch.cuda.synchronize()
    assert not any(K.launches.values()), dict(K.launches)
    np.testing.assert_allclose(float(loss), float(twin_loss), rtol=1e-5)
    got, want = _grads(models[0]), _grads(models[1])
    floor = 1e-3 * float(torch.stack([w.norm() for w in want.values() if w is not None]).norm())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-3
    for n, w in want.items():
        assert (got[n] is None) == (w is None), n
        if w is not None:
            assert torch.isfinite(got[n]).all(), n
            err = float((got[n] - w).norm()) / max(float(w.norm()), floor)
            assert err <= tol, (n, err)
    assert all(q.device.type == "cuda" and q.dtype == torch.float32
               for q in models[0].parameters())


def _binding_problem(seed=0, B=3, T=9, L=4, V=11):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, L + 1, V)), dtype=torch.float32)
    dur = torch.tensor(rng.standard_normal((B, T, L + 1, len(DURATIONS))), dtype=torch.float32)
    labels = torch.tensor(rng.integers(1, V - 2, (B, L)), dtype=torch.int32)
    il = torch.tensor([T, T - 2, T - 1], dtype=torch.int32)
    ll = torch.tensor([L, L - 1, L - 3], dtype=torch.int32)
    return acts, dur, labels, il, ll


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_binding_on_cuda_tensors(dev, reduction):
    """``RNNTLoss`` on CUDA tensors launches the dense kernels and gives the
    port's CPU values and gradients under the binding's conventions."""
    acts, _, labels, il, ll = _binding_problem()
    a = acts.to(dev).requires_grad_(True)
    K.reset_launches()
    got = tb.RNNTLoss(reduction=reduction, fastemit_lambda=0.1)(a, *(x.to(dev) for x in
                                                                     (labels, il, ll)))
    got.sum().backward()
    torch.cuda.synchronize()
    assert all(K.launches[k] > 0 for k in ("prep", "wavefront", "grad")), dict(K.launches)
    r = acts.clone().requires_grad_(True)
    want = rnnt_loss(r, labels, il, ll, reduction="none", fastemit_lambda=0.1)
    if reduction != "none":
        want = want.sum().unsqueeze(-1) / (acts.shape[0] if reduction == "mean" else 1)
    want.sum().backward()
    assert got.shape == want.shape and got.is_cuda
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a.grad.cpu(), r.grad, rtol=1e-4, atol=1e-5)


def test_binding_tdt_on_cuda_tensors(dev):
    acts, dur, labels, il, ll = _binding_problem(seed=1)
    K.reset_launches()
    got = tb.rnnt_loss_tdt(acts.to(dev), dur.to(dev), *(x.to(dev) for x in (labels, il, ll)),
                           durations=DURATIONS, reduction="sum")
    torch.cuda.synchronize()
    assert K.launches["window_stream"] > 0 and got.shape == (1,)
    want = rnnt_loss_tdt(acts, dur, labels, il, ll, DURATIONS, reduction="sum")
    torch.testing.assert_close(got.cpu()[0], want, rtol=1e-5, atol=1e-5)
