"""``rnnt_loss_fused_joint`` of warp_transducer_tpu_torch and its two plain
stages (``ops/fused_joint.py::fused_prep`` / ``fused_grad``, the plain
versions of csrc/joint_prep.cu and joint_grad.cu) on the CPU, held against
the JAX package: its portable XLA engine, the Pallas kernels
``pallas/joint_fused.py::_prep_kernel`` / ``_grad_kernel`` in interpret mode
(as tests/test_fused_joint.py runs them), and their V-chunked variants
(``fused_prep_chunked``, ``fused_grad_chunked``).

Inputs are made with numpy from a seed and given to both as the same arrays.
Tolerances, as tests/test_fused_joint.py on the CPU: costs rtol 1e-5 / atol
1e-5 (log-sum-exps and products summed in another order), gradients rtol
1e-4 / atol 1e-4 (exp(α + β − ll) turns the lattice's rounding into a
relative error of the gradient); with bf16 inputs rtol 3e-2 on the costs.
The (B, T, U) fields are compared at the cells inside each utterance's
lattice: outside it the port holds its sentinels (NEG, 0) and the JAX
kernels the values of the padding rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import fused_joint as JF
from warp_transducer_tpu.ops.pallas import joint_fused as K6
from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_fused_joint
from warp_transducer_tpu_torch.ops import fused_joint, gradients, lattice
import torch_threads  # noqa: F401  (one torch thread a process)

COST = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
NAMES = ("de", "dp", "dW", "db")


def _problem(seed, B, T, U, V, H, ragged=True, blank=0):
    rng = np.random.default_rng(seed)
    e = (rng.standard_normal((B, T, H)) * 0.5).astype(np.float32)
    p = (rng.standard_normal((B, U, H)) * 0.5).astype(np.float32)
    W = (rng.standard_normal((H, V)) / np.sqrt(H)).astype(np.float32)
    bias = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(0, V - 1, (B, max(U - 1, 1)))
    labels = (labels + (labels >= blank)).astype(np.int32)  # never the blank
    if ragged:
        il = rng.integers(1, T + 1, B).astype(np.int32)
        ll = rng.integers(0, U, B).astype(np.int32)
        il[0], ll[0] = T, U - 1
    else:
        il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    return e, p, W, bias, labels, il, ll


def _t(*arrays, dtype=None):
    out = [torch.tensor(np.asarray(a)) for a in arrays]
    return [x.to(dtype) if dtype is not None and x.is_floating_point() else x for x in out]


def _torch_loss_and_grads(e, p, W, bias, labels, il, ll, fn=rnnt_loss_fused_joint, **kw):
    leaves = [x.requires_grad_(True) for x in _t(e, p, W, bias)]
    costs = fn(*leaves, *_t(labels, il, ll), reduction="none", **kw)
    grads = torch.autograd.grad(costs.sum(), leaves)
    return costs.detach().numpy(), [g.numpy() for g in grads]


def _jax_loss_and_grads(e, p, W, bias, labels, il, ll, impl, **kw):
    ints = [jnp.asarray(x) for x in (labels, il, ll)]

    def total(*a):
        costs = JF.rnnt_loss_fused_joint(*a, *ints, reduction="none", implementation=impl, **kw)
        return jnp.sum(costs), costs

    (_, costs), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(
        *[jnp.asarray(x) for x in (e, p, W, bias)])
    return np.asarray(costs), [np.asarray(g) for g in grads]


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **COST)
    for name, a, b in zip(NAMES, got[1], want[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,ragged", [
    (0, 2, 6, 4, 9, 16, False),
    (1, 3, 7, 5, 11, 8, True),
    (2, 2, 9, 3, 150, 16, True),  # two V tiles of the Pallas kernel
])
def test_matches_jax(seed, B, T, U, V, H, ragged, impl):
    prob = _problem(seed, B, T, U, V, H, ragged)
    _assert_same(_torch_loss_and_grads(*prob), _jax_loss_and_grads(*prob, impl))


@pytest.mark.parametrize("kw", [{"blank": 6}, {"fastemit_lambda": 0.3}, {"delay_penalty": 0.2},
                                {"blank": 3, "fastemit_lambda": 0.2, "delay_penalty": 0.1}],
                         ids=["blank_last", "fastemit", "delay", "all"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_options_match_jax(kw, impl):
    prob = _problem(3, 3, 6, 4, 7, 8, blank=kw.get("blank", 0))
    _assert_same(_torch_loss_and_grads(*prob, **kw), _jax_loss_and_grads(*prob, impl, **kw))


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_reductions_match_jax(reduction):
    e, p, W, bias, labels, il, ll = _problem(4, 3, 5, 4, 6, 8)
    got = rnnt_loss_fused_joint(*_t(e, p, W, bias, labels, il, ll), reduction=reduction)
    want = JF.rnnt_loss_fused_joint(*[jnp.asarray(x) for x in (e, p, W, bias, labels, il, ll)],
                                    reduction=reduction, implementation="xla")
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COST)


class TestAgainstJaxVChunks:
    """The JAX package splits V into chunks when W does not fit the TPU's
    VMEM and merges their partial (max, sum-exp); the port covers V in one
    pass. Forced to two chunks at small sizes, the chunked functions must still give
    the port's costs and gradients. The shapes are used nowhere else: the
    knobs are read while JAX traces, and a cached trace of the same shape
    would ignore them."""

    @pytest.fixture(autouse=True)
    def _force_chunks(self, monkeypatch):
        monkeypatch.setattr(K6, "_V_TILE", 128)
        monkeypatch.setattr(K6, "_N_CHUNKS_OVERRIDE", 2)

    @pytest.mark.parametrize("seed,B,T,U,V,H,blank", [(5, 2, 6, 4, 310, 16, 0),
                                                      (6, 2, 5, 3, 270, 8, 260)],
                             ids=["labels_in_both_chunks", "blank_in_second_chunk"])
    def test_costs_and_grads(self, seed, B, T, U, V, H, blank):
        prob = _problem(seed, B, T, U, V, H, blank=blank)
        e, p, W = (jnp.asarray(x) for x in prob[:3])
        assert K6.fused_n_chunks(e, p, W) == 2
        _assert_same(_torch_loss_and_grads(*prob, blank=blank),
                     _jax_loss_and_grads(*prob, "pallas", blank=blank))


def test_several_t_chunks(monkeypatch):
    """One frame per chunk (a zero budget), a ragged last chunk included,
    gives what one chunk gives."""
    prob = _problem(7, 2, 11, 4, 13, 8)
    want = _torch_loss_and_grads(*prob)
    monkeypatch.setattr(fused_joint, "_T_CHUNK_MB", 0)
    assert fused_joint._t_chunk(2, 11, 4, 8, 13) == 1
    one = _torch_loss_and_grads(*prob)
    monkeypatch.setattr(fused_joint, "_t_chunk", lambda *a: 4)  # 11 = 4 + 4 + 3
    four = _torch_loss_and_grads(*prob)
    for got in (one, four):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        for name, a, b in zip(NAMES, got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    _assert_same(one, _jax_loss_and_grads(*prob, "xla"))


def _valid(il, ll, T, U):
    return (np.arange(T)[None, :, None] < il[:, None, None]) & \
        (np.arange(U)[None, None, :] <= ll[:, None, None])


@pytest.mark.parametrize("seed,B,T,U,V,H,blank", [(8, 3, 7, 5, 11, 8, 0), (9, 2, 9, 3, 150, 16, 149)])
def test_plain_stages_match_pallas_kernels(seed, B, T, U, V, H, blank):
    """``fused_prep`` and ``fused_grad`` against ``joint_fused.fused_prep`` and
    ``fused_grad`` in interpret mode, fed the same coefficient fields."""
    e, p, W, bias, labels, il, ll = _problem(seed, B, T, U, V, H, blank=blank)
    tl = _t(e, p, W, bias, labels, il, ll)
    jl = [jnp.asarray(x) for x in (e, p, W, bias, labels)]
    full = jnp.full((B,), U - 1, jnp.int32)  # as ops/fused_joint.py calls the kernels
    got = fused_joint.fused_prep(*tl, blank)
    denom, lpb, lpe = K6.fused_prep(*jl, full, blank=blank, interpret=True)
    valid = _valid(il, ll, T, U)
    has_label = valid & (np.arange(U) < U - 1)
    np.testing.assert_allclose(got.denom.numpy()[valid], np.asarray(denom)[valid], **COST)
    np.testing.assert_allclose(got.lpb.numpy()[valid], np.asarray(lpb)[valid], **COST)
    np.testing.assert_allclose(got.lpe.numpy()[has_label], np.asarray(lpe)[has_label], **COST)
    assert np.all(got.lpe.numpy()[~has_label] == fused_joint.NEG)
    assert np.all(got.lpb.numpy()[~valid] == fused_joint.NEG)
    assert np.all(got.denom.numpy()[~valid] == 0)

    res = lattice.forward_backward(got.lpb, got.lpe, tl[5], tl[6])
    scale = torch.linspace(0.5, 1.5, B)
    fields = gradients.coefficients(got.lpb, got.lpe, res.alphas, res.betas, res.ll_forward,
                                    tl[5], tl[6], scale, 0.2)
    grads = fused_joint.fused_grad(*tl, got.denom, fields, blank)
    want = K6.fused_grad(*jl, full, jnp.asarray(got.denom.numpy()),
                         *[jnp.asarray(f.numpy()) for f in fields], blank=blank, interpret=True)
    for name, a, b, like in zip(NAMES, grads, want, tl):
        assert a.dtype == like.dtype and a.shape == like.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("seed,B,T,U,V,H,ragged", [(10, 2, 6, 4, 9, 16, False),
                                                   (11, 3, 7, 5, 11, 8, True),
                                                   (12, 1, 9, 40, 11, 8, True)])
def test_matches_unfused_composition(seed, B, T, U, V, H, ragged):
    """The port's own identity: the loss of the materialised joint logits."""
    prob = _problem(seed, B, T, U, V, H, ragged)

    def unfused(e, p, W, bias, labels, il, ll, reduction):
        acts = torch.tanh(e[:, :, None, :] + p[:, None, :, :]) @ W + bias
        return rnnt_loss(acts, labels, il, ll, reduction=reduction)

    _assert_same(_torch_loss_and_grads(*prob), _torch_loss_and_grads(*prob, fn=unfused))


def test_bf16_inputs():
    """bf16 e, p, W: close to the f32 loss (rtol 3e-2, as
    tests/test_fused_joint.py), closer to the JAX package's bf16 result, and
    gradients in the types of their inputs."""
    e, p, W, bias, labels, il, ll = _problem(13, 2, 5, 4, 9, 16, ragged=False)
    e16, p16, W16 = _t(e, p, W, dtype=torch.bfloat16)
    leaves = [x.requires_grad_(True) for x in (e16, p16, W16, torch.tensor(bias))]
    costs = rnnt_loss_fused_joint(*leaves, *_t(labels, il, ll), reduction="none")
    grads = torch.autograd.grad(costs.sum(), leaves)
    assert costs.dtype == torch.bfloat16
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32]
    f32 = rnnt_loss_fused_joint(e16.float(), p16.float(), W16.float(),
                                *_t(bias, labels, il, ll), reduction="none")
    np.testing.assert_allclose(costs.detach().float().numpy(), f32.detach().numpy(), rtol=3e-2)
    ref = JF.rnnt_loss_fused_joint(
        *[jnp.asarray(x, jnp.bfloat16) for x in (e, p, W)], jnp.asarray(bias),
        *[jnp.asarray(x) for x in (labels, il, ll)], reduction="none", implementation="xla")
    np.testing.assert_allclose(costs.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2)


def test_label_equal_to_blank_and_out_of_range():
    """A label equal to the blank takes both subtractions; a label outside
    [0, V) selects nothing (its emit arc costs NEG), as in ``rnnt_loss``."""
    e, p, W, bias, labels, il, ll = _problem(14, 2, 5, 4, 7, 8, ragged=False)
    labels[0, 1] = 0
    prob = (e, p, W, bias, labels, il, ll)
    _assert_same(_torch_loss_and_grads(*prob), _jax_loss_and_grads(*prob, "xla"))
    labels[1, 0] = 7
    got = fused_joint.fused_prep(*_t(e, p, W, bias, labels, il, ll), 0)
    assert torch.all(got.lpe[1, :, 0] == fused_joint.NEG)


def test_validation():
    e, p, W, bias, labels, il, ll = _t(*_problem(15, 2, 4, 3, 6, 8))
    with pytest.raises(ValueError, match="expected"):
        rnnt_loss_fused_joint(e[0], p, W, bias, labels, il, ll)
    with pytest.raises(ValueError, match="disagree"):
        rnnt_loss_fused_joint(e, p[:, :, :4], W, bias, labels, il, ll)
    with pytest.raises(ValueError, match="batch dims disagree"):
        rnnt_loss_fused_joint(e, p[:1], W, bias, labels, il, ll)
    with pytest.raises(ValueError, match="labels must be"):
        rnnt_loss_fused_joint(e, p, W, bias, labels[:, :1], il, ll)
    with pytest.raises(ValueError, match="reduction"):
        rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, reduction="x")
    with pytest.raises(ValueError, match="fastemit_lambda"):
        rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, fastemit_lambda=-1.0)
    with pytest.raises(ValueError, match="delay_penalty"):
        rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, delay_penalty=-1.0)
    with pytest.raises(ValueError, match="implementation must be"):
        rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, implementation="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_fused_joint(e, p, W, bias, labels, il, ll, implementation="cuda")


@pytest.fixture
def global_tf32(monkeypatch):
    """``torch.set_float32_matmul_precision("high")`` for the test, and every
    ``torch.matmul`` call's CUDA switch recorded: the plain stages must run
    their products in IEEE f32 all the same and leave the setting as found."""
    seen = []
    matmul = torch.matmul

    def recording(*a, **kw):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return matmul(*a, **kw)

    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    monkeypatch.setattr(torch, "matmul", recording)
    try:
        yield seen
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision(old)


def _plain_stage_outputs(e, p, W, bias, labels, il, ll):
    """Every plain stage of ops/fused_joint.py with both hooks, flattened."""
    Wd = (W[:, :3] * 0.7).contiguous()
    bias_d = bias[:3].clone()
    pr = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0, extra_cols=(1,),
                                dur_head=(Wd, bias_d))
    res = lattice.forward_backward(pr.lpb, pr.lpe, il, ll)
    fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
    g_dur = pr.dur * 0.1
    grads = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, pr.denom, fields, 0,
                                   extra=((1,), pr.extras.clamp_min(-1.0).exp()),
                                   dur_head=(Wd, g_dur))
    return (list(pr) + list(grads) + [fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll)]
            + list(fused_joint.dur_head_grad(e, p, Wd, g_dur, il, ll)))


def test_plain_stages_are_ieee_f32_under_a_global_tf32_setting(global_tf32):
    e, p, W, bias, labels, il, ll = _t(*_problem(21, 2, 6, 4, 13, 8))
    got = _plain_stage_outputs(e, p, W, bias, labels, il, ll)
    assert global_tf32 and set(global_tf32) == {"ieee"}, set(global_tf32)
    torch.set_float32_matmul_precision("highest")
    want = _plain_stage_outputs(e, p, W, bias, labels, il, ll)
    torch.set_float32_matmul_precision("high")
    for a, b in zip(got, want):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
