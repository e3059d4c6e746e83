"""The multi-blank loss of warp_transducer_tpu_torch (ops/multiblank.py)
against the JAX package and its float64 oracle
(``utils/numpy_oracle_multiblank.py``): the prep with extra columns, the
coefficient fields, the gradient pass with extra columns, and
``rnnt_loss_multiblank`` end to end (the lattice itself:
tests/test_torch_window.py).

The same inputs, made with numpy from a seed, go to both packages. The port
runs its plain PyTorch versions here (CPU tensors), the twins of
csrc/prep.cu, csrc/window_stream.cu and csrc/grad.cu.

Tolerances: f64 costs 1e-9 and gradients 1e-9 (rounding only); f32 costs
rtol 1e-5 and gradients atol 2e-5 against the JAX XLA engine and against the
Pallas kernel K7 in interpret mode (the engines add in different orders and
exp(α + β − ll) turns that into a relative error of the gradient); bf16
inputs compute in f32 and are held to the oracle on the bf16-rounded values
within one bf16 ulp (2^-8) of each result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu import rnnt_loss_multiblank as jax_multiblank
from warp_transducer_tpu.ops import multiblank as JM
from warp_transducer_tpu.ops import prep as JP
from warp_transducer_tpu.utils import numpy_oracle_multiblank as omb
from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_multiblank
from warp_transducer_tpu_torch.ops import gradients as TG
from warp_transducer_tpu_torch.ops import multiblank as TM
from warp_transducer_tpu_torch.ops import prep as TP
from warp_transducer_tpu_torch.ops import rnnt as TR
from warp_transducer_tpu_torch.ops.lattice import LatticeResult
from jax_programs import release_compiled_programs  # noqa: F401

F64 = dict(rtol=1e-9, atol=1e-9)
F32_COST = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=2e-5)

# durations, sigma, FastEmit λ, delay penalty: the grid of
# tests/test_multiblank.py::test_vs_oracle.
GRID = [((2,), 0.0, 0.0, 0.0), ((2, 4), 0.05, 0.0, 0.0), ((2, 3, 8), 0.0, 0.25, 0.0),
        ((2, 4), 0.05, 0.1, 0.02)]


def _rand_problem(seed, B=3, T=8, U=4, V=9, K=2):
    rng = np.random.default_rng(seed)
    acts = (rng.standard_normal((B, T, U, V)) * 2.0).astype(np.float64)
    labels = rng.integers(1, V - K, size=(B, U - 1)).astype(np.int32)
    il = rng.integers(max(2, T - 4), T + 1, size=(B,)).astype(np.int32)
    il[0] = T
    ll = rng.integers(0, U, size=(B,)).astype(np.int32)
    ll[0] = U - 1
    return acts, labels, il, ll


def _port(acts, labels, il, ll, durations, dtype=torch.float64, scale=None, **kw):
    """(costs, grads) of the port; ``scale`` weights the costs in the sum
    that is differentiated (an upstream cotangent)."""
    a = torch.tensor(acts).to(dtype).requires_grad_(True)
    costs = rnnt_loss_multiblank(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                                 durations, reduction="none", **kw)
    weighted = costs if scale is None else costs * torch.tensor(scale).to(dtype)
    weighted.sum().backward()
    return costs.detach(), a.grad


def _jax(acts, labels, il, ll, durations, dtype=jnp.float64, **kw):
    def f(a):
        return jax_multiblank(a, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
                              durations, reduction="none", **kw)

    a = jnp.asarray(acts, dtype)
    costs, vjp = jax.vjp(f, a)
    return np.asarray(costs), np.asarray(vjp(jnp.ones_like(costs))[0])


# ---- the stages ----------------------------------------------------------

@pytest.mark.parametrize("cols", [(), (8,), (7, 8), (2, 8, 5)], ids=str)
def test_prepare_extra_cols_matches_onepass_stats(cols):
    acts, labels, _, _ = _rand_problem(1)
    x = acts.astype(np.float32)
    labels_full = jnp.pad(jnp.asarray(labels), ((0, 0), (0, 1)))
    denom, e, bv, *extra = JP.onepass_stats(jnp.asarray(x), labels_full, 0, extra_cols=cols)
    port = TP.prepare(torch.tensor(x), torch.tensor(labels), 0, False, extra_cols=cols)
    assert port.extras.shape == x.shape[:3] + (len(cols),)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.denom.numpy(), np.asarray(denom), **tol)
    np.testing.assert_allclose(port.lpb.numpy(), np.asarray(bv + denom), **tol)
    np.testing.assert_allclose(port.lpe[:, :, :-1].numpy(), np.asarray(e + denom)[:, :, :-1], **tol)
    for k in range(len(cols)):
        np.testing.assert_allclose(port.extras[..., k].numpy(), np.asarray(extra[k] + denom),
                                   **tol)
    # log-prob inputs: the columns are read as they are
    lp = TP.prepare(torch.tensor(x), torch.tensor(labels), 0, True, extra_cols=cols)
    assert lp.denom is None and torch.equal(lp.extras, torch.tensor(x)[..., list(cols)])


def test_extra_cols_are_checked():
    acts, labels, il, ll = _rand_problem(2)
    x = torch.tensor(acts)
    # no cap on their number
    assert TP.prepare(x, torch.tensor(labels), 0, False, extra_cols=range(9)).extras.shape[-1] == 9
    with pytest.raises(ValueError, match="inside"):
        TP.prepare(x, torch.tensor(labels), 0, False, extra_cols=(9,))
    p = TP.prepare(x, torch.tensor(labels), 0, False)
    fields = TG.Coefficients(p.lpb, p.lpb, p.lpb)
    with pytest.raises(ValueError, match="extra_fields"):
        TG.dense_grad(x, p.denom, fields, TP.label_rows(torch.tensor(labels), 4),
                      torch.tensor(il), torch.tensor(ll), 0, torch.float64, extra_cols=(7, 8))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_multiblank_prep_matches_jax(sigma, dtype):
    """The σ shift lowers lpb, lpe and lpB and leaves denom as it is."""
    acts, labels, _, _ = _rand_problem(3)
    x = acts.astype(dtype)
    ref = JM._multiblank_prep(jnp.asarray(x), jnp.asarray(labels), 0, (7, 8), sigma,
                              jnp.dtype(dtype))
    port = TM._multiblank_prep(TR._PLAIN, torch.tensor(x), torch.tensor(labels), 0, (7, 8), sigma)
    tol = F64 if dtype == np.float64 else dict(rtol=1e-5, atol=1e-6)
    for got, want in zip(port, ref[:4]):  # lpb, lpe, lpB, denom
        got, want = got.numpy(), np.asarray(want)
        live = want > -1e29
        assert np.all(got[~live] <= -1e29)  # lpe's column U-1
        np.testing.assert_allclose(got[live], want[live], **tol)


def _jax_stages(acts, labels, il, ll, durations, sigma):
    """The JAX package's prep and lattice, for the stages after them."""
    durs, idx = JM._resolve_indices(acts.shape[-1], 0, durations, None)
    lpb, lpe, lpB, denom, _ = JM._multiblank_prep(jnp.asarray(acts), jnp.asarray(labels), 0, idx,
                                                  sigma, jnp.float64)
    lat = JM._multiblank_lattice(lpb, lpe, lpB, durs, jnp.asarray(il), jnp.asarray(ll))
    return durs, idx, lpb, lpe, lpB, denom, lat


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("m", [2, 3, 8, 20])
def test_beta_shift_m_matches_jax(m):
    rng = np.random.default_rng(4)
    betas = rng.standard_normal((3, 9, 4))
    il, ll = np.array([9, 6, 2], np.int32), np.array([3, 0, 2], np.int32)
    ref = JM._beta_shift_m(jnp.asarray(betas), m, jnp.asarray(il), jnp.asarray(ll))
    port = TM._beta_shift_m(torch.tensor(betas), m, torch.tensor(il), torch.tensor(ll))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lam", [0.0, 0.25])
def test_mb_coefs_match_jax(lam):
    """ce comes back (1+λ)-scaled and coef carries + λ·ce, as in the JAX
    package: the fused multi-blank loss consumes this convention."""
    acts, labels, il, ll = _rand_problem(5, T=9, U=5, V=11)
    durs, idx, lpb, lpe, lpB, denom, lat = _jax_stages(acts, labels, il, ll, (2, 4), 0.05)
    scale = np.array([0.5, 1.0, 2.0])
    ref = JM._mb_coefs(lpb, lpe, lpB, lat, durs, jnp.asarray(il), jnp.asarray(ll),
                       scale=jnp.asarray(scale), fastemit_lambda=lam)
    port_lat = LatticeResult(_t(lat.alphas), _t(lat.betas), _t(lat.ll_forward),
                             _t(lat.ll_backward))
    port = TM._mb_coefs(_t(lpb), _t(lpe), _t(lpB), port_lat, durs, _t(il), _t(ll),
                        scale=_t(scale), fastemit_lambda=lam)
    assert len(port) == 4 and len(port[3]) == 2
    for got, want in zip(port[:3], ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    for got, want in zip(port[3], ref[3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


@pytest.mark.parametrize("durations", [(2,), (2, 4), (2, 3, 8)], ids=str)
def test_dense_grad_extra_cols_matches_jax(durations):
    """``gradients.dense_grad(extra_cols=...)`` on the JAX package's own
    lattice against ``_multiblank_grad``."""
    acts, labels, il, ll = _rand_problem(6, T=9, U=5, V=11, K=len(durations))
    durs, idx, lpb, lpe, lpB, denom, lat = _jax_stages(acts, labels, il, ll, durations, 0.05)
    labels_full = jnp.pad(jnp.asarray(labels), ((0, 0), (0, 1)))
    scale = np.array([0.5, 1.0, 2.0])
    ref = JM._multiblank_grad(jnp.asarray(acts), denom, lpb, lpe, lpB, lat, labels_full, durs,
                              idx, jnp.asarray(il), jnp.asarray(ll), 0, jnp.float64,
                              scale=jnp.asarray(scale), fastemit_lambda=0.1)
    port_lat = LatticeResult(_t(lat.alphas), _t(lat.betas), _t(lat.ll_forward),
                             _t(lat.ll_backward))
    port = TM._multiblank_grad(TR._PLAIN, _t(acts), _t(denom), _t(lpb), _t(lpe), _t(lpB),
                               port_lat, _t(labels), durs, idx, _t(il), _t(ll), 0,
                               scale=_t(scale), fastemit_lambda=0.1)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F64)


def test_dense_grad_without_extra_cols_is_unchanged():
    acts, labels, il, ll = _rand_problem(7)
    x, lab = torch.tensor(acts), torch.tensor(labels)
    p = TP.prepare(x, lab, 0, False)
    fields = TG.Coefficients(torch.exp(p.lpb), torch.exp(p.lpb) / 2, torch.exp(p.lpe))
    args = (x, p.denom, fields, TP.label_rows(lab, 4), torch.tensor(il), torch.tensor(ll), 0,
            torch.float64)
    base = TG.dense_grad(*args)
    assert torch.equal(base, TG.dense_grad(*args, extra_cols=(),
                                           extra_fields=torch.zeros(3, 8, 4, 0)))
    zeros = torch.zeros(3, 8, 4, 2, dtype=torch.float64)
    assert torch.equal(base, TG.dense_grad(*args, extra_cols=(7, 8), extra_fields=zeros))
    ones = torch.ones_like(zeros)
    diff = base - TG.dense_grad(*args, extra_cols=(7, 8), extra_fields=ones)
    valid = diff.abs().sum(-1) > 0
    assert torch.equal(diff[valid][:, 7:], torch.ones_like(diff[valid][:, 7:]))
    assert not diff[..., :7].any()


# ---- the loss, end to end -------------------------------------------------

@pytest.mark.parametrize("durations,sigma,lam,dp", GRID, ids=str)
def test_vs_oracle_and_jax_f64(durations, sigma, lam, dp):
    acts, labels, il, ll = _rand_problem(42, T=9, U=5, V=11, K=len(durations))
    kw = dict(sigma=sigma, fastemit_lambda=lam, delay_penalty=dp)
    oc, og = omb.multiblank_batch(acts, labels, il, ll, durations, **kw)
    costs, grads = _port(acts, labels, il, ll, durations, **kw)
    assert costs.dtype == torch.float64 and grads.dtype == torch.float64
    np.testing.assert_allclose(costs.numpy(), oc, **F64)
    np.testing.assert_allclose(grads.numpy(), og, **F64)
    jc, jg = _jax(acts, labels, il, ll, durations, **kw)
    np.testing.assert_allclose(costs.numpy(), jc, **F64)
    np.testing.assert_allclose(grads.numpy(), jg, **F64)


@pytest.mark.parametrize("implementation", ["xla", "pallas"])
@pytest.mark.parametrize("durations,sigma,lam,dp", GRID[1::2], ids=str)
def test_vs_jax_f32(durations, sigma, lam, dp, implementation):
    """'pallas' runs the JAX loss through K7 in interpret mode."""
    acts, labels, il, ll = _rand_problem(43, T=10, U=4, V=9, K=len(durations))
    kw = dict(sigma=sigma, fastemit_lambda=lam, delay_penalty=dp)
    costs, grads = _port(acts, labels, il, ll, durations, dtype=torch.float32, **kw)
    assert costs.dtype == torch.float32 and grads.dtype == torch.float32
    jc, jg = _jax(acts, labels, il, ll, durations, dtype=jnp.float32,
                  implementation=implementation, **kw)
    np.testing.assert_allclose(costs.numpy(), jc, **F32_COST)
    np.testing.assert_allclose(grads.numpy(), jg, **F32_GRAD)


def test_bf16_inputs():
    acts, labels, il, ll = _rand_problem(44)
    a_bf = torch.tensor(acts).to(torch.bfloat16)
    oc, og = omb.multiblank_batch(a_bf.double().numpy(), labels, il, ll, (2, 4), sigma=0.05)
    costs, grads = _port(a_bf.float().numpy(), labels, il, ll, (2, 4), dtype=torch.bfloat16,
                         sigma=0.05)
    assert costs.dtype == torch.bfloat16 and grads.dtype == torch.bfloat16
    np.testing.assert_allclose(costs.float().numpy(), oc, rtol=2 ** -8)
    np.testing.assert_allclose(grads.float().numpy(), og, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_reductions_and_upstream_cotangent(reduction):
    acts, labels, il, ll = _rand_problem(45)
    oc, og = omb.multiblank_batch(acts, labels, il, ll, (2, 4), sigma=0.05)
    a = torch.tensor(acts, requires_grad=True)
    out = rnnt_loss_multiblank(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                               (2, 4), sigma=0.05, reduction=reduction)
    scale = np.array([0.5, 1.0, 2.0])
    if reduction == "none":
        assert out.shape == (3,)
        (out * torch.tensor(scale)).sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), og * scale[:, None, None, None], **F64)
    else:
        assert out.shape == ()
        out.backward()
        div = 3.0 if reduction == "mean" else 1.0
        np.testing.assert_allclose(out.item(), oc.sum() / div, **F64)
        np.testing.assert_allclose(a.grad.numpy(), og / div, **F64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k0_is_rnnt_loss(dtype):
    """No big blanks: W = 1, one blank arc; the costs and gradients of the
    port's ``rnnt_loss`` (another lattice engine, the wavefront)."""
    acts, labels, il, ll = _rand_problem(7, K=0)
    kw = dict(fastemit_lambda=0.1, delay_penalty=0.02)
    costs, grads = _port(acts, labels, il, ll, (), dtype=dtype, **kw)
    a = torch.tensor(acts).to(dtype).requires_grad_(True)
    dense = rnnt_loss(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                      reduction="none", **kw)
    dense.sum().backward()
    tol = F64 if dtype == torch.float64 else F32_COST
    np.testing.assert_allclose(costs.numpy(), dense.detach().numpy(), **tol)
    np.testing.assert_allclose(grads.numpy(), a.grad.numpy(),
                               **(F64 if dtype == torch.float64 else F32_GRAD))


def test_explicit_big_blank_indices():
    acts, labels, il, ll = _rand_problem(46, V=10, K=0)
    labels[(labels == 3) | (labels == 6)] = 1
    oc, og = omb.multiblank_batch(acts, labels, il, ll, (4, 2), big_blank_indices=(6, 3),
                                  blank=9, sigma=0.05)
    costs, grads = _port(acts, labels, il, ll, (4, 2), big_blank_indices=(6, 3), blank=9,
                         sigma=0.05)
    np.testing.assert_allclose(costs.numpy(), oc, **F64)
    np.testing.assert_allclose(grads.numpy(), og, **F64)


def test_gradient_is_zero_outside_the_lengths_and_big_blanks_help():
    acts, labels, il, ll = _rand_problem(47, B=2, T=12, U=3, V=8, K=1)
    il[1], ll[1] = 7, 1
    costs, grads = _port(acts, labels, il, ll, (4,))
    assert not grads[1, 7:].any() and not grads[1, :, 2:].any() and grads[1, :7, :2].any()
    dense, _ = _port(acts, labels, il, ll, ())
    assert torch.all(costs <= dense + 1e-9)  # more paths, same weights at σ = 0


def test_no_grad_skips_the_beta_sweep():
    acts, labels, il, ll = _rand_problem(48)
    a = torch.tensor(acts)
    with torch.no_grad():
        c0 = rnnt_loss_multiblank(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                                  (2, 4), reduction="none")
    c1, _ = _port(acts, labels, il, ll, (2, 4))
    assert not c0.requires_grad and torch.equal(c0, c1)


def test_validation():
    acts, labels, il, ll = _rand_problem(1)
    a = (torch.tensor(acts), torch.tensor(labels), torch.tensor(il), torch.tensor(ll))
    with pytest.raises(ValueError, match=">= 2"):
        rnnt_loss_multiblank(*a, (1, 2))
    with pytest.raises(ValueError, match="distinct"):
        rnnt_loss_multiblank(*a, (2, 2))
    with pytest.raises(ValueError, match="entries for"):
        rnnt_loss_multiblank(*a, (2, 3), big_blank_indices=(8,))
    with pytest.raises(ValueError, match="distinct in-range"):
        rnnt_loss_multiblank(*a, (2, 3), big_blank_indices=(8, 8))
    with pytest.raises(ValueError, match="distinct in-range"):
        rnnt_loss_multiblank(*a, (2, 3), big_blank_indices=(8, 9))
    with pytest.raises(ValueError, match="distinct in-range"):
        rnnt_loss_multiblank(*a, (2, 3), big_blank_indices=(0, 8))  # the blank
    with pytest.raises(ValueError, match="reduction"):
        rnnt_loss_multiblank(*a, (2,), reduction="avg")
    with pytest.raises(ValueError, match="fastemit_lambda"):
        rnnt_loss_multiblank(*a, (2,), fastemit_lambda=-0.1)
    with pytest.raises(ValueError, match="delay_penalty"):
        rnnt_loss_multiblank(*a, (2,), delay_penalty=-0.1)
    with pytest.raises(ValueError, match="implementation must be"):
        rnnt_loss_multiblank(*a, (2,), implementation="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_multiblank(*a, (2,), implementation="cuda")
    with pytest.raises(ValueError, match="4-D"):
        rnnt_loss_multiblank(a[0][0], *a[1:], (2,))
    with pytest.raises(TypeError, match="integer"):
        rnnt_loss_multiblank(a[0], a[1].float(), *a[2:], (2,))
    # nine big blanks compute (the duration set has no cap)
    nine = rnnt_loss_multiblank(torch.zeros(3, 8, 4, 20), *a[1:], tuple(range(2, 11)),
                                reduction="none")
    assert bool(torch.isfinite(nine).all())
    assert JM._resolve_indices(9, 0, (2, 4), None) == TM._resolve_indices(9, 0, (2, 4), None)
