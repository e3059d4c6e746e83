"""The TDT loss of warp_transducer_tpu_torch (ops/tdt.py) against the JAX
package and its float64 oracle (``utils/numpy_oracle_tdt.py``): the two-head
prep, the shifted betas, the coefficient fields, both heads' gradients, and
``rnnt_loss_tdt`` end to end (the lattice itself: tests/test_torch_window.py).

The same inputs, made with numpy from a seed, go to both packages. The port
runs its plain PyTorch versions here (CPU tensors), the twins of
csrc/prep.cu, csrc/window_stream.cu and csrc/grad.cu.

Tolerances: f64 costs and gradients 1e-9 (rounding only); f32 costs rtol
1e-5 and gradients atol 2e-5 against the JAX XLA engine and against the
Pallas kernel K7 in interpret mode; bf16 inputs compute in f32 and are held
to the oracle on the bf16-rounded values within one bf16 ulp (2^-8) of each
result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu import rnnt_loss_tdt as jax_tdt
from warp_transducer_tpu.ops import tdt as JT
from warp_transducer_tpu.utils import numpy_oracle_tdt as otdt
from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_tdt
from warp_transducer_tpu_torch.ops import rnnt as TR
from warp_transducer_tpu_torch.ops import tdt as TT
from warp_transducer_tpu_torch.ops.lattice import LatticeResult
from jax_programs import release_compiled_programs  # noqa: F401

F64 = dict(rtol=1e-9, atol=1e-9)
F32_COST = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=2e-5)

# durations, sigma, FastEmit λ, delay penalty: the grid of
# tests/test_tdt.py::test_vs_oracle ((1, 2, 3) has no d = 0).
GRID = [((0, 1, 2, 4), 0.0, 0.0, 0.0), ((0, 1, 2, 4), 0.05, 0.0, 0.0),
        ((1, 2, 3), 0.0, 0.25, 0.0), ((0, 1, 3), 0.05, 0.1, 0.02)]


def _rand_problem(seed, B=3, T=9, U=4, V=7, durs=(0, 1, 2, 4)):
    rng = np.random.default_rng(seed)
    tok = (rng.standard_normal((B, T, U, V)) * 2.0).astype(np.float64)
    dur = (rng.standard_normal((B, T, U, len(durs))) * 2.0).astype(np.float64)
    labels = rng.integers(1, V, size=(B, U - 1)).astype(np.int32)
    il = rng.integers(max(2, T - 4), T + 1, size=(B,)).astype(np.int32)
    il[0] = T
    ll = rng.integers(0, U, size=(B,)).astype(np.int32)
    ll[0] = U - 1
    return tok, dur, labels, il, ll


def _port(tok, dur, labels, il, ll, durs, dtype=torch.float64, scale=None, **kw):
    """(costs, d token_logits, d duration_logits) of the port."""
    t = torch.tensor(tok).to(dtype).requires_grad_(True)
    d = torch.tensor(dur).to(dtype).requires_grad_(True)
    costs = rnnt_loss_tdt(t, d, torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durs,
                          reduction="none", **kw)
    weighted = costs if scale is None else costs * torch.tensor(scale).to(dtype)
    weighted.sum().backward()
    return costs.detach(), t.grad, d.grad


def _jax(tok, dur, labels, il, ll, durs, dtype=jnp.float64, **kw):
    def f(t, d):
        return jax_tdt(t, d, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll), durs,
                       reduction="none", **kw)

    costs, vjp = jax.vjp(f, jnp.asarray(tok, dtype), jnp.asarray(dur, dtype))
    gt, gd = vjp(jnp.ones_like(costs))
    return np.asarray(costs), np.asarray(gt), np.asarray(gd)


def _t(x):
    return torch.tensor(np.asarray(x))


# ---- the stages ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_tdt_prep_matches_jax(sigma, dtype):
    """σ lowers the token head's lpb and lpe only; the duration head is its
    own log-softmax."""
    tok, dur, labels, _, _ = _rand_problem(1)
    ref = JT._tdt_prep(jnp.asarray(tok.astype(dtype)), jnp.asarray(dur.astype(dtype)),
                       jnp.asarray(labels), 0, sigma, jnp.dtype(dtype))
    port = TT._tdt_prep(TR._PLAIN, torch.tensor(tok.astype(dtype)),
                        torch.tensor(dur.astype(dtype)), torch.tensor(labels), 0, sigma)
    tol = F64 if dtype == np.float64 else dict(rtol=1e-5, atol=1e-6)
    for got, want in zip(port, ref[:4]):  # lpb, lpe, lpd, denom
        got, want = got.numpy(), np.asarray(want)
        live = want > -1e29
        assert np.all(got[~live] <= -1e29)  # lpe's column U-1
        np.testing.assert_allclose(got[live], want[live], **tol)
    np.testing.assert_allclose(torch.exp(port[2]).sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("d", [0, 1, 3, 20])
def test_tdt_shifts_match_jax(d):
    rng = np.random.default_rng(2)
    betas = rng.standard_normal((3, 9, 4))
    il, ll = np.array([9, 6, 2], np.int32), np.array([3, 0, 2], np.int32)
    ref = JT._tdt_shifts(jnp.asarray(betas), d, jnp.asarray(il), jnp.asarray(ll))
    port = TT._tdt_shifts(torch.tensor(betas), d, torch.tensor(il), torch.tensor(ll))
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_stages(tok, dur, labels, il, ll, durs, sigma):
    """The JAX package's prep and lattice, for the stages after them."""
    lpb, lpe, lpd, denom, denom_d = JT._tdt_prep(jnp.asarray(tok), jnp.asarray(dur),
                                                 jnp.asarray(labels), 0, sigma, jnp.float64)
    lat = JT._tdt_lattice(lpb, lpe, lpd, durs, jnp.asarray(il), jnp.asarray(ll))
    return lpb, lpe, lpd, denom, denom_d, lat


@pytest.mark.parametrize("durs,lam", [((0, 1, 2, 4), 0.0), ((0, 1, 3), 0.25), ((1, 2), 0.1)],
                         ids=str)
def test_tdt_coefs_match_jax(durs, lam):
    """ce comes back without FastEmit's (1+λ): the callers apply it."""
    tok, dur, labels, il, ll = _rand_problem(3, durs=durs)
    lpb, lpe, lpd, _, _, lat = _jax_stages(tok, dur, labels, il, ll, durs, 0.05)
    scale = np.array([0.5, 1.0, 2.0])
    ref = JT._tdt_coefs(lpb, lpe, lpd, lat, durs, jnp.asarray(il), jnp.asarray(ll),
                        scale=jnp.asarray(scale), fastemit_lambda=lam)
    port_lat = LatticeResult(_t(lat.alphas), _t(lat.betas), _t(lat.ll_forward),
                             _t(lat.ll_backward))
    port = TT._tdt_coefs(_t(lpb), _t(lpe), _t(lpd), port_lat, durs, _t(il), _t(ll),
                         scale=_t(scale), fastemit_lambda=lam)
    assert len(port) == 5 and len(port[3]) == len(port[4]) == len(durs)
    for got, want in zip(port[:3], ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    for got, want in zip(port[3] + port[4], ref[3] + ref[4]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    # every arc carries one factor of each head: the blank and token arc
    # posteriors of a cell sum to its occupation (without FastEmit's λ·ce)
    if not lam:
        np.testing.assert_allclose((port[1] + port[2]).numpy(), port[0].numpy(), **F64)


def test_tdt_grads_match_jax():
    """Both heads' passes on the JAX package's own lattice."""
    durs = (0, 1, 2, 4)
    tok, dur, labels, il, ll = _rand_problem(4, durs=durs)
    lpb, lpe, lpd, denom, denom_d, lat = _jax_stages(tok, dur, labels, il, ll, durs, 0.05)
    labels_full = jnp.pad(jnp.asarray(labels), ((0, 0), (0, 1)))
    scale = np.array([0.5, 1.0, 2.0])
    ref = JT._tdt_grads(jnp.asarray(tok), jnp.asarray(dur), denom, denom_d, lpb, lpe, lpd, lat,
                        labels_full, durs, jnp.asarray(il), jnp.asarray(ll), 0,
                        scale=jnp.asarray(scale), fastemit_lambda=0.1)
    port_lat = LatticeResult(_t(lat.alphas), _t(lat.betas), _t(lat.ll_forward),
                             _t(lat.ll_backward))
    port = TT._tdt_grads(TR._PLAIN, _t(tok), _t(dur), _t(denom), _t(lpb), _t(lpe), _t(lpd),
                         port_lat, _t(labels), durs, _t(il), _t(ll), 0, scale=_t(scale),
                         fastemit_lambda=0.1)
    for got, want in zip(port, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


# ---- the loss, end to end -------------------------------------------------

@pytest.mark.parametrize("durs,sigma,lam,dp", GRID, ids=str)
def test_vs_oracle_and_jax_f64(durs, sigma, lam, dp):
    tok, dur, labels, il, ll = _rand_problem(42, durs=durs)
    kw = dict(sigma=sigma, fastemit_lambda=lam, delay_penalty=dp)
    oc, ogt, ogd = otdt.tdt_batch(tok, dur, labels, il, ll, durs, **kw)
    costs, gt, gd = _port(tok, dur, labels, il, ll, durs, **kw)
    assert costs.dtype == gt.dtype == gd.dtype == torch.float64
    np.testing.assert_allclose(costs.numpy(), oc, **F64)
    np.testing.assert_allclose(gt.numpy(), ogt, **F64)
    np.testing.assert_allclose(gd.numpy(), ogd, **F64)
    jc, jgt, jgd = _jax(tok, dur, labels, il, ll, durs, **kw)
    np.testing.assert_allclose(costs.numpy(), jc, **F64)
    np.testing.assert_allclose(gt.numpy(), jgt, **F64)
    np.testing.assert_allclose(gd.numpy(), jgd, **F64)


@pytest.mark.parametrize("implementation", ["xla", "pallas"])
@pytest.mark.parametrize("durs,sigma,lam,dp", GRID[1:3], ids=str)
def test_vs_jax_f32(durs, sigma, lam, dp, implementation):
    """'pallas' runs the JAX loss through K7 in interpret mode."""
    tok, dur, labels, il, ll = _rand_problem(43, T=10, durs=durs)
    kw = dict(sigma=sigma, fastemit_lambda=lam, delay_penalty=dp)
    costs, gt, gd = _port(tok, dur, labels, il, ll, durs, dtype=torch.float32, **kw)
    assert costs.dtype == gt.dtype == gd.dtype == torch.float32
    jc, jgt, jgd = _jax(tok, dur, labels, il, ll, durs, dtype=jnp.float32,
                        implementation=implementation, **kw)
    np.testing.assert_allclose(costs.numpy(), jc, **F32_COST)
    np.testing.assert_allclose(gt.numpy(), jgt, **F32_GRAD)
    np.testing.assert_allclose(gd.numpy(), jgd, **F32_GRAD)


def test_bf16_inputs():
    durs = (0, 1, 2, 4)
    tok, dur, labels, il, ll = _rand_problem(44)
    t_bf, d_bf = torch.tensor(tok).to(torch.bfloat16), torch.tensor(dur).to(torch.bfloat16)
    oc, ogt, ogd = otdt.tdt_batch(t_bf.double().numpy(), d_bf.double().numpy(), labels, il, ll,
                                  durs, sigma=0.05)
    costs, gt, gd = _port(t_bf.float().numpy(), d_bf.float().numpy(), labels, il, ll, durs,
                          dtype=torch.bfloat16, sigma=0.05)
    assert costs.dtype == gt.dtype == gd.dtype == torch.bfloat16
    np.testing.assert_allclose(costs.float().numpy(), oc, rtol=2 ** -8)
    np.testing.assert_allclose(gt.float().numpy(), ogt, rtol=2 ** -8, atol=1e-5)
    np.testing.assert_allclose(gd.float().numpy(), ogd, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_reductions_and_upstream_cotangent(reduction):
    durs = (0, 1, 2, 4)
    tok, dur, labels, il, ll = _rand_problem(45)
    oc, ogt, ogd = otdt.tdt_batch(tok, dur, labels, il, ll, durs, sigma=0.05)
    t, d = torch.tensor(tok, requires_grad=True), torch.tensor(dur, requires_grad=True)
    out = rnnt_loss_tdt(t, d, torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durs,
                        sigma=0.05, reduction=reduction)
    scale = np.array([0.5, 1.0, 2.0])
    if reduction == "none":
        assert out.shape == (3,)
        (out * torch.tensor(scale)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), ogt * scale[:, None, None, None], **F64)
        np.testing.assert_allclose(d.grad.numpy(), ogd * scale[:, None, None, None], **F64)
    else:
        assert out.shape == ()
        out.backward()
        div = 3.0 if reduction == "mean" else 1.0
        np.testing.assert_allclose(out.item(), oc.sum() / div, **F64)
        np.testing.assert_allclose(t.grad.numpy(), ogt / div, **F64)
        np.testing.assert_allclose(d.grad.numpy(), ogd / div, **F64)


def test_gradient_to_one_head_only():
    durs = (0, 1, 2)
    tok, dur, labels, il, ll = _rand_problem(46, durs=durs)
    _, gt, gd = _port(tok, dur, labels, il, ll, durs)
    args = (torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durs)
    t = torch.tensor(tok, requires_grad=True)
    rnnt_loss_tdt(t, torch.tensor(dur), *args, reduction="sum").backward()
    assert torch.equal(t.grad, gt)
    d = torch.tensor(dur, requires_grad=True)
    rnnt_loss_tdt(torch.tensor(tok), d, *args, reduction="sum").backward()
    assert torch.equal(d.grad, gd)


def test_without_d0_vs_oracle():
    """No d = 0 among the durations: no within-row chain, every token costs
    at least one frame."""
    durs = (1, 2)
    tok, dur, labels, il, ll = _rand_problem(47, T=8, U=3, durs=durs)
    oc, ogt, ogd = otdt.tdt_batch(tok, dur, labels, il, ll, durs)
    costs, gt, gd = _port(tok, dur, labels, il, ll, durs)
    assert np.all(oc < 1e29)
    np.testing.assert_allclose(costs.numpy(), oc, **F64)
    np.testing.assert_allclose(gt.numpy(), ogt, **F64)
    np.testing.assert_allclose(gd.numpy(), ogd, **F64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_infeasible_utterance_sentinel(dtype):
    """durations (2,) with an odd T_b: no combination consumes the frames
    exactly: a huge finite cost and zero gradients to both heads, no NaN —
    the case of tests/test_tdt.py::test_infeasible_utterance_sentinel."""
    rng = np.random.default_rng(0)
    B, T, U, V = 2, 5, 3, 6
    tok = rng.standard_normal((B, T, U, V))
    dur = rng.standard_normal((B, T, U, 1))
    labels = rng.integers(1, V, size=(B, U - 1)).astype(np.int32)
    il = np.array([5, 4], np.int32)  # utterance 0 infeasible, utterance 1 feasible
    ll = np.array([2, 1], np.int32)
    oc, ogt, ogd = otdt.tdt_batch(tok, dur, labels, il, ll, (2,))
    assert oc[0] == 1e30 and np.isfinite(oc[1])
    costs, gt, gd = _port(tok, dur, labels, il, ll, (2,), dtype=dtype,
                          scale=np.array([3.0, 0.5]))
    assert float(costs[0]) > 1e29 and bool(torch.isfinite(costs).all())
    assert bool(torch.isfinite(gt).all()) and bool(torch.isfinite(gd).all())
    assert not gt[0].any() and not gd[0].any()
    tol = F64 if dtype == torch.float64 else F32_GRAD
    np.testing.assert_allclose(float(costs[1]), oc[1], rtol=tol["rtol"])
    np.testing.assert_allclose(gt[1].numpy(), 0.5 * ogt[1], **tol)
    np.testing.assert_allclose(gd[1].numpy(), 0.5 * ogd[1], **tol)
    jc, jgt, jgd = _jax(tok, dur, labels, il, ll, (2,))
    assert jc[0] > 1e29 and not jgt[0].any()


def test_embeds_dense_paths():
    """durations (0, 1) with a uniform duration head embed every standard
    RNN-T path at (1/2)^(T_b + U_b − 1) of its weight, so
    cost_tdt <= cost_dense + (T_b + U_b − 1)·log 2
    (tests/test_tdt.py::test_embeds_dense_paths)."""
    tok, dur, labels, il, ll = _rand_problem(7, durs=(0, 1))
    costs, _, _ = _port(tok, np.zeros_like(dur), labels, il, ll, (0, 1))
    dense = rnnt_loss(torch.tensor(tok), torch.tensor(labels), torch.tensor(il),
                      torch.tensor(ll), reduction="none")
    assert np.all(costs.numpy() <= dense.numpy() + (il + ll) * np.log(2.0) + 1e-9)


def test_gradient_is_zero_outside_the_lengths():
    tok, dur, labels, il, ll = _rand_problem(48, B=2, T=9, U=4)
    il[1], ll[1] = 6, 1
    _, gt, gd = _port(tok, dur, labels, il, ll, (0, 1, 2, 4))
    for g in (gt, gd):
        assert not g[1, 6:].any() and not g[1, :, 2:].any() and g[1, :6, :2].any()


def test_validation():
    tok, dur, labels, il, ll = _rand_problem(1)
    a = (torch.tensor(tok), torch.tensor(dur), torch.tensor(labels), torch.tensor(il),
         torch.tensor(ll))
    with pytest.raises(ValueError, match="non-empty"):
        rnnt_loss_tdt(*a, ())
    with pytest.raises(ValueError, match=">= 0"):
        rnnt_loss_tdt(*a, (-1, 1, 2, 3))
    with pytest.raises(ValueError, match="distinct"):
        rnnt_loss_tdt(*a, (0, 1, 1, 2))
    with pytest.raises(ValueError, match=">= 1"):
        rnnt_loss_tdt(*a, (0,))
    with pytest.raises(ValueError, match="last dim"):
        rnnt_loss_tdt(*a, (0, 1))
    with pytest.raises(ValueError, match="disagree"):
        rnnt_loss_tdt(a[0], a[1][:, :-1], *a[2:], (0, 1, 2, 4))
    with pytest.raises(ValueError, match="must be 4-D"):
        rnnt_loss_tdt(a[0], a[1][0], *a[2:], (0, 1, 2, 4))
    with pytest.raises(ValueError, match="reduction"):
        rnnt_loss_tdt(*a, (0, 1, 2, 4), reduction="avg")
    with pytest.raises(ValueError, match="fastemit_lambda"):
        rnnt_loss_tdt(*a, (0, 1, 2, 4), fastemit_lambda=-1.0)
    with pytest.raises(ValueError, match="delay_penalty"):
        rnnt_loss_tdt(*a, (0, 1, 2, 4), delay_penalty=-1.0)
    # nine durations compute (the duration set has no cap)
    nine = rnnt_loss_tdt(a[0], torch.zeros(3, 9, 4, 9), *a[2:], tuple(range(9)), reduction="none")
    assert bool(torch.isfinite(nine).all())
    with pytest.raises(ValueError, match="implementation must be"):
        rnnt_loss_tdt(*a, (0, 1, 2, 4), implementation="xla")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rnnt_loss_tdt(*a, (0, 1, 2, 4), implementation="cuda")
    with pytest.raises(TypeError, match="integer"):
        rnnt_loss_tdt(a[0], a[1], a[2].float(), *a[3:], (0, 1, 2, 4))
    assert TT._check_durations([0, 1, 2]) == JT._check_durations([0, 1, 2]) == (0, 1, 2)
