"""The pruned path of warp_transducer_tpu_torch — ``ranges_from_posteriors``,
``rnnt_prune_ranges``, ``gather_banded``, the band prep, lattice and
gradient (``ops/band.py``, the plain versions of csrc/band_prep.cu,
band_stream.cu, band_grad.cu and ranges.cu) and ``rnnt_loss_pruned`` — on
the CPU, held against the JAX package: its XLA engine, and the Pallas
kernels K4 (``pallas/band_stream.py``), K5a and K5b
(``pallas/band_pipeline.py``) in interpret mode, as tests/test_pruned.py
runs them.

Inputs are made with numpy from a seed and given to both as the same arrays.
Tolerances, as tests/test_pruned.py on the CPU:
* costs rtol 1e-5 / atol 1e-5 (log-sum-exps in another form and order);
* gradients rtol 1e-4 / atol 1e-5: exp(α + β − ll) turns the lattice's
  absolute rounding into a relative error of the gradient;
* lattices 1e-4 at valid cells (test_pruned.py:349-354; invalid cells hold
  the NEG sentinel in both and are not compared);
* ranges, labels and the gathered band exactly; the gathered band's
  backward 1e-6: index_add_ and the JAX one-hot product add the rows that
  share a source in another order (on the card, with atomics, in an order
  that varies from run to run).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import lattice as JL
from warp_transducer_tpu.ops import prep as JP
from warp_transducer_tpu.ops import pruned as JPR
from warp_transducer_tpu.ops import simple as JS
from warp_transducer_tpu.ops.pallas import band_pipeline as K5
from warp_transducer_tpu.ops.pallas import band_stream as K4
from warp_transducer_tpu_torch import (gather_banded, rnnt_loss, rnnt_loss_pruned,
                                       rnnt_loss_simple, rnnt_prune_ranges)
from warp_transducer_tpu_torch.ops import band
from warp_transducer_tpu_torch.ops.pruned import ranges_from_posteriors
from jax_programs import release_compiled_programs  # noqa: F401

COST = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
LATTICE = dict(rtol=1e-4, atol=1e-4)


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _lengths(rng, B, T, U, min_t=1, min_l=0):
    il = rng.integers(min_t, T + 1, B).astype(np.int32)
    ll = rng.integers(min_l, U, B).astype(np.int32)
    il[0], ll[0] = T, U - 1
    return il, ll


def _ranges(rng, B, T, S, ll):
    """Random contract-abiding band starts: monotone, steps <= S-1, start 0,
    at most max(U_b - S, 0) (test_pruned.py:310-315)."""
    steps = rng.integers(0, S, (B, T))
    steps[:, 0] = 0
    return np.minimum(np.cumsum(steps, axis=1),
                      np.maximum(ll[:, None] + 1 - S, 0)).astype(np.int32)


def _band_problem(seed, B, T, U, V, S):
    rng = np.random.default_rng(seed)
    band_acts = rng.standard_normal((B, T, S, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, max(U - 1, 1))).astype(np.int32)
    il, ll = _lengths(rng, B, T, U)
    return band_acts, labels, il, ll, _ranges(rng, B, T, S, ll)


def _valid(ranges, il, ll, S):
    return band.band_valid(*_t(ranges, il, ll), S).numpy()


# ---- ranges -----------------------------------------------------------------

def _posteriors(seed, B, T, U, V):
    """The JAX package's simple-joiner lattice (XLA engine), as numpy."""
    rng = np.random.default_rng(seed)
    am = rng.standard_normal((B, T, V)).astype(np.float32)
    lm = rng.standard_normal((B, U, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il, ll = _lengths(rng, B, T, U)
    labels_u = jnp.pad(JP._pad_labels(jnp.asarray(labels), U), ((0, 0), (0, 1)))
    lpb, lpe, *_ = JS._factorised_lattice_inputs(jnp.asarray(am), jnp.asarray(lm), labels_u, 0,
                                                jax.lax.Precision.HIGHEST)
    res = JL.forward_backward(lpb, lpe, jnp.asarray(il), jnp.asarray(ll))
    return [np.asarray(x) for x in (res.alphas, res.betas, res.ll_forward)], il, ll


@pytest.mark.parametrize("seed,S", [(0, 2), (1, 3), (2, 4), (3, 5), (4, 3), (5, 7)])
def test_ranges_equal_jax_given_same_posteriors(seed, S):
    """Fed the same alphas, betas and ll, the port's three scans give the
    JAX package's ranges exactly: once from a real lattice (ragged, some
    utterances no width-S band can align), once from random posteriors,
    whose peaks jump about and drive every clamp."""
    (a, b, llf), il, ll = _posteriors(seed, B=4, T=11, U=9, V=6)
    rng = np.random.default_rng(100 + seed)
    noise = rng.standard_normal(a.shape).astype(np.float32) * 5
    for alphas, betas in ((a, b), (noise, np.zeros_like(noise))):
        ref = JPR.ranges_from_posteriors(*_j(alphas, betas, llf, il, ll), S)
        got = ranges_from_posteriors(*_t(alphas, betas, llf, il, ll), S)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tied", [(0, 4), (4, 8), (0, 8), (0, 4, 8)],
                         ids=["first_middle", "middle_last", "first_last", "all_three"])
def test_ranges_ties_equal_jax(tied, dtype):
    """Integer-valued alphas and betas with equal maxima planted at the
    first, middle and last u of every frame (U = 9), the peak moving
    between the tied positions from frame to frame: the port's
    ranges_from_posteriors equals the JAX one exactly (both take the first
    maximum)."""
    B, T, U, S = 4, 12, 9, 3
    rng = np.random.default_rng(sum(tied))
    alphas = rng.integers(-6, 0, (B, T, U)).astype(dtype)
    betas = rng.integers(-6, 0, (B, T, U)).astype(dtype)
    for t in range(T):  # the tie, and at odd frames one tied u raised above it
        alphas[:, t, list(tied)] = 2
        betas[:, t, list(tied)] = 1
        if t % 2:
            alphas[:, t, tied[t // 2 % len(tied)]] = 3
    llf = rng.integers(-5, 0, B).astype(dtype)
    il, ll = _lengths(rng, B, T, U)
    ref = JPR.ranges_from_posteriors(*_j(alphas, betas, llf, il, ll), S)  # x64: conftest
    got = ranges_from_posteriors(*_t(alphas, betas, llf, il, ll), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", range(6))
def test_prune_ranges_contract_fuzz(seed):
    """The ranges contract holds unconditionally (test_pruned.py:213-260):
    start 0, monotone, steps <= S-1, at most U_b-1, held beyond T_b-1; the
    pruned loss on them has finite gradients, a finite cost below 1e29 for
    every utterance a width-S band can align, and above it otherwise."""
    B, T, U, V, S = 2, 10, 8, 6, 3
    rng = np.random.default_rng(seed)
    am, lm = (rng.standard_normal((B, n, V)).astype(np.float32) for n in (T, U))
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il = rng.integers(1, T + 1, B).astype(np.int32)
    ll = rng.integers(1, U, B).astype(np.int32)
    r = rnnt_prune_ranges(*_t(am, lm, labels, il, ll), S).numpy()
    d = np.diff(r, axis=1)
    assert np.all(r[:, 0] == 0) and np.all(d >= 0) and np.all(d <= S - 1), r
    for b in range(B):
        assert np.all(r[b] <= max(0, ll[b])), r
        assert np.all(r[b, il[b] - 1:] == r[b, il[b] - 1]), r
    acts = torch.tensor(rng.standard_normal((B, T, S, V)).astype(np.float32), requires_grad=True)
    costs = rnnt_loss_pruned(acts, *_t(r, labels, il, ll), reduction="none")
    costs.sum().backward()
    costs = costs.detach()
    assert torch.isfinite(acts.grad).all() and torch.isfinite(costs).all()
    for b in range(B):
        feasible = ll[b] <= il[b] * (S - 1)
        assert (costs[b].item() < 1e29) == feasible, (b, costs[b].item())


# ---- gather_banded ----------------------------------------------------------

@pytest.mark.parametrize("rest", [(5,), (), (2, 3)], ids=["H", "none", "2x3"])
def test_gather_banded_matches_jax(rest):
    rng = np.random.default_rng(7)
    B, U, T, S = 3, 9, 17, 4
    x = rng.standard_normal((B, U) + rest).astype(np.float32)
    ranges = np.minimum(np.sort(rng.integers(0, U, (B, T)), axis=1), U - 1).astype(np.int32)
    ct = rng.standard_normal((B, T, S) + rest).astype(np.float32)
    ref, vjp = jax.vjp(lambda xx: JPR.gather_banded(xx, jnp.asarray(ranges), S), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    out = gather_banded(xt, torch.tensor(ranges), S)
    (dx,) = torch.autograd.grad(out, xt, torch.tensor(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=1e-6, atol=1e-6)


# ---- the band stages --------------------------------------------------------

def test_band_labels_match_jax():
    rng = np.random.default_rng(3)
    B, T, U, S = 3, 7, 6, 3
    labels = rng.integers(1, 9, (B, U - 1)).astype(np.int32)
    ranges = _ranges(rng, B, T, S, np.full(B, U - 1))
    ref_lab, ref_has = JPR._band_labels(*_j(labels, ranges), S)
    lab, has = band.band_labels(*_t(labels, ranges), S)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))
    np.testing.assert_array_equal(has.numpy(), np.asarray(ref_has))


def _k5_prep(acts, lab_band, has_lab, blank):
    """K5a in interpret mode, set up as band_pipeline.pruned_forward does."""
    B, T, S, V = acts.shape
    S_pad, SV, Tc, _ = K5._geometry(B, T, S, V)
    lab_lane = jnp.where(has_lab, jnp.arange(S)[None, None, :] * V + lab_band, -1)
    lab_lane = jnp.pad(lab_lane.astype(jnp.float32), ((0, 0), (0, 0), (0, S_pad - S)),
                       constant_values=-1.0)
    packed = K5._prep_fields_call(acts.reshape(B, T, SV), lab_lane, S, V, blank, Tc, True)
    return [packed[:, :, g * S_pad:g * S_pad + S] for g in range(3)]


@pytest.mark.parametrize("blank,dtype", [(0, np.float32), (4, np.float32), (0, "bfloat16")])
def test_band_prep_matches_jax(blank, dtype):
    acts, labels, il, ll, ranges = _band_problem(2, B=2, T=5, U=6, V=7, S=3)
    labels[0, 1] = blank  # a label equal to blank
    j_acts = jnp.asarray(acts).astype(dtype)
    ref = JPR._band_prep(j_acts, *_j(labels, ranges), blank)
    k5 = _k5_prep(j_acts, ref[3], ref[4], blank)
    t_acts = torch.tensor(np.asarray(j_acts.astype(jnp.float32)))
    if dtype == "bfloat16":
        t_acts = t_acts.bfloat16()
    lab_band, has_lab = band.band_labels(*_t(labels, ranges), 3)
    got = band.band_prep(t_acts, band.label_rows(lab_band, has_lab), blank)
    for name, g, r, k in zip(("lpb", "lpe", "denom"), (got.lpb, got.lpe, got.denom),
                             (ref[0], ref[1], ref[2]), k5):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **COST)
        np.testing.assert_allclose(g.numpy(), np.asarray(k), err_msg=name, **COST)


LATTICE_CASES = [(0, 3, 9, 6, 5, 3), (1, 2, 5, 9, 4, 5), (2, 4, 12, 7, 6, 8), (3, 1, 1, 1, 3, 2),
                 (4, 2, 17, 12, 5, 11), (5, 2, 6, 45, 4, 40)]


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("case", LATTICE_CASES,
                         ids=["S3", "S5", "S8", "T1", "S11", "S40_chunked"])
def test_band_lattice_matches_jax(case, engine):
    """The shapes of test_pruned.py:319-325 (T = 1, S = 8 and S = 11
    among them) and S = 40, which the card's kernel walks in two 32-lane
    chunks."""
    seed, B, T, U, V, S = case
    acts, labels, il, ll, ranges = _band_problem(seed, B, T, U, V, S)
    lpb, lpe, *_ = JPR._band_prep(*_j(acts, labels, ranges), 0)
    if engine == "xla":
        ref = JPR._band_lattice(lpb, lpe, *_j(ranges, il, ll), implementation="xla")
    else:
        ref = JPR.BandLattice(*K4.band_forward_backward(lpb, lpe, *_j(ranges, il, ll),
                                                        interpret=True))
    got = band.forward_backward(*_t(lpb, lpe, ranges, il, ll))
    np.testing.assert_allclose(got.ll_forward.numpy(), np.asarray(ref.ll_forward), **COST)
    np.testing.assert_allclose(got.ll_backward.numpy(), np.asarray(ref.ll_backward), **COST)
    mask = _valid(ranges, il, ll, S)
    for name in ("alphas", "betas"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(g[mask], r[mask], err_msg=name, **LATTICE)
        assert np.all(g[~mask] == np.float32(-1e30)), name


def test_band_grad_matches_jax():
    """The coefficient fields and the gradient pass against JAX's
    _band_grad, given the same lattice, with a cotangent scale and
    FastEmit."""
    acts, labels, il, ll, ranges = _band_problem(6, B=3, T=8, U=6, V=5, S=3)
    ja = _j(acts, labels, ranges, il, ll)
    lpb, lpe, denom, lab_band, has_lab = JPR._band_prep(ja[0], ja[1], ja[2], 0)
    lat = JPR._band_lattice(lpb, lpe, ja[2], ja[3], ja[4], implementation="xla")
    scale = np.array([0.5, 1.0, 2.0], np.float32)
    ref = JPR._band_grad(ja[0], denom, lpb, lpe, lat, ja[2], lab_band, has_lab, ja[3], ja[4], 0,
                         jnp.asarray(scale), fastemit_lambda=0.2)
    t = _t(acts, ranges, il, ll, lpb, lpe, denom, lab_band, has_lab)
    fields = band.band_coefs(t[4], t[5], band.BandLattice(*_t(*lat)), t[1], t[8], t[2], t[3],
                             torch.tensor(scale), 0.2)
    got = band.band_grad(t[0], t[6], fields, band.label_rows(t[7], t[8]), t[1], t[2], t[3], 0,
                         torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


def test_infeasible_band():
    """A band too narrow to reach the terminal (U-1 = 7 > T·(S-1) = 3):
    ll_forward < -1e29 in the port and in both JAX engines, the cost is
    about 1e30 and finite, and the gradient is exactly zero."""
    rng = np.random.default_rng(5)
    B, T, U, V, S = 1, 3, 8, 4, 2
    acts = rng.standard_normal((B, T, S, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    ranges = np.array([[0, 1, 2]], np.int32)
    lpb, lpe, *_ = JPR._band_prep(*_j(acts, labels, ranges), 0)
    for ref in (JPR._band_lattice(lpb, lpe, *_j(ranges, il, ll), implementation="xla"),
                K4.band_forward_backward(lpb, lpe, *_j(ranges, il, ll), interpret=True)):
        assert float(ref[2][0]) < -1e29
    assert float(band.forward_backward(*_t(lpb, lpe, ranges, il, ll)).ll_forward[0]) < -1e29
    a = torch.tensor(acts, requires_grad=True)
    cost = rnnt_loss_pruned(a, *_t(ranges, labels, il, ll), reduction="sum")
    cost.backward()
    assert np.isfinite(cost.item()) and cost.item() > 1e29
    assert torch.count_nonzero(a.grad) == 0


# ---- the loss ---------------------------------------------------------------

def _jax_pruned(acts, ranges, labels, il, ll, impl, reduction="sum", **kw):
    def f(a):
        out = JPR.rnnt_loss_pruned(a, *_j(ranges, labels, il, ll), reduction=reduction,
                                   implementation=impl, **kw)
        return jnp.sum(out), out
    (_, out), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(acts))
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("kw", [{}, dict(fastemit_lambda=0.3), dict(delay_penalty=0.05)],
                         ids=["plain", "fastemit", "delay"])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_pruned_loss_matches_jax(engine, kw):
    """Costs and gradients against the XLA engine and the Pallas pipeline
    (K5a → K4 → K5b, interpret mode)."""
    acts, labels, il, ll, ranges = _band_problem(7, B=2, T=8, U=5, V=6, S=3)
    ref_c, ref_g = _jax_pruned(acts, ranges, labels, il, ll, engine, reduction="none", **kw)
    a = torch.tensor(acts, requires_grad=True)
    costs = rnnt_loss_pruned(a, *_t(ranges, labels, il, ll), reduction="none", **kw)
    costs.sum().backward()
    np.testing.assert_allclose(costs.detach().numpy(), ref_c, **COST)
    np.testing.assert_allclose(a.grad.numpy(), ref_g, **GRAD)


@pytest.mark.parametrize("seed,ragged", [(0, False), (1, True), (2, True)])
def test_full_band_equals_port_dense(seed, ragged):
    """A band over the whole lattice (S = U, ranges = 0) is the dense loss:
    costs and gradients equal the port's rnnt_loss."""
    rng = np.random.default_rng(seed)
    B, T, U, V = 3, 6, 4, 5
    acts = rng.standard_normal((B, T, U, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il, ll = _lengths(rng, B, T, U, min_t=2, min_l=1) if ragged else (
        np.full(B, T, np.int32), np.full(B, U - 1, np.int32))
    ranges = np.zeros((B, T), np.int32)
    a = torch.tensor(acts, requires_grad=True)
    dense = rnnt_loss(a, *_t(labels, il, ll), reduction="none")
    (gd,) = torch.autograd.grad(dense.sum(), a)
    pruned = rnnt_loss_pruned(a, *_t(ranges, labels, il, ll), reduction="none")
    (gp,) = torch.autograd.grad(pruned.sum(), a)
    np.testing.assert_allclose(pruned.detach().numpy(), dense.detach().numpy(), **COST)
    np.testing.assert_allclose(gp.numpy(), gd.numpy(), **GRAD)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_pruned_slice_matches_jax(reduction):
    """The whole pruned step — simple loss with prune_range, the band of the
    additive joiner, the pruned loss — against the same chain in JAX:
    ranges, both costs, and the gradients to am and lm through both
    stages. Peaked inputs keep the posterior argmax clear of ties, so the
    two lattices give the same ranges."""
    rng = np.random.default_rng(11)
    B, T, U, V, S = 3, 12, 6, 7, 3
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il = np.array([12, 10, 7], np.int32)
    ll = np.array([5, 4, 3], np.int32)
    am = rng.standard_normal((B, T, V)).astype(np.float32)
    lm = rng.standard_normal((B, U, V)).astype(np.float32)
    for b in range(B):  # emit label u around frame u·T/U, blank elsewhere
        am[b, :, 0] += 3.0
        for u in range(U - 1):
            lm[b, u, labels[b, u]] += 4.0

    def jax_chain(am_, lm_):
        ls, r = JS.rnnt_loss_simple(am_, lm_, *_j(labels, il, ll), reduction=reduction,
                                    implementation="xla", prune_range=S)
        band_acts = am_[:, :, None, :] + JPR.gather_banded(lm_, r, S)
        lp = JPR.rnnt_loss_pruned(band_acts, r, *_j(labels, il, ll), reduction=reduction,
                                  implementation="xla")
        return ls + lp, (ls, lp, r)

    (_, (ls_ref, lp_ref, r_ref)), (gam_ref, glm_ref) = jax.value_and_grad(
        jax_chain, argnums=(0, 1), has_aux=True)(*_j(am, lm))

    a = torch.tensor(am, requires_grad=True)
    m = torch.tensor(lm, requires_grad=True)
    lab, il_t, ll_t = _t(labels, il, ll)
    loss_s, ranges = rnnt_loss_simple(a, m, lab, il_t, ll_t, reduction=reduction, prune_range=S)
    band_acts = a[:, :, None, :] + gather_banded(m, ranges, S)
    loss_p = rnnt_loss_pruned(band_acts, ranges, lab, il_t, ll_t, reduction=reduction)
    (loss_s + loss_p).backward()

    np.testing.assert_array_equal(ranges.numpy(), np.asarray(r_ref))
    np.testing.assert_allclose(loss_s.item(), float(ls_ref), **COST)
    np.testing.assert_allclose(loss_p.item(), float(lp_ref), **COST)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gam_ref), **GRAD)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(glm_ref), **GRAD)


def test_band_cost_bounds_dense_cost():
    """The band holds a subset of the lattice's paths, so on the joint it
    samples the pruned cost is never below the dense cost; with the band
    the port's rnnt_prune_ranges picks it stays within a few nats of it."""
    rng = np.random.default_rng(4)
    B, T, U, V, S = 3, 10, 6, 6, 4
    am, lm = (rng.standard_normal((B, n, V)).astype(np.float32) for n in (T, U))
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    am_t, lm_t, lab, il_t, ll_t = _t(am, lm, labels, il, ll)
    dense = rnnt_loss(am_t[:, :, None] + lm_t[:, None], lab, il_t, ll_t, reduction="none")
    ranges = rnnt_prune_ranges(am_t, lm_t, lab, il_t, ll_t, S)
    band_acts = am_t[:, :, None] + gather_banded(lm_t, ranges, S)
    pruned = rnnt_loss_pruned(band_acts, ranges, lab, il_t, ll_t, reduction="none")
    assert torch.all(pruned >= dense - 1e-4), (pruned, dense)
    assert torch.all(pruned <= dense + 5.0), (pruned, dense)


@pytest.mark.parametrize("case", ["acts_3d", "ranges_shape", "reduction", "fastemit", "delay",
                                  "implementation", "dtype", "noncontiguous"])
def test_pruned_validation(case):
    """The validation of warp_transducer_tpu/ops/pruned.py:570-581, and the
    port's own arguments."""
    acts = torch.zeros(2, 4, 2, 5)
    args = [acts, torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 3, dtype=torch.int32),
            torch.full((2,), 4), torch.full((2,), 2)]
    kw, err = {}, ValueError
    if case == "acts_3d":
        args[0] = acts[0]
    elif case == "ranges_shape":
        args[1] = args[1][:, :2]
    elif case == "dtype":
        args[0], err = acts.to(torch.int32), TypeError
    elif case == "noncontiguous":
        args[0] = torch.zeros(2, 4, 5, 2).transpose(2, 3)
    else:
        kw = {"reduction": dict(reduction="x"), "fastemit": dict(fastemit_lambda=-0.1),
              "delay": dict(delay_penalty=-0.1),
              "implementation": dict(implementation="cuda")}[case]
    with pytest.raises(err):
        rnnt_loss_pruned(*args, **kw)


def test_prune_ranges_rejects_narrow_band():
    am, lm = torch.zeros(1, 4, 3), torch.zeros(1, 3, 3)
    args = (torch.ones(1, 2, dtype=torch.int32), torch.tensor([4]), torch.tensor([2]))
    with pytest.raises(ValueError):
        rnnt_prune_ranges(am, lm, *args, 1)
    with pytest.raises(ValueError):
        ranges_from_posteriors(torch.zeros(1, 4, 3), torch.zeros(1, 4, 3), torch.zeros(1),
                               torch.tensor([4]), torch.tensor([2]), 1)
