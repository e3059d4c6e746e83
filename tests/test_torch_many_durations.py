"""The duration-arc losses of warp_transducer_tpu_torch at duration sets of
more than eight members, held against the JAX package: TDT with D = 9, 17
and 33 durations (33 crosses a warp's 32 lanes in the kernels), the
multi-blank loss with K = 9 and 16 big blanks, raw and on log-probs, the two
fused losses at D = 9 and K = 9, ``multiblank_viterbi_align`` at K = 9, the
binding's ``rnnt_loss_multiblank`` at K = 9 and the TDT loss function of a
small model with durations 0 … 8 (the TDT paper's set, arXiv:2304.06795),
whose weights the converter carries over from the Flax model.

The port has no cap on the duration set; the kernels' counterparts of
these calls run past eight columns in instances of their own
(tests/test_torch_cuda_many_durations.py holds them on a card). Here the
port runs its plain PyTorch versions (CPU tensors). The references are the
JAX package's: its XLA engines for the fused losses, the alignment and the
model, and its float64 oracles (``utils/numpy_oracle_tdt.py``,
``utils/numpy_oracle_multiblank.py``) for the losses on logits, whose XLA
lattices compile for a minute and more at 17 and 33 durations (the oracles
are the references the JAX package's own tests hold its engines to).
Inputs are made with numpy from a seed.

Tolerances: f64 costs and gradients 1e-9 (rounding only); f32 as
tests/test_torch_tdt.py: costs rtol 1e-5, gradients rtol 1e-4 / atol 2e-5;
the f32 model loss rtol 1e-5 (as tests/test_torch_transducer.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.models import transducer as JM
from warp_transducer_tpu.ops import alignment as JA
from warp_transducer_tpu.ops import multiblank_fused as JMF
from warp_transducer_tpu.ops import tdt_fused as JTF
from warp_transducer_tpu.utils import numpy_oracle_multiblank as omb
from warp_transducer_tpu.utils import numpy_oracle_tdt as otdt
from warp_transducer_tpu_torch import (rnnt_loss_multiblank, rnnt_loss_multiblank_fused_joint,
                                       rnnt_loss_tdt, rnnt_loss_tdt_fused_joint)
from warp_transducer_tpu_torch.bindings import torch_binding as tb
from warp_transducer_tpu_torch.models import transducer as TM
from warp_transducer_tpu_torch.ops import alignment as TA
from warp_transducer_tpu_torch.utils.convert import transducer_state_dict_from_flax
from jax_programs import release_compiled_programs  # noqa: F401
from test_torch_multiblank_log_probs import _expected, _problem as _lp_problem

F64 = dict(rtol=1e-9, atol=1e-9)
F32_COST = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=2e-5)


def _tdt_problem(seed, D, B=2, T=10, U=4, V=6):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((B, T, U, V)) * 2.0
    dur = rng.standard_normal((B, T, U, D)) * 2.0
    labels = rng.integers(1, V, (B, U - 1)).astype(np.int32)
    il = np.array([T, T - 3], np.int32)
    ll = np.array([U - 1, U - 2], np.int32)
    return tok, dur, labels, il, ll


def _mb_problem(seed, K, B=2, T=10, U=4, V=None):
    V = V or K + 4
    rng = np.random.default_rng(seed)
    acts = rng.standard_normal((B, T, U, V)) * 2.0
    labels = rng.integers(1, V - K, (B, U - 1)).astype(np.int32)
    return acts, labels, np.array([T, T - 2], np.int32), np.array([U - 1, U - 3], np.int32)


def _big_blanks(K):
    """K big-blank durations: 2 … K + 1 (a window past a warp's lanes at K = 32)."""
    return tuple(range(2, K + 2))


@pytest.mark.parametrize("D,dtype", [(9, "f64"), (17, "f64"), (33, "f64"), (9, "f32")])
def test_tdt(D, dtype):
    durs = tuple(range(D))
    tok, dur, labels, il, ll = _tdt_problem(D, D)
    tdt = torch.float64 if dtype == "f64" else torch.float32
    t = torch.tensor(tok, dtype=tdt, requires_grad=True)
    d = torch.tensor(dur, dtype=tdt, requires_grad=True)
    costs = rnnt_loss_tdt(t, d, torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durs,
                          reduction="none", sigma=0.05, fastemit_lambda=0.1)
    costs.sum().backward()
    # the oracle on the same values as the port's inputs
    x = (tok, dur) if dtype == "f64" else (t.detach().double().numpy(), d.detach().double().numpy())
    oc, ogt, ogd = otdt.tdt_batch(*x, labels, il, ll, durs, sigma=0.05, fastemit_lambda=0.1)
    cost_tol, grad_tol = (F64, F64) if dtype == "f64" else (F32_COST, F32_GRAD)
    np.testing.assert_allclose(costs.detach().double().numpy(), oc, **cost_tol)
    np.testing.assert_allclose(t.grad.double().numpy(), ogt, **grad_tol)
    np.testing.assert_allclose(d.grad.double().numpy(), ogd, **grad_tol)


def _port_multiblank(acts, labels, il, ll, durs, fn=rnnt_loss_multiblank, **kw):
    a = torch.tensor(acts, requires_grad=True)
    costs = fn(a, torch.tensor(labels), torch.tensor(il), torch.tensor(ll), durs,
               reduction="none", sigma=0.05, fastemit_lambda=0.1, **kw)
    costs.sum().backward()
    return costs.detach().numpy(), a.grad.numpy()


@pytest.mark.parametrize("K", [9, 16])
def test_multiblank(K):
    durs = _big_blanks(K)
    acts, labels, il, ll = _mb_problem(K, K)
    costs, grads = _port_multiblank(acts, labels, il, ll, durs)
    oc, og = omb.multiblank_batch(acts, labels, il, ll, durs, sigma=0.05, fastemit_lambda=0.1)
    np.testing.assert_allclose(costs, oc, **F64)
    np.testing.assert_allclose(grads, og, **F64)


@pytest.mark.parametrize("K", [9, 16])
def test_multiblank_log_probs(K):
    """The binding on log-probs against the float64 oracle of the JAX
    package (its sparse gradient, as the native engine writes it)."""
    durs = _big_blanks(K)
    lp, labels, il, ll = _lp_problem(K, B=2, T=10, L=3, V=K + 4, K=K)
    idx = tuple(range(4, K + 4))
    x = torch.tensor(lp, requires_grad=True)
    costs = tb.rnnt_loss_multiblank(x, torch.tensor(labels), torch.tensor(il), torch.tensor(ll),
                                    durs, sigma=0.05, reduction="none", from_log_probs=True)
    costs.sum().backward()
    want_c, want_g = _expected(lp, labels, il, ll, durs, idx, sigma=0.05)
    np.testing.assert_allclose(costs.detach().numpy(), want_c, **F64)
    np.testing.assert_allclose(x.grad.numpy(), want_g, **F64)


def test_binding_multiblank_raw():
    durs = _big_blanks(9)
    acts, labels, il, ll = _mb_problem(3, 9)
    costs, grads = _port_multiblank(acts, labels, il, ll, durs, fn=tb.rnnt_loss_multiblank)
    oc, og = omb.multiblank_batch(acts, labels, il, ll, durs, sigma=0.05, fastemit_lambda=0.1)
    np.testing.assert_allclose(costs, oc, **F64)
    np.testing.assert_allclose(grads, og, **F64)


def _joint(seed, B=2, T=5, U=4, V=14, H=8, D=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    floats = [f(B, T, H, scale=0.5), f(B, U, H, scale=0.5), f(H, V, scale=1 / np.sqrt(H)),
              f(V, scale=0.1)]
    if D:
        floats += [f(H, D, scale=1 / np.sqrt(H)), f(D, scale=0.1)]
    labels = rng.integers(1, 5, (B, U - 1)).astype(np.int32)
    ints = (labels, np.array([T, T - 1], np.int32), np.array([U - 1, U - 2], np.int32))
    return floats, ints


@pytest.mark.parametrize("loss", ["tdt", "multiblank"])
def test_fused_losses(loss):
    if loss == "tdt":
        floats, ints = _joint(9, D=9)
        kw = dict(durations=tuple(range(9)), sigma=0.05)
        port, jfn = rnnt_loss_tdt_fused_joint, JTF.rnnt_loss_tdt_fused_joint
    else:
        floats, ints = _joint(10)
        kw = dict(big_blank_durations=_big_blanks(9))
        port, jfn = rnnt_loss_multiblank_fused_joint, JMF.rnnt_loss_multiblank_fused_joint
    leaves = [torch.tensor(x).requires_grad_(True) for x in floats]
    costs = port(*leaves, *map(torch.tensor, ints), reduction="none", **kw)
    grads = torch.autograd.grad(costs.sum(), leaves)

    def total(*a):
        c = jfn(*a, *map(jnp.asarray, ints), reduction="none", **kw)
        return jnp.sum(c), c

    (_, jc), jg = jax.jit(jax.value_and_grad(total, argnums=tuple(range(len(floats))),
                                             has_aux=True))(*map(jnp.asarray, floats))
    np.testing.assert_allclose(costs.detach().numpy(), np.asarray(jc), **F32_COST)
    for i, (g, w) in enumerate(zip(grads, jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=str(i), **F32_GRAD)


def test_multiblank_viterbi_align():
    durs = _big_blanks(9)
    acts, labels, il, ll = _mb_problem(11, 9)
    want = jax.jit(JA.multiblank_viterbi_align, static_argnames=("big_blank_durations", "sigma"))(
        jnp.asarray(acts), jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll),
        big_blank_durations=durs, sigma=0.05)
    got = TA.multiblank_viterbi_align(torch.tensor(acts), torch.tensor(labels), torch.tensor(il),
                                      torch.tensor(ll), durs, sigma=0.05)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), **F64)
    for field in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


def test_tdt_model_loss():
    """``tdt_loss_fn`` of a small f32 model with durations 0 … 8, its weights
    carried over from the Flax model, against the JAX package's."""
    kw = dict(vocab_size=12, encoder_dim=16, encoder_heads=2, encoder_layers=1, conv_kernel=3,
              prediction_dim=16, joint_dim=16, input_dim=8, tdt_durations=tuple(range(9)))
    jcfg = JM.TransducerConfig(dtype=jnp.float32, **kw)
    tcfg = TM.TransducerConfig(dtype=torch.float32, **kw)
    rng = np.random.default_rng(12)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(12)))
    model = TM.Transducer(tcfg, device="cpu")
    model.load_state_dict(transducer_state_dict_from_flax(params), strict=True)
    B, T, L = 2, 8, 3
    batch = {"feats": rng.standard_normal((B, T, 8)).astype(np.float32),
             "feat_lengths": np.array([T, T - 3], np.int32),
             "labels": rng.integers(1, 12, (B, L)).astype(np.int32),
             "label_lengths": np.array([L, L - 1], np.int32)}
    flax_model = JM.make_model(jcfg)
    value = jax.jit(lambda p: JM.tdt_loss_fn(p, flax_model, jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, params))
    loss = TM.tdt_loss_fn(model, {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
