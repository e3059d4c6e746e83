"""The plain fused-joint stages with their two hooks — K extra vocabulary
columns (the big blanks of the multi-blank loss) and the duration head of
the TDT loss — and the plain standalone duration-head pair
(``ops/fused_joint.py``: the plain versions of csrc/joint_prep.cu,
joint_grad.cu and dur_head.cu) on the CPU, held against the JAX package: its
portable ``_fused_prep_xla`` / ``_fused_grad_xla`` and the six Pallas calls
of ``pallas/joint_fused.py`` (``fused_prep_mb``, ``fused_grad_mb``,
``fused_prep_tdt``, ``fused_grad_tdt``, ``dur_head_prep``, ``dur_head_grad``)
in interpret mode.

Inputs are made with numpy from a seed and given to both as the same arrays.
Tolerances: f32 rtol 1e-5 / atol 1e-6 on the prep outputs (sums over H and V
taken in another order), rtol 1e-4 / atol 1e-5 on the gradients (sums over
every row); with bf16 W the prep within atol 1e-3 (a tanh that differs in its
last bit can round h to the neighbouring bf16 value) and the gradients within
a relative norm error of 2e-2. The (B, T, U) fields are compared at the cells
inside each utterance's lattice: outside it the port holds its sentinels
(NEG, 0) and the JAX functions the values of the padding rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.ops import fused_joint as JF
from warp_transducer_tpu.ops.pallas import joint_fused as K6
from warp_transducer_tpu_torch.ops import fused_joint, gradients
from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
from warp_transducer_tpu_torch.ops.prep import NEG

PREP = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)

# seed, B, T, U, V, H, K, D
SHAPES = [(0, 2, 6, 4, 9, 16, 2, 4), (1, 3, 7, 5, 40, 8, 1, 1), (2, 2, 9, 3, 300, 16, 3, 5),
          (3, 2, 12, 5, 33, 12, 8, 8)]
IDS = ["small", "K1_D1", "V300", "K8_D8"]


def _problem(seed, B, T, U, V, H, K, D, ragged=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    e, p = f(B, T, H, scale=0.5), f(B, U, H, scale=0.5)
    W, bias = f(H, V, scale=1 / np.sqrt(H)), f(V, scale=0.1)
    Wd, bias_d = f(H, D, scale=1 / np.sqrt(H)), f(D, scale=0.1)
    labels = rng.integers(1, V - K, (B, U - 1)).astype(np.int32)  # off blank 0 and the last K
    if ragged:
        il = rng.integers(1, T + 1, B).astype(np.int32)
        ll = rng.integers(0, U, B).astype(np.int32)
        il[0], ll[0] = T, U - 1
        ll[-1] = 0
    else:
        il, ll = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    return dict(e=e, p=p, W=W, bias=bias, Wd=Wd, bias_d=bias_d, labels=labels, il=il, ll=ll,
                cols=tuple(range(V - K, V)))


def _t(x, dtype=None):
    x = torch.tensor(np.asarray(x))
    return x.to(dtype) if dtype is not None else x


def _valid(il, ll, T, U):
    return (np.arange(T)[None, :, None] < il[:, None, None]) & \
        (np.arange(U)[None, None, :] <= ll[:, None, None])


def _fields(q, n, seed):
    """n random (B, T, U) fields, zero outside each utterance's lattice."""
    rng = np.random.default_rng(seed)
    B, T, U = q["e"].shape[0], q["e"].shape[1], q["p"].shape[1]
    valid = _valid(q["il"], q["ll"], T, U)
    return [(rng.random((B, T, U)) * valid).astype(np.float32) for _ in range(n)]


def _torch_prep(q, fn=fused_joint.fused_prep, w_dtype=None, **kw):
    return fn(_t(q["e"]), _t(q["p"]), _t(q["W"], w_dtype), _t(q["bias"]), _t(q["labels"]),
              _t(q["il"]), _t(q["ll"]), 0, **kw)


def _jax_base(q, w_dtype=None):
    return [jnp.asarray(q["e"]), jnp.asarray(q["p"]), jnp.asarray(q["W"], w_dtype),
            jnp.asarray(q["bias"])]


def _full(q):
    """The label lengths the JAX losses hand their kernels: U - 1 everywhere."""
    return jnp.full((q["e"].shape[0],), q["p"].shape[1] - 1, jnp.int32)


def _assert_prep(got, denom, lpb, lpe, q, tol=PREP):
    T, U = q["e"].shape[1], q["p"].shape[1]
    valid = _valid(q["il"], q["ll"], T, U)
    has_label = valid & (np.arange(U) < U - 1)
    np.testing.assert_allclose(got.denom.numpy()[valid], np.asarray(denom)[valid], **tol)
    np.testing.assert_allclose(got.lpb.numpy()[valid], np.asarray(lpb)[valid], **tol)
    np.testing.assert_allclose(got.lpe.numpy()[has_label], np.asarray(lpe)[has_label], **tol)
    assert np.all(got.lpe.numpy()[~has_label] == NEG)
    return valid


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,K,D", SHAPES, ids=IDS)
def test_prep_extra_cols(seed, B, T, U, V, H, K, D, engine):
    q = _problem(seed, B, T, U, V, H, K, D)
    got = _torch_prep(q, extra_cols=q["cols"])
    if engine == "xla":
        denom, lpb, lpe, lpX = JF._fused_prep_xla(*_jax_base(q), jnp.asarray(q["labels"]), 0,
                                                  extra_cols=q["cols"])
    else:
        denom, lpb, lpe, lpX = K6.fused_prep_mb(*_jax_base(q), jnp.asarray(q["labels"]), _full(q),
                                                blank=0, extra_cols=q["cols"], interpret=True)
    valid = _assert_prep(got, denom, lpb, lpe, q)
    assert got.extras.shape == (B, T, U, K) and got.dur is None
    np.testing.assert_allclose(got.extras.numpy()[valid], np.asarray(lpX)[valid], **PREP)
    assert np.all(got.extras.numpy()[~valid] == NEG)
    # the extra columns are those very columns of the log-softmax
    h = np.tanh(q["e"][:, :, None] + q["p"][:, None])
    logp = torch.log_softmax(_t(h @ q["W"] + q["bias"]), -1).numpy()
    np.testing.assert_allclose(got.extras.numpy()[valid], logp[..., list(q["cols"])][valid],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,K,D", SHAPES, ids=IDS)
def test_prep_dur_head(seed, B, T, U, V, H, K, D, engine):
    q = _problem(seed, B, T, U, V, H, K, D)
    got = _torch_prep(q, dur_head=(_t(q["Wd"]), _t(q["bias_d"])))
    head = (jnp.asarray(q["Wd"]), jnp.asarray(q["bias_d"]))
    if engine == "xla":
        denom, lpb, lpe, dlog = JF._fused_prep_xla(*_jax_base(q), jnp.asarray(q["labels"]), 0,
                                                   dur_head=head)
    else:
        denom, lpb, lpe, dlog = K6.fused_prep_tdt(*_jax_base(q), *head, jnp.asarray(q["labels"]),
                                                  _full(q), blank=0, interpret=True)
    valid = _assert_prep(got, denom, lpb, lpe, q)
    assert got.dur.shape == (B, T, U, D) and got.extras is None
    np.testing.assert_allclose(got.dur.numpy()[valid], np.asarray(dlog)[valid], **PREP)
    assert np.all(got.dur.numpy()[~valid] == 0)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,K,D", SHAPES, ids=IDS)
def test_grad_extra_fields(seed, B, T, U, V, H, K, D, engine):
    q = _problem(seed, B, T, U, V, H, K, D)
    denom = _torch_prep(q).denom
    f = _fields(q, 3 + K, seed + 10)
    cX = np.stack(f[3:], axis=-1)
    got = fused_joint.fused_grad(
        _t(q["e"]), _t(q["p"]), _t(q["W"]), _t(q["bias"]), _t(q["labels"]), _t(q["il"]),
        _t(q["ll"]), denom, gradients.Coefficients(*map(_t, f[:3])), 0,
        extra=(q["cols"], _t(cX)))
    args = (*_jax_base(q), jnp.asarray(q["labels"]))
    fields = [jnp.asarray(denom.numpy())] + [jnp.asarray(x) for x in f[:3]]
    if engine == "xla":
        want = JF._fused_grad_xla(*args, *fields, 0, extra=(q["cols"], jnp.asarray(cX)))
    else:
        want = K6.fused_grad_mb(*args, _full(q), *fields, jnp.asarray(cX), blank=0,
                                extra_cols=q["cols"], interpret=True)
    assert len(got) == len(want) == 4
    for name, a, b in zip(("de", "dp", "dW", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("seed,B,T,U,V,H,K,D", SHAPES, ids=IDS)
def test_grad_dur_head(seed, B, T, U, V, H, K, D, engine):
    q = _problem(seed, B, T, U, V, H, K, D)
    denom = _torch_prep(q).denom
    f = _fields(q, 3 + D, seed + 20)
    gd = np.stack(f[3:], axis=-1) - 0.5 * f[0][..., None]  # mixed signs, zero outside
    got = fused_joint.fused_grad(
        _t(q["e"]), _t(q["p"]), _t(q["W"]), _t(q["bias"]), _t(q["labels"]), _t(q["il"]),
        _t(q["ll"]), denom, gradients.Coefficients(*map(_t, f[:3])), 0,
        dur_head=(_t(q["Wd"]), _t(gd)))
    fields = [jnp.asarray(denom.numpy())] + [jnp.asarray(x) for x in f[:3]]
    if engine == "xla":
        want = JF._fused_grad_xla(*_jax_base(q), jnp.asarray(q["labels"]), *fields, 0,
                                  dur_head=(jnp.asarray(q["Wd"]), jnp.asarray(gd)))
    else:
        want = K6.fused_grad_tdt(*_jax_base(q), jnp.asarray(q["Wd"]), jnp.asarray(q["labels"]),
                                 _full(q), *fields, jnp.asarray(gd), blank=0, interpret=True)
    assert len(got) == len(want) == 5
    for name, a, b in zip(("de", "dp", "dW", "db", "dWd"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("seed,B,T,U,V,H,K,D", SHAPES, ids=IDS)
def test_dur_head_pair(seed, B, T, U, V, H, K, D):
    """The standalone duration head against ``dur_head_prep`` and
    ``dur_head_grad`` in interpret mode, and composed with the plain token
    head against the stages that hold the duration head inside."""
    q = _problem(seed, B, T, U, V, H, K, D)
    e, p, Wd, bias_d = (_t(q[k]) for k in ("e", "p", "Wd", "bias_d"))
    je, jp, jWd, jbd = (jnp.asarray(q[k]) for k in ("e", "p", "Wd", "bias_d"))
    got = fused_joint.dur_head_prep(e, p, Wd, bias_d)
    np.testing.assert_allclose(got.numpy(), np.asarray(K6.dur_head_prep(je, jp, jWd, jbd,
                                                                        interpret=True)), **PREP)
    il, ll = _t(q["il"]), _t(q["ll"])
    masked = fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll)
    inside = _torch_prep(q, dur_head=(Wd, bias_d)).dur
    np.testing.assert_allclose(masked.numpy(), inside.numpy(), rtol=1e-6, atol=1e-7)

    f = _fields(q, 3 + D, seed + 30)
    gd = np.stack(f[3:], axis=-1) - 0.5 * f[0][..., None]
    de2, dp2, dWd = fused_joint.dur_head_grad(e, p, Wd, _t(gd), il, ll)
    want = K6.dur_head_grad(je, jp, jWd, jnp.asarray(gd), interpret=True)
    for name, a, b in zip(("de2", "dp2", "dWd"), (de2, dp2, dWd), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)
    # token head alone + duration head alone = both in one pass
    denom = _torch_prep(q).denom
    base = (e, p, _t(q["W"]), _t(q["bias"]), _t(q["labels"]), il, ll, denom,
            gradients.Coefficients(*map(_t, f[:3])), 0)
    alone = fused_joint.fused_grad(*base)
    both = fused_joint.fused_grad(*base, dur_head=(Wd, _t(gd)))
    for name, a, b in zip(("de", "dp", "dW", "db", "dWd"),
                          (alone[0] + de2, alone[1] + dp2, alone[2], alone[3], dWd), both):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, rtol=1e-5, atol=1e-6)


def test_both_hooks_at_once():
    """The plain stages take the extra columns and the duration head in one
    call (the CUDA kernels do too); the JAX package's XLA stages as well."""
    q = _problem(4, 2, 6, 4, 12, 8, 2, 3)
    head = (_t(q["Wd"]), _t(q["bias_d"]))
    got = _torch_prep(q, extra_cols=q["cols"], dur_head=head)
    denom, lpb, lpe, lpX, dlog = JF._fused_prep_xla(
        *_jax_base(q), jnp.asarray(q["labels"]), 0, extra_cols=q["cols"],
        dur_head=(jnp.asarray(q["Wd"]), jnp.asarray(q["bias_d"])))
    valid = _assert_prep(got, denom, lpb, lpe, q)
    np.testing.assert_allclose(got.extras.numpy()[valid], np.asarray(lpX)[valid], **PREP)
    np.testing.assert_allclose(got.dur.numpy()[valid], np.asarray(dlog)[valid], **PREP)
    f = _fields(q, 3 + 2 + 3, 40)
    cX, gd = np.stack(f[3:5], axis=-1), np.stack(f[5:], axis=-1)
    grads = fused_joint.fused_grad(
        _t(q["e"]), _t(q["p"]), _t(q["W"]), _t(q["bias"]), _t(q["labels"]), _t(q["il"]),
        _t(q["ll"]), got.denom, gradients.Coefficients(*map(_t, f[:3])), 0,
        extra=(q["cols"], _t(cX)), dur_head=(head[0], _t(gd)))
    want = JF._fused_grad_xla(
        *_jax_base(q), jnp.asarray(q["labels"]), jnp.asarray(got.denom.numpy()),
        *[jnp.asarray(x) for x in f[:3]], 0, extra=(q["cols"], jnp.asarray(cX)),
        dur_head=(jnp.asarray(q["Wd"]), jnp.asarray(gd)))
    for name, a, b in zip(("de", "dp", "dW", "db", "dWd"), grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD)


@pytest.mark.parametrize("hook", ["extra_cols", "dur_head"])
def test_bf16_weight(hook):
    """bf16 W: the token head rounds h and g to bf16, as the JAX package;
    the duration head takes the unrounded h, so its outputs stay at the f32
    tolerances."""
    q = _problem(5, 2, 7, 4, 40, 16, 2, 4)
    bf = torch.bfloat16
    head = (_t(q["Wd"]), _t(q["bias_d"]))
    kw = {"extra_cols": q["cols"]} if hook == "extra_cols" else {"dur_head": head}
    got = _torch_prep(q, w_dtype=bf, **kw)
    jkw = dict(kw) if hook == "extra_cols" else {"dur_head": (jnp.asarray(q["Wd"]),
                                                              jnp.asarray(q["bias_d"]))}
    out = JF._fused_prep_xla(*_jax_base(q, jnp.bfloat16), jnp.asarray(q["labels"]), 0, **jkw)
    valid = _assert_prep(got, *out[:3], q, tol=dict(rtol=1e-5, atol=1e-3))
    f = _fields(q, 3 + 4, 50)
    fields = gradients.Coefficients(*map(_t, f[:3]))
    jfields = [jnp.asarray(got.denom.numpy())] + [jnp.asarray(x) for x in f[:3]]
    base = (_t(q["e"]), _t(q["p"]), _t(q["W"], bf), _t(q["bias"]), _t(q["labels"]), _t(q["il"]),
            _t(q["ll"]), got.denom, fields, 0)
    if hook == "extra_cols":
        np.testing.assert_allclose(got.extras.numpy()[valid], np.asarray(out[3])[valid],
                                   rtol=1e-5, atol=1e-3)
        cX = np.stack(f[3:5], axis=-1)
        grads = fused_joint.fused_grad(*base, extra=(q["cols"], _t(cX)))
        want = JF._fused_grad_xla(*_jax_base(q, jnp.bfloat16), jnp.asarray(q["labels"]), *jfields,
                                  0, extra=(q["cols"], jnp.asarray(cX)))
    else:
        np.testing.assert_allclose(got.dur.numpy()[valid], np.asarray(out[3])[valid], **PREP)
        f32 = _torch_prep(q, dur_head=head).dur
        assert torch.equal(got.dur, f32)
        gd = np.stack(f[3:], axis=-1) - 0.5 * f[0][..., None]
        grads = fused_joint.fused_grad(*base, dur_head=(head[0], _t(gd)))
        want = JF._fused_grad_xla(*_jax_base(q, jnp.bfloat16), jnp.asarray(q["labels"]), *jfields,
                                  0, dur_head=(jnp.asarray(q["Wd"]), jnp.asarray(gd)))
        np.testing.assert_allclose(grads[4].numpy(), np.asarray(want[4]), **GRAD)
        assert grads[4].dtype == torch.float32
    assert grads[2].dtype == bf
    for name, a, b in zip(("de", "dp", "dW", "db"), grads, want):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b), name


def test_cpu_tensors_take_the_plain_versions():
    """The kernel wrappers given CPU tensors run the plain versions, hooks
    included (on a CUDA tensor they launch or raise)."""
    q = _problem(6, 2, 5, 3, 10, 8, 2, 3)
    head = (_t(q["Wd"]), _t(q["bias_d"]))
    a = _torch_prep(q, fn=kjoint.fused_prep, extra_cols=q["cols"], dur_head=head)
    b = _torch_prep(q, extra_cols=q["cols"], dur_head=head)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    e, p = _t(q["e"]), _t(q["p"])
    assert torch.equal(kjoint.dur_head_prep(e, p, *head), fused_joint.dur_head_prep(e, p, *head))
    gd = _t(np.stack(_fields(q, 3, 60), axis=-1))
    for x, y in zip(kjoint.dur_head_grad(e, p, head[0], gd),
                    fused_joint.dur_head_grad(e, p, head[0], gd)):
        assert torch.equal(x, y)


def test_validation():
    q = _problem(7, 2, 5, 3, 10, 8, 2, 3)
    head = (_t(q["Wd"]), _t(q["bias_d"]))
    with pytest.raises(ValueError, match="extra columns"):
        _torch_prep(q, extra_cols=(10,))
    # nine extra columns and a head of nine columns compute (no cap)
    assert _torch_prep(q, extra_cols=tuple(range(9))).extras.shape[-1] == 9
    assert fused_joint.dur_head_prep(_t(q["e"]), _t(q["p"]), torch.zeros(8, 9),
                                     torch.zeros(9)).shape[-1] == 9
    with pytest.raises(ValueError, match="Wd must be"):
        _torch_prep(q, dur_head=(head[0][:4], head[1]))
    with pytest.raises(ValueError, match="Wd must be"):
        fused_joint.dur_head_prep(_t(q["e"]), _t(q["p"]), torch.zeros(8, 0), torch.zeros(0))
    with pytest.raises(ValueError, match="bias_d has 2 columns"):
        _torch_prep(q, dur_head=(head[0], head[1][:2]))
    denom = _torch_prep(q).denom
    fields = gradients.Coefficients(denom, denom, denom)
    base = (_t(q["e"]), _t(q["p"]), _t(q["W"]), _t(q["bias"]), _t(q["labels"]), _t(q["il"]),
            _t(q["ll"]), denom, fields, 0)
    with pytest.raises(ValueError, match="extra fields must be"):
        fused_joint.fused_grad(*base, extra=(q["cols"], denom[..., None]))
    with pytest.raises(ValueError, match="g_dur has 2 columns"):
        fused_joint.fused_grad(*base, dur_head=(head[0], torch.zeros(2, 5, 3, 2)))
