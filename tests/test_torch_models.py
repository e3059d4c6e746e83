"""The port's ``Joint`` module and the function that carries the Flax
module's weights across (``utils/convert.py``), on the CPU, held against the
JAX package's Flax ``Joint``.

A Flax parameter tree is made with numpy from a seed; it goes into
``Joint(cfg).apply`` on the JAX side (``cfg.dtype`` float32) and through
``joint_state_dict_from_flax`` into the port's ``Joint``. Outputs and losses
agree (rtol 1e-5 / atol 1e-5), and so does the gradient of every parameter,
mapped back through the transpose (rtol 1e-4 / atol 1e-4, as the fused-joint
tests). With ``tdt_durations`` the tree also holds the duration head
``DurHead_0`` and the module ``dur_proj``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.models import transducer as JM
from warp_transducer_tpu_torch import rnnt_loss
from warp_transducer_tpu_torch.models import Joint, TransducerConfig
from warp_transducer_tpu_torch.ops import pruned_fused, tdt_fused
from warp_transducer_tpu_torch.utils.convert import joint_state_dict_from_flax

OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
DIMS = dict(vocab_size=11, encoder_dim=6, prediction_dim=5, joint_dim=8)
LAYERS = {"Dense_0": "enc_proj", "Dense_1": "pred_proj", "Dense_2": "out_proj"}
DURATIONS = (0, 1, 2, 4)
TDT_LAYERS = LAYERS | {"DurHead_0": "dur_proj"}


def _tree(seed=0, durations=()):
    rng = np.random.default_rng(seed)
    shapes = {"Dense_0": (DIMS["encoder_dim"], DIMS["joint_dim"]),
              "Dense_1": (DIMS["prediction_dim"], DIMS["joint_dim"]),
              "Dense_2": (DIMS["joint_dim"], DIMS["vocab_size"])}
    if durations:
        shapes["DurHead_0"] = (DIMS["joint_dim"], len(durations))
    return {name: {"kernel": (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32),
                   "bias": (rng.standard_normal(s[1]) * 0.1).astype(np.float32)}
            for name, s in shapes.items()}


def _batch(seed=1, B=3, T=7, U=5, S=3):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, DIMS["encoder_dim"])).astype(np.float32)
    pred = rng.standard_normal((B, U, DIMS["prediction_dim"])).astype(np.float32)
    labels = rng.integers(1, DIMS["vocab_size"], (B, U - 1)).astype(np.int32)
    il = np.array([T, T - 1, T - 2], np.int32)
    ll = np.array([U - 1, U - 2, U - 1], np.int32)
    steps = rng.integers(0, S, (B, T))
    steps[:, 0] = 0
    ranges = np.minimum(np.cumsum(steps, 1), np.maximum(ll[:, None] + 1 - S, 0)).astype(np.int32)
    return enc, pred, labels, il, ll, ranges


@pytest.fixture
def models():
    tree = _tree()
    flax_joint = JM.Joint(JM.TransducerConfig(dtype=jnp.float32, **DIMS))
    joint = Joint(TransducerConfig(dtype=torch.float32, **DIMS), device="cpu")
    joint.load_state_dict(joint_state_dict_from_flax(tree))
    return tree, flax_joint, joint


def _flax_value_and_grads(flax_joint, tree, method, *args, **kw):
    def total(params):
        return jnp.sum(flax_joint.apply({"params": params}, *args, method=method, **kw))

    value, grads = jax.value_and_grad(total)(jax.tree.map(jnp.asarray, tree))
    return float(value), jax.tree.map(np.asarray, grads)


@pytest.fixture
def tdt_models():
    tree = _tree(durations=DURATIONS)
    flax_joint = JM.Joint(JM.TransducerConfig(dtype=jnp.float32, tdt_durations=DURATIONS, **DIMS))
    joint = Joint(TransducerConfig(dtype=torch.float32, tdt_durations=DURATIONS, **DIMS),
                  device="cpu")
    joint.load_state_dict(joint_state_dict_from_flax(tree))
    return tree, flax_joint, joint


def _assert_param_grads(joint, flax_grads, layers=LAYERS):
    for flax_name, name in layers.items():
        layer = getattr(joint, name)
        np.testing.assert_allclose(layer.weight.grad.numpy().T, flax_grads[flax_name]["kernel"],
                                   err_msg=f"{name}.weight", **GRAD)
        np.testing.assert_allclose(layer.bias.grad.numpy(), flax_grads[flax_name]["bias"],
                                   err_msg=f"{name}.bias", **GRAD)


def test_state_dict_from_flax():
    tree = _tree()
    state = joint_state_dict_from_flax(tree)
    assert sorted(state) == sorted(f"{n}.{leaf}" for n in LAYERS.values()
                                   for leaf in ("weight", "bias"))
    for flax_name, name in LAYERS.items():
        assert state[f"{name}.weight"].dtype == torch.float32
        np.testing.assert_array_equal(state[f"{name}.weight"].numpy(), tree[flax_name]["kernel"].T)
        np.testing.assert_array_equal(state[f"{name}.bias"].numpy(), tree[flax_name]["bias"])
    # the same tree under "params", and as Joint_0 of a whole Transducer
    for wrapped in ({"params": tree}, {"params": {"Joint_0": tree, "Encoder_0": {}}},
                    {"Joint_0": tree}):
        again = joint_state_dict_from_flax(wrapped)
        assert all(torch.equal(again[k], state[k]) for k in state)
    Joint(TransducerConfig(dtype=torch.float32, **DIMS), device="cpu").load_state_dict(
        state, strict=True)


def test_state_dict_from_flax_refuses_what_it_does_not_know():
    tree = _tree()
    with pytest.raises(KeyError, match="DurHead_1"):
        joint_state_dict_from_flax({**tree, "DurHead_1": tree["Dense_2"]})
    with pytest.raises(KeyError, match="DurHead_1"):
        joint_state_dict_from_flax({**_tree(durations=DURATIONS), "DurHead_1": tree["Dense_2"]})
    with pytest.raises(KeyError, match="kernel"):
        joint_state_dict_from_flax({**tree, "DurHead_0": {"bias": tree["Dense_2"]["bias"]}})
    with pytest.raises(KeyError, match="lack"):
        joint_state_dict_from_flax({k: v for k, v in tree.items() if k != "Dense_1"})
    with pytest.raises(KeyError, match="kernel"):
        joint_state_dict_from_flax({**tree, "Dense_0": {"kernel": tree["Dense_0"]["kernel"]}})
    with pytest.raises(ValueError, match="Dense_2"):
        joint_state_dict_from_flax({**tree, "Dense_2": {"kernel": tree["Dense_2"]["kernel"],
                                                        "bias": tree["Dense_0"]["bias"]}})


def test_flax_init_tree_loads():
    """The tree Flax itself initialises has the names the function expects."""
    cfg = JM.TransducerConfig(dtype=jnp.float32, **DIMS)
    params = JM.Joint(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, DIMS["encoder_dim"])),
                                jnp.zeros((1, 2, DIMS["prediction_dim"])))
    state = joint_state_dict_from_flax(jax.tree.map(np.asarray, params))
    Joint(TransducerConfig(dtype=torch.float32, **DIMS), device="cpu").load_state_dict(
        state, strict=True)


def test_forward_and_banded_match_flax(models):
    tree, flax_joint, joint = models
    enc, pred, *_ = _batch()
    want = flax_joint.apply({"params": tree}, jnp.asarray(enc), jnp.asarray(pred))
    got = joint(torch.tensor(enc), torch.tensor(pred))
    assert got.shape == (3, 7, 5, DIMS["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT)
    rng = np.random.default_rng(2)
    band = rng.standard_normal((3, 7, 3, DIMS["prediction_dim"])).astype(np.float32)
    want = flax_joint.apply({"params": tree}, jnp.asarray(enc), jnp.asarray(band),
                            method=JM.Joint.banded)
    got = joint.banded(torch.tensor(enc), torch.tensor(band))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_fused_loss_matches_flax(models, reduction):
    tree, flax_joint, joint = models
    enc, pred, labels, il, ll, _ = _batch()
    want, flax_grads = _flax_value_and_grads(
        flax_joint, tree, JM.Joint.fused_loss, *map(jnp.asarray, (enc, pred, labels, il, ll)),
        reduction=reduction, implementation="xla")
    loss = joint.fused_loss(*map(torch.tensor, (enc, pred, labels, il, ll)), reduction=reduction)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, **OUT)
    _assert_param_grads(joint, flax_grads)
    # and the port's own identity: the loss of the module's logits
    fused = [q.grad.clone() for q in joint.parameters()]
    joint.zero_grad()
    dense = rnnt_loss(joint(torch.tensor(enc), torch.tensor(pred)),
                      *map(torch.tensor, (labels, il, ll)), reduction=reduction)
    dense.backward()
    np.testing.assert_allclose(float(loss.detach()), float(dense.detach()), **OUT)
    for a, q in zip(fused, joint.parameters()):
        np.testing.assert_allclose(a.numpy(), q.grad.numpy(), **GRAD)


@pytest.mark.parametrize("route_mb", [0, 4096], ids=["sweep", "materialise"])
def test_pruned_fused_loss_matches_flax(models, route_mb, monkeypatch):
    tree, flax_joint, joint = models
    monkeypatch.setattr(pruned_fused, "_MATERIALIZE_MB", route_mb)
    monkeypatch.setenv("WTT_PRUNED_FUSED_MAT_MB", str(route_mb))
    enc, pred, labels, il, ll, ranges = _batch()
    want, flax_grads = _flax_value_and_grads(
        flax_joint, tree, JM.Joint.pruned_fused_loss,
        *map(jnp.asarray, (enc, pred, ranges, labels, il, ll)), s_range=3, reduction="sum",
        implementation="xla")
    loss = joint.pruned_fused_loss(*map(torch.tensor, (enc, pred, ranges, labels, il, ll)),
                                   s_range=3, reduction="sum")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, **OUT)
    _assert_param_grads(joint, flax_grads)


def test_bf16_activations_keep_f32_parameters():
    joint = Joint(TransducerConfig(dtype=torch.bfloat16, **DIMS), device="cpu")
    joint.load_state_dict(joint_state_dict_from_flax(_tree()))
    enc, pred, labels, il, ll, _ = _batch()
    assert joint(torch.tensor(enc), torch.tensor(pred)).dtype == torch.bfloat16
    loss = joint.fused_loss(*map(torch.tensor, (enc, pred, labels, il, ll)), reduction="sum")
    loss.backward()
    f32 = Joint(TransducerConfig(dtype=torch.float32, **DIMS), device="cpu")
    f32.load_state_dict(joint.state_dict())
    ref = f32.fused_loss(*map(torch.tensor, (enc, pred, labels, il, ll)), reduction="sum")
    np.testing.assert_allclose(float(loss.detach()), float(ref.detach()), rtol=3e-2)
    for q in joint.parameters():
        assert q.dtype == torch.float32 and q.grad.dtype == torch.float32
        assert torch.isfinite(q.grad).all()


def test_duration_head_is_refused():
    """A ``Joint`` without durations has no ``dur_proj``, and its TDT
    methods say so; its state dict refuses a duration head's weights."""
    joint = Joint(TransducerConfig(dtype=torch.float32, **DIMS), device="cpu")
    assert not hasattr(joint, "dur_proj")
    assert sorted(n for n, _ in joint.named_children()) == ["enc_proj", "out_proj", "pred_proj"]
    enc, pred, labels, il, ll, _ = map(torch.tensor, _batch())
    with pytest.raises(ValueError, match="no duration head"):
        joint.tdt(enc, pred)
    with pytest.raises(ValueError, match="no duration head"):
        joint.tdt_step(enc[:, 0], pred[:, 0])
    with pytest.raises(ValueError, match="no duration head"):
        joint.tdt_fused_loss(enc, pred, labels, il, ll)
    with pytest.raises(RuntimeError, match="dur_proj"):
        joint.load_state_dict(joint_state_dict_from_flax(_tree(durations=DURATIONS)))


def test_state_dict_from_flax_carries_the_duration_head():
    tree = _tree(durations=DURATIONS)
    state = joint_state_dict_from_flax(tree)
    assert sorted(state) == sorted(f"{n}.{leaf}" for n in TDT_LAYERS.values()
                                   for leaf in ("weight", "bias"))
    assert state["dur_proj.weight"].shape == (len(DURATIONS), DIMS["joint_dim"])
    np.testing.assert_array_equal(state["dur_proj.weight"].numpy(), tree["DurHead_0"]["kernel"].T)
    np.testing.assert_array_equal(state["dur_proj.bias"].numpy(), tree["DurHead_0"]["bias"])
    joint = Joint(TransducerConfig(dtype=torch.float32, tdt_durations=DURATIONS, **DIMS),
                  device="cpu")
    joint.load_state_dict(state, strict=True)
    # the tree Flax itself initialises, through the method that touches both heads
    cfg = JM.TransducerConfig(dtype=jnp.float32, tdt_durations=DURATIONS, **DIMS)
    params = JM.Joint(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, DIMS["encoder_dim"])),
                                jnp.zeros((1, 2, DIMS["prediction_dim"])), method=JM.Joint.tdt)
    joint.load_state_dict(joint_state_dict_from_flax(jax.tree.map(np.asarray, params)),
                          strict=True)


def test_tdt_heads_and_steps_match_flax(tdt_models):
    tree, flax_joint, joint = tdt_models
    enc, pred, *_ = _batch()
    apply = lambda method, *a: flax_joint.apply({"params": tree}, *map(jnp.asarray, a),  # noqa: E731
                                                method=method)
    tok, dur = joint.tdt(torch.tensor(enc), torch.tensor(pred))
    want_tok, want_dur = apply(JM.Joint.tdt, enc, pred)
    assert tok.shape == (3, 7, 5, DIMS["vocab_size"]) and dur.shape == (3, 7, 5, len(DURATIONS))
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(want_tok), **OUT)
    np.testing.assert_allclose(dur.detach().numpy(), np.asarray(want_dur), **OUT)
    np.testing.assert_allclose(tok.detach().numpy(),
                               joint(torch.tensor(enc), torch.tensor(pred)).detach().numpy())
    # decode time: one frame against one prediction state, and against a beam of 4
    rng = np.random.default_rng(3)
    beam = rng.standard_normal((3, 4, DIMS["prediction_dim"])).astype(np.float32)
    for pred_out in (pred[:, 0], beam):
        got = joint.step(torch.tensor(enc[:, 0]), torch.tensor(pred_out))
        want = apply(JM.Joint.step, enc[:, 0], pred_out)
        assert got.shape == pred_out.shape[:-1] + (DIMS["vocab_size"],)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OUT)
        got = joint.tdt_step(torch.tensor(enc[:, 0]), torch.tensor(pred_out))
        want = apply(JM.Joint.tdt_step, enc[:, 0], pred_out)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **OUT)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_multiblank_fused_loss_matches_flax(models, reduction):
    tree, flax_joint, joint = models
    enc, pred, labels, il, ll, _ = _batch()
    labels = np.minimum(labels, DIMS["vocab_size"] - 3)  # off the two big-blank columns
    kw = dict(reduction=reduction, sigma=0.05, fastemit_lambda=0.1, delay_penalty=0.02)
    want, flax_grads = _flax_value_and_grads(
        flax_joint, tree, JM.Joint.multiblank_fused_loss,
        *map(jnp.asarray, (enc, pred, labels, il, ll)), (2, 3), **kw)
    loss = joint.multiblank_fused_loss(*map(torch.tensor, (enc, pred, labels, il, ll)), (2, 3),
                                       **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, **OUT)
    _assert_param_grads(joint, flax_grads)


@pytest.mark.parametrize("route", ["integrated", "composed"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_tdt_fused_loss_matches_flax(tdt_models, reduction, route, monkeypatch):
    tree, flax_joint, joint = tdt_models
    monkeypatch.setattr(tdt_fused, "_tdt_single_chunk", lambda *a: route == "integrated")
    enc, pred, labels, il, ll, _ = _batch()
    kw = dict(reduction=reduction, sigma=0.05, fastemit_lambda=0.1, delay_penalty=0.02)
    want, flax_grads = _flax_value_and_grads(
        flax_joint, tree, JM.Joint.tdt_fused_loss, *map(jnp.asarray, (enc, pred, labels, il, ll)),
        **kw)
    loss = joint.tdt_fused_loss(*map(torch.tensor, (enc, pred, labels, il, ll)), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, **OUT)
    _assert_param_grads(joint, flax_grads, TDT_LAYERS)
    # and the port's own identity: the TDT loss of the module's two heads
    from warp_transducer_tpu_torch import rnnt_loss_tdt
    fused = [q.grad.clone() for q in joint.parameters()]
    joint.zero_grad()
    dense = rnnt_loss_tdt(*joint.tdt(torch.tensor(enc), torch.tensor(pred)),
                          *map(torch.tensor, (labels, il, ll)), DURATIONS, **kw)
    dense.backward()
    np.testing.assert_allclose(float(loss.detach()), float(dense.detach()), **OUT)
    for a, q in zip(fused, joint.parameters()):
        np.testing.assert_allclose(a.numpy(), q.grad.numpy(), **GRAD)
