"""The port's Transducer model (``models/transducer.py``): its layers, the
five loss functions and the eight train steps, on the CPU, held against the
JAX package's Flax model on weights carried across by
``utils/convert.py::transducer_state_dict_from_flax``.

A Flax tree is made by ``init_params`` and every leaf moved by numpy noise
from a seed, so biases and LayerNorm scales are not at their initial zeros
and ones. Two tiny configurations: two blocks with an odd conv kernel (3)
and one block with an even one (4, padded one more frame on the right), both
with a TDT duration head; the loss functions run on the second alone, to
keep the gate's time. Tolerances, f32: a single module rtol/atol 1e-5,
anything through the whole encoder 1e-4 (four more LayerNorms and the
attention's softmax in a row); losses rtol 1e-5 and every parameter's
gradient within a relative norm error of 1e-4 of ``jax.value_and_grad`` of
the JAX loss function (``implementation="xla"`` where it takes one). One bf16
check of ``Transducer.forward`` at relative norm 2e-2 (the two frameworks
round the bf16 products, the softmax and the LSTM gates at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_programs import release_compiled_programs  # noqa: F401
from warp_transducer_tpu.models import transducer as JM
from warp_transducer_tpu_torch.models import transducer as TM
from warp_transducer_tpu_torch.utils.convert import transducer_state_dict_from_flax

MODULE = dict(rtol=1e-5, atol=1e-5)
WHOLE = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
DURATIONS = (0, 1, 2)
BIG_BLANKS = (2, 3)
S_RANGE = 3
CONFIGS = {"odd_kernel": dict(encoder_layers=2, conv_kernel=3),
           "even_kernel": dict(encoder_layers=1, conv_kernel=4)}
DIMS = dict(vocab_size=16, encoder_dim=32, encoder_heads=2, prediction_dim=32, joint_dim=32,
            input_dim=8, tdt_durations=DURATIONS)
B, T, L = 3, 10, 4


def _cfgs(name, dtype="f32"):
    kw = DIMS | CONFIGS[name]
    return (JM.TransducerConfig(dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype], **kw),
            TM.TransducerConfig(dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype], **kw))


def _flax_tree(jcfg, seed):
    params = jax.jit(lambda key: JM.init_params(jcfg, key))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape))
                        .astype(np.float32), params)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    # labels below V - 2: the multi-blank loss's big blanks take the last two columns
    return {"feats": rng.standard_normal((B, T, DIMS["input_dim"])).astype(np.float32),
            "feat_lengths": np.array([T, T - 3, T - 1], np.int32),
            "labels": rng.integers(1, DIMS["vocab_size"] - 2, (B, L)).astype(np.int32),
            "label_lengths": np.array([L, L - 2, L - 1], np.int32)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    """(flax model, flax params, port model loaded from them, numpy batch)."""
    jcfg, tcfg = _cfgs(request.param)
    params = _flax_tree(jcfg, seed=len(request.param))
    model = TM.Transducer(tcfg, device="cpu")
    model.load_state_dict(transducer_state_dict_from_flax(params), strict=True)
    return JM.make_model(jcfg), params, model, _batch()


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# --- the layers, each against its Flax module on the same weights -----------------------------


def _block_input(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, DIMS["encoder_dim"])).astype(np.float32)
    mask = np.arange(T)[None, :] < _batch()["feat_lengths"][:, None]
    return x, mask


def test_feed_forward(setup):
    _, params, model, _ = setup
    x, _ = _block_input()
    for i, part in ((0, "ff1"), (1, "ff2")):
        sub = params["params"]["Encoder_0"]["ConformerBlock_0"][f"FeedForward_{i}"]
        want = JM.FeedForward(DIMS["encoder_dim"], jnp.float32).apply({"params": sub}, x)
        _close(getattr(model.encoder.blocks[0], part)(torch.tensor(x)), want, MODULE)


def test_conv_module(setup):
    """The GLU, the depthwise conv's SAME padding (odd and even kernels)
    and its LayerNorm (epsilon 1e-6)."""
    _, params, model, _ = setup
    x, _ = _block_input()
    k = model.cfg.conv_kernel
    sub = params["params"]["Encoder_0"]["ConformerBlock_0"]["ConvModule_0"]
    want = JM.ConvModule(DIMS["encoder_dim"], k, jnp.float32).apply({"params": sub}, x)
    _close(model.encoder.blocks[0].conv(torch.tensor(x)), want, MODULE)


def test_conformer_block_ragged_mask(setup):
    """The attention's mask is on keys only: padded queries still attend to
    the valid keys, and their outputs agree too."""
    _, params, model, _ = setup
    x, mask = _block_input()
    sub = params["params"]["Encoder_0"]["ConformerBlock_0"]
    want = JM.ConformerBlock(DIMS["encoder_dim"], DIMS["encoder_heads"], model.cfg.conv_kernel,
                             jnp.float32).apply({"params": sub}, x, mask)
    _close(model.encoder.blocks[0](torch.tensor(x), torch.tensor(mask)), want, MODULE)


def test_encoder(setup):
    flax_model, params, model, batch = setup
    want = flax_model.apply(params, batch["feats"], batch["feat_lengths"],
                            method=flax_model.encode)
    got = model.encode(torch.tensor(batch["feats"]), torch.tensor(batch["feat_lengths"]))
    _close(got, want, WHOLE)
    assert not got[1, T - 3:].any()  # the padded frames are zero


def test_prediction_call_and_steps(setup):
    """``__call__`` prefixes the blank (U = L + 1); ``initial_state`` and U
    ``step``s give the same outputs one token at a time."""
    _, params, model, batch = setup
    jcfg = _cfgs("odd_kernel")[0]
    sub = {"params": params["params"]["Prediction_0"]}
    want = JM.Prediction(jcfg).apply(sub, batch["labels"])
    got = model.prediction(torch.tensor(batch["labels"]))
    assert got.shape == (B, L + 1, DIMS["prediction_dim"])
    _close(got, want, MODULE)
    tokens = np.pad(batch["labels"], ((0, 0), (1, 0)), constant_values=jcfg.blank)
    state = model.predict_init(B)
    for u in range(L + 1):
        state, out = model.predict_step(state, torch.tensor(tokens[:, u]))
        _close(out, want[:, u], MODULE)
    flax_state = JM.Prediction(jcfg).apply(sub, B, method=JM.Prediction.initial_state)
    assert [tuple(s.shape) for s in state] == [s.shape for s in flax_state]


def test_transducer_methods(setup):
    """``forward``, ``factorised_full``, ``tdt_logits`` and ``banded_joint``
    against the Flax model's methods."""
    flax_model, params, model, batch = setup
    args = (batch["feats"], batch["feat_lengths"], batch["labels"])
    targs = tuple(torch.tensor(a) for a in args)
    _close(model(*targs), flax_model.apply(params, *args), WHOLE)
    for got, want in zip(model.factorised_full(*targs),
                         flax_model.apply(params, *args, method=flax_model.factorised_full)):
        _close(got, want, WHOLE)
    for got, want in zip(model.tdt_logits(*targs),
                         flax_model.apply(params, *args, method=flax_model.tdt_logits)):
        _close(got, want, WHOLE)
    rng = np.random.default_rng(4)
    steps = rng.integers(0, 2, (B, T))
    steps[:, 0] = 0
    ranges = np.minimum(np.cumsum(steps, 1), L + 1 - S_RANGE).astype(np.int32)
    want = flax_model.apply(params, *args, ranges, S_RANGE, method=flax_model.banded_joint)
    _close(model.banded_joint(*targs, torch.tensor(ranges), S_RANGE), want, WHOLE)


@pytest.mark.parametrize("setup", ["odd_kernel"], indirect=True)
def test_bf16_forward(setup):
    """cfg.dtype bf16 (the default): f32 parameters, bf16 activations, the
    logits within a relative norm error of 2e-2 of the Flax model's."""
    _, params, _, batch = setup
    jcfg, tcfg = _cfgs("odd_kernel", "bf16")
    model = TM.Transducer(tcfg, device="cpu")
    model.load_state_dict(transducer_state_dict_from_flax(params))
    assert all(q.dtype == torch.float32 for q in model.parameters())
    want = np.asarray(JM.make_model(jcfg).apply(params, batch["feats"], batch["feat_lengths"],
                                                batch["labels"]), np.float32)
    got = model(*(torch.tensor(batch[k]) for k in ("feats", "feat_lengths", "labels")))
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.detach().float().numpy() - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


# --- the converter ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_converter_uses_every_leaf(setup):
    """Every leaf of the Flax tree lands in the state dict (the element
    counts match and each leaf's values are found), and the state dict has
    exactly the model's keys."""
    _, params, model, _ = setup
    state = transducer_state_dict_from_flax(params)
    assert sorted(state) == sorted(model.state_dict())
    leaves = dict(_leaves(params["params"]))
    assert sum(v.size for v in leaves.values()) == sum(t.numel() for t in state.values())
    values = np.sort(np.concatenate([t.numpy().ravel() for t in state.values()]))
    for name, leaf in leaves.items():
        idx = np.searchsorted(values, leaf.ravel())
        assert np.array_equal(values[np.minimum(idx, values.size - 1)], leaf.ravel()), name


@pytest.mark.parametrize("where", ["top", "encoder", "block", "attention", "lstm", "joint"])
def test_converter_refuses_unknown_and_missing(where):
    params = _flax_tree(_cfgs("even_kernel")[0], seed=6)["params"]
    path = {"top": [], "encoder": ["Encoder_0"],
            "block": ["Encoder_0", "ConformerBlock_0"],
            "attention": ["Encoder_0", "ConformerBlock_0", "MultiHeadDotProductAttention_0"],
            "lstm": ["Prediction_0", "ScanOptimizedLSTMCell_0"], "joint": ["Joint_0"]}[where]

    def edited(edit):
        tree = jax.tree.map(lambda x: x, params)  # a copy of the dicts
        node = tree
        for key in path:
            node = node[key]
        edit(node)
        return tree

    extra = edited(lambda node: node.__setitem__("Extra_0", {"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="Extra_0"):
        transducer_state_dict_from_flax({"params": extra})
    needed = {"top": "Prediction_0", "encoder": "Dense_0", "block": "LayerNorm_4",
              "attention": "value", "lstm": "hf", "joint": "Dense_1"}[where]
    lacking = edited(lambda node: node.pop(needed))
    with pytest.raises(KeyError, match="lack"):
        transducer_state_dict_from_flax(lacking)


# --- the five loss functions against jax.value_and_grad ------------------------------------------

LOSSES = {
    "loss_fn": (dict(implementation="xla"), {}),
    "tdt_loss_fn": ({}, {}),
    "multiblank_loss_fn": (dict(big_blank_durations=BIG_BLANKS, sigma=0.05),
                           dict(big_blank_durations=BIG_BLANKS, sigma=0.05)),
    "pruned_loss_fn": (dict(s_range=S_RANGE, implementation="xla"), dict(s_range=S_RANGE)),
    "pruned_fused_loss_fn": (dict(s_range=S_RANGE, implementation="xla"), dict(s_range=S_RANGE)),
}


def _rel_norm(got, want, floor):
    """|got − want| / max(|want|, floor); a missing ``.grad`` counts as zero."""
    want = np.asarray(want, np.float64)
    got = np.zeros_like(want) if got is None else got.detach().double().numpy()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), floor)


@pytest.mark.parametrize("setup", ["even_kernel"], indirect=True)
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_function_and_gradients(setup, name):
    """The loss and every parameter's gradient; the JAX gradient tree goes
    through the same converter, so each leaf lands beside its parameter's
    ``.grad`` (a parameter the loss does not reach has a zero JAX gradient
    and no ``.grad``). The attention's key bias has a zero gradient in exact
    arithmetic (the softmax ignores a shift shared by every key), so both
    sides hold rounding noise there: each error is measured against at
    least 1e-3 of the norm of the whole gradient."""
    flax_model, params, model, batch = setup
    jax_kw, torch_kw = LOSSES[name]
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: getattr(JM, name)(p, flax_model, jax.tree.map(jnp.asarray, batch), **jax_kw)))(
            jax.tree.map(jnp.asarray, params))
    model.zero_grad(set_to_none=True)
    loss = getattr(TM, name)(model, _torch(batch), **torch_kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=LOSS_RTOL)
    want = transducer_state_dict_from_flax(jax.tree.map(np.asarray, grads))
    floor = 1e-3 * float(torch.cat([w.ravel() for w in want.values()]).double().norm())
    for n, q in model.named_parameters():
        rel = _rel_norm(q.grad, want[n].numpy(), floor)
        assert rel <= GRAD_REL, (n, rel)


# --- the eight train steps --------------------------------------------------------------------

STEPS = {
    "make_train_step": {},
    "make_fused_train_step": {},
    "make_tdt_train_step": {},
    "make_tdt_fused_train_step": dict(sigma=0.05),
    "make_multiblank_train_step": dict(big_blank_durations=BIG_BLANKS),
    "make_multiblank_fused_train_step": dict(big_blank_durations=BIG_BLANKS),
    "make_pruned_train_step": dict(s_range=S_RANGE),
    "make_pruned_fused_train_step": dict(s_range=S_RANGE),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_lowers_the_loss(name):
    """A few Adam steps on one batch lower the loss, as the JAX package's
    ``tests/test_models.py`` checks for its steps."""
    cfg = _cfgs("odd_kernel")[1]
    model = TM.Transducer(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = getattr(TM, name)(model, opt, **STEPS[name])
    batch = _torch(_batch())
    losses = [float(step(batch)) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# --- the default device -----------------------------------------------------------------------


@pytest.mark.parametrize("part", ["Joint", "Transducer", "Encoder", "Prediction", "FeedForward"])
def test_builds_on_the_card_or_raises(part, monkeypatch):
    """With no device given the parameters go to the card; with no card
    the module raises rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfgs("odd_kernel")[1]
    args = (32, torch.float32) if part == "FeedForward" else (cfg,)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(TM, part)(*args)
    built = getattr(TM, part)(*args, device="cpu")
    assert all(q.device.type == "cpu" for q in built.parameters())


def test_seeded_initialisation():
    """The same generator seed gives the same weights; another seed other
    weights."""
    cfg = _cfgs("even_kernel")[1]
    a, b, c = (TM.Transducer(cfg, device="cpu", generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    for (n, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), n
    assert not all(torch.equal(x, z) for x, z in zip(a.parameters(), c.parameters()))
