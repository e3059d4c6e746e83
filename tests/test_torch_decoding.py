"""The port's decoders (``models/decoding.py``) on the CPU, held against the
JAX package's (``warp_transducer_tpu/models/decoding.py``) on the same
weights, and the decoders' properties rescored through the port's
alignments and losses (after ``tests/test_models.py::TestBeamSearch``,
``tests/test_multiblank.py::test_greedy_decode_big_blanks`` and
``tests/test_tdt.py::test_model_train_and_decode``).

A tiny f32 configuration (vocabulary 8, widths 16, one conformer block), a
Flax tree from ``init_params``, and the port's ``Transducer`` loaded from it
through ``transducer_state_dict_from_flax``. The JAX decoders run jitted
with x64 off, as they run outside the tests (the suite turns x64 on), so
both sides score in f32. Tolerances: tokens and lengths equal in every beam
slot, dead ones included; scores rtol 1e-5, atol 1e-4; the properties'
bounds 1e-3 (the decode step and the full lattice take their products in
other shapes) and 1e-5 between two beam searches of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warp_transducer_tpu_torch as W
from jax_programs import release_compiled_programs  # noqa: F401
from warp_transducer_tpu.models import decoding as JD
from warp_transducer_tpu.models import transducer as JM
from warp_transducer_tpu_torch.models import decoding as TD
from warp_transducer_tpu_torch.models import transducer as TM
from warp_transducer_tpu_torch.utils.convert import transducer_state_dict_from_flax

SCORES = dict(rtol=1e-5, atol=1e-4)
BOUND = 1e-3
DIMS = dict(vocab_size=8, encoder_dim=16, encoder_layers=1, encoder_heads=2, prediction_dim=16,
            joint_dim=16, input_dim=6, conv_kernel=3)
B, T, MAX_SYMBOLS = 3, 7, 6
BIG_BLANKS, SIGMA = (2, 3), 0.05
TDT_DURATIONS = (0, 1, 2)


def _setup(tdt, key, seed):
    jcfg = JM.TransducerConfig(dtype=jnp.float32, tdt_durations=tdt, **DIMS)
    params = jax.jit(lambda k: JM.init_params(jcfg, k, B=B, T=T, U=4))(jax.random.PRNGKey(key))
    model = TM.Transducer(TM.TransducerConfig(dtype=torch.float32, tdt_durations=tdt, **DIMS),
                          device="cpu")
    model.load_state_dict(transducer_state_dict_from_flax(params), strict=True)
    feats = np.random.RandomState(seed).randn(B, T, DIMS["input_dim"]).astype(np.float32)
    return JM.make_model(jcfg), params, model, feats, np.array([7, 5, 3], np.int32)


@pytest.fixture(scope="module")
def std():
    """(flax model, params, port model, feats, lengths) as tests/test_models.py:214-225."""
    return _setup((), key=2, seed=0)


@pytest.fixture(scope="module")
def tdt():
    return _setup(TDT_DURATIONS, key=5, seed=3)


def _t(*xs):
    return [torch.tensor(x) for x in xs]


# ---- each decoder against its JAX twin -------------------------------------------------------

CASES = {
    "greedy": ("std", "greedy_decode", dict(max_symbols=MAX_SYMBOLS)),
    "greedy_big_blanks": ("std", "greedy_decode",
                          dict(max_symbols=MAX_SYMBOLS, big_blank_durations=(2, 4))),
    "greedy_tdt": ("tdt", "greedy_decode_tdt", dict(max_symbols=MAX_SYMBOLS)),
    "beam": ("std", "beam_search_decode", dict(max_symbols=MAX_SYMBOLS, beam=4, expansions=3)),
    "beam_unmerged": ("std", "beam_search_decode",
                      dict(max_symbols=MAX_SYMBOLS, beam=4, expansions=8, merge=False)),
    "beam_multiblank": ("std", "beam_search_decode_multiblank",
                        dict(max_symbols=MAX_SYMBOLS, beam=6, big_blank_durations=BIG_BLANKS,
                             sigma=SIGMA)),
    "beam_tdt": ("tdt", "beam_search_decode_tdt",
                 dict(max_symbols=MAX_SYMBOLS, beam=6, sigma=SIGMA)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_matches_jax(case, request):
    which, name, kw = CASES[case]
    jmodel, params, model, feats, fl = request.getfixturevalue(which)
    with jax.enable_x64(False):
        want = jax.jit(lambda f, l: getattr(JD, name)(jmodel, params, f, l, **kw))(
            jnp.asarray(feats), jnp.asarray(fl))
        want = [np.asarray(w) for w in want]
    got = getattr(TD, name)(model, *_t(feats, fl), **kw)
    assert len(got) == len(want)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    if len(got) == 3:
        assert got[2].dtype == torch.float32
        np.testing.assert_allclose(got[2].numpy(), want[2], **SCORES)


# ---- properties, rescored through the port's alignments and losses --------------------------


def _rows(tokens, n):
    """The utterances with n > 0, each as (b, labels (1, n))."""
    return [(b, tokens[b:b + 1, :int(n[b])]) for b in range(tokens.shape[0]) if int(n[b]) > 0]


def _dense_logits(model, feats, fl, b, labels):
    with torch.no_grad():
        return model(feats[b:b + 1], fl[b:b + 1], labels).float().contiguous()


def _dense_bounds(model, feats, fl, b, labels):
    """(Viterbi score, marginal log-likelihood) of ``labels`` for utterance b."""
    acts, n = _dense_logits(model, feats, fl, b, labels), torch.tensor([labels.shape[1]])
    vit = W.rnnt_viterbi_align(acts, labels, fl[b:b + 1], n).score[0].item()
    return vit, -W.rnnt_score(acts, labels, fl[b:b + 1], n)[0].item()


def _mb_bounds(model, feats, fl, b, labels, durs=BIG_BLANKS, sigma=SIGMA):
    acts, n = _dense_logits(model, feats, fl, b, labels), torch.tensor([labels.shape[1]])
    vit = W.multiblank_viterbi_align(acts, labels, fl[b:b + 1], n, durs, sigma=sigma)
    ll = W.rnnt_loss_multiblank(acts, labels, fl[b:b + 1], n, durs, sigma=sigma,
                                reduction="none")
    return vit.score[0].item(), -ll[0].item()


def _tdt_bounds(model, feats, fl, b, labels, sigma=SIGMA):
    with torch.no_grad():
        tok, dur = model.tdt_logits(feats[b:b + 1], fl[b:b + 1], labels)
    tok, dur = tok.float().contiguous(), dur.float().contiguous()
    n = torch.tensor([labels.shape[1]])
    vit = W.tdt_viterbi_align(tok, dur, labels, fl[b:b + 1], n, TDT_DURATIONS, sigma=sigma)
    ll = W.rnnt_loss_tdt(tok, dur, labels, fl[b:b + 1], n, TDT_DURATIONS, sigma=sigma,
                         reduction="none")
    return vit.score[0].item(), -ll[0].item()


def test_beam_score_is_true_path_score(std):
    """Without prefix merging the returned score is one path's score of the
    returned hypothesis: at most its Viterbi score."""
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    bt, bn, bs = TD.beam_search_decode(model, feats, fl, MAX_SYMBOLS, beam=4, expansions=8,
                                       merge=False)
    for b, labels in _rows(bt[:, 0], bn[:, 0]):
        vit, _ = _dense_bounds(model, feats, fl, b, labels)
        assert vit >= bs[b, 0].item() - BOUND, (b, vit, bs[b, 0].item())


def test_beam_shapes_and_ranges(std):
    _, _, model, feats, fl = std
    bt, bn, bs = TD.beam_search_decode(model, *_t(feats, fl), MAX_SYMBOLS, beam=2, expansions=8)
    assert bt.shape == (B, 2, MAX_SYMBOLS) and bn.shape == bs.shape == (B, 2)
    assert ((bn >= 0) & (bn <= MAX_SYMBOLS)).all() and torch.isfinite(bs[:, 0]).all()
    assert ((bt >= 0) & (bt < DIMS["vocab_size"])).all()


def test_beam_scores_sorted_and_improve_on_greedy(std):
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    _, _, s1 = TD.beam_search_decode(model, feats, fl, MAX_SYMBOLS, beam=1, expansions=8)
    _, _, s4 = TD.beam_search_decode(model, feats, fl, MAX_SYMBOLS, beam=4, expansions=8)
    assert (s4[:, 1:] - s4[:, :-1] <= 1e-5).all()  # best first
    assert (s4[:, 0] >= s1[:, 0] - 1e-5).all()  # a wider beam finds no worse a hypothesis


def test_merged_score_bounds(std):
    """The pooled score of a merged hypothesis lies between its Viterbi
    score and its marginal log-likelihood."""
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    bt, bn, bs = TD.beam_search_decode(model, feats, fl, MAX_SYMBOLS, beam=4, expansions=8)
    for b, labels in _rows(bt[:, 0], bn[:, 0]):
        vit, ll = _dense_bounds(model, feats, fl, b, labels)
        assert vit - BOUND <= bs[b, 0].item() <= ll + BOUND, (b, vit, bs[b, 0].item(), ll)


def test_prefix_merge_pools_probability(std):
    """merge=True pools duplicate token strings: the best merged score is at
    least the best unmerged one, and no two live beams hold the same
    string."""
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    tm, nm, sm = TD.beam_search_decode(model, feats, fl, MAX_SYMBOLS, beam=4, expansions=3)
    _, _, su = TD.beam_search_decode(model, feats, fl, MAX_SYMBOLS, beam=4, expansions=3,
                                     merge=False)
    assert (sm[:, 0] >= su[:, 0] - 1e-5).all()
    for b in range(B):
        live = [tuple(tm[b, k, :nm[b, k]].tolist()) for k in range(4) if sm[b, k] > -1e29]
        assert len(live) == len(set(live)), (b, live)


def test_multiblank_beam_score_sandwich_and_order(std):
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    bt, bn, bs = TD.beam_search_decode_multiblank(model, feats, fl, MAX_SYMBOLS, beam=6,
                                                  big_blank_durations=BIG_BLANKS, sigma=SIGMA)
    assert (bs[:, 1:] - bs[:, :-1] <= 1e-5).all() and torch.isfinite(bs[:, 0]).all()
    for b, labels in _rows(bt[:, 0], bn[:, 0]):
        assert (labels < DIMS["vocab_size"] - len(BIG_BLANKS)).all()  # no big blank as a token
        vit, ll = _mb_bounds(model, feats, fl, b, labels)
        assert vit - BOUND <= bs[b, 0].item() <= ll + BOUND, (b, vit, bs[b, 0].item(), ll)


def test_multiblank_beam_at_least_as_good_as_greedy(std):
    """The beam-best hypothesis's marginal is at least the greedy
    (frame-skipping) hypothesis's on every utterance."""
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    gt, gn = TD.greedy_decode(model, feats, fl, MAX_SYMBOLS, big_blank_durations=BIG_BLANKS)
    bt, bn, _ = TD.beam_search_decode_multiblank(model, feats, fl, MAX_SYMBOLS, beam=6,
                                                 big_blank_durations=BIG_BLANKS, sigma=SIGMA)
    greedy = dict(_rows(gt, gn))
    for b, labels in _rows(bt[:, 0], bn[:, 0]):
        if b in greedy:
            mb = _mb_bounds(model, feats, fl, b, labels)[1]
            mg = _mb_bounds(model, feats, fl, b, greedy[b])[1]
            assert mb >= mg - BOUND, (b, mb, mg)


def test_tdt_beam_score_sandwich_and_order(tdt):
    _, _, model, feats, fl = tdt
    feats, fl = _t(feats, fl)
    bt, bn, bs = TD.beam_search_decode_tdt(model, feats, fl, MAX_SYMBOLS, beam=6, sigma=SIGMA)
    assert (bs[:, 1:] - bs[:, :-1] <= 1e-5).all() and torch.isfinite(bs[:, 0]).all()
    for b, labels in _rows(bt[:, 0], bn[:, 0]):
        vit, ll = _tdt_bounds(model, feats, fl, b, labels)
        assert vit - BOUND <= bs[b, 0].item() <= ll + BOUND, (b, vit, bs[b, 0].item(), ll)


def test_tdt_beam_at_least_as_good_as_greedy(tdt):
    _, _, model, feats, fl = tdt
    feats, fl = _t(feats, fl)
    gt, gn = TD.greedy_decode_tdt(model, feats, fl, MAX_SYMBOLS)
    bt, bn, _ = TD.beam_search_decode_tdt(model, feats, fl, MAX_SYMBOLS, beam=6, sigma=SIGMA)
    greedy = dict(_rows(gt, gn))
    for b, labels in _rows(bt[:, 0], bn[:, 0]):
        if b in greedy:
            mb = _tdt_bounds(model, feats, fl, b, labels)[1]
            mg = _tdt_bounds(model, feats, fl, b, greedy[b])[1]
            assert mb >= mg - BOUND, (b, mb, mg)


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_duration_beam_wider_is_no_worse(family, std, tdt):
    if family == "multiblank":
        _, _, model, feats, fl = std
        run = lambda k: TD.beam_search_decode_multiblank(  # noqa: E731
            model, *_t(feats, fl), MAX_SYMBOLS, beam=k, big_blank_durations=BIG_BLANKS)
    else:
        _, _, model, feats, fl = tdt
        run = lambda k: TD.beam_search_decode_tdt(  # noqa: E731
            model, *_t(feats, fl), MAX_SYMBOLS, beam=k)
    assert (run(4)[2][:, 0] >= run(1)[2][:, 0] - 1e-5).all()


def test_greedy_decode_big_blanks(std):
    """K = 0 is the plain greedy decode; with big blanks a big-blank argmax
    consumes several frames, and big blanks are never recorded as tokens."""
    _, _, model, feats, fl = std
    feats, fl = _t(feats, fl)
    t0, n0 = TD.greedy_decode(model, feats, fl, MAX_SYMBOLS)
    t1, n1 = TD.greedy_decode(model, feats, fl, MAX_SYMBOLS, big_blank_durations=())
    assert torch.equal(t0, t1) and torch.equal(n0, n1)
    tb, nb = TD.greedy_decode(model, feats, fl, MAX_SYMBOLS, big_blank_durations=(2, 4))
    assert tb.shape == (B, MAX_SYMBOLS) and ((tb >= 0) & (tb < DIMS["vocab_size"])).all()
    recorded = tb[nb[:, None] > torch.arange(MAX_SYMBOLS)[None, :]]
    assert not torch.isin(recorded, torch.tensor([6, 7])).any()


def test_tdt_model_train_and_decode(tdt):
    """The TDT train step lowers the loss; the TDT greedy decode of the
    trained model returns valid tokens."""
    _, _, model, feats, fl = tdt
    model = TM.Transducer(model.cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(0)
    batch = {"feats": torch.tensor(rng.randn(B, T, DIMS["input_dim"]), dtype=torch.float32),
             "feat_lengths": torch.tensor([7, 5, 3], dtype=torch.int32),
             "labels": torch.tensor(rng.randint(1, 8, (B, 3)), dtype=torch.int32),
             "label_lengths": torch.tensor([3, 2, 1], dtype=torch.int32)}
    step = TM.make_tdt_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                                  sigma=0.02)
    losses = [float(step(batch)) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    tokens, n = TD.greedy_decode_tdt(model, batch["feats"], batch["feat_lengths"], 5)
    assert tokens.shape == (B, 5) and ((n >= 0) & (n <= 5)).all()
    assert ((tokens >= 0) & (tokens < DIMS["vocab_size"])).all()


def test_decoders_follow_the_features_device(std):
    """Lengths on another device or of another integer type are moved to
    the features' (here int64 lengths for CPU features)."""
    _, _, model, feats, fl = std
    f = torch.tensor(feats)
    a = TD.greedy_decode(model, f, torch.tensor(fl, dtype=torch.int64), MAX_SYMBOLS)
    b = TD.greedy_decode(model, f, torch.tensor(fl), MAX_SYMBOLS)
    assert all(torch.equal(x, y) and x.device == f.device for x, y in zip(a, b))
