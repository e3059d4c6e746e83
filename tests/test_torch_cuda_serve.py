"""The inference side on the card: the three Viterbi alignments with their
prep on the kernel (``csrc/prep.cu``) against the same call through the
plain prep (``implementation="torch"``) on the card, and the five decoders
on the card against the same decoders on the CPU, with no host sync.

Every test here needs a CUDA device; without one each skips (the ``dev``
fixture decides while the test runs, never at import). On a machine with an
H100: ``python -m pytest tests/test_torch_cuda_serve.py --noconftest``
(tests/conftest.py imports JAX). Imports no JAX.

Tolerances: alignment scores rtol 1e-5, atol 1e-5 (f32; the prep kernel's
online log-sum-exp rounds otherwise than the plain two-pass one) and 1e-10
(f64, where the paths must also be equal); decoder tokens and lengths equal
in every beam slot on an f32 model with TF32 off, scores rtol 1e-5, atol
1e-4.
"""
import numpy as np
import pytest
import torch

import warp_transducer_tpu_torch as W
from warp_transducer_tpu_torch.models import decoding as TD
from warp_transducer_tpu_torch.models import transducer as tm
from warp_transducer_tpu_torch.ops import cuda as K

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=16, encoder_dim=32, encoder_layers=1, encoder_heads=2, conv_kernel=3,
             prediction_dim=24, joint_dim=32, input_dim=8)
B, T, L = 4, 20, 5
DURATIONS, BIG_BLANKS, SIGMA = (0, 1, 2, 4), (2, 4), 0.05
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.float64: dict(rtol=1e-10, atol=1e-10)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def exact_f32():
    """f32 products in IEEE f32 (TF32 off) while a test runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _problem(dev, dtype, seed=0, Bp=5, Tp=30, Lp=6, V=12):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((Bp, Tp, Lp + 1, V)) * 2, dtype=dtype, device=dev)
    dur = torch.tensor(rng.standard_normal((Bp, Tp, Lp + 1, len(DURATIONS))) * 2, dtype=dtype,
                       device=dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    il, ll = rng.integers(Tp // 2, Tp + 1, Bp), rng.integers(0, Lp + 1, Bp)
    il[0], ll[0] = Tp, Lp
    return acts, dur, i32(rng.integers(1, V - 2, (Bp, Lp))), i32(il), i32(ll)


ALIGNERS = {
    "dense": lambda a, d, lab, il, ll, **kw: W.rnnt_viterbi_align(a, lab, il, ll, **kw),
    "tdt": lambda a, d, lab, il, ll, **kw: W.tdt_viterbi_align(a, d, lab, il, ll, DURATIONS,
                                                              sigma=SIGMA, **kw),
    "multiblank": lambda a, d, lab, il, ll, **kw: W.multiblank_viterbi_align(
        a, lab, il, ll, BIG_BLANKS, sigma=SIGMA, **kw),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(ALIGNERS))
def test_alignment_kernel_route_matches_plain(dev, name, dtype):
    args = _problem(dev, dtype)
    K.reset_launches()
    got = ALIGNERS[name](*args)
    torch.cuda.synchronize()
    assert K.launches["prep"] == 1, dict(K.launches)
    want = ALIGNERS[name](*args, implementation="torch")
    assert got.score.device.type == "cuda" and got.score.dtype == dtype
    np.testing.assert_allclose(got.score.cpu().numpy(), want.score.cpu().numpy(), **TOL[dtype])
    if dtype == torch.float64:
        for field in got._fields[1:]:
            assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.parametrize("name", sorted(ALIGNERS))
def test_alignment_on_the_card_has_no_host_sync(dev, name):
    args = _problem(dev, torch.float32, seed=1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ALIGNERS[name](*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.score).all()


def _models(dev, tdt=()):
    """The same tiny f32 model on the card and on the CPU (one seed)."""
    cfg = tm.TransducerConfig(dtype=torch.float32, tdt_durations=tdt, **SMALL)
    return [tm.Transducer(cfg, device=d, generator=torch.Generator().manual_seed(7))
            for d in (dev, "cpu")]


DECODERS = {
    "greedy": ((), lambda m, f, fl: TD.greedy_decode(m, f, fl, 2 * L)),
    "greedy_big_blanks": ((), lambda m, f, fl: TD.greedy_decode(m, f, fl, 2 * L,
                                                               big_blank_durations=BIG_BLANKS)),
    "greedy_tdt": (DURATIONS, lambda m, f, fl: TD.greedy_decode_tdt(m, f, fl, 2 * L)),
    "beam": ((), lambda m, f, fl: TD.beam_search_decode(m, f, fl, 2 * L)),
    "beam_multiblank": ((), lambda m, f, fl: TD.beam_search_decode_multiblank(
        m, f, fl, 2 * L, big_blank_durations=BIG_BLANKS, sigma=SIGMA)),
    "beam_tdt": (DURATIONS, lambda m, f, fl: TD.beam_search_decode_tdt(m, f, fl, 2 * L,
                                                                       sigma=SIGMA)),
}


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_on_the_card_matches_the_cpu(dev, exact_f32, name):
    durations, run = DECODERS[name]
    card, cpu = _models(dev, durations)
    rng = np.random.default_rng(3)
    feats = torch.tensor(rng.standard_normal((B, T, SMALL["input_dim"])), dtype=torch.float32)
    fl = torch.tensor([T, T - 4, T // 2, T - 1], dtype=torch.int32)
    feats_card, fl_card = feats.to(dev), fl.to(dev)
    torch.cuda.set_sync_debug_mode("error")  # any host sync in the decode raises
    try:
        got = run(card, feats_card, fl_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = run(cpu, feats, fl)
    assert all(g.device.type == "cuda" for g in got)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w), (g, w)
    if len(got) == 3:
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(), rtol=1e-5, atol=1e-4)
