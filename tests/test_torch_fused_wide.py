"""The fused joint losses at joint widths H above 1024 on the CPU, held
against the JAX package, and the plan of the fused joint kernels
(``ops/cuda/joint.py::joint_plan``, the mirror of csrc/joint.cuh's Plan).

On a CUDA tensor the fused joint kernels take any H: above 1024 they stream
W through shared memory in k-slices and take dh and dW in passes of 1024
columns. Here the port runs its plain versions (CPU tensors), at H = 1100
(no k-slice divides it), 1280 and 2048, against the JAX package's XLA engine
and its Pallas kernels in interpret mode: ``rnnt_loss_fused_joint``, the
multi-blank fused loss (K = 2), the TDT fused loss on both of the port's
routes (D = 4) and ``Joint.fused_loss`` at ``joint_dim`` 1280 with the Flax
module's weights carried across by ``joint_state_dict_from_flax``. B, T, U
and V stay tiny; the inputs are made with numpy from a seed.

Tolerances: costs rtol 1e-5 (atol 1e-5), every gradient within 1e-4 of its
norm (sums over H, V and the rows taken in another order). The kernels
themselves, at these widths and at the fused shape, are held against the
plain versions on the card (tests/test_torch_cuda_fused.py,
tests/test_torch_cuda_fused_variants.py, chip_smoke.py).

The plan tests need no JAX: every k of [0, H) lies in exactly one pass and
one k-slice of each kernel's schedule, and each kernel's shared memory stays
within a block's 227 KB at every H from 1 to 8192.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warp_transducer_tpu.models import transducer as JM
from warp_transducer_tpu.ops import fused_joint as JF
from warp_transducer_tpu.ops import multiblank_fused as JMF
from warp_transducer_tpu.ops import tdt_fused as JTF
from warp_transducer_tpu_torch import (rnnt_loss_fused_joint, rnnt_loss_multiblank_fused_joint,
                                       rnnt_loss_tdt_fused_joint)
from warp_transducer_tpu_torch.models import Joint, TransducerConfig
from warp_transducer_tpu_torch.ops import tdt_fused
from warp_transducer_tpu_torch.ops.cuda import SMEM_BYTES
from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
from warp_transducer_tpu_torch.utils.convert import joint_state_dict_from_flax
from jax_programs import release_compiled_programs  # noqa: F401

COST = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4
WIDE = [1100, 1280, 2048]
BIG_BLANKS = (2, 4)
DURS = (0, 1, 2, 4)


def _problem(seed, H, B=2, T=5, U=3, V=9, K=0, D=0):
    """e, p, W, bias (and Wd, bias_d with D > 0); labels off the blank and
    the last K columns; ragged lengths, one utterance full."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    floats = (f(B, T, H, scale=0.5), f(B, U, H, scale=0.5), f(H, V, scale=1 / np.sqrt(H)),
              f(V, scale=0.1))
    if D:
        floats += (f(H, D, scale=1 / np.sqrt(H)), f(D, scale=0.1))
    labels = (rng.integers(0, V - K - 1, (B, U - 1)) + 1).astype(np.int32)
    il = rng.integers(2, T + 1, B).astype(np.int32)
    ll = rng.integers(0, U, B).astype(np.int32)
    il[0], ll[0] = T, U - 1
    return floats, (labels, il, ll)


def _port(fn, floats, ints, *args, **kw):
    leaves = [torch.tensor(x).requires_grad_(True) for x in floats]
    costs = fn(*leaves, *map(torch.tensor, ints), *args, reduction="none", **kw)
    grads = torch.autograd.grad(costs.sum(), leaves)
    return costs.detach().numpy(), [g.numpy() for g in grads]


def _jax(fn, floats, ints, *args, **kw):
    ints = [jnp.asarray(x) for x in ints]

    def total(*a):
        costs = fn(*a, *ints, *args, reduction="none", **kw)
        return jnp.sum(costs), costs

    (_, costs), grads = jax.value_and_grad(total, argnums=tuple(range(len(floats))),
                                           has_aux=True)(*map(jnp.asarray, floats))
    return np.asarray(costs), [np.asarray(g) for g in grads]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **COST)
    assert len(got[1]) == len(want[1])
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert a.shape == b.shape, i
        assert np.isfinite(a).all() and _rel(a, b) <= GRAD_REL, (i, _rel(a, b))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("H", WIDE)
def test_fused_joint_matches_jax(H, impl):
    floats, ints = _problem(H, H)
    _assert_same(_port(rnnt_loss_fused_joint, floats, ints),
                 _jax(JF.rnnt_loss_fused_joint, floats, ints, implementation=impl))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("H", WIDE)
def test_multiblank_fused_matches_jax(H, impl):
    floats, ints = _problem(H + 1, H, K=len(BIG_BLANKS))
    _assert_same(_port(rnnt_loss_multiblank_fused_joint, floats, ints, BIG_BLANKS),
                 _jax(JMF.rnnt_loss_multiblank_fused_joint, floats, ints, BIG_BLANKS,
                      implementation=impl))


@pytest.mark.parametrize("route", ["integrated", "composed"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("H", WIDE)
def test_tdt_fused_matches_jax(H, impl, route, monkeypatch):
    monkeypatch.setattr(tdt_fused, "_tdt_single_chunk", lambda *a: route == "integrated")
    floats, ints = _problem(H + 2, H, D=len(DURS))
    _assert_same(_port(rnnt_loss_tdt_fused_joint, floats, ints, durations=DURS),
                 _jax(JTF.rnnt_loss_tdt_fused_joint, floats, ints, durations=DURS,
                      implementation=impl))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_joint_fused_loss_at_joint_dim_1280(impl):
    dims = dict(vocab_size=9, encoder_dim=6, prediction_dim=5, joint_dim=1280)
    rng = np.random.default_rng(3)
    tree = {name: {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                   "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}
            for name, i, o in (("Dense_0", 6, 1280), ("Dense_1", 5, 1280), ("Dense_2", 1280, 9))}
    B, T, U = 2, 5, 3
    enc = rng.standard_normal((B, T, 6)).astype(np.float32)
    pred = rng.standard_normal((B, U, 5)).astype(np.float32)
    labels = rng.integers(1, 9, (B, U - 1)).astype(np.int32)
    il, ll = np.array([T, T - 2], np.int32), np.array([U - 1, U - 2], np.int32)
    flax_joint = JM.Joint(JM.TransducerConfig(dtype=jnp.float32, **dims))

    def total(params):
        return jnp.sum(flax_joint.apply({"params": params},
                                        *map(jnp.asarray, (enc, pred, labels, il, ll)),
                                        method=JM.Joint.fused_loss, reduction="sum",
                                        implementation=impl))

    want, flax_grads = jax.value_and_grad(total)(jax.tree.map(jnp.asarray, tree))
    joint = Joint(TransducerConfig(dtype=torch.float32, **dims), device="cpu")
    joint.load_state_dict(joint_state_dict_from_flax(tree))
    loss = joint.fused_loss(*map(torch.tensor, (enc, pred, labels, il, ll)), reduction="sum")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **COST)
    for flax_name, name in (("Dense_0", "enc_proj"), ("Dense_1", "pred_proj"),
                            ("Dense_2", "out_proj")):
        layer = getattr(joint, name)
        for got, leaf in ((layer.weight.grad.numpy().T, "kernel"),
                          (layer.bias.grad.numpy(), "bias")):
            rel = _rel(got, np.asarray(flax_grads[flax_name][leaf]))
            assert rel <= GRAD_REL, (name, leaf, rel)


# ---- the plan (no JAX) -------------------------------------------------------

PLAN_H = [1, 8, 127, 128, 129, 200, 256, 257, 300, 512, 513, 600, 1000, 1023, 1024, 1025, 1100,
          1152, 1280, 1281, 1536, 2000, 2047, 2048, 2049, 2816, 2817, 3000, 4096, 4864, 4865,
          5000, 6000, 8191, 8192]
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


def _slices(lo, hi, ks):
    """The k-slices [k0, k0 + ks) ∩ [lo, hi) that cover [lo, hi)."""
    return [(k0, min(k0 + ks, hi)) for k0 in range(lo, hi, ks)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("H", PLAN_H)
def test_plan_covers_every_k_once(H, dtype):
    """Every k in [0, H) lies in exactly one k-slice of the logits' W tile
    (prep, row and column kernels), exactly one pass of dh / dW, and within it
    exactly one dh slice and one warp's n8 tile (row kernel) and one m16 tile
    (column kernel) of that slice; the padding beyond H holds zeros."""
    q = kjoint.joint_plan(H, dtype)
    assert q.hp % kjoint.JOINT_H_ALIGN == 0 and H <= q.hp < H + kjoint.JOINT_H_ALIGN
    logits = np.zeros(q.hp, int)
    for k0, k1 in _slices(0, q.hp, q.ks):
        logits[k0:k1] += 1
    assert (logits == 1).all() and len(_slices(0, q.hp, q.ks)) == q.slices
    dh = np.zeros(q.hp, int)
    dw = np.zeros(q.hp, int)
    pass_cols = kjoint.JOINT_PASS_H if q.sliced else q.hp
    assert q.passes == -(-q.hp // pass_cols)
    wh = kjoint.JOINT_WARPS // q.tm  # warps along H in the row kernel's dh product
    for hp0 in range(0, q.hp, pass_cols):
        hpn = min(pass_cols, q.hp - hp0)
        nih = hpn // wh // 8  # a warp's dh tiles in the pass
        mi = hpn // (16 * kjoint.JOINT_WARPS)  # a warp's dW tiles in the pass
        assert nih <= 16 and mi <= 8  # 64 accumulators a lane
        for w in range(kjoint.JOINT_WARPS):
            wn = w // q.tm
            for j in range(nih):
                # n8 tile j of warp w: contiguous at one pass, interleaved above
                c = hp0 + ((j * wh + wn) * 8 if q.sliced else wn * (hpn // wh) + 8 * j)
                if w % q.tm == 0:  # the TM warps of one H share hold other rows
                    dh[c:c + 8] += 1
            for i in range(mi):
                r = hp0 + ((i * 8 + w) * 16 if q.sliced else w * (hpn // 8) + 16 * i)
                dw[r:r + 16] += 1
        if q.sliced:  # each dh / dW k-slice of the pass holds whole tiles of every warp
            for k0, k1 in _slices(hp0, hp0 + hpn, q.ks):
                assert (k1 - k0) % (8 * wh) == 0 and (k1 - k0) % (16 * kjoint.JOINT_WARPS) == 0
    assert (dh == 1).all() and (dw == 1).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plan_fits_a_block_at_every_h(dtype):
    """Each kernel's dynamic shared memory is within a block's 227 KB at
    every H from 1 to 8192; up to 1024 one k-slice holds all of H (the
    schedule of the kernels before they streamed), above it the h tile is
    whole wherever it fits beside the W stages, and the chunk of rows is a
    whole number of row tiles."""
    for H in range(1, 8193):
        q = kjoint.joint_plan(H, dtype)
        assert max(q.prep_smem, q.rows_smem, q.cols_smem) <= SMEM_BYTES, (H, q)
        assert q.chunk_rows % (kjoint.JOINT_DIM * q.tm) == 0 and q.chunk_rows > 0
        if q.hp <= kjoint.JOINT_PASS_H:
            assert (q.sliced, q.ks, q.slices, q.passes) == (0, q.hp, 1, 1)
            assert q.prep_hcols == q.rows_hcols == q.hp
        else:
            ks = kjoint.JOINT_SLICE if dtype == torch.bfloat16 else kjoint.JOINT_SLICE // 2
            assert (q.sliced, q.tm, q.ks, q.prep_stages) == (1, 1, ks, 2)
            assert q.prep_hcols in (q.hp, q.ks) and q.rows_hcols in (q.hp, q.ks)
    # the widths of the fused shape's wide phase hold their h tiles whole
    for dt, slices in zip(DTYPES, (16, 8)):
        q = kjoint.joint_plan(2048, dt)
        assert (q.prep_hcols, q.rows_hcols, q.passes, q.slices) == (2048, 2048, 2, slices)


def test_plan_chunk_rows_follow_the_buffer():
    """The gradient's chunk: rows whose h (Hp wide, in W's type) fill at most
    the buffer, a whole number of row tiles, at least one."""
    for H, dt, mb, want in ((2048, torch.bfloat16, 32, 8192), (2048, torch.float32, 32, 4096),
                            (256, torch.float32, 32, 32768), (1100, torch.float32, 32, 7280),
                            (8192, torch.float32, 0, 16), (200, torch.bfloat16, 0, 64)):
        assert kjoint.joint_plan(H, dt, mb).chunk_rows == want, (H, dt, mb)
