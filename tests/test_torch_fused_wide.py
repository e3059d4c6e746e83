"""The fused joint losses at joint widths H above 1024 on the CPU, held
against the JAX package, and the plan of the fused joint kernels
(``ops/cuda/joint.py::joint_plan``, the mirror of csrc/joint.cuh's Plan).

On a CUDA tensor the fused joint kernels take any H: every product streams
its operands through shared memory in k-slices, and no kernel holds an
H-wide sum. Here the port runs its plain versions (CPU tensors), at H = 1100
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

The plan tests need no JAX: every k of [0, H) and every column of V lies in
exactly one tile and k-slice of each kernel's schedule, each kernel's shared
memory stays within a block's 227 KB at every H from 1 to 8192, a numpy
replay of the gradient's schedule (tiles, k-slices, splits, chunks, the tiled
layouts) gives the plain version's gradients, and the once-split three-TF32
product keeps f32 accuracy at H = 2048.
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


# ---- the plan, the schedule and the split products (no JAX) ----------------

PLAN_H = [1, 8, 127, 128, 129, 200, 256, 257, 300, 512, 513, 600, 1000, 1023, 1024, 1025, 1100,
          1152, 1280, 1281, 1536, 2000, 2047, 2048, 2049, 2816, 2817, 3000, 4096, 4864, 4865,
          5000, 6000, 8191, 8192]
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]
TILE = kjoint.JOINT_TILE
PLAN_V = 1003  # the awkward shape's V: no tile divides it


def _spans(n, parts):
    """The kernels' split of n tiles into ``parts`` spans of ceil(n / parts)."""
    span = -(-n // parts)
    return [(z * span, min(n, (z + 1) * span)) for z in range(parts)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("H", PLAN_H)
def test_plan_covers_every_k_once(H, dtype):
    """Every k of [0, H) lies in exactly one k-slice of the logits (K6a and
    the g kernel stream Hp in slices of ``ks``), one 128-column tile of dh
    and one 128-row tile of dW; every column of V in one tile of the g
    kernel and of dW; the padding beyond H and V is whole tiles' worth of
    zeros; each split of dh's sum over V and of dW's sum over a chunk's row
    tiles covers every tile exactly once; and the tiled layout is a
    one-to-one map of an operand's elements."""
    q = kjoint.joint_plan(H, PLAN_V, dtype)
    assert q.hp % TILE == 0 and H <= q.hp < H + TILE and q.vp % TILE == 0
    assert PLAN_V <= q.vp < PLAN_V + TILE
    assert q.ks * (2 if dtype == torch.bfloat16 else 4) == 128  # a stage row: 128 bytes
    for width, step in ((q.hp, q.ks), (q.hp, TILE), (q.vp, TILE), (q.vp, q.ks)):
        seen = np.zeros(width, int)
        for k0 in range(0, width, step):
            seen[k0:k0 + step] += 1
        assert (seen == 1).all()
    for tiles in (q.vp // TILE, q.grad_rows // TILE):
        for parts in range(1, min(tiles, 12) + 1):
            seen = np.zeros(tiles, int)
            for t0, t1 in _spans(tiles, parts):
                seen[t0:t1] += 1
            assert (seen == 1).all()
    rows = min(q.hp, 4 * TILE)
    order = kjoint.tile_order(rows, q.hp, dtype).flatten()
    assert torch.equal(torch.sort(order).values, torch.arange(rows * q.hp))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plan_fits_a_block_at_every_h(dtype):
    """Each engine kernel's dynamic shared memory is within a block's 227 KB
    at every H from 1 to 8192 (it does not depend on H: every operand
    streams), and the chunks are whole numbers of 128-row tiles."""
    for H in range(1, 8193):
        for V in (5, 5000):
            q = kjoint.joint_plan(H, V, dtype)
            assert max(q.prep_smem, q.g_smem, q.dh_smem, q.dw_smem) <= SMEM_BYTES, (H, V, q)
            assert q.prep_rows % TILE == 0 and q.grad_rows % TILE == 0, (H, V, q)
            assert q.prep_rows >= TILE and q.grad_rows >= TILE
    sizes = {kjoint.joint_plan(H, 5000, dtype)[4:8] for H in (1, 256, 2048, 8192)}
    assert len(sizes) == 1


def test_plan_chunk_rows_follow_the_buffer():
    """The chunks: rows whose buffers (the prep's h; the gradient's h, hᵀ, g,
    gᵀ in W's operand type, one f32 row of dh and db's partials) fill at
    most the budget, whole 128-row tiles, at least one."""
    for H, V, dt, mb, want in ((256, 5000, torch.bfloat16, 128, (262144, 5888)),
                               (256, 5000, torch.float32, 128, (65536, 1536)),
                               (2048, 5000, torch.bfloat16, 128, (32768, 3584)),
                               (2048, 5000, torch.float32, 128, (8192, 1024)),
                               (1100, 1003, torch.float32, 32, (3584, 768)),
                               (8192, 5000, torch.float32, 0, (128, 128))):
        q = kjoint.joint_plan(H, V, dt, mb)
        assert (q.prep_rows, q.grad_rows) == want, (H, V, dt, mb, q)


def _tf32(x):
    """cvt.rna.tf32.f32: round x (float32) to 10 mantissa bits, to nearest
    with ties away from zero (the 13 dropped bits, half added to the
    magnitude)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def test_three_tf32_products_keep_f32_accuracy():
    """The split that the kernels make once, where an operand is written:
    x = hi + lo with hi = tf32(x), lo = tf32(x − hi). Over a depth of 2048
    (the wide joint's H) lo·hi + hi·lo + hi·hi, each product exact and summed
    in f32 k-slice by k-slice as the engine sums, holds the f32 product to
    f32 accuracy; plain TF32 (hi·hi) misses it by about 2^-11."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 48)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    (ah, al), (bh, bl) = _split(a), _split(b)
    assert np.array_equal(_tf32(ah), ah) and np.array_equal(_tf32(al), al)
    three = np.zeros(exact.shape, np.float32)
    for k0 in range(0, 2048, 32):  # a stage's products in f64 (exact), added in f32
        sl = slice(k0, k0 + 32)
        part = (al[:, sl].astype(np.float64) @ bh[sl] + ah[:, sl].astype(np.float64) @ bl[sl]
                + ah[:, sl].astype(np.float64) @ bh[sl])
        three = (three + part.astype(np.float32)).astype(np.float32)
    plain = ah.astype(np.float64) @ bh.astype(np.float64)
    rel = lambda x: np.linalg.norm(x - exact) / np.linalg.norm(exact)  # noqa: E731
    f32 = a @ b  # what IEEE f32 gives
    assert rel(three) <= 2 * max(rel(f32), 1e-7) and rel(three) < 1e-6
    assert rel(plain) > 1e-4


def _untile(buf, rows, cols, dtype):
    """An operand back from its tiled layout as wgmma's descriptors read it:
    the n-th 16-byte piece of a tile is row (n // 8 // 8)·8 + n % 8 and
    k-piece (n // 8) % 8 of the tile, its E elements along k."""
    ks = kjoint._KS[dtype]
    E = 16 // (2 if dtype == torch.bfloat16 else 4)
    tiles = buf.reshape(rows // TILE, cols // ks, TILE * ks)
    n = np.arange(TILE * ks)
    piece, within = n // E, n % E
    r = (piece // 8 // 8) * 8 + piece % 8
    k = ((piece // 8) % 8) * E + within
    out = np.zeros((rows, cols), buf.dtype)
    for rt in range(rows // TILE):
        for kt in range(cols // ks):
            out[rt * TILE + r, kt * ks + k] = tiles[rt, kt]
    return out


def _replay_grad(e, p, W, bias, labels, il, ll, denom, fields, blank, dtype, chunk, sms):
    """The fused gradient's kernels in numpy (float64), in their order: W's
    layouts once; a chunk at a time h and hᵀ of the tiles that hold a valid
    row, the g kernel's 128 × 128 tiles over Hp's k-slices with db's
    partials, dh's tiles over their splits of V's k-slices, the d epilogue
    summing the splits, dW's tiles over their spans of the chunk's valid
    row tiles (first chunk written, later ones added; the slices summed
    after the last chunk), db's partials added in tile order. The operands
    go through the tiled layout and back as the descriptors read it."""
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    q = kjoint.joint_plan(H, V, dtype)
    ks, hp, vp = q.ks, q.hp, q.vp
    dh_split, dw_split = kjoint.grad_splits(q, chunk, sms)
    tiled = lambda x: (lambda o, f: (f.__setitem__(o.numpy().ravel(), x.ravel()), f)[1])(  # noqa
        kjoint.tile_order(*x.shape, dtype), np.zeros(x.size))
    through = lambda x: _untile(tiled(x), *x.shape, dtype)  # noqa: E731
    Wp = np.zeros((hp, vp))
    Wp[:H, :V] = W
    wt, wp = through(Wp.T.copy()), through(Wp)
    lab = np.full((B, U), -1)
    lab[:, :U - 1] = labels
    rows = [(b, t, u) for b in range(B) for t in range(il[b]) for u in range(ll[b] + 1)]
    total = len(rows)
    de, dp = np.zeros((B, T, H)), np.zeros((B, U, H))
    dW_part, db = np.zeros((dw_split, H, V)), np.zeros(V)
    cells = B * T * U
    for r0 in range(0, cells, chunk):
        valid = min(max(total - r0, 0), chunk)
        ntiles = -(-valid // TILE)
        h = np.zeros((chunk, hp))
        for m in range(valid):
            b, t, u = rows[r0 + m]
            h[m, :H] = np.tanh(e[b, t] + p[b, u])
        ht, h = through(h.T.copy()), through(h)
        g = np.zeros((chunk, vp))
        db_part = np.zeros((chunk // TILE, vp))
        for rt in range(ntiles):
            for vt in range(vp // TILE):
                acc = np.zeros((TILE, TILE))
                for kt in range(hp // ks):
                    k = slice(kt * ks, (kt + 1) * ks)
                    acc += h[rt * TILE:(rt + 1) * TILE, k] @ wt[vt * TILE:(vt + 1) * TILE, k].T
                for m in range(TILE):
                    if r0 + rt * TILE + m >= total:
                        continue
                    b, t, u = rows[r0 + rt * TILE + m]
                    for n in range(TILE):
                        v = vt * TILE + n
                        if v >= V:
                            continue
                        x = fields[1][b, t, u] * np.exp(acc[m, n] + bias[v] + denom[b, t, u])
                        x -= fields[2][b, t, u] * (v == blank) + fields[3][b, t, u] * (v == lab[b, u])
                        g[rt * TILE + m, v] = x
                db_part[rt, vt * TILE:(vt + 1) * TILE] = g[rt * TILE:(rt + 1) * TILE,
                                                           vt * TILE:(vt + 1) * TILE].sum(0)
        gt, g = through(g.T.copy()), through(g)
        dh_part = np.zeros((dh_split, chunk, hp))
        for z, (t0, t1) in enumerate(_spans(vp // TILE, dh_split)):
            for rt in range(ntiles):
                for c in range(hp // TILE):
                    for kt in range(t0 * TILE // ks, t1 * TILE // ks):
                        k = slice(kt * ks, (kt + 1) * ks)
                        dh_part[z, rt * TILE:(rt + 1) * TILE, c * TILE:(c + 1) * TILE] += (
                            g[rt * TILE:(rt + 1) * TILE, k] @ wp[c * TILE:(c + 1) * TILE, k].T)
        dh = dh_part.sum(0)
        for m in range(valid):
            b, t, u = rows[r0 + m]
            d = dh[m, :H] * (1 - np.tanh(e[b, t] + p[b, u]) ** 2)
            de[b, t] += d
            dp[b, u] += d
        for z, (t0, t1) in enumerate(_spans(chunk // TILE, dw_split)):
            acc = np.zeros((hp, vp))
            for kt in range(t0 * TILE // ks, min(t1, ntiles) * TILE // ks):
                k = slice(kt * ks, (kt + 1) * ks)
                acc += ht[:, k] @ gt[:, k].T
            dW_part[z] = acc[:H, :V] + (dW_part[z] if r0 > 0 else 0)
        db = db_part[:ntiles].sum(0)[:V] + (db if r0 > 0 else 0)
    return de, dp, dW_part.sum(0), db, (dh_split, dw_split)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("H,V,chunk", [(200, 300, 384), (129, 130, 128)])
def test_schedule_replay_matches_the_plain_gradient(H, V, chunk, dtype):
    """The kernels' schedule replayed in numpy at sizes no tile divides
    (H, V; ragged rows, several chunks, splits of dh and dW) gives the
    plain version's de, dp, dW and db (f32 sums in another order: 1e-5 of
    each norm)."""
    from warp_transducer_tpu_torch.ops import fused_joint, gradients
    B, T, U, blank = 3, 40, 9, 1
    rng = np.random.default_rng(H)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    e, p, W, bias = f(B, T, H, scale=0.5), f(B, U, H, scale=0.5), f(H, V, scale=H ** -0.5), f(V)
    labels = rng.integers(2, V, (B, U - 1)).astype(np.int32)
    il, ll = np.array([T, 23, 31], np.int32), np.array([U - 1, 4, 6], np.int32)
    t = [torch.tensor(x) for x in (e, p, W, bias, labels, il, ll)]
    pr = fused_joint.fused_prep(*t, blank)
    valid = gradients._valid_cells((B, T, U), t[5], t[6], "cpu").float()
    coef = (torch.tensor(rng.random((B, T, U)), dtype=torch.float32) * valid).contiguous()
    cb, ce = coef * 0.3, coef * 0.2
    fields = gradients.Coefficients(coef, cb, ce)
    want = fused_joint.fused_grad(*t, pr.denom, fields, blank)
    got = _replay_grad(e.astype(np.float64), p.astype(np.float64), W.astype(np.float64), bias,
                       labels, il, ll, pr.denom.numpy().astype(np.float64),
                       [None, coef.numpy(), cb.numpy(), ce.numpy()], blank, dtype, chunk, 132)
    assert got[4][0] > 1 or got[4][1] > 1  # the splits are exercised
    for name, a, b in zip(("de", "dp", "dW", "db"), got[:4], want):
        assert _rel(a, b.numpy().astype(np.float64)) <= 1e-5, (name, _rel(a, b.numpy()))
