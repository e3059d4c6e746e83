"""The kernels' instances past eight extra columns, duration columns or
duration arcs, and the window walk's rings in device memory, each against
its plain PyTorch version on the card at small shapes:

* K3 (csrc/prep.cu) and grad.cu's fields modes, dense and sparse, with K = 9,
  16 and 32 extra columns read from a device table;
* K7's table instance (csrc/window_walk.cuh::window_table_kernel): TDT with
  D = 9, 17 and 33 durations (33 crosses a warp's lanes), multi-blank with
  K = 9, 16 and 32 big blanks, in its rings form (a ring of departures an
  arc) and its pending form (alpha's pending window), the rings in shared
  memory and, where they pass a block, in device memory, in passes at a
  long U;
* K6c (csrc/dur_head.cu) in groups of 8 columns and K6d in one pass
  (dur_grad_many_kernel) at D = 9, 16, 17 and 33 and at H = 2048, and K6d
  with its sums of dWd in device memory (D = 350);
* K6a/K6b (csrc/joint_prep.cu, joint_grad.cu) with K = 9 and 16 extra
  columns and with a duration head of D = 9 and 33;
* the public losses at D = 9 and K = 9 under the launch counters: the
  kernels run, never the plain versions; the multi-blank loss with nine
  big blanks on log-probs (the binding) and ``multiblank_viterbi_align``.

Every test needs a CUDA device and skips without one (the ``dev`` fixture
decides while the test runs). On a machine with an H100:
``python -m pytest tests/test_torch_cuda_many_durations.py --noconftest``.

Tolerances as the files whose helpers this one takes
(tests/test_torch_cuda_window.py, tests/test_torch_cuda_fused_variants.py):
f32 1e-5, f64 1e-10, the fused gradients' relative norms 1e-4 (f32 W) and
2e-2 (bf16 W).
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch import (rnnt_loss_multiblank, rnnt_loss_multiblank_fused_joint,
                                       rnnt_loss_tdt, rnnt_loss_tdt_fused_joint)
from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import fused_joint, gradients, prep, window
from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
from warp_transducer_tpu_torch.ops.cuda import prep as kprep
from warp_transducer_tpu_torch.ops.cuda import window as kwindow
from test_torch_cuda_fused_variants import F32, GRAD_REL, PREP_TOL, _fields, _problem, _rel
from test_torch_cuda_window import _channels, _close

pytestmark = pytest.mark.cuda

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _acts(B, T, U, V, n_cols, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    acts = torch.tensor(rng.standard_normal((B, T, U, V)) * 2.0, dtype=dtype, device=dev)
    labels = torch.tensor(rng.integers(1, V - n_cols, (B, U - 1)), dtype=torch.int32,
                          device=dev)
    il = torch.tensor(rng.integers(1, T + 1, B), dtype=torch.int32, device=dev)
    ll = torch.tensor(rng.integers(0, U, B), dtype=torch.int32, device=dev)
    il[0], ll[0] = T, U - 1
    return acts, labels, il, ll


# ---- K3 and grad.cu past eight columns -----------------------------------------------------

@DTYPES
@pytest.mark.parametrize("n_cols", [9, 16, 32])
@pytest.mark.parametrize("V", [48, 700])  # the tile mode and the warp mode
def test_prep_and_grad_many_columns(dev, V, n_cols, dtype):
    acts, labels, il, ll = _acts(3, 7, 5, V, n_cols, dtype, dev, seed=n_cols)
    cols = tuple(range(V - n_cols, V))
    for log_probs in (False, True):
        x = torch.log_softmax(acts, -1) if log_probs else acts
        got = kprep.prepare(x, labels, 0, log_probs, extra_cols=cols)
        torch.cuda.synchronize()
        want = prep.prepare(x, labels, 0, log_probs, extra_cols=cols)
        for name in ("lpb", "lpe", "extras") + (() if log_probs else ("denom",)):
            _close(getattr(got, name), getattr(want, name), dtype)
    p = prep.prepare(acts, labels, 0, False, extra_cols=cols)
    f = _fields(3, 7, 5, 3 + n_cols, il, ll, 1, dev)
    fields = gradients.Coefficients(*(x.to(dtype) for x in f[:3]))
    extra = torch.stack(f[3:], -1).to(dtype)
    labels_u = prep.label_rows(labels, 5)
    kw = dict(extra_cols=cols, extra_fields=extra)
    got = kgrad.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype, **kw)
    torch.cuda.synchronize()
    want = gradients.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype, **kw)
    _close(got, want, dtype)
    got = kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, dtype, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, gradients.sparse_grad(fields, labels_u, il, ll, 0, V, dtype, **kw))


# ---- K7's table instance -------------------------------------------------------------------

# (arcs, B, T, U, the types in which the rings lie in device memory in the
# rings form, in the pending form): alpha's pending window of W + 1 slots
# fits a block at every count of arcs here but a longest duration of 300
# and sixteen big blanks on four warps in f64 and the passes of a long U;
# the rings form's rings pass a block at D = 33, K = 16 on four warps, K =
# 32 in f64, the window of 300 and the long U.
F64, BOTH = (torch.float64,), (torch.float32, torch.float64)
WINDOW_CASES = {
    "tdt_d9": (window.tdt_arcs(tuple(range(9))), 4, 12, 41, (), ()),
    "tdt_d17": (window.tdt_arcs(tuple(range(17))), 3, 20, 9, (), ()),
    "tdt_d33": (window.tdt_arcs(tuple(range(33))), 3, 40, 6, BOTH, ()),
    "tdt_d9_no_chain": (window.tdt_arcs(tuple(range(1, 10))), 2, 15, 33, (), ()),
    "mb_k9": (window.multiblank_arcs(tuple(range(2, 11))), 4, 14, 41, (), ()),
    "mb_k16_four_warps": (window.multiblank_arcs(tuple(range(2, 18))), 2, 25, 300, BOTH,
                          F64),
    "mb_k32": (window.multiblank_arcs(tuple(range(2, 34))), 2, 40, 9, F64, ()),
    "w300": (window.multiblank_arcs((2, 4, 8, 16, 32, 64, 128, 300)), 2, 320, 45, BOTH,
             F64),
    "tdt_d9_long_u": (window.tdt_arcs(tuple(range(9))), 1, 6, 9000, BOTH, BOTH),
}
FORMS = pytest.mark.parametrize("form", [kwindow.TABLE, kwindow.PENDING],
                                ids=["rings", "pending"])


@FORMS
@DTYPES
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_table_instance(dev, case, dtype, form):
    arcs, B, T, U, *dev_rings = WINDOW_CASES[case]
    n = max(c for _, chs in arcs.blank_arcs + arcs.emit_arcs for c in chs) - 1
    lpb, lpe, extra, il, ll = _channels(B, T, U, n, 3, dtype, dev)
    p = kwindow.lattice_plan(lpb, extra, arcs, form=form)
    in_device = dev_rings[0 if form == kwindow.TABLE else 1]
    assert p.wide == form and (p.rings > 0) == (dtype in in_device), p
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    args = (B, T, U, dtype, arcs.window, len(arcs.blank_arcs) + len(arcs.emit_arcs), n,
            arcs.chain is not None, True, n_sm, 0, kwindow.arc_channels(arcs), False)
    assert p == kwindow.kernel_plan(*args, form=form)
    assert kwindow.lattice_plan(lpb, extra, arcs) == kwindow.kernel_plan(*args) in \
        (p, kwindow.lattice_plan(lpb, extra, arcs, form=kwindow.TABLE + kwindow.PENDING - form))
    for betas in (True, False):
        got = kwindow.launch(lpb, lpe, extra, arcs, il, ll, compute_betas=betas, form=form)
        torch.cuda.synchronize()
        want = window.forward_backward(lpb, lpe, extra, arcs, il, ll, compute_betas=betas)
        if dtype == torch.float32 and U > 600:
            # The prefix form cancels against |c| ~ 7e4 here: both f32 versions
            # are a few ulps of it off the f64 value, each its own way; the
            # kernel is held against the plain version in f64 within the f32
            # plain version's own largest error there and 4 ulps of max |c|.
            want64 = window.forward_backward(lpb.double(), lpe.double(), extra.double(), arcs,
                                             il, ll, compute_betas=betas)
            chain = sum(lpb if ch == 0 else lpe if ch == 1 else extra[..., ch - 2]
                        for ch in arcs.chain)
            c = float(chain[..., :-1].clamp_min(-1e4).sum(-1).abs().max())
            for name in ("alphas", "betas", "ll_forward", "ll_backward"):
                w64 = getattr(want64, name)
                live = w64.abs() < 1e29
                own = float((getattr(want, name).double() - w64)[live].abs().max())
                err = float((getattr(got, name).double() - w64)[live].abs().max())
                assert err <= own + c * 2.0 ** -22 + 1e-5, (name, err, own, c)
            continue
        for name in ("alphas", "betas", "ll_forward", "ll_backward"):
            _close(getattr(got, name), getattr(want, name), dtype, U=min(U, 600))


@FORMS
def test_window_table_reproducible(dev, form):
    arcs, B, T, U, *_ = WINDOW_CASES["mb_k16_four_warps"]
    lpb, lpe, extra, il, ll = _channels(B, T, U, 16, 4, torch.float32, dev)
    a = kwindow.launch(lpb, lpe, extra, arcs, il, ll, form=form)
    b = kwindow.launch(lpb, lpe, extra, arcs, il, ll, form=form)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@FORMS
def test_window_table_reproducible_emit_arcs(dev, form):
    """Emit arcs that cross lanes, warps (the pending form: their entries)
    and passes (the edge column, or the pre-joined arrivals handed on): two
    calls give the same bits."""
    arcs, B, T, U, *_ = WINDOW_CASES["tdt_d9_long_u"]
    lpb, lpe, extra, il, ll = _channels(B, T, U, 9, 5, torch.float32, dev)
    assert kwindow.lattice_plan(lpb, extra, arcs, form=form).passes > 1
    a = kwindow.launch(lpb, lpe, extra, arcs, il, ll, form=form)
    b = kwindow.launch(lpb, lpe, extra, arcs, il, ll, form=form)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- K6c/K6d and K6a/K6b past eight columns -------------------------------------------------

def _dur_head_case(dev, B, T, U, H, D, seed):
    """K6c and K6d against their plain versions: the prep at f32 1e-5, each
    gradient at a relative norm of 1e-4 and elementwise within 1e-3 of its
    median nonzero |g|; two calls of the gradient bit-equal."""
    e, p, _, _, Wd, bias_d, _, il, ll = _problem(B, T, U, 40, H, 0, D, seed=seed, device=dev)
    got = kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll), **F32)
    gd = torch.stack(_fields(B, T, U, D, il, ll, 6, dev), dim=-1) - 0.3
    gd = gd * gradients._valid_cells((B, T, U), il, ll, dev)[..., None]
    got = kjoint.dur_head_grad(e, p, Wd, gd, il, ll)
    again = kjoint.dur_head_grad(e, p, Wd, gd, il, ll)
    torch.cuda.synchronize()
    want = fused_joint.dur_head_grad(e, p, Wd, gd, il, ll)
    for name, g, w, a in zip(("de2", "dp2", "dWd"), got, want, again):
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
        atol = 1e-3 * float(w.abs()[w != 0].median())
        assert float((g - w).abs().max()) <= atol, (name, float((g - w).abs().max()), atol)
        assert torch.equal(g, a), name  # no atomics


@pytest.mark.parametrize("D,H", [(9, 200), (16, 200), (17, 200), (33, 200), (9, 2048)])
def test_dur_head_groups(dev, D, H):
    """Past 8 columns: the prep in groups of 8, the gradient in one pass
    (its warps' sums of dWd in shared memory)."""
    assert not kjoint.dur_many_smem(D)[2]
    _dur_head_case(dev, 3, 9, 5 if H > 256 else 37, H, D, seed=D)


def test_dur_head_grad_sums_in_device_memory(dev):
    """A head so wide that the warps' sums of dWd pass a block's shared
    memory: they lie in the scratch, Wd is read from device memory."""
    assert kjoint.dur_many_smem(350)[2]
    _dur_head_case(dev, 2, 6, 5, 40, 350, seed=350)


def test_dur_part_floats_matches_its_mirror(dev):
    for B, T, U, H in ((3, 9, 5, 200), (64, 150, 21, 256), (2, 6, 5, 40), (4, 7, 300, 2048)):
        for D in list(range(1, 80)) + [300, 344, 345, 350, 1000]:
            assert K.lib().wtt_dur_head_part_floats(B, T, U, H, D) == \
                kjoint.dur_part_floats(B, T, U, H, D), (B, T, U, H, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n_cols,D", [(9, 0), (16, 0), (0, 9), (0, 33), (9, 9), (2, 9)])
def test_fused_prep_and_grad_many(dev, n_cols, D, dtype):
    B, T, U, V, H = 3, 17, 6, 300, 200
    e, p, W, bias, Wd, bias_d, labels, il, ll = _problem(B, T, U, V, H, max(n_cols, 1),
                                                         max(D, 1), seed=n_cols + D,
                                                         dtype=dtype, device=dev)
    cols = tuple(range(V - n_cols, V))
    kw = ({"extra_cols": cols} if n_cols else {}) | ({"dur_head": (Wd, bias_d)} if D else {})
    got = kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, **kw)
    torch.cuda.synchronize()
    want = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0, **kw)
    for name in ("lpb", "lpe", "denom") + (("extras",) if n_cols else ()):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), **PREP_TOL[dtype])
    if D:
        torch.testing.assert_close(got.dur, want.dur, **F32)
    f = _fields(B, T, U, 3 + n_cols + D, il, ll, 2, dev)
    fields = gradients.Coefficients(*f[:3])
    gkw = {}
    if n_cols:
        gkw["extra"] = (cols, torch.stack(f[3:3 + n_cols], dim=-1))
    if D:
        gkw["dur_head"] = (Wd, torch.stack(f[3 + n_cols:], dim=-1) - 0.5 * f[0][..., None])
    got = kjoint.fused_grad(e, p, W, bias, labels, il, ll, want.denom, fields, 0, **gkw)
    torch.cuda.synchronize()
    ref = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, want.denom, fields, 0, **gkw)
    for name, g, w in zip(("de", "dp", "dW", "db", "dWd"), got, ref):
        tol = 1e-4 if name == "dWd" else GRAD_REL[dtype]
        assert _rel(g, w) <= tol, (name, _rel(g, w))


# ---- the public losses under the counters ---------------------------------------------------

def _losses(dev, implementation):
    """The four losses past eight columns at small shapes, with gradients."""
    rng = np.random.default_rng(9)
    B, T, U, V, H = 3, 14, 5, 30, 64
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                device=dev, requires_grad=True)
    labels = torch.tensor(rng.integers(1, V - 9, (B, U - 1)), dtype=torch.int32, device=dev)
    il = torch.tensor([T, T - 3, T - 5], dtype=torch.int32, device=dev)
    ll = torch.tensor([U - 1, U - 2, 1], dtype=torch.int32, device=dev)
    tok, dur, acts = t(B, T, U, V), t(B, T, U, 9), t(B, T, U, V)
    e, p, W, bias, Wd, bias_d = t(B, T, H), t(B, U, H), t(H, V), t(V), t(H, 9), t(9)
    leaves = (tok, dur, acts, e, p, W, bias, Wd, bias_d)
    durs, big = tuple(range(9)), tuple(range(2, 11))
    kw = dict(reduction="sum", implementation=implementation)
    total = (rnnt_loss_tdt(tok, dur, labels, il, ll, durs, **kw)
             + rnnt_loss_multiblank(acts, labels, il, ll, big, **kw)
             + rnnt_loss_tdt_fused_joint(0.1 * e, 0.1 * p, W, bias, Wd, bias_d, labels, il, ll,
                                         durs, **kw)
             + rnnt_loss_multiblank_fused_joint(0.1 * e, 0.1 * p, W, bias, labels, il, ll, big,
                                                **kw))
    grads = torch.autograd.grad(total, leaves)
    return total.detach(), grads


def test_losses_run_the_kernels(dev):
    K.reset_launches()
    total, grads = _losses(dev, "auto")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    for name in ("prep", "window_stream", "grad_fields", "joint_prep", "joint_grad", "dur_head"):
        assert counts[name] > 0, (name, counts)
    want, wgrads = _losses(dev, "torch")
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-4)
    for g, w in zip(grads, wgrads):
        assert _rel(g, w) <= 1e-4


def test_multiblank_nine_big_blanks_on_log_probs_and_alignment(dev):
    """The binding's multi-blank loss on log-probs with nine big blanks
    (K3 past 8 columns on log-probs, K7's table instance, grad.cu's sparse
    mode) against the plain route in f64, and ``multiblank_viterbi_align``
    (K3 past 8 columns, raw) against its plain route, f32 and f64."""
    from warp_transducer_tpu_torch.bindings import torch_binding
    from warp_transducer_tpu_torch.ops import alignment, multiblank
    rng = np.random.default_rng(19)
    B, T, U, V = 3, 14, 5, 30
    big = tuple(range(2, 11))
    acts = torch.tensor(rng.standard_normal((B, T, U, V)), dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.integers(1, V - 9, (B, U - 1)), dtype=torch.int32, device=dev)
    il = torch.tensor([T, T - 3, T - 5], dtype=torch.int32, device=dev)
    ll = torch.tensor([U - 1, U - 2, 1], dtype=torch.int32, device=dev)
    lp = torch.log_softmax(acts, -1).requires_grad_(True)
    K.reset_launches()
    costs = torch_binding.rnnt_loss_multiblank(lp, labels, il, ll, big, sigma=0.05,
                                               reduction="none", from_log_probs=True)
    (grad,) = torch.autograd.grad(costs.sum(), lp)
    torch.cuda.synchronize()
    for name in ("prep", "window_stream", "grad_fields"):
        assert K.launches[name] > 0, (name, dict(K.launches))
    lp64 = lp.detach().double().requires_grad_(True)
    want = multiblank._multiblank_costs(lp64, labels, il, ll, big, 0, None, "none", 0.05, 0.0,
                                        0.0, True, "torch")
    (wgrad,) = torch.autograd.grad(want.sum(), lp64)
    torch.testing.assert_close(costs.double(), want.detach(), rtol=1e-5, atol=1e-4)
    assert _rel(grad.double(), wgrad) <= 1e-4
    for dtype in (torch.float32, torch.float64):
        x = acts.to(dtype)
        K.reset_launches()
        got = alignment.multiblank_viterbi_align(x, labels, il, ll, big, sigma=0.05)
        torch.cuda.synchronize()
        assert K.launches["prep"] == 1, dict(K.launches)
        ref = alignment.multiblank_viterbi_align(x, labels, il, ll, big, sigma=0.05,
                                                 implementation="torch")
        torch.testing.assert_close(got.score, ref.score, rtol=1e-5, atol=1e-5)
        if dtype == torch.float64:
            for field in got._fields[1:]:
                assert torch.equal(getattr(got, field), getattr(ref, field)), field
