"""The prep kernel (csrc/prep.cu, the tiled row reductions of
csrc/reduce.cuh) against its plain PyTorch version ``ops/prep.py::prepare``,
on the card.

Every V from a row shorter than a vector to the large-V shape, both modes
(the kernel's own plan, and the other mode forced through
``prepare_planned`` where it fits), the four input types, K = 0 and 2
extra columns, log-prob inputs, a row count that no tile divides, a base
address off the 16-byte grid (one-element loads), and rows with columns at
-inf (masked tokens). Also the kernel's C planner against
``rows.reduce_plan``. Tolerances as in tests/test_torch_cuda.py (f32 1e-5:
the kernel's sums and the plain two-pass logsumexp round in another order;
f64 1e-10; bf16 and f16 inputs compute in f32).

Every test here needs a CUDA device and skips without one (the ``dev``
fixture decides while the test runs). On a machine with an H100:
``python -m pytest tests/test_torch_cuda_prep.py --noconftest``.
"""
import numpy as np
import pytest
import torch

from warp_transducer_tpu_torch.ops import cuda as K
from warp_transducer_tpu_torch.ops import prep
from warp_transducer_tpu_torch.ops.cuda import prep as kprep
from warp_transducer_tpu_torch.ops.cuda import rows as R

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.float64: dict(rtol=1e-10, atol=1e-10)}
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
VS = [1, 2, 3, 5, 28, 50, 127, 600, R.REDUCE_TILE_MAX_V, R.REDUCE_TILE_MAX_V + 1, 5000]
# 666 rows: no tile of any V divides them (512 rows at V = 1, 146 at V = 28 f32).
B, T, U = 2, 37, 9


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(V, dtype, dev, seed=0, offset=0, masked=False):
    """acts (B, T, U, V) of ``dtype`` on the card, ``offset`` elements into
    a larger buffer; labels (B, U - 1) in [0, V). With ``masked`` a third
    of the rows get a quarter of their columns (never all) set to -inf."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((B, T, U, V)) * 3.0, dtype=dtype)
    if masked:
        rows = x.view(-1, V)
        hit = torch.tensor(rng.random((rows.shape[0], V)) < 0.25) & \
            torch.tensor(rng.random((rows.shape[0], 1)) < 1 / 3)
        hit[:, 0] = False
        rows[hit] = float("-inf")
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
    acts = buf[offset:].view(B, T, U, V)
    acts.copy_(x.to(dev))
    labels = torch.tensor(rng.integers(0, V, (B, U - 1)), dtype=torch.int32, device=dev)
    return acts, labels


def _cols(V, n):
    return tuple((V - 1 - k) % V for k in range(n))


def _check(got, want, dtype, lpi):
    cdtype = prep.compute_dtype(dtype)
    assert got.lpb.dtype == cdtype and got.extras.shape == want.extras.shape
    names = ("lpb", "lpe", "extras") + (() if lpi else ("denom",))
    for name in names:
        a, b = getattr(got, name).double().cpu(), getattr(want, name).double().cpu()
        torch.testing.assert_close(a, b, **TOL[cdtype], msg=name)
    if lpi:
        assert got.denom is None


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("lpi", [False, True], ids=["acts", "log_probs"])
@pytest.mark.parametrize("n_cols", [0, 2])
@pytest.mark.parametrize("V", VS)
def test_prep_kernel_every_v(dev, V, n_cols, lpi, dtype):
    acts, labels = _problem(V, dtype, dev, seed=V)
    if lpi:
        acts = torch.log_softmax(acts.float(), -1).to(dtype)
    blank = V // 2
    cols = _cols(V, n_cols)
    got = kprep.prepare(acts, labels, blank, lpi, extra_cols=cols)
    torch.cuda.synchronize()
    _check(got, prep.prepare(acts, labels, blank, lpi, extra_cols=cols), dtype, lpi)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("V", [1, 3, 28, 50, 600, 5000])
def test_prep_kernel_unaligned_base(dev, V, dtype):
    """A view one element into a buffer: the base is off the 16-byte grid,
    so the kernel plans one-element loads (the head of every row in the
    warp mode starts wherever the row does)."""
    acts, labels = _problem(V, dtype, dev, seed=V + 1, offset=1)
    assert acts.data_ptr() % 16 != 0 and acts.is_contiguous()
    elt = acts.element_size()
    assert kprep.library_plan(V, elt, R.alignment(acts.data_ptr()))[2] == 1
    cols = _cols(V, 2)
    got = kprep.prepare(acts, labels, 0, False, extra_cols=cols)
    torch.cuda.synchronize()
    _check(got, prep.prepare(acts, labels, 0, False, extra_cols=cols), dtype, False)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("V", [5, 28, 50, 5000])
def test_prep_kernel_masked_columns(dev, V, dtype):
    """Rows with columns at -inf (masked tokens) reduce over the rest;
    where the label or an extra column is masked, its log-prob is -inf in
    both versions."""
    acts, labels = _problem(V, dtype, dev, seed=V + 2, masked=True)
    cols = _cols(V, 2)
    got = kprep.prepare(acts, labels, 0, False, extra_cols=cols)
    torch.cuda.synchronize()
    want = prep.prepare(acts, labels, 0, False, extra_cols=cols)
    assert bool(torch.isinf(want.lpe).any()) and bool(torch.isfinite(want.denom).all())
    _check(got, want, dtype, False)


def _forced(V, elt, mode):
    """The plan for V with its mode forced, None where a tile does not fit."""
    p = R.reduce_plan(V, elt)
    if mode == R.WARP:
        return p._replace(mode=R.WARP, rows=R.WARP_ROWS, group=32, stride=V)
    if p.mode == R.TILE:
        return p
    rows = R.THREADS * R.VECS_PER_THREAD * p.vec // V
    rows -= rows % (p.vec // np.gcd(V, p.vec))
    stride = -(-V // 32) * 32
    return p._replace(mode=R.TILE, rows=int(rows), group=32, stride=stride) if rows else None


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mode", [R.TILE, R.WARP], ids=["tile", "warp"])
@pytest.mark.parametrize("V", [2, 28, 50, 600, 1000])
def test_prep_kernel_both_modes(dev, V, mode, dtype):
    """Each mode at V on both sides of the switch point, through the
    planned entry; both equal the plain version, and the launch counts."""
    acts, labels = _problem(V, dtype, dev, seed=V + 3)
    p = _forced(V, acts.element_size(), mode)
    if p is None:
        pytest.fail(f"no tile at V={V}")
    cols = _cols(V, 2)
    before = K.launches["prep"]
    got = kprep.prepare_planned(acts, labels, 1, False, p, extra_cols=cols)
    torch.cuda.synchronize()
    assert K.launches["prep"] == before + 1
    _check(got, prep.prepare(acts, labels, 1, False, extra_cols=cols), dtype, False)


def test_prep_kernel_refuses_bad_plans(dev):
    acts, labels = _problem(28, torch.float32, dev)
    p = R.reduce_plan(28, 4)
    for bad in (p._replace(group=3), p._replace(stride=32), p._replace(rows=1000),
                p._replace(vec=2), p._replace(mode=7)):
        with pytest.raises(RuntimeError, match="prep kernel launch failed"):
            kprep.prepare_planned(acts, labels, 0, False, bad)
    with pytest.raises(RuntimeError, match="prep kernel launch failed"):  # vectors, unaligned
        odd, lab = _problem(28, torch.float32, dev, offset=1)
        kprep.prepare_planned(odd, lab, 0, False, p)


def test_library_plan_matches_python(dev):
    """csrc/reduce.cuh::plan, the kernel's own, is rows.reduce_plan."""
    for elt in (2, 4, 8):
        for align in (16, 8, 4, 2):
            for V in list(range(1, 1025)) + [2047, 5000, 5001, 2 ** 20 + 1]:
                assert kprep.library_plan(V, elt, align) == tuple(R.reduce_plan(V, elt, align)), \
                    (V, elt, align)
