"""Wrappers of the fused joint kernels: ``csrc/joint_prep.cu``,
``csrc/joint_grad.cu`` and ``csrc/dur_head.cu``. They stand for the JAX
package's ``pallas/joint_fused.py``: ``fused_prep`` for its ``fused_prep``,
``fused_prep_mb`` (``extra_cols``) and ``fused_prep_tdt`` (``dur_head``);
``fused_grad`` for ``fused_grad``, ``fused_grad_mb`` (``extra``) and
``fused_grad_tdt`` (``dur_head``); ``dur_head_prep`` and ``dur_head_grad``
for the functions of those names. The plain versions are in
``ops/fused_joint.py``.

The kernels take e, p, bias and the duration head in f32 and W in f32 or
bf16; a bf16 e or p is widened here (exact, and (B, T, H)-sized), and the
gradients come back in the types of e, p, W, bias, Wd. They visit only the
cells inside each utterance's lattice, numbered through running sums of
T_b·U_b that are taken on the card, so nothing here waits for the device;
what they skip is filled here (NEG, or 0 for denom and the duration
logits)."""
from __future__ import annotations

import ctypes

import torch

from .. import fused_joint as _plain
from .. import gradients as _gradients
from .. import prep as _prep
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_F32 = (torch.float32,)
_IN = (torch.float32, torch.bfloat16)
# The column kernel's row splits: about three blocks a multiprocessor.
_BLOCKS_PER_SM = 3
# The duration-head gradient's row splits: two blocks a multiprocessor.
_DUR_BLOCKS_PER_SM = 2


def _rows(e, p, input_lengths, label_lengths):
    """The numbering of the valid rows: (offsets (B+1,) int64 running sums
    of T_b·U_b, label_lengths int32), both on the card. Without lengths
    every row is valid."""
    dev = e.device
    (B, T), U = e.shape[:2], p.shape[1]
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
        label_lengths = torch.full((B,), U - 1, dtype=torch.int32, device=dev)
    il = input_lengths.to(device=dev, dtype=torch.int64).clamp(0, T)
    ul = (label_lengths.to(device=dev, dtype=torch.int64) + 1).clamp(0, U)
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    torch.cumsum(il * ul, 0, out=offsets[1:])
    return offsets, label_lengths.to(device=dev, dtype=torch.int32).contiguous()


def _check_h(H, smem_entry):
    """Raise unless the kernels' tiling covers this H; ``smem_entry`` names
    the C entry that gives the kernel's shared memory at this H."""
    max_h = lib().wtt_joint_max_h()
    if H > max_h:
        raise ValueError(f"H={H} exceeds the fused joint kernels' limit of {max_h}: a thread "
                         "keeps 64 accumulators of an H-wide result in registers")
    need = getattr(lib(), smem_entry)(H)
    if need > SMEM_BYTES:
        raise ValueError(f"H={H} needs {need} bytes of shared memory for the h tile; a block "
                         f"may use {SMEM_BYTES} (227 KB)")


def _inputs(e, p, W, bias, labels, input_lengths, label_lengths, blank, smem_entry):
    """Check what the kernels take and bring it to their types: (e32, p32,
    W, bias32, lab_full, offsets, label_lengths32)."""
    dev = e.device
    require(e, "e", dev, _IN, 3)
    require(p, "p", dev, _IN, 3)
    require(W, "W", dev, _IN, 2)
    require(bias, "bias", dev, _IN, 1)
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    if p.shape[0] != B or p.shape[2] != H or W.shape[0] != H or bias.shape[0] != V:
        raise ValueError(f"shapes disagree: e {tuple(e.shape)}, p {tuple(p.shape)}, "
                         f"W {tuple(W.shape)}, bias {tuple(bias.shape)}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    _check_h(H, smem_entry)
    offsets, ll = _rows(e, p, input_lengths, label_lengths)
    lab = _plain.lab_full(labels.to(dev), U)
    return e.float(), p.float(), W, bias.float(), lab, offsets, ll


def _dur_head(dev, H, Wd, other, what, shape):
    """A duration head as the kernels take it: (Wd32 (H, D), other32), both
    f32 and contiguous on the card; ``other`` is bias_d or g_dur and must
    have ``shape`` + (D,)."""
    Wd32, other32 = _plain._check_dur_head(Wd, other, H, what)
    require(Wd32, "Wd", dev, _F32, 2)
    require(other32, what, dev, _F32, len(shape) + 1)
    if tuple(other32.shape) != tuple(shape) + (Wd32.shape[1],):
        raise ValueError(f"{what} must be {tuple(shape) + (Wd32.shape[1],)}; got "
                         f"{tuple(other32.shape)}")
    return Wd32, other32


def _dur_inputs(e, p, Wd, other, what, per_cell):
    """What the standalone duration-head kernels take: (e32, p32, Wd32,
    other32)."""
    dev = e.device
    require(e, "e", dev, _IN, 3)
    require(p, "p", dev, _IN, 3)
    B, T, H = e.shape
    if p.shape[0] != B or p.shape[2] != H:
        raise ValueError(f"shapes disagree: e {tuple(e.shape)}, p {tuple(p.shape)}")
    _check_h(H, "wtt_dur_head_smem")
    shape = (B, T, p.shape[1]) if per_cell else ()
    return (e.float(), p.float()) + _dur_head(dev, H, Wd, other, what, shape)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _host_cols(cols):
    return (ctypes.c_int * len(cols))(*cols)


def fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank: int,
               extra_cols=(), dur_head=None) -> _prep.PreparedInputs:
    """``fused_joint.fused_prep`` on the card: one launch over the valid
    rows and all of V, whatever the hooks. On a CPU tensor this is the plain
    version."""
    if e.device.type != "cuda":
        return _plain.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank,
                                 extra_cols, dur_head)
    dev = e.device
    e32, p32, W, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
                                                 label_lengths, blank, "wtt_joint_prep_smem")
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    cols = _prep.check_extra_cols(extra_cols, V)
    K, D = len(cols), 0
    lpb = torch.full((B, T, U), _prep.NEG, dtype=torch.float32, device=dev)
    lpe = torch.full_like(lpb, _prep.NEG)
    denom = torch.zeros_like(lpb)
    lpX = torch.full((B, T, U, K), _prep.NEG, dtype=torch.float32, device=dev) if K else None
    Wd32 = bias_d32 = dlog = None
    if dur_head is not None:
        Wd32, bias_d32 = _dur_head(dev, H, dur_head[0], dur_head[1], "bias_d", ())
        D = Wd32.shape[1]
        dlog = torch.zeros((B, T, U, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_joint_prep(
            e32.data_ptr(), p32.data_ptr(), W.data_ptr(), DTYPE_CODES[W.dtype], b32.data_ptr(),
            lab.data_ptr(), offsets.data_ptr(), ll.data_ptr(), lpb.data_ptr(), lpe.data_ptr(),
            denom.data_ptr(), _ptr(lpX), _host_cols(cols), K, _ptr(Wd32), _ptr(bias_d32),
            _ptr(dlog), D, B, T, U, H, V, int(blank), stream(dev))
    check(err, "joint_prep")
    return _prep.PreparedInputs(lpb=lpb, lpe=lpe, denom=denom, extras=lpX, dur=dlog)


def _dur_splits(B, T, U, H, dev):
    """Row splits of the duration-head gradient kernels: each split walks
    every nsplit-th row tile and owns one partial of dWd."""
    tile = lib().wtt_joint_grad_stripe(H)  # its row tiles are as tall as the column kernel's
    tiles = -(-(B * T * U) // tile)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(_DUR_BLOCKS_PER_SM * sms, tiles))


def fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
               fields: _gradients.Coefficients, blank: int, extra=None, dur_head=None):
    """``fused_joint.fused_grad`` on the card: the row kernel (de, dp; the
    duration head's cotangent joins dh there) and the column kernel (dW,
    db), and with a duration head a third for dWd: two or three launches
    counted under ``joint_grad``. On a CPU tensor this is the plain
    version."""
    if e.device.type != "cuda":
        return _plain.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                                 fields, blank, extra, dur_head)
    dev = e.device
    e32, p32, W, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
                                                 label_lengths, blank, "wtt_joint_grad_smem")
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    for name, t in (("denom", denom),) + tuple(zip(fields._fields, fields)):
        require(t, name, dev, _F32, 3)
        if tuple(t.shape) != (B, T, U):
            raise ValueError(f"{name} must be {(B, T, U)}; got {tuple(t.shape)}")
    cols, cX, K = (), None, 0
    if extra is not None:
        cols = _prep.check_extra_cols(extra[0], V)
        K = len(cols)
        cX = extra[1]
        require(cX, "the extra fields", dev, _F32, 4)
        if tuple(cX.shape) != (B, T, U, K):
            raise ValueError(f"the extra fields must be {(B, T, U, K)}; got {tuple(cX.shape)}")
    Wd32 = gd = None
    D = 0
    if dur_head is not None:
        Wd32, gd = _dur_head(dev, H, dur_head[0], dur_head[1], "g_dur", (B, T, U))
        D = Wd32.shape[1]
    de = torch.zeros((B, T, H), dtype=torch.float32, device=dev)
    dp = torch.zeros((B, U, H), dtype=torch.float32, device=dev)
    dW = torch.empty((H, V), dtype=torch.float32, device=dev)
    db = torch.empty((V,), dtype=torch.float32, device=dev)
    stripe = lib().wtt_joint_grad_stripe(H)
    stripes = -(-V // stripe)
    tiles = -(-(B * T * U) // stripe)  # row tiles are as tall as a stripe is wide
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit = max(1, min(_BLOCKS_PER_SM * sms // stripes, tiles))
    dW_part = torch.empty((nsplit, H, V), dtype=torch.float32, device=dev) if nsplit > 1 else dW
    db_part = torch.empty((nsplit, V), dtype=torch.float32, device=dev) if nsplit > 1 else db
    common = (e32.data_ptr(), p32.data_ptr(), W.data_ptr(), DTYPE_CODES[W.dtype], b32.data_ptr(),
              lab.data_ptr(), offsets.data_ptr(), ll.data_ptr(), denom.data_ptr(),
              fields.coef.data_ptr(), fields.cb.data_ptr(), fields.ce.data_ptr(), _ptr(cX),
              _host_cols(cols), K)
    dims = (B, T, U, H, V, int(blank), stream(dev))
    out = ()
    with torch.cuda.device(dev):
        err = lib().wtt_joint_grad_rows(*common, _ptr(Wd32), _ptr(gd), D, de.data_ptr(),
                                        dp.data_ptr(), *dims)
        check(err, "joint_grad")
        err = lib().wtt_joint_grad_cols(*common, dW.data_ptr(), db.data_ptr(), dW_part.data_ptr(),
                                        db_part.data_ptr(), nsplit, *dims)
        check(err, "joint_grad")
        if dur_head is not None:
            nd = _dur_splits(B, T, U, H, dev)
            dWd = torch.empty((H, D), dtype=torch.float32, device=dev)
            dWd_part = torch.empty((nd, H, D), dtype=torch.float32, device=dev)
            err = lib().wtt_joint_grad_dwd(e32.data_ptr(), p32.data_ptr(), offsets.data_ptr(),
                                           ll.data_ptr(), gd.data_ptr(), dWd.data_ptr(),
                                           dWd_part.data_ptr(), nd, B, T, U, H, D, stream(dev))
            check(err, "joint_grad")
            out = (dWd.to(dur_head[0].dtype),)
    return (de.to(e.dtype), dp.to(p.dtype), dW.to(W.dtype), db.to(bias.dtype)) + out


def dur_head_prep(e, p, Wd, bias_d, input_lengths=None, label_lengths=None):
    """``fused_joint.dur_head_prep`` on the card: one warp a valid row. On a
    CPU tensor this is the plain version."""
    if e.device.type != "cuda":
        return _plain.dur_head_prep(e, p, Wd, bias_d, input_lengths, label_lengths)
    dev = e.device
    e32, p32, Wd32, bias_d32 = _dur_inputs(e, p, Wd, bias_d, "bias_d", False)
    B, T, H = e.shape
    U, D = p.shape[1], Wd32.shape[1]
    offsets, ll = _rows(e, p, input_lengths, label_lengths)
    dlog = torch.zeros((B, T, U, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_dur_head_prep(e32.data_ptr(), p32.data_ptr(), Wd32.data_ptr(),
                                      bias_d32.data_ptr(), offsets.data_ptr(), ll.data_ptr(),
                                      dlog.data_ptr(), B, T, U, H, D, stream(dev))
    check(err, "dur_head")
    return dlog


def dur_head_grad(e, p, Wd, g_dur, input_lengths=None, label_lengths=None):
    """``fused_joint.dur_head_grad`` on the card: one launch for de2, dp2
    and the partials of dWd, and their sum in a fixed order. On a CPU tensor
    this is the plain version."""
    if e.device.type != "cuda":
        return _plain.dur_head_grad(e, p, Wd, g_dur, input_lengths, label_lengths)
    dev = e.device
    e32, p32, Wd32, gd = _dur_inputs(e, p, Wd, g_dur, "g_dur", True)
    B, T, H = e.shape
    U, D = p.shape[1], Wd32.shape[1]
    offsets, ll = _rows(e, p, input_lengths, label_lengths)
    nd = _dur_splits(B, T, U, H, dev)
    de = torch.zeros((B, T, H), dtype=torch.float32, device=dev)
    dp = torch.zeros((B, U, H), dtype=torch.float32, device=dev)
    dWd = torch.empty((H, D), dtype=torch.float32, device=dev)
    dWd_part = torch.empty((nd, H, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_dur_head_grad(e32.data_ptr(), p32.data_ptr(), Wd32.data_ptr(),
                                      gd.data_ptr(), offsets.data_ptr(), ll.data_ptr(),
                                      de.data_ptr(), dp.data_ptr(), dWd.data_ptr(),
                                      dWd_part.data_ptr(), nd, B, T, U, H, D, stream(dev))
    check(err, "dur_head")
    return de.to(e.dtype), dp.to(p.dtype), dWd.to(Wd.dtype)
