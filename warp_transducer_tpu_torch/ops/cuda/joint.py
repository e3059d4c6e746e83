"""Wrappers of the fused joint kernels: ``csrc/joint_prep.cu`` (the
counterpart of ``warp_transducer_tpu/ops/pallas/joint_fused.py::_prep_kernel``)
and ``csrc/joint_grad.cu`` (``joint_fused.py::_grad_kernel``). The plain
versions are in ``ops/fused_joint.py``.

The kernels take e, p and bias in f32 and W in f32 or bf16; a bf16 e or p
is widened here (exact, and (B, T, H)-sized), and the gradients come back
in the types of e, p, W, bias. They visit only the cells inside each
utterance's lattice, numbered through running sums of T_b·U_b that are
taken on the card, so nothing here waits for the device."""
from __future__ import annotations

import torch

from .. import fused_joint as _plain
from .. import gradients as _gradients
from .. import prep as _prep
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_F32 = (torch.float32,)
_IN = (torch.float32, torch.bfloat16)
# The column kernel's row splits: about three blocks a multiprocessor.
_BLOCKS_PER_SM = 3


def _inputs(e, p, W, bias, labels, input_lengths, label_lengths, blank, smem_entry):
    """Check what the kernels take and bring it to their types: (e32, p32,
    W, bias32, lab_full, offsets, label_lengths32). ``smem_entry`` names the
    C entry that gives the kernel's shared memory at this H."""
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
    max_h = lib().wtt_joint_max_h()
    if H > max_h:
        raise ValueError(f"H={H} exceeds the fused joint kernels' limit of {max_h}: a thread "
                         "keeps 64 accumulators of an H-wide result in registers")
    need = getattr(lib(), smem_entry)(H)
    if need > SMEM_BYTES:
        raise ValueError(f"H={H} needs {need} bytes of shared memory for the h tile; a block "
                         f"may use {SMEM_BYTES} (227 KB)")
    il = input_lengths.to(device=dev, dtype=torch.int64).clamp(0, T)
    ul = (label_lengths.to(device=dev, dtype=torch.int64) + 1).clamp(0, U)
    offsets = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    torch.cumsum(il * ul, 0, out=offsets[1:])
    lab = _plain.lab_full(labels.to(dev), U)
    return (e.float(), p.float(), W, bias.float(), lab, offsets,
            label_lengths.to(device=dev, dtype=torch.int32).contiguous())


def fused_prep(e, p, W, bias, labels, input_lengths, label_lengths,
               blank: int) -> _prep.PreparedInputs:
    """``fused_joint.fused_prep`` on the card: one launch over the valid
    rows and all of V. On a CPU tensor this is the plain version."""
    if e.device.type != "cuda":
        return _plain.fused_prep(e, p, W, bias, labels, input_lengths, label_lengths, blank)
    dev = e.device
    e32, p32, W, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
                                                 label_lengths, blank, "wtt_joint_prep_smem")
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    lpb = torch.full((B, T, U), _prep.NEG, dtype=torch.float32, device=dev)
    lpe = torch.full_like(lpb, _prep.NEG)
    denom = torch.zeros_like(lpb)
    with torch.cuda.device(dev):
        err = lib().wtt_joint_prep(
            e32.data_ptr(), p32.data_ptr(), W.data_ptr(), DTYPE_CODES[W.dtype], b32.data_ptr(),
            lab.data_ptr(), offsets.data_ptr(), ll.data_ptr(), lpb.data_ptr(), lpe.data_ptr(),
            denom.data_ptr(), B, T, U, H, V, int(blank), stream(dev))
    check(err, "joint_prep")
    return _prep.PreparedInputs(lpb=lpb, lpe=lpe, denom=denom)


def fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
               fields: _gradients.Coefficients, blank: int):
    """``fused_joint.fused_grad`` on the card: the row kernel (de, dp) and
    the column kernel (dW, db), two launches counted under ``joint_grad``.
    On a CPU tensor this is the plain version."""
    if e.device.type != "cuda":
        return _plain.fused_grad(e, p, W, bias, labels, input_lengths, label_lengths, denom,
                                 fields, blank)
    dev = e.device
    e32, p32, W, b32, lab, offsets, ll = _inputs(e, p, W, bias, labels, input_lengths,
                                                 label_lengths, blank, "wtt_joint_grad_smem")
    B, T, H = e.shape
    U, V = p.shape[1], W.shape[1]
    for name, t in (("denom", denom),) + tuple(zip(fields._fields, fields)):
        require(t, name, dev, _F32, 3)
        if tuple(t.shape) != (B, T, U):
            raise ValueError(f"{name} must be {(B, T, U)}; got {tuple(t.shape)}")
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
              fields.coef.data_ptr(), fields.cb.data_ptr(), fields.ce.data_ptr())
    with torch.cuda.device(dev):
        err = lib().wtt_joint_grad_rows(*common, de.data_ptr(), dp.data_ptr(), B, T, U, H, V,
                                        int(blank), stream(dev))
        check(err, "joint_grad")
        err = lib().wtt_joint_grad_cols(*common, dW.data_ptr(), db.data_ptr(), dW_part.data_ptr(),
                                        db_part.data_ptr(), nsplit, B, T, U, H, V, int(blank),
                                        stream(dev))
        check(err, "joint_grad")
    return de.to(e.dtype), dp.to(p.dtype), dW.to(W.dtype), db.to(bias.dtype)
