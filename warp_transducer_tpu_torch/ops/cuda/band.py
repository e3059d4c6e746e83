"""Wrappers of the band kernels: ``csrc/band_prep.cu`` (the counterpart of
``warp_transducer_tpu/ops/pallas/band_pipeline.py::_prep_kernel``),
``csrc/band_stream.cu`` (``pallas/band_stream.py::_band_kernel``) and
``csrc/band_grad.cu`` (``pallas/band_pipeline.py::_grad_kernel``). The
plain versions are in ``ops/band.py``."""
from __future__ import annotations

import torch

from .. import band as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, int32, lib, require, rows, stream

_F32 = (torch.float32,)
_INT = (torch.int32,)


def band_prep(acts: torch.Tensor, lab_row: torch.Tensor, blank: int) -> _plain.BandPrep:
    """``band.band_prep`` on the card: one read of the (B, T, S, V) band
    (f32, bf16, f16 or f64) gives lpb, lpe and denom in f32. On a CPU
    tensor this is the plain version."""
    if acts.device.type != "cuda":
        return _plain.band_prep(acts, lab_row, blank)
    dev = acts.device
    require(acts, "acts", dev, DTYPE_CODES, 4)
    require(lab_row, "lab_row", dev, _INT, 3)
    B, T, S, V = acts.shape
    if tuple(lab_row.shape) != (B, T, S):
        raise ValueError(f"lab_row must be {(B, T, S)}; got {tuple(lab_row.shape)}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    lpb = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    lpe = torch.empty_like(lpb)
    denom = torch.empty_like(lpb)
    with torch.cuda.device(dev):
        err = lib().wtt_band_prep(
            acts.data_ptr(), DTYPE_CODES[acts.dtype], lab_row.data_ptr(), lpb.data_ptr(),
            lpe.data_ptr(), denom.data_ptr(), B * T * S, V, int(blank), stream(dev))
    check(err, "band_prep")
    return _plain.BandPrep(lpb, lpe, denom)


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor, ranges: torch.Tensor,
                     input_lengths: torch.Tensor,
                     label_lengths: torch.Tensor) -> _plain.BandLattice:
    """``band.forward_backward`` on the card: grid (B, 2), one warp for α
    and one for β of each utterance. On a CPU tensor this is the plain
    version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, ranges, input_lengths, label_lengths)
    dev = lpb.device
    require(lpb, "lpb", dev, _F32, 3)
    require(lpe, "lpe", dev, _F32, 3)
    B, T, S = lpb.shape
    if lpe.shape != lpb.shape:
        raise ValueError(f"lpe shape {tuple(lpe.shape)} != lpb shape {tuple(lpb.shape)}")
    r, il, ll = int32(dev, ranges, input_lengths, label_lengths)
    if tuple(r.shape) != (B, T):
        raise ValueError(f"ranges must be {(B, T)}; got {tuple(r.shape)}")
    if T < 1 or S < 1:
        raise ValueError(f"the band needs T >= 1 and S >= 1; got T={T}, S={S}")
    if 3 * S * 4 > SMEM_BYTES:
        raise ValueError(f"S={S} exceeds the band kernel's limit of {SMEM_BYTES // 12}: three "
                         "rows of S f32 values must fit the 227 KB of shared memory a block "
                         "may use")
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb)
    ll_forward = torch.empty((B,), dtype=torch.float32, device=dev)
    ll_backward = torch.empty_like(ll_forward)
    with torch.cuda.device(dev):
        err = lib().wtt_band_stream(
            lpb.data_ptr(), lpe.data_ptr(), r.data_ptr(), il.data_ptr(), ll.data_ptr(),
            alphas.data_ptr(), betas.data_ptr(), ll_forward.data_ptr(), ll_backward.data_ptr(),
            B, T, S, stream(dev))
    check(err, "band_stream")
    return _plain.BandLattice(alphas, betas, ll_forward, ll_backward)


def band_grad(acts, denom, fields, lab_row, ranges, input_lengths, label_lengths, blank,
              out_dtype):
    """``band.band_grad`` on the card (acts in ``out_dtype``). On a CPU
    tensor this is the plain version."""
    if acts.device.type != "cuda":
        return _plain.band_grad(acts, denom, fields, lab_row, ranges, input_lengths,
                                label_lengths, blank, out_dtype)
    dev = acts.device
    require(acts, "acts", dev, DTYPE_CODES, 4)
    if acts.dtype != out_dtype:
        raise ValueError(f"the band gradient kernel writes acts' dtype {acts.dtype}, "
                         f"not {out_dtype}")
    B, T, S, V = acts.shape
    for name, t in (("denom", denom),) + tuple(zip(fields._fields, fields)):
        require(t, name, dev, _F32, 3)
    require(lab_row, "lab_row", dev, _INT, 3)
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    if B * T * S >= 2 ** 31:
        raise ValueError(f"B·T·S = {B * T * S} rows exceed the band gradient kernel's 2^31")
    r, il, ll = int32(dev, ranges, input_lengths, label_lengths)
    grads = torch.empty_like(acts)
    plan = rows.host_plan(V, acts.element_size(), rows.alignment(acts.data_ptr(), grads.data_ptr()))
    with torch.cuda.device(dev):
        err = lib().wtt_band_grad(
            acts.data_ptr(), DTYPE_CODES[acts.dtype], denom.data_ptr(), fields.coef.data_ptr(),
            fields.cb.data_ptr(), fields.ce.data_ptr(), lab_row.data_ptr(), r.data_ptr(),
            il.data_ptr(), ll.data_ptr(), grads.data_ptr(), B * T * S, T, S, V, int(blank),
            plan, stream(dev))
    check(err, "band_grad")
    return grads
