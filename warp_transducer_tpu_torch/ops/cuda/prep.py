"""Wrapper of the prep kernel (``csrc/prep.cu``), the counterpart of
``warp_transducer_tpu/ops/pallas/prep_fused.py``."""
from __future__ import annotations

import ctypes

import torch

from .. import prep as _plain
from . import DTYPE_CODES, check, lib, require, stream


def prepare(acts: torch.Tensor, labels: torch.Tensor, blank: int,
            log_probs_input: bool, extra_cols=()) -> _plain.PreparedInputs:
    """``ops.prep.prepare`` on the card: one read of ``acts`` (f32, bf16,
    f16 or f64, in its own type) gives lpb, lpe, denom and the K extra
    columns (f32, or f64 for f64 input). On a CPU tensor this is the plain
    version."""
    if acts.device.type != "cuda":
        return _plain.prepare(acts, labels, blank, log_probs_input, extra_cols)
    dev = acts.device
    require(acts, "acts", dev, DTYPE_CODES, 4)
    B, T, U, V = acts.shape
    cols = _plain.check_extra_cols(extra_cols, V)
    K = len(cols)
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    lab = _plain.label_rows(labels.to(dev), U)
    cdtype = _plain.compute_dtype(acts.dtype)
    lpb = torch.empty((B, T, U), dtype=cdtype, device=dev)
    lpe = torch.empty_like(lpb)
    denom = None if log_probs_input else torch.empty_like(lpb)
    extras = torch.empty((B, T, U, K), dtype=cdtype, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_prep(
            acts.data_ptr(), DTYPE_CODES[acts.dtype], lab.data_ptr(), lpb.data_ptr(),
            lpe.data_ptr(), None if denom is None else denom.data_ptr(),
            extras.data_ptr() if K else None, (ctypes.c_int * K)(*cols), K,
            B * T * U, T, U, V, int(blank), int(bool(log_probs_input)), stream(dev))
    check(err, "prep")
    return _plain.PreparedInputs(lpb=lpb, lpe=lpe, denom=denom, extras=extras)
