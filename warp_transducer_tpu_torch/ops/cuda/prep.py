"""Wrapper of the prep kernel (``csrc/prep.cu``), the counterpart of
``warp_transducer_tpu/ops/pallas/prep_fused.py``."""
from __future__ import annotations

import ctypes

import torch

from .. import prep as _plain
from . import DTYPE_CODES, check, device_table, lib, require, stream


def prepare(acts: torch.Tensor, labels: torch.Tensor, blank: int,
            log_probs_input: bool, extra_cols=()) -> _plain.PreparedInputs:
    """``ops.prep.prepare`` on the card: one read of ``acts`` (f32, bf16,
    f16 or f64, in its own type) gives lpb, lpe, denom and the K extra
    columns (f32, or f64 for f64 input), by the tiled row reductions of
    ``csrc/reduce.cuh`` (the kernel plans itself as ``rows.reduce_plan``
    does). On a CPU tensor this is the plain version."""
    if acts.device.type != "cuda":
        return _plain.prepare(acts, labels, blank, log_probs_input, extra_cols)
    return _launch(acts, labels, blank, log_probs_input, extra_cols, None)


def prepare_planned(acts: torch.Tensor, labels: torch.Tensor, blank: int,
                    log_probs_input: bool, plan, extra_cols=()) -> _plain.PreparedInputs:
    """``prepare`` on a CUDA tensor with ``plan`` (a ``rows.ReducePlan``)
    in place of the kernel's own: the tile and the warp mode at one V, for
    the card tests and ``scripts/tune_prep.py``. The kernel refuses a plan
    outside its limits."""
    return _launch(acts, labels, blank, log_probs_input, extra_cols,
                   (ctypes.c_uint * 7)(*plan))


def library_plan(V: int, elt: int, align: int) -> tuple:
    """The kernel's own plan (``csrc/reduce.cuh::plan``), as a tuple of the
    seven fields of ``rows.ReducePlan``."""
    out = (ctypes.c_uint * 7)()
    lib().wtt_reduce_plan(V, elt, align, out)
    return tuple(out)


# Extra columns past this many go to the kernels' own instances, which read
# them from a table in device memory (csrc/common.cuh::kMaxExtraCols).
COLS_BY_VALUE = 8


def col_table(cols, dev):
    """The address of the device table of the columns past COLS_BY_VALUE of
    them (prep.cu, grad.cu), else None."""
    return device_table(cols, dev).data_ptr() if len(cols) > COLS_BY_VALUE else None


def _launch(acts, labels, blank, log_probs_input, extra_cols, plan):
    dev = acts.device
    require(acts, "acts", dev, DTYPE_CODES, 4)
    B, T, U, V = acts.shape
    cols = _plain.check_extra_cols(extra_cols, V)
    K = len(cols)
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    if B * T * U >= 2 ** 31:
        raise ValueError(f"B·T·U = {B * T * U} rows exceed the prep kernel's 2^31")
    lab = _plain.label_rows(labels.to(dev), U)
    cdtype = _plain.compute_dtype(acts.dtype)
    lpb = torch.empty((B, T, U), dtype=cdtype, device=dev)
    lpe = torch.empty_like(lpb)
    denom = None if log_probs_input else torch.empty_like(lpb)
    extras = torch.empty((B, T, U, K), dtype=cdtype, device=dev)
    args = (acts.data_ptr(), DTYPE_CODES[acts.dtype], lab.data_ptr(), lpb.data_ptr(),
            lpe.data_ptr(), None if denom is None else denom.data_ptr(),
            extras.data_ptr() if K else None, (ctypes.c_int * K)(*cols), K,
            col_table(cols, dev), B * T * U, T, U, V, int(blank), int(bool(log_probs_input)))
    with torch.cuda.device(dev):
        if plan is None:
            err = lib().wtt_prep(*args, stream(dev))
        else:
            err = lib().wtt_prep_planned(*args, plan, stream(dev))
    check(err, "prep")
    return _plain.PreparedInputs(lpb=lpb, lpe=lpe, denom=denom, extras=extras)
