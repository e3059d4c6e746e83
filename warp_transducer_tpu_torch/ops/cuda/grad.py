"""Wrapper of the gradient kernel (``csrc/grad.cu``), the counterpart of the
XLA pass of ``warp_transducer_tpu/ops/gradients.py``. The (B, T, U)
coefficient fields are plain torch ops (``gradients.coefficients``) on
every device; the kernel is the pass over (B, T, U, V), in the dense
(``dense_grad``) or the sparse (``sparse_grad``) convention."""
from __future__ import annotations

import ctypes

import torch

from .. import gradients as _plain
from . import DTYPE_CODES, check, lib, require, stream


def _launch(acts, denom, fields, labels_u, input_lengths, label_lengths, blank,
            shape, out_dtype, sparse, extra_cols=(), extra_fields=None):
    dev = fields.cb.device
    B, T, U, V = shape
    cdtype = fields.cb.dtype
    cols = _plain.check_extra_cols(extra_cols, V)
    K = len(cols)
    if K:
        require(extra_fields, "extra_fields", dev, (cdtype,), 4)
        if extra_fields.shape != (B, T, U, K):
            raise ValueError(f"extra_fields must be (B, T, U, {K}) for extra_cols {cols}; got "
                             f"{tuple(extra_fields.shape)}")
    for name, t in zip(fields._fields, fields):
        require(t, name, dev, (cdtype,), 3)
    if not sparse:
        require(acts, "acts", dev, DTYPE_CODES, 4)
        require(denom, "denom", dev, (cdtype,), 3)
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"the gradient kernel writes {tuple(DTYPE_CODES)}, not {out_dtype}")
    if (cdtype == torch.float64) != (out_dtype == torch.float64):
        raise ValueError(f"{out_dtype} output needs {'f64' if out_dtype == torch.float64 else 'f32'} "
                         f"coefficients, got {cdtype}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    lab = labels_u.to(device=dev, dtype=torch.int32).contiguous()
    il = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    ll = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
    grads = torch.empty(shape, dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_grad(
            None if sparse else acts.data_ptr(), DTYPE_CODES[out_dtype],
            None if sparse else denom.data_ptr(), fields.coef.data_ptr(),
            fields.cb.data_ptr(), fields.ce.data_ptr(),
            extra_fields.data_ptr() if K else None, (ctypes.c_int * K)(*cols), K,
            lab.data_ptr(), il.data_ptr(), ll.data_ptr(), grads.data_ptr(), B * T * U, T, U, V,
            int(blank), int(sparse), stream(dev))
    check(err, "grad")
    return grads


def dense_grad(acts, denom, fields, labels_u, input_lengths, label_lengths, blank,
               out_dtype, extra_cols=(), extra_fields=None):
    """``gradients.dense_grad`` on the card (acts in ``out_dtype``), with the
    K extra columns' posteriors subtracted in the same pass."""
    if acts.device.type != "cuda":
        return _plain.dense_grad(acts, denom, fields, labels_u, input_lengths,
                                 label_lengths, blank, out_dtype, extra_cols, extra_fields)
    if acts.dtype != out_dtype:
        raise ValueError(f"the gradient kernel writes acts' dtype {acts.dtype}, not {out_dtype}")
    return _launch(acts, denom, fields, labels_u, input_lengths, label_lengths, blank,
                   tuple(acts.shape), out_dtype, sparse=False, extra_cols=extra_cols,
                   extra_fields=extra_fields)


def sparse_grad(fields, labels_u, input_lengths, label_lengths, blank, shape_v,
                out_dtype):
    """``gradients.sparse_grad`` on the card."""
    if fields.cb.device.type != "cuda":
        return _plain.sparse_grad(fields, labels_u, input_lengths, label_lengths,
                                  blank, shape_v, out_dtype)
    return _launch(None, None, fields, labels_u, input_lengths, label_lengths, blank,
                   tuple(fields.cb.shape) + (shape_v,), out_dtype, sparse=True)

