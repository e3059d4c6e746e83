"""Wrappers of the gradient kernels (``csrc/grad.cu``), the counterpart of
the XLA pass of ``warp_transducer_tpu/ops/gradients.py``, in two modes:

* lattice mode (``grad_wrt_acts``, ``grad_wrt_log_probs``; counted under
  ``grad``): the kernel computes each row's coefficients from α, β, ll,
  lpb and lpe itself, and no (B, T, U) field is written — the dense loss's
  backward;
* fields mode (``dense_grad``, ``sparse_grad``; counted under
  ``grad_fields``): the (B, T, U) coefficient fields come in, with any
  number of extra columns in both (up to 8 by value; past 8 the kernel's
  instances of their own read them from a device table) — the multi-blank
  loss (dense on raw activations, sparse on log-probs) and the TDT token
  head, whose coefficients are not the standard ones.

Both run on the row passes of ``csrc/rows.cuh``, planned by ``rows.plan``.
On a CPU tensor each function is its plain version in ``ops/gradients.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import gradients as _plain
from . import DTYPE_CODES, check, int32, lib, require, rows, stream
from .prep import col_table

_COMPUTE = (torch.float32, torch.float64)


def _row_plan(V, out, *tensors):
    """The host array of the plan for rows of V elements of ``out``'s type,
    vectors only where every base address allows them."""
    align = rows.alignment(*(t.data_ptr() for t in (out,) + tensors if t is not None))
    return rows.host_plan(V, out.element_size(), align)


def _common_checks(cdtype, out_dtype, blank, V, n_rows):
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"the gradient kernel writes {tuple(DTYPE_CODES)}, not {out_dtype}")
    if (cdtype == torch.float64) != (out_dtype == torch.float64):
        raise ValueError(f"{out_dtype} output needs {'f64' if out_dtype == torch.float64 else 'f32'} "
                         f"coefficients, got {cdtype}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} is outside [0, V={V})")
    if n_rows >= 2 ** 31:
        raise ValueError(f"B·T·U = {n_rows} rows exceed the gradient kernel's 2^31")


def _lattice(acts, denom, lpb, lpe, alphas, betas, ll, labels_u, input_lengths, label_lengths,
             blank, shape_v, out_dtype, scale, fastemit_lambda, sparse):
    dev = alphas.device
    cdtype = alphas.dtype
    if cdtype not in _COMPUTE:
        raise ValueError(f"alphas has dtype {cdtype}; the kernel takes {_COMPUTE}")
    for name, t in (("lpb", lpb), ("lpe", lpe), ("alphas", alphas), ("betas", betas)):
        require(t, name, dev, (cdtype,), 3)
        if t.shape != alphas.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != alphas shape {tuple(alphas.shape)}")
    B, T, U = alphas.shape
    require(ll, "ll", dev, (cdtype,), 1)
    if not sparse:
        require(acts, "acts", dev, DTYPE_CODES, 4)
        require(denom, "denom", dev, (cdtype,), 3)
        if acts.shape[:3] != alphas.shape or denom.shape != alphas.shape:
            raise ValueError(f"acts {tuple(acts.shape)} and denom {tuple(denom.shape)} do not "
                             f"match the lattice {tuple(alphas.shape)}")
        if acts.dtype != out_dtype:
            raise ValueError(f"the gradient kernel writes acts' dtype {acts.dtype}, "
                             f"not {out_dtype}")
    _common_checks(cdtype, out_dtype, blank, shape_v, B * T * U)
    lab, il, lens = int32(dev, labels_u, input_lengths, label_lengths)
    if tuple(lab.shape) != (B, U) or ll.shape != (B,) or il.shape != (B,) or lens.shape != (B,):
        raise ValueError(f"labels_u must be {(B, U)} and ll and the lengths ({B},)")
    if scale is not None:
        scale = scale.to(device=dev, dtype=cdtype)
        if scale.shape != (B,):
            raise ValueError(f"scale must be ({B},); got {tuple(scale.shape)}")
    grads = torch.empty((B, T, U, shape_v), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_grad_lattice(
            None if sparse else acts.data_ptr(), DTYPE_CODES[out_dtype],
            None if sparse else denom.data_ptr(), lpb.data_ptr(), lpe.data_ptr(),
            alphas.data_ptr(), betas.data_ptr(), ll.data_ptr(),
            None if scale is None else scale.data_ptr(), 0 if scale is None else scale.stride(0),
            float(fastemit_lambda), lab.data_ptr(), il.data_ptr(), lens.data_ptr(),
            grads.data_ptr(), B * T * U, T, U, shape_v, int(blank), int(sparse),
            _row_plan(shape_v, grads, None if sparse else acts), stream(dev))
    check(err, "grad")
    return grads


def grad_wrt_acts(acts, denom, lpb, lpe, alphas, betas, ll, labels_u, input_lengths,
                  label_lengths, blank, out_dtype=None, scale=None, fastemit_lambda=0.0):
    """``gradients.grad_wrt_acts`` on the card: the dense gradient, its
    coefficients computed per row inside the pass (acts in ``out_dtype``).
    On a CPU tensor this is the plain version."""
    if acts.device.type != "cuda":
        return _plain.grad_wrt_acts(acts, denom, lpb, lpe, alphas, betas, ll, labels_u,
                                    input_lengths, label_lengths, blank, out_dtype, scale,
                                    fastemit_lambda)
    return _lattice(acts, denom, lpb, lpe, alphas, betas, ll, labels_u, input_lengths,
                    label_lengths, blank, acts.shape[-1], out_dtype or acts.dtype, scale,
                    fastemit_lambda, sparse=False)


def grad_wrt_log_probs(lpb, lpe, alphas, betas, ll, labels_u, input_lengths, label_lengths,
                       blank, shape_v, out_dtype, scale=None, fastemit_lambda=0.0):
    """``gradients.grad_wrt_log_probs`` on the card: the sparse gradient,
    its coefficients computed per row inside the pass. On a CPU tensor this
    is the plain version."""
    if lpb.device.type != "cuda":
        return _plain.grad_wrt_log_probs(lpb, lpe, alphas, betas, ll, labels_u, input_lengths,
                                         label_lengths, blank, shape_v, out_dtype, scale,
                                         fastemit_lambda)
    return _lattice(None, None, lpb, lpe, alphas, betas, ll, labels_u, input_lengths,
                    label_lengths, blank, shape_v, out_dtype, scale, fastemit_lambda,
                    sparse=True)


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
    _common_checks(cdtype, out_dtype, blank, V, B * T * U)
    lab, il, ll = int32(dev, labels_u, input_lengths, label_lengths)
    grads = torch.empty(shape, dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib().wtt_grad(
            None if sparse else acts.data_ptr(), DTYPE_CODES[out_dtype],
            None if sparse else denom.data_ptr(), fields.coef.data_ptr(),
            fields.cb.data_ptr(), fields.ce.data_ptr(),
            extra_fields.data_ptr() if K else None, (ctypes.c_int * K)(*cols), K,
            col_table(cols, dev), lab.data_ptr(), il.data_ptr(), ll.data_ptr(), grads.data_ptr(),
            B * T * U, T, U, V, int(blank), int(sparse),
            _row_plan(V, grads, None if sparse else acts), stream(dev))
    check(err, "grad_fields")
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
                out_dtype, extra_cols=(), extra_fields=None):
    """``gradients.sparse_grad`` on the card, with the K extra columns'
    posteriors written in the same pass (the label over them, them over
    blank)."""
    if fields.cb.device.type != "cuda":
        return _plain.sparse_grad(fields, labels_u, input_lengths, label_lengths,
                                  blank, shape_v, out_dtype, extra_cols, extra_fields)
    return _launch(None, None, fields, labels_u, input_lengths, label_lengths, blank,
                   tuple(fields.cb.shape) + (shape_v,), out_dtype, sparse=True,
                   extra_cols=extra_cols, extra_fields=extra_fields)
