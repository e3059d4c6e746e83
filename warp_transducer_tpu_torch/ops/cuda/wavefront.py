"""Wrapper of the lattice kernel (``csrc/wavefront.cu``), the counterpart of
``warp_transducer_tpu/ops/pallas/wavefront_stream.py`` and
``ops/pallas/wavefront.py``."""
from __future__ import annotations

import torch

from .. import lattice as _plain
from . import DTYPE_CODES, SMEM_BYTES, check, lib, require, stream

_LATTICE_DTYPES = (torch.float32, torch.float64)


def forward_backward(lpb: torch.Tensor, lpe: torch.Tensor,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     compute_betas: bool = True) -> _plain.LatticeResult:
    """``ops.lattice.forward_backward`` on the card: grid (B, 2) (alpha and
    beta side by side) or (B, 1) without betas. On a CPU tensor this is the
    plain version."""
    if lpb.device.type != "cuda":
        return _plain.forward_backward(lpb, lpe, input_lengths, label_lengths,
                                       compute_betas=compute_betas)
    dev = lpb.device
    require(lpb, "lpb", dev, _LATTICE_DTYPES, 3)
    require(lpe, "lpe", dev, (lpb.dtype,), 3)
    if lpe.shape != lpb.shape:
        raise ValueError(f"lpe shape {tuple(lpe.shape)} != lpb shape {tuple(lpb.shape)}")
    B, T, U = lpb.shape
    max_u = SMEM_BYTES // (2 * lpb.element_size())  # two diagonals of U values
    if U > max_u:
        raise ValueError(
            f"U={U} exceeds the lattice kernel's limit of {max_u} for {lpb.dtype}: "
            "two diagonals of U values must fit the 227 KB of shared memory a "
            "block may use")
    il = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    ll = label_lengths.to(device=dev, dtype=torch.int32).contiguous()
    alphas = torch.empty_like(lpb)
    betas = torch.empty_like(lpb) if compute_betas else None
    ll_forward = torch.empty((B,), dtype=lpb.dtype, device=dev)
    ll_backward = torch.empty_like(ll_forward) if compute_betas else None
    with torch.cuda.device(dev):
        err = lib().wtt_wavefront(
            lpb.data_ptr(), lpe.data_ptr(), DTYPE_CODES[lpb.dtype], il.data_ptr(),
            ll.data_ptr(), alphas.data_ptr(),
            None if betas is None else betas.data_ptr(), ll_forward.data_ptr(),
            None if ll_backward is None else ll_backward.data_ptr(),
            B, T, U, int(compute_betas), stream(dev))
    check(err, "wavefront")
    if not compute_betas:
        return _plain.LatticeResult(alphas, alphas, ll_forward, ll_forward)
    return _plain.LatticeResult(alphas, betas, ll_forward, ll_backward)
