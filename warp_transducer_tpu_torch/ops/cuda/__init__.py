"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Counterpart of ``warp_transducer_tpu/ops/pallas/``. Each wrapper has the
signature of the plain version it stands for:

* the dense loss: ``prep.prepare``, ``wavefront.forward_backward`` (also
  the lattice of the simple loss), ``grad.dense_grad`` /
  ``grad.sparse_grad``;
* the pruned path: ``band.band_prep``, ``band.forward_backward``,
  ``band.band_grad`` and ``ranges.band_starts``;
* the fused joint+loss: ``joint.fused_prep`` and ``joint.fused_grad`` (two
  kernels, three with a duration head, all counted under ``joint_grad``),
  both also with K big-blank columns and with the duration head of the TDT
  loss, and ``joint.dur_head_prep`` / ``joint.dur_head_grad``, that head
  alone (counted under ``dur_head``);
* the duration-arc losses (multi-blank, TDT): ``window.forward_backward``,
  with ``prep.prepare`` and ``grad.dense_grad`` taking the extra columns.

On a CPU tensor a wrapper runs that plain version; on a CUDA tensor it
launches its kernel on PyTorch's current stream, or raises. It never falls
back. ``launches`` counts the launches of each kernel, so a run can show
that it went through them.
"""
from __future__ import annotations

import torch

from .build import library as lib

# One counter per kernel, raised by one right after each successful launch.
launches = {"prep": 0, "wavefront": 0, "grad": 0, "band_prep": 0, "band_stream": 0,
            "band_grad": 0, "ranges": 0, "joint_prep": 0, "joint_grad": 0, "window_stream": 0,
            "dur_head": 0}

# Type codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
# Shared memory a block may use on sm_90 (227 KB); the wrappers check what
# their kernel keeps there against it.
SMEM_BYTES = 232448


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check(err: int, kernel: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t, then count the
    launch."""
    if err != 0:
        msg = lib().wtt_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err} ({msg})")
    launches[kernel] += 1


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, device: torch.device, dtypes, ndim: int) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor that the kernel
    takes: on ``device``, of one of ``dtypes``, with ``ndim`` dimensions."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes {tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D; got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
