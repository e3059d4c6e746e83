"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Counterpart of ``warp_transducer_tpu/ops/pallas/``. Each wrapper
(``prep.prepare``, ``wavefront.forward_backward``, ``grad.dense_grad`` /
``grad.sparse_grad``) has the signature of the plain version it stands
for. On a CPU tensor it runs that plain version; on a CUDA tensor it
launches its kernel on PyTorch's current stream, or raises. It never falls
back. ``launches`` counts the launches of each kernel, so a run can show
that it went through them.
"""
from __future__ import annotations

import torch

from .build import library as lib

# One counter per kernel, raised by one right after each successful launch.
launches = {"prep": 0, "wavefront": 0, "grad": 0}

# Type codes of csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}


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
