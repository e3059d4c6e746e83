"""Runtime options, the PyTorch mirror of ``rnntOptions``
(reference ``include/rnnt.h:43-64``).

The reference's struct carries loc/num_threads/stream/maxT/maxU/batch_first —
artifacts of its C ABI. Here the device is the device of ``acts`` and the
stream is PyTorch's current stream. What survives is the semantic
configuration: blank index, gradient convention, reduction, implementation.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

PRECISIONS = ("highest", "default")


def _precision_switches(precision: str):
    """(backend flags, value) pairs that ``precision`` sets: the CUDA
    matmul's to "ieee" or "tf32"; at "highest" also oneDNN's (the CPU's
    matmul), which ``torch.set_float32_matmul_precision`` moves too."""
    backends = torch.backends
    if precision == "highest":
        return [(backends.cuda.matmul, "ieee")] + (
            [(backends.mkldnn.matmul, "ieee")] if hasattr(backends.mkldnn, "matmul") else [])
    return [(backends.cuda.matmul, "tf32")]


@contextlib.contextmanager
def matmul_precision(precision: str):
    """The precision of the f32 matrix products inside the block:
    ``"highest"`` IEEE f32, ``"default"`` TF32 allowed on the card (no effect
    on the CPU), whatever the caller has set globally
    (``torch.set_float32_matmul_precision``, ``fp32_precision``). Uses
    ``fp32_precision`` where this PyTorch has it and the legacy
    ``allow_tf32`` otherwise (reading the legacy flag after the new one was
    set raises); on exit every switch holds what it held before."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    cuda = torch.backends.cuda.matmul
    if not hasattr(cuda, "fp32_precision"):
        old = cuda.allow_tf32
        cuda.allow_tf32 = precision == "default"
        try:
            yield
        finally:
            cuda.allow_tf32 = old
        return
    switches = _precision_switches(precision)
    olds = [flags.fp32_precision for flags, _ in switches]
    try:
        for flags, value in switches:
            flags.fp32_precision = value
        yield
    finally:
        for (flags, _), old in zip(switches, olds):
            flags.fp32_precision = old


@dataclasses.dataclass(frozen=True)
class RNNTOptions:
    blank: int = 0
    reduction: str = "mean"  # none | sum | mean
    log_probs_input: bool = False  # reference-CPU convention when True
    # auto: the CUDA kernels for CUDA tensors, the plain PyTorch version for
    # CPU tensors | torch: the plain version on any device | cuda: the
    # kernels, and an error for a CPU tensor.
    implementation: str = "auto"
    # Optional numerical self-check: warn when |ll_fwd - ll_bwd| exceeds this
    # (mirrors the CPU backend's mismatch warning, cpu_rnnt.h:167-169).
    fwd_bwd_check_tol: float | None = None
    # FastEmit regularization strength λ (arXiv:2010.11148): scales the
    # emit-arc gradient by (1 + λ); the loss value is unchanged. 0 = off.
    fastemit_lambda: float = 0.0
    # Delay-penalized transducer strength λ (arXiv:2211.00490): emit arcs
    # at frame t get + λ·((T_b-1)/2 - t) on their log-weight (changes the
    # objective, exactly differentiable). 0 = off.
    delay_penalty: float = 0.0
