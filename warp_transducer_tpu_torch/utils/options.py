"""Runtime options, the PyTorch mirror of ``rnntOptions``
(reference ``include/rnnt.h:43-64``).

The reference's struct carries loc/num_threads/stream/maxT/maxU/batch_first —
artifacts of its C ABI. Here the device is the device of ``acts`` and the
stream is PyTorch's current stream. What survives is the semantic
configuration: blank index, gradient convention, reduction, implementation.
"""
from __future__ import annotations

import dataclasses


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
