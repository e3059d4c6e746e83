"""warp_transducer_tpu_torch — the RNN-Transducer loss in PyTorch, with
hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of ``warp_transducer_tpu``: the dense RNN-T
negative log-likelihood and its analytic gradient over the (B, T, U, V)
joint lattice, with fused log-softmax, per-utterance lengths, configurable
blank, none|sum|mean reductions, a loss-only scoring path, FastEmit and the
delay penalty. A CUDA tensor runs the kernels of ``csrc/`` (built with
``nvcc`` on first use); a CPU tensor runs their plain PyTorch versions.
"""

from .ops.lattice import LatticeResult
from .ops.rnnt import (RNNTLoss, forward_backward_mismatch, rnnt_forward_backward,
                       rnnt_loss, rnnt_loss_and_grad, rnnt_score)
from .utils.options import RNNTOptions

__version__ = "0.1.0"

__all__ = [
    "LatticeResult",
    "RNNTLoss",
    "RNNTOptions",
    "forward_backward_mismatch",
    "rnnt_forward_backward",
    "rnnt_loss",
    "rnnt_loss_and_grad",
    "rnnt_score",
    "__version__",
]
