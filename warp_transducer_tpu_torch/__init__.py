"""warp_transducer_tpu_torch — the RNN-Transducer loss in PyTorch, with
hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of ``warp_transducer_tpu``:

* the dense RNN-T negative log-likelihood and its analytic gradient over
  the (B, T, U, V) joint lattice, with fused log-softmax, per-utterance
  lengths, configurable blank, none|sum|mean reductions, a loss-only
  scoring path, FastEmit and the delay penalty (``rnnt_loss`` and its
  relatives);
* the pruned path (arXiv:2206.13236): ``rnnt_loss_simple`` for the
  additive joiner without the (B, T, U, V) tensor, ``rnnt_prune_ranges``
  for per-frame band starts, ``gather_banded`` to bring U-indexed rows to
  the band and ``rnnt_loss_pruned`` for the loss on a (B, T, S, V) band;
* the fused joint+loss: ``rnnt_loss_fused_joint`` for the loss of
  ``tanh(e ⊕ p) @ W + bias`` with gradients to e, p, W and bias, without
  the (B, T, U, V) logits or their gradient in device memory, and
  ``rnnt_loss_pruned_fused`` for the same on a pruned band;
  ``models.transducer.Joint`` is the module through which a model calls
  both, and ``utils.convert`` carries the Flax module's weights across;
* the duration-arc losses on logits: ``rnnt_loss_multiblank``
  (arXiv:2211.03541, big blanks that advance several frames) and
  ``rnnt_loss_tdt`` (arXiv:2304.06795, a token head and a duration head),
  both over one pending-window lattice;
* the same two fused into the joint: ``rnnt_loss_multiblank_fused_joint``
  (the fused prep and gradient with K big-blank columns; the counterpart of
  the JAX package's ``fused_prep_mb`` / ``fused_grad_mb`` kernels) and
  ``rnnt_loss_tdt_fused_joint`` (with the duration head inside the fused
  kernels, ``fused_prep_tdt`` / ``fused_grad_tdt``, or beside them,
  ``dur_head_prep`` / ``dur_head_grad``), with gradients to every joint
  input; ``Joint.multiblank_fused_loss`` and ``Joint.tdt_fused_loss`` call
  them.
* the model around the losses (``models.transducer``): the conformer
  encoder, the LSTM prediction network, the joint, ``Transducer``, the five
  loss functions and the eight train steps, with
  ``utils.convert.transducer_state_dict_from_flax`` for a Flax tree; and
  ``bindings.torch_binding``, the ``warprnnt_pytorch`` surface on CPU and
  CUDA tensors;
* the inference side: Viterbi forced alignment over the dense, TDT and
  multi-blank lattices (``rnnt_viterbi_align``, ``tdt_viterbi_align``,
  ``multiblank_viterbi_align``), and the greedy and beam-search decoders
  of ``models.decoding``;
* the data-parallel losses of ``parallel`` (``parallel.sharding``): each
  rank of a ``torch.distributed`` device mesh computes its shard of the
  batch with the losses above, and one ``all_reduce`` over the mesh axis
  reduces the costs (and the gradients of a replicated joint's weights).

A CUDA tensor runs the kernels of ``csrc/`` (built with ``nvcc`` on first
use); a CPU tensor runs their plain PyTorch versions.
"""

from .ops.alignment import (MultiblankViterbiAlignment, TDTViterbiAlignment,
                            ViterbiAlignment, multiblank_viterbi_align,
                            rnnt_viterbi_align, tdt_viterbi_align)
from .ops.fused_joint import rnnt_loss_fused_joint
from .ops.lattice import LatticeResult
from .ops.multiblank import rnnt_loss_multiblank
from .ops.multiblank_fused import rnnt_loss_multiblank_fused_joint
from .ops.pruned import gather_banded, rnnt_loss_pruned, rnnt_prune_ranges
from .ops.pruned_fused import rnnt_loss_pruned_fused
from .ops.rnnt import (RNNTLoss, forward_backward_mismatch, rnnt_forward_backward,
                       rnnt_loss, rnnt_loss_and_grad, rnnt_score)
from .ops.simple import rnnt_loss_simple
from .ops.tdt import rnnt_loss_tdt
from .ops.tdt_fused import rnnt_loss_tdt_fused_joint
from .utils.options import RNNTOptions

__version__ = "0.7.0"

__all__ = [
    "LatticeResult",
    "MultiblankViterbiAlignment",
    "RNNTLoss",
    "RNNTOptions",
    "TDTViterbiAlignment",
    "ViterbiAlignment",
    "forward_backward_mismatch",
    "gather_banded",
    "multiblank_viterbi_align",
    "rnnt_forward_backward",
    "rnnt_loss",
    "rnnt_loss_and_grad",
    "rnnt_loss_fused_joint",
    "rnnt_loss_multiblank",
    "rnnt_loss_multiblank_fused_joint",
    "rnnt_loss_pruned",
    "rnnt_loss_pruned_fused",
    "rnnt_loss_simple",
    "rnnt_loss_tdt",
    "rnnt_loss_tdt_fused_joint",
    "rnnt_prune_ranges",
    "rnnt_score",
    "rnnt_viterbi_align",
    "tdt_viterbi_align",
    "__version__",
]
