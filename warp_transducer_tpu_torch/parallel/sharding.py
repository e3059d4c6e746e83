"""Data-parallel RNN-T losses over a ``torch.distributed`` device mesh.

The PyTorch counterpart of ``warp_transducer_tpu.parallel.sharding``. There
the utterance batch shards across a ``jax.sharding.Mesh`` axis under
``shard_map`` and the scalar reductions ride ``psum``. Here every process
(rank) of a mesh axis holds its own shard of the batch, computes its costs
with the port's loss (the kernels on a CUDA tensor), and the reductions ride
one ``all_reduce`` over the axis's process group (NCCL on the card, gloo on
the CPU).

Gradients follow the JAX wrappers' contract: the gradient of a wrapper's
output with respect to a rank's shard equals the single-process gradient at
those rows, and a replicated tensor (a joint's W, bias, Wd, bias_d) receives
on every rank the single-process gradient, summed over the axis by the
wrapper itself (the transpose of replication, as ``shard_map`` does for a
replicated input). So a caller must not also put those tensors under a
``DistributedDataParallel`` reducer: their gradients would be summed twice.

Every wrapper but ``auto_sharded_rnnt_loss`` checks, once a call and before
the loss, that every rank of the axis holds the same number of utterances:
one ``all_reduce`` of two integers and one host sync. The rest of the call
adds no host sync to the loss's own.

Every rank of the axis must make the same calls in the same order, with the
same tensors requiring grad: the collectives pair up by order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops import rnnt as _rnnt
from ..ops.fused_joint import rnnt_loss_fused_joint
from ..ops.multiblank import rnnt_loss_multiblank
from ..ops.multiblank_fused import rnnt_loss_multiblank_fused_joint
from ..ops.pruned_fused import rnnt_loss_pruned_fused
from ..ops.tdt import rnnt_loss_tdt
from ..ops.tdt_fused import rnnt_loss_tdt_fused_joint

DATA_AXIS = "data"
_REDUCTIONS = ("none", "sum", "mean")


def make_mesh(device_type: str = "cuda", axis_names: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A device mesh over the ranks of the default process group
    (``initialize_distributed`` first); by default a 1-D data-parallel mesh
    over all of them, on the card. CPU callers pass ``device_type="cpu"``."""
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def initialize_distributed(**kwargs) -> None:
    """Multi-process bring-up: a thin wrapper over
    ``torch.distributed.init_process_group(**kwargs)``.

    Without an ``init_method`` it reads ``env://`` (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, as ``torchrun`` sets them). The backend is NCCL
    where CUDA is present and gloo otherwise, unless ``backend=`` names one."""
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward is the identity, so each rank's
    inputs get the gradient of their own share of the replicated total (an
    all-reduced cotangent would come out world-size times too large)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group, so
    every rank holds the gradient of the whole batch."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _axis_group(mesh: DeviceMesh, axis: str, reduction: str, local_batch: int,
                device: torch.device):
    """Check ``reduction`` and that every rank of ``mesh[axis]`` holds
    ``local_batch`` utterances (one all_reduce of two integers and a host
    sync); return the axis's process group."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    group = mesh.get_group(axis)
    sizes = torch.tensor([local_batch, -local_batch], dtype=torch.int64, device=device)
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
    largest, smallest = sizes.tolist()
    smallest = -smallest
    if largest != smallest:
        raise ValueError(
            f"local batches differ across mesh axis {axis!r} "
            f"({dist.get_world_size(group)} ranks): from {smallest} to {largest} utterances; "
            f"this rank holds {local_batch}")
    return group


def _reduce(costs, reduction, group):
    """The JAX wrappers' psum of the shards' sums, divided by the global
    batch for 'mean' (each rank's mean over the axis size: the local batches
    are equal)."""
    if reduction == "none":
        return costs
    if reduction == "sum":
        return _AllReduceSum.apply(costs.sum(), group)
    return _AllReduceSum.apply(costs.mean() / dist.get_world_size(group), group)


def data_parallel_rnnt_loss(acts, labels, input_lengths, label_lengths, mesh: DeviceMesh,
                            axis: str = DATA_AXIS, blank: int = 0, reduction: str = "mean",
                            log_probs_input: bool = False, implementation: str = "auto"):
    """RNN-T loss with the utterance batch sharded over ``mesh[axis]``.

    Each rank passes its shard (every rank the same local batch) and gets
    its (b,) costs for 'none', else the total over the axis ('mean' divides
    by the global batch), the same on every rank. Differentiable w.r.t.
    ``acts``: the gradient is the single-process one at this rank's rows.
    Arguments otherwise as in ``rnnt_loss``.
    """
    group = _axis_group(mesh, axis, reduction, acts.shape[0], acts.device)
    costs = _rnnt.rnnt_loss(acts, labels, input_lengths, label_lengths, blank=blank,
                            reduction="none", log_probs_input=log_probs_input,
                            implementation=implementation)
    return _reduce(costs, reduction, group)


def data_parallel_fused_joint_loss(e, p, W, bias, labels, input_lengths, label_lengths,
                                   mesh: DeviceMesh, axis: str = DATA_AXIS, blank: int = 0,
                                   reduction: str = "mean", implementation: str = "auto"):
    """Fused joint+loss with the batch sharded over ``mesh[axis]``.

    e, p, labels and lengths are this rank's shard; W and bias are
    replicated (the same on every rank). de and dp are the single-process
    gradients at this rank's rows; dW and db are summed over the axis by
    the wrapper, so every rank holds the single-process dW and db (do not
    also reduce them with DDP). Arguments as in ``rnnt_loss_fused_joint``.
    """
    group = _axis_group(mesh, axis, reduction, e.shape[0], e.device)
    W, bias = (_Replicated.apply(x, group) for x in (W, bias))
    costs = rnnt_loss_fused_joint(e, p, W, bias, labels, input_lengths, label_lengths,
                                  blank=blank, reduction="none", implementation=implementation)
    return _reduce(costs, reduction, group)


def auto_sharded_rnnt_loss(acts, labels, input_lengths, label_lengths, mesh: DeviceMesh,
                           axis: str = DATA_AXIS, **kwargs):
    """The counterpart of the JAX package's GSPMD path: every rank passes the
    global tensors and computes ``rnnt_loss(**kwargs)`` on its rows of them,
    the ``mesh[axis]`` coordinate's share of the batch (which must divide).

    Returns a ``DTensor`` whose placement is pinned: the costs as
    ``Shard(0)`` for reduction 'none', a ``Replicate()`` scalar for 'sum' and
    'mean' (``options.reduction`` overrides the keyword, as in
    ``rnnt_loss``). The gradient reaches ``acts`` only at this rank's rows;
    the other rows' gradient is on the ranks that own them.
    """
    reduction = kwargs.pop("reduction", "mean")
    if kwargs.get("options") is not None:
        reduction = kwargs["options"].reduction
        kwargs["options"] = dataclasses.replace(kwargs["options"], reduction="none")
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be none|sum|mean, got {reduction!r}")
    group = mesh.get_group(axis)
    n_shards, B = dist.get_world_size(group), acts.shape[0]
    if B % n_shards:
        raise ValueError(f"batch {B} not divisible by mesh axis {axis!r} size {n_shards}")
    start = mesh.get_local_rank(axis) * (B // n_shards)
    rows = slice(start, start + B // n_shards)
    costs = _rnnt.rnnt_loss(acts[rows], labels[rows], input_lengths[rows], label_lengths[rows],
                            reduction="none", **kwargs)
    placements = [Replicate()] * mesh.ndim
    if reduction == "none":
        placements[mesh.mesh_dim_names.index(axis)] = Shard(0)
    return DTensor.from_local(_reduce(costs, reduction, group), mesh, placements,
                              run_check=False)


def data_parallel_pruned_fused_loss(e, p, W, bias, ranges, labels, input_lengths, label_lengths,
                                    s_range: int, mesh: DeviceMesh, axis: str = DATA_AXIS,
                                    blank: int = 0, reduction: str = "mean",
                                    implementation: str = "auto", fastemit_lambda: float = 0.0):
    """Pruned fused joint+loss with the batch sharded over ``mesh[axis]``.

    The layout of ``data_parallel_fused_joint_loss``: e, p, ranges, labels
    and lengths are this rank's shard, W and bias replicated, dW and db
    summed over the axis by the wrapper (not by DDP). Arguments as in
    ``rnnt_loss_pruned_fused``.
    """
    group = _axis_group(mesh, axis, reduction, e.shape[0], e.device)
    W, bias = (_Replicated.apply(x, group) for x in (W, bias))
    costs = rnnt_loss_pruned_fused(e, p, W, bias, ranges, labels, input_lengths, label_lengths,
                                   s_range=s_range, blank=blank, reduction="none",
                                   implementation=implementation,
                                   fastemit_lambda=fastemit_lambda)
    return _reduce(costs, reduction, group)


def data_parallel_multiblank_loss(acts, labels, input_lengths, label_lengths,
                                  big_blank_durations, mesh: DeviceMesh, axis: str = DATA_AXIS,
                                  blank: int = 0, big_blank_indices=None, sigma: float = 0.0,
                                  reduction: str = "mean", fastemit_lambda: float = 0.0,
                                  delay_penalty: float = 0.0, implementation: str = "auto"):
    """Multi-blank transducer loss (arXiv:2211.03541) with the batch sharded
    over ``mesh[axis]``; the contract of ``data_parallel_rnnt_loss``,
    arguments as in ``rnnt_loss_multiblank``."""
    group = _axis_group(mesh, axis, reduction, acts.shape[0], acts.device)
    costs = rnnt_loss_multiblank(acts, labels, input_lengths, label_lengths, big_blank_durations,
                                 blank=blank, big_blank_indices=big_blank_indices, sigma=sigma,
                                 reduction="none", fastemit_lambda=fastemit_lambda,
                                 delay_penalty=delay_penalty, implementation=implementation)
    return _reduce(costs, reduction, group)


def data_parallel_tdt_loss(token_logits, duration_logits, labels, input_lengths, label_lengths,
                           durations, mesh: DeviceMesh, axis: str = DATA_AXIS, blank: int = 0,
                           sigma: float = 0.0, reduction: str = "mean",
                           fastemit_lambda: float = 0.0, delay_penalty: float = 0.0,
                           implementation: str = "auto"):
    """Token-and-Duration Transducer loss (arXiv:2304.06795) with the batch
    sharded over ``mesh[axis]``; differentiable w.r.t. both logits tensors
    (the single-process gradients at this rank's rows). Arguments as in
    ``rnnt_loss_tdt``."""
    group = _axis_group(mesh, axis, reduction, token_logits.shape[0], token_logits.device)
    costs = rnnt_loss_tdt(token_logits, duration_logits, labels, input_lengths, label_lengths,
                          durations, blank=blank, sigma=sigma, reduction="none",
                          fastemit_lambda=fastemit_lambda, delay_penalty=delay_penalty,
                          implementation=implementation)
    return _reduce(costs, reduction, group)


def data_parallel_tdt_fused_loss(e, p, W, bias, Wd, bias_d, labels, input_lengths, label_lengths,
                                 durations, mesh: DeviceMesh, axis: str = DATA_AXIS,
                                 blank: int = 0, sigma: float = 0.0, reduction: str = "mean",
                                 fastemit_lambda: float = 0.0, delay_penalty: float = 0.0,
                                 implementation: str = "auto"):
    """Fused TDT joint+loss with the batch sharded over ``mesh[axis]``; W,
    bias, Wd and bias_d replicated, their gradients summed over the axis by
    the wrapper (not by DDP; cf. ``data_parallel_fused_joint_loss``).
    Arguments as in ``rnnt_loss_tdt_fused_joint``."""
    group = _axis_group(mesh, axis, reduction, e.shape[0], e.device)
    W, bias, Wd, bias_d = (_Replicated.apply(x, group) for x in (W, bias, Wd, bias_d))
    costs = rnnt_loss_tdt_fused_joint(e, p, W, bias, Wd, bias_d, labels, input_lengths,
                                      label_lengths, durations, blank=blank, sigma=sigma,
                                      reduction="none", fastemit_lambda=fastemit_lambda,
                                      delay_penalty=delay_penalty, implementation=implementation)
    return _reduce(costs, reduction, group)


def data_parallel_multiblank_fused_loss(e, p, W, bias, labels, input_lengths, label_lengths,
                                        big_blank_durations, mesh: DeviceMesh,
                                        axis: str = DATA_AXIS, blank: int = 0,
                                        big_blank_indices=None, sigma: float = 0.0,
                                        reduction: str = "mean", fastemit_lambda: float = 0.0,
                                        delay_penalty: float = 0.0,
                                        implementation: str = "auto"):
    """Fused multi-blank joint+loss with the batch sharded over
    ``mesh[axis]``; W and bias replicated, dW and db summed over the axis by
    the wrapper (not by DDP). Arguments as in
    ``rnnt_loss_multiblank_fused_joint``."""
    group = _axis_group(mesh, axis, reduction, e.shape[0], e.device)
    W, bias = (_Replicated.apply(x, group) for x in (W, bias))
    costs = rnnt_loss_multiblank_fused_joint(e, p, W, bias, labels, input_lengths, label_lengths,
                                             big_blank_durations, blank=blank,
                                             big_blank_indices=big_blank_indices, sigma=sigma,
                                             reduction="none", fastemit_lambda=fastemit_lambda,
                                             delay_penalty=delay_penalty,
                                             implementation=implementation)
    return _reduce(costs, reduction, group)
