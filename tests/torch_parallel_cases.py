"""The cases of the port's data-parallel wrappers
(``warp_transducer_tpu_torch.parallel``) that tests/test_torch_parallel.py
and tests/test_torch_cuda_parallel.py hold, and the worker that runs them on
one rank of a gloo group:

    python tests/torch_parallel_cases.py --rank R --world-size N \
        --store FILE --inputs NPZ --out DIR [--device cpu|cuda]

Each case's global inputs are made with numpy from a seed (``problems``);
the worker takes its rank's rows of every batch-sharded input (the
replicated W, bias, Wd and bias_d whole), runs the wrapper with each
reduction, and writes the output and the gradients of every
differentiable input to ``DIR/<case>-<reduction>-<rank>.npz``; then
``auto_sharded_rnnt_loss`` on the global inputs, a call whose local batches
differ across the ranks, and the meshes' names and shapes
(``DIR/summary-<rank>.json``). Imports torch, numpy and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch

REDUCTIONS = ("none", "sum", "mean")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "warp_transducer_tpu")
B = 4


@dataclasses.dataclass(frozen=True)
class Case:
    local: str  # the port's entry point, by name
    args: tuple  # the inputs, in the wrapper's order
    leaves: tuple  # the differentiable inputs
    replicated: tuple = ()  # inputs every rank holds whole
    pre_mesh: tuple = ()  # positional arguments between the inputs and the mesh
    kw: dict = dataclasses.field(default_factory=dict)


CASES = {
    "data_parallel_rnnt_loss": Case("rnnt_loss", ("acts", "labels", "il", "ll"), ("acts",)),
    "data_parallel_fused_joint_loss": Case(
        "rnnt_loss_fused_joint", ("e", "p", "W", "bias", "labels", "il", "ll"),
        ("e", "p", "W", "bias"), ("W", "bias")),
    "data_parallel_pruned_fused_loss": Case(
        "rnnt_loss_pruned_fused", ("e", "p", "W", "bias", "ranges", "labels", "il", "ll"),
        ("e", "p", "W", "bias"), ("W", "bias"), (3,)),
    "data_parallel_multiblank_loss": Case(
        "rnnt_loss_multiblank", ("acts", "labels", "il", "ll"), ("acts",), (), ((2, 4),),
        dict(sigma=0.05)),
    "data_parallel_tdt_loss": Case(
        "rnnt_loss_tdt", ("acts", "dur", "labels", "il", "ll"), ("acts", "dur"), (), ((0, 1, 2),),
        dict(sigma=0.02)),
    "data_parallel_tdt_fused_loss": Case(
        "rnnt_loss_tdt_fused_joint", ("e", "p", "W", "bias", "Wd", "bd", "labels", "il", "ll"),
        ("e", "p", "W", "bias", "Wd", "bd"), ("W", "bias", "Wd", "bd"), ((0, 1, 2),),
        dict(sigma=0.02)),
    "data_parallel_multiblank_fused_loss": Case(
        "rnnt_loss_multiblank_fused_joint", ("e", "p", "W", "bias", "labels", "il", "ll"),
        ("e", "p", "W", "bias"), ("W", "bias"), ((2, 3),), dict(sigma=0.05)),
}
# The dense losses take float64 (their f64 path); the fused ones float32.
F64_CASES = ("data_parallel_rnnt_loss", "data_parallel_multiblank_loss", "data_parallel_tdt_loss")


def _lengths(rng, T, U):
    il = rng.integers(2, T + 1, B).astype(np.int32)
    ll = rng.integers(0, U, B).astype(np.int32)
    il[0], ll[0] = T, U - 1
    return il, ll


def _logits_problem(seed, T, U, V, n_extra=0, D=0):
    rng = np.random.default_rng(seed)
    out = {"acts": rng.standard_normal((B, T, U, V))}
    if D:
        out["dur"] = rng.standard_normal((B, T, U, D))
    out["labels"] = rng.integers(1, V - n_extra, (B, U - 1)).astype(np.int32)
    out["il"], out["ll"] = _lengths(rng, T, U)
    return out


def _joint_problem(seed, T, U, V, H, n_extra=0, D=0):
    rng = np.random.default_rng(seed)
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    out = {"e": f32(rng.standard_normal((B, T, H)) * 0.5),
           "p": f32(rng.standard_normal((B, U, H)) * 0.5),
           "W": f32(rng.standard_normal((H, V)) / np.sqrt(H)),
           "bias": f32(rng.standard_normal(V) * 0.1)}
    if D:
        out["Wd"] = f32(rng.standard_normal((H, D)) / np.sqrt(H))
        out["bd"] = f32(rng.standard_normal(D) * 0.1)
    out["labels"] = rng.integers(1, V - n_extra, (B, U - 1)).astype(np.int32)
    out["il"], out["ll"] = _lengths(rng, T, U)
    return out


def _pruned_problem(seed, T=6, U=4, V=9, H=16, S=3):
    """Full lengths and band starts that every path can follow (the ranges
    of tests/test_sharding.py)."""
    out = _joint_problem(seed, T, U, V, H)
    out["il"], out["ll"] = np.full(B, T, np.int32), np.full(B, U - 1, np.int32)
    rng = np.random.default_rng(seed + 1)
    steps = rng.integers(0, S, (B, T))
    steps[:, 0] = 0
    ranges = np.minimum(np.cumsum(steps, 1), max(U - S, 0))
    ranges[:, -1] = max(U - S, 0)
    for t in range(T - 1, 0, -1):
        ranges[:, t - 1] = np.maximum(ranges[:, t - 1], ranges[:, t] - (S - 1))
    ranges[:, 0] = 0
    out["ranges"] = ranges.astype(np.int32)
    return out


def problems():
    """{case: {input: global numpy array}}, B = 4 utterances each."""
    return {
        "data_parallel_rnnt_loss": _logits_problem(0, T=8, U=4, V=6),
        "data_parallel_fused_joint_loss": _joint_problem(1, T=6, U=4, V=9, H=16),
        "data_parallel_pruned_fused_loss": _pruned_problem(2),
        "data_parallel_multiblank_loss": _logits_problem(3, T=8, U=4, V=8, n_extra=2),
        "data_parallel_tdt_loss": _logits_problem(4, T=8, U=4, V=7, D=3),
        "data_parallel_tdt_fused_loss": _joint_problem(5, T=8, U=4, V=10, H=6, D=3),
        "data_parallel_multiblank_fused_loss": _joint_problem(6, T=8, U=4, V=10, H=6, n_extra=2),
    }


def tensors(name, arrays, device, rows=slice(None)):
    """The case's inputs as tensors on ``device``: the batch-sharded ones at
    ``rows``, the replicated ones whole; differentiable ones as leaves."""
    case = CASES[name]
    out = {}
    for k in case.args:
        x = torch.tensor(arrays[k] if k in case.replicated else arrays[k][rows], device=device)
        out[k] = x.requires_grad_(True) if k in case.leaves else x
    return out


def _result(out, t, leaves):
    grads = torch.autograd.grad(out.sum(), [t[k] for k in leaves])
    return out.detach(), dict(zip(leaves, grads))


def run_wrapper(name, t, mesh, reduction):
    """The wrapper on this rank's inputs ``t``: (output, {leaf: gradient})."""
    from warp_transducer_tpu_torch.parallel import sharding
    case = CASES[name]
    out = getattr(sharding, name)(*(t[k] for k in case.args), *case.pre_mesh, mesh,
                                  reduction=reduction, **case.kw)
    return _result(out, t, case.leaves)


def run_local(name, t, reduction):
    """The port's entry point on the inputs ``t``: (output, {leaf: gradient})."""
    import warp_transducer_tpu_torch as W
    case = CASES[name]
    out = getattr(W, case.local)(*(t[k] for k in case.args), *case.pre_mesh,
                                 reduction=reduction, **case.kw)
    return _result(out, t, case.leaves)


def _save(path, out, grads):
    np.savez(path, out=out.cpu().numpy(), **{f"d{k}": g.cpu().numpy() for k, g in grads.items()})


def _worker(rank, world_size, store, inputs, out_dir, device_type):
    from torch.distributed.tensor import Shard

    import warp_transducer_tpu_torch as W
    from warp_transducer_tpu_torch.parallel import sharding as S

    S.initialize_distributed(backend="gloo", init_method=f"file://{store}",
                             world_size=world_size, rank=rank,
                             timeout=datetime.timedelta(seconds=60))
    mesh = S.make_mesh(device_type)
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    with np.load(inputs) as f:
        flat = dict(f)
    arrays = {name: {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith(name + "/")}
              for name in CASES}
    b = B // world_size
    rows = slice(rank * b, (rank + 1) * b)
    for name in CASES:
        for reduction in REDUCTIONS:
            t = tensors(name, arrays[name], device, rows)
            _save(out_dir / f"{name}-{reduction}-{rank}.npz",
                  *run_wrapper(name, t, mesh, reduction))

    dense = arrays["data_parallel_rnnt_loss"]
    summary = {"placements": {}}
    calls = {r: dict(reduction=r) for r in REDUCTIONS}
    calls["options"] = dict(reduction="sum", options=W.RNNTOptions(reduction="none"))
    for tag, kw in calls.items():
        t = tensors("data_parallel_rnnt_loss", dense, device)
        out = S.auto_sharded_rnnt_loss(*(t[k] for k in ("acts", "labels", "il", "ll")), mesh, **kw)
        summary["placements"][tag] = ["shard0" if p == Shard(0) else "replicate"
                                      for p in out.placements]
        if tag == "mean":
            out.backward()  # through the DTensor itself
        else:
            out.to_local().sum().backward()
        _save(out_dir / f"auto-{tag}-{rank}.npz", out.to_local().detach(), {"acts": t["acts"].grad})

    # Local batches that differ: rank r holds 2 - r utterances.
    t = tensors("data_parallel_rnnt_loss", dense, device, slice(0, 2 - rank))
    try:
        S.data_parallel_rnnt_loss(*(t[k] for k in ("acts", "labels", "il", "ll")), mesh)
        summary["mismatch"] = None
    except ValueError as err:
        summary["mismatch"] = str(err)

    two_d = S.make_mesh(device_type, ("data", "model"))
    summary["meshes"] = [[list(m.mesh_dim_names), list(m.shape)] for m in (mesh, two_d)]
    summary["forbidden_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    (out_dir / f"summary-{rank}.json").write_text(json.dumps(summary))
    torch.distributed.destroy_process_group()


def save_problems(path):
    """Write ``problems()`` to one .npz as ``<case>/<input>``; return them."""
    probs = problems()
    np.savez(path, **{f"{name}/{k}": v
                      for name, arrays in probs.items() for k, v in arrays.items()})
    return probs


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--inputs", required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    a = parser.parse_args()
    torch.set_num_threads(1)
    _worker(a.rank, a.world_size, a.store, a.inputs, a.out, a.device)
