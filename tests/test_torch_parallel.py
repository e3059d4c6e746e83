"""``warp_transducer_tpu_torch.parallel`` on the CPU: the port's eight
data-parallel wrappers on two gloo ranks against the JAX package's wrappers
of the same names on a two-device mesh, and on one rank against the port's
own single-process entry points.

Two worker processes (``tests/torch_parallel_cases.py``, which imports
torch and the port only) meet at a FileStore in a temporary directory, take
their halves of each case's batch and write their outputs and gradients;
the JAX references are computed here meanwhile, with
``implementation="xla"``, on the same numpy inputs made from seeds. A
rendezvous that fails, or workers that take longer than WORKER_TIMEOUT_S,
fail the tests.

Tolerances: the float64 losses (dense, multi-blank, TDT) rtol 1e-10 on costs
and gradients, with atol 1e-12 for the gradients' entries that round to
about zero; the float32 fused losses rtol 1e-5 on costs and every gradient
(de, dp, dW, db, dWd, dbd) at a relative norm error of at most 1e-4: the
port's plain stages and XLA sum in other orders. At world size 1 every
wrapper's output and gradients equal the entry point's bit for bit.
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import warp_transducer_tpu_torch as W
from jax_programs import release_compiled_programs  # noqa: F401
from torch_parallel_cases import (CASES, F64_CASES, REDUCTIONS, B, problems, run_local,
                                  run_wrapper, save_problems, tensors)
from warp_transducer_tpu.parallel import sharding as JS
from warp_transducer_tpu.utils.options import RNNTOptions as JaxRNNTOptions
from warp_transducer_tpu_torch.parallel import sharding as S

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_cases.py"
WORKER_TIMEOUT_S = 120
N_RANKS = 2
F64 = dict(rtol=1e-10, atol=0.0)
F64_GRAD = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=0.0)
F32_GRAD_REL = 1e-4
DENSE_ARGS = ("acts", "labels", "il", "ll")


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close_grad(name, got, want, what):
    if name in F64_CASES:
        np.testing.assert_allclose(got, want, err_msg=what, **F64_GRAD)
    else:
        assert _rel(got, want) <= F32_GRAD_REL, (what, _rel(got, want))


def _jax_references(probs):
    """{case: {reduction: (output, {leaf: gradient})}} from the JAX
    wrappers on two devices. The 'sum' references are the 'mean' ones times
    the global batch of 4, exact in binary (a compile less per case); the
    'none' gradients are those of the sum."""
    mesh = JS.make_mesh(jax.devices()[:N_RANKS])
    refs = {}
    for name, case in CASES.items():
        ins = {k: jnp.asarray(v) for k, v in probs[name].items()}

        def loss(reduction, *leaves, name=name, case=case, ins=ins):
            xs = dict(ins, **dict(zip(case.leaves, leaves)))
            return getattr(JS, name)(*(xs[k] for k in case.args), *case.pre_mesh, mesh,
                                     reduction=reduction, implementation="xla", **case.kw)

        leaves = [ins[k] for k in case.leaves]
        costs = np.asarray(jax.jit(functools.partial(loss, "none"))(*leaves))
        mean, grads = jax.jit(jax.value_and_grad(functools.partial(loss, "mean"),
                                                 tuple(range(len(leaves)))))(*leaves)
        grads = {k: np.asarray(g) for k, g in zip(case.leaves, grads)}
        summed = {k: g * B for k, g in grads.items()}
        refs[name] = {"none": (costs, summed), "sum": (np.asarray(mean) * B, summed),
                      "mean": (np.asarray(mean), grads)}

    dense = {k: jnp.asarray(v) for k, v in probs["data_parallel_rnnt_loss"].items()}
    args = [dense[k] for k in DENSE_ARGS]
    auto = {r: dict(reduction=r, implementation="xla") for r in REDUCTIONS}
    auto["options"] = dict(reduction="sum", options=JaxRNNTOptions(reduction="none",
                                                                   implementation="xla"))
    refs["auto"] = {tag: np.asarray(JS.auto_sharded_rnnt_loss(*args, mesh, **kw))
                    for tag, kw in auto.items()}
    return refs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Start two gloo workers, compute the JAX references while they run,
    and return (probs, refs, {(case, reduction, rank): npz}, [summaries])."""
    tmp = tmp_path_factory.mktemp("parallel")
    probs = save_problems(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(N_RANKS):
        log = open(tmp / f"worker-{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), "--rank", str(rank), "--world-size", str(N_RANKS),
             "--store", str(tmp / "store"), "--inputs", str(tmp / "inputs.npz"), "--out",
             str(tmp)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        refs = _jax_references(probs)
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo workers took longer than {WORKER_TIMEOUT_S} s")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, (tmp / f"worker-{rank}.log").read_text()[-4000:]
    results = {}
    for name in list(CASES) + ["auto"]:
        for tag in REDUCTIONS + (("options",) if name == "auto" else ()):
            for rank in range(N_RANKS):
                with np.load(tmp / f"{name}-{tag}-{rank}.npz") as f:
                    results[name, tag, rank] = dict(f)
    summaries = [json.loads((tmp / f"summary-{rank}.json").read_text()) for rank in range(N_RANKS)]
    return probs, refs, results, summaries


def _ranks(results, name, tag):
    return [results[name, tag, rank] for rank in range(N_RANKS)]


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", CASES)
def test_costs_match_the_jax_wrapper(two_ranks, name, reduction):
    _, refs, results, _ = two_ranks
    want = refs[name][reduction][0]
    outs = [r["out"] for r in _ranks(results, name, reduction)]
    tol = F64 if name in F64_CASES else F32
    if reduction == "none":  # each rank its shard's costs
        np.testing.assert_allclose(np.concatenate(outs), want, **tol)
    else:  # the same total on every rank
        for out in outs:
            np.testing.assert_allclose(out, want, **tol)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", CASES)
def test_gradients_match_the_jax_wrapper(two_ranks, name, reduction):
    """Sharded inputs: the ranks' rows together are the JAX gradient.
    Replicated inputs: every rank holds the whole of it, so a gradient off
    by any factor of the world size fails."""
    _, refs, results, _ = two_ranks
    case, want = CASES[name], refs[name][reduction][1]
    ranks = _ranks(results, name, reduction)
    for leaf in case.leaves:
        if leaf in case.replicated:
            for rank, r in enumerate(ranks):
                _close_grad(name, r[f"d{leaf}"], want[leaf], f"d{leaf} on rank {rank}")
        else:
            _close_grad(name, np.concatenate([r[f"d{leaf}"] for r in ranks]), want[leaf],
                        f"d{leaf}")


@pytest.mark.parametrize("tag", REDUCTIONS + ("options",))
def test_auto_sharded_matches_the_jax_one(two_ranks, tag):
    """Costs and their pinned placement: Shard(0) for 'none' (also when
    options.reduction overrides the keyword 'sum'), Replicate() else."""
    _, refs, results, summaries = two_ranks
    outs = [r["out"] for r in _ranks(results, "auto", tag)]
    sharded = tag in ("none", "options")
    if sharded:
        np.testing.assert_allclose(np.concatenate(outs), refs["auto"][tag], **F64)
    else:
        for out in outs:
            np.testing.assert_allclose(out, refs["auto"][tag], **F64)
    for s in summaries:
        assert s["placements"][tag] == ["shard0" if sharded else "replicate"]


def test_auto_sharded_gradient_reaches_own_rows_only(two_ranks):
    """Each rank's gradient of the 'mean' is the JAX one (that of the dense
    wrapper on the same inputs, the single-device gradient) at its own rows
    and zero at the others."""
    _, refs, results, _ = two_ranks
    want = refs["data_parallel_rnnt_loss"]["mean"][1]["acts"]
    b = len(want) // N_RANKS
    got = _ranks(results, "auto", "mean")
    for rank, r in enumerate(got):
        rows = np.zeros(len(want), bool)
        rows[rank * b:(rank + 1) * b] = True
        assert not r["dacts"][~rows].any()
    np.testing.assert_allclose(sum(r["dacts"] for r in got), want, **F64_GRAD)


def test_local_batches_that_differ_raise_on_every_rank(two_ranks):
    for rank, s in enumerate(two_ranks[3]):
        assert s["mismatch"] is not None, f"rank {rank} did not raise"
        assert "from 1 to 2 utterances" in s["mismatch"] and "axis 'data'" in s["mismatch"]


def test_make_mesh_names_and_shapes(two_ranks):
    for s in two_ranks[3]:
        assert s["meshes"] == [[["data"], [2]], [["data", "model"], [2, 1]]]


def test_workers_import_no_jax(two_ranks):
    for s in two_ranks[3]:
        assert s["forbidden_modules"] == []


@pytest.fixture(scope="module")
def mesh_one(tmp_path_factory):
    """A gloo group of this process alone, and its 1-D CPU mesh."""
    store = tmp_path_factory.mktemp("parallel_one") / "store"
    S.initialize_distributed(init_method=f"file://{store}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "gloo"
        yield S.make_mesh("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", CASES)
def test_world_size_one_equals_the_local_call(mesh_one, name, reduction):
    arrays = problems()[name]
    out, grads = run_wrapper(name, tensors(name, arrays, "cpu"), mesh_one, reduction)
    want, want_grads = run_local(name, tensors(name, arrays, "cpu"), reduction)
    assert torch.equal(out, want)
    for k in grads:
        assert torch.equal(grads[k], want_grads[k]), k


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_auto_sharded_world_size_one(mesh_one, reduction):
    arrays = problems()["data_parallel_rnnt_loss"]
    t = tensors("data_parallel_rnnt_loss", arrays, "cpu")
    out = S.auto_sharded_rnnt_loss(*(t[k] for k in DENSE_ARGS), mesh_one, reduction=reduction)
    assert out.placements == ((Shard(0),) if reduction == "none" else (Replicate(),))
    want = W.rnnt_loss(*(t[k] for k in DENSE_ARGS), reduction=reduction)
    assert torch.equal(out.to_local(), want)


@pytest.mark.parametrize("name", list(CASES) + ["auto_sharded_rnnt_loss"])
def test_bad_reduction_raises(mesh_one, name):
    inputs_of = name if name in CASES else "data_parallel_rnnt_loss"
    case = CASES[inputs_of]
    t = tensors(inputs_of, problems()[inputs_of], "cpu")
    with pytest.raises(ValueError, match=r"reduction must be none\|sum\|mean"):
        getattr(S, name)(*(t[k] for k in case.args), *case.pre_mesh, mesh_one,
                         reduction="avg", **case.kw)


def test_make_mesh_world_size_one(mesh_one):
    assert mesh_one.mesh_dim_names == ("data",) and mesh_one.shape == (1,)
    assert S.DATA_AXIS == JS.DATA_AXIS
    two_d = S.make_mesh("cpu", ("data", "model"))
    assert two_d.mesh_dim_names == ("data", "model") and two_d.shape == (1, 1)
