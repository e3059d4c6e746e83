"""The port's data-parallel wrappers (``warp_transducer_tpu_torch.parallel``)
on the card: NCCL at world size 1, where each wrapper must equal the
port's single-process call and add no host sync to the loss after its batch
check; and two gloo ranks sharing the one card (NCCL refuses two ranks on
one GPU), against the single-process call on the card.

Every test here needs a CUDA device; without one each skips (the fixtures
decide while the test runs, never at import). On a machine with an H100:
``python -m pytest tests/test_torch_cuda_parallel.py --noconftest``
(tests/conftest.py imports JAX). Imports no JAX.

Tolerances. World size 1: bit for bit, wherever two single-process calls
agree bit for bit; the fused gradient kernel adds de and dp with atomics,
and where two calls differ the wrapper is held at a relative norm error of
1e-5 (f32). Two ranks: the float64 losses rtol 1e-10 on costs and
gradients (atol 1e-12 on the gradients' entries that round to about zero),
the float32 fused losses rtol 1e-5 on costs and 1e-4 relative norm on every
gradient: each rank's kernels see half the batch, and the sums of the
replicated gradients add two partials in another order.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_parallel_cases import (CASES, F64_CASES, REDUCTIONS, problems, run_local, run_wrapper,
                                  save_problems, tensors)
from warp_transducer_tpu_torch.parallel import sharding as S

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_cases.py"
WORKER_TIMEOUT_S = 300
N_RANKS = 2
REPRO_REL = 1e-5
DENSE_ARGS = ("acts", "labels", "il", "ll")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _same(got, want, again, what):
    """Bit for bit where ``want`` and ``again`` (two single-process calls)
    are; else within REPRO_REL."""
    if torch.equal(want, again):
        assert torch.equal(got, want), what
    else:
        assert _rel(got.cpu(), want.cpu()) <= REPRO_REL, what


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """An NCCL group of this process alone on cuda:0, and ``make_mesh()``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and the kernels have no CPU mode)")
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    S.initialize_distributed(init_method=f"file://{store}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = S.make_mesh()
        assert mesh.device_type == "cuda" and mesh.shape == (1,)
        yield mesh
    finally:
        dist.destroy_process_group()


def _check_world_size_one(name, mesh, reduction, monkeypatch=None):
    arrays = problems()[name]
    want, want_g = run_local(name, tensors(name, arrays, "cuda"), reduction)
    again, again_g = run_local(name, tensors(name, arrays, "cuda"), reduction)
    t = tensors(name, arrays, "cuda")
    if monkeypatch is None:
        got, got_g = run_wrapper(name, t, mesh, reduction)
    else:  # the batch check once, then the call with no host sync allowed
        group = S._axis_group(mesh, S.DATA_AXIS, reduction, t[CASES[name].args[0]].shape[0],
                              t[CASES[name].args[0]].device)
        monkeypatch.setattr(S, "_axis_group", lambda *args: group)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, got_g = run_wrapper(name, t, mesh, reduction)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _same(got, want, again, f"{name} {reduction} output")
    for k in got_g:
        _same(got_g[k], want_g[k], again_g[k], f"{name} {reduction} d{k}")


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", CASES)
def test_nccl_world_size_one_equals_the_local_call(nccl_mesh, name, reduction):
    _check_world_size_one(name, nccl_mesh, reduction)


@pytest.mark.parametrize("name", CASES)
def test_no_host_sync_after_the_batch_check(nccl_mesh, name, monkeypatch):
    _check_world_size_one(name, nccl_mesh, "mean", monkeypatch)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_auto_sharded_nccl_world_size_one(nccl_mesh, reduction):
    t = tensors("data_parallel_rnnt_loss", problems()["data_parallel_rnnt_loss"], "cuda")
    args = [t[k] for k in DENSE_ARGS]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = S.auto_sharded_rnnt_loss(*args, nccl_mesh, reduction=reduction)
        (grad,) = torch.autograd.grad(out.to_local().sum(), args[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_g = run_local("data_parallel_rnnt_loss",
                             tensors("data_parallel_rnnt_loss",
                                     problems()["data_parallel_rnnt_loss"], "cuda"), reduction)
    assert torch.equal(out.to_local(), want) and torch.equal(grad, want_g["acts"])


@pytest.fixture(scope="module")
def two_ranks_on_the_card(tmp_path_factory):
    """Two gloo ranks, each on cuda:0 with half of each batch (the worker
    of tests/torch_parallel_cases.py); {(case, reduction, rank): npz}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from warp_transducer_tpu_torch.ops.cuda import build
    build.library()  # the workers load it
    tmp = tmp_path_factory.mktemp("gloo_cuda")
    save_problems(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for rank in range(N_RANKS):
        log = open(tmp / f"worker-{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), "--rank", str(rank), "--world-size", str(N_RANKS),
             "--store", str(tmp / "store"), "--inputs", str(tmp / "inputs.npz"), "--out",
             str(tmp), "--device", "cuda"], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
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
    for name in CASES:
        for reduction in REDUCTIONS:
            for rank in range(N_RANKS):
                with np.load(tmp / f"{name}-{reduction}-{rank}.npz") as f:
                    results[name, reduction, rank] = dict(f)
    summaries = [json.loads((tmp / f"summary-{rank}.json").read_text()) for rank in range(N_RANKS)]
    return results, summaries


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", CASES)
def test_two_gloo_ranks_on_the_card(two_ranks_on_the_card, name, reduction):
    results, _ = two_ranks_on_the_card
    case = CASES[name]
    want, want_g = run_local(name, tensors(name, problems()[name], "cuda"), reduction)
    want, want_g = want.cpu().numpy(), {k: g.cpu().numpy() for k, g in want_g.items()}
    ranks = [results[name, reduction, rank] for rank in range(N_RANKS)]
    f64 = name in F64_CASES
    outs = [r["out"] for r in ranks]
    got = np.concatenate(outs) if reduction == "none" else outs
    for out in ([got] if reduction == "none" else got):
        np.testing.assert_allclose(out, want, rtol=1e-10 if f64 else 1e-5, atol=0.0)
    for leaf in case.leaves:
        grads = ([r[f"d{leaf}"] for r in ranks] if leaf in case.replicated
                 else [np.concatenate([r[f"d{leaf}"] for r in ranks])])
        for g in grads:
            if f64:
                np.testing.assert_allclose(g, want_g[leaf], rtol=1e-10, atol=1e-12, err_msg=leaf)
            else:
                assert _rel(g, want_g[leaf]) <= 1e-4, (leaf, _rel(g, want_g[leaf]))


def test_two_gloo_ranks_on_the_card_meshes(two_ranks_on_the_card):
    for s in two_ranks_on_the_card[1]:
        assert s["meshes"] == [[["data"], [2]], [["data", "model"], [2, 1]]]
        assert s["mismatch"] is not None and "from 1 to 2 utterances" in s["mismatch"]
        assert s["forbidden_modules"] == []
