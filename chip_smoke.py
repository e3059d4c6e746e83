#!/usr/bin/env python3
"""Smoke run of warp_transducer_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of warp_transducer_tpu_torch/csrc from this
checkout, holds each kernel against its plain PyTorch version on the card,
drives the main paths with every launch counter read — the dense loss
(``rnnt_loss(...).backward()`` and ``rnnt_loss_and_grad``) at the
reference's published shapes, its gradient in the lattice mode of
csrc/grad.cu with ``gradients.coefficients`` shown not to run, the same step
timed and profiled without that fold (the coefficient passes, then the
fields mode) beside it, the pruned step (``rnnt_loss_simple``
with ``prune_range`` → ``gather_banded`` → ``rnnt_loss_pruned``, backward
through both) at the JAX package's two published pruned shapes, the fused
joint+loss step (``Joint.fused_loss`` forward and backward, weights loaded
through ``joint_state_dict_from_flax``) at the JAX package's published
fused shape with f32 and with bf16 activations and W (bf16 is the config's
default), held against the plain path and, in f32, the unfused composition,
with the device time of each of the gradient's launches, the registers of
each fused kernel and a check that two calls give bit-equal dW and db, and
the pruned fused
step (``rnnt_loss_simple`` → ``Joint.pruned_fused_loss``) at the shape whose
band would not fit, and the two duration-arc steps
(``rnnt_loss_multiblank`` with big blanks of 2 and 4 frames,
``rnnt_loss_tdt`` with durations 0, 1, 2, 4, forward and backward) at the
JAX package's two published shapes for them, and the same two losses fused
into the joint (``Joint.multiblank_fused_loss``, ``Joint.tdt_fused_loss`` on
both of its routes) at the fused shape, held against their unfused
compositions, and the training surface: the eight train steps of
``models/transducer.py`` on the whole model at ``TransducerConfig()``'s
widths (B=64 T=150 L=20; vocabulary 128, or 5000 for the fused and pruned
steps), each held against its plain twin and run ten Adam steps, and the
``warprnnt_pytorch`` binding on CUDA tensors, and the inference side: the
five decoders of ``models/decoding.py`` on the same model (bf16, and f32
with TF32 off) with no host sync, their best hypotheses rescored through
the Viterbi alignments and the losses' kernels, and the three alignments of
``ops/alignment.py`` at the duration-arc shapes against their plain route
and their own paths, and the data-parallel wrappers of ``parallel/sharding.py``:
all eight on an NCCL group of this process alone at the shapes above, bit-equal
to the local calls (where those are reproducible) and timed beside them, with
the batch check's and the all_reduces' own cost, and two gloo ranks sharing
the card (two processes of this script, ``--parallel-worker``) at the
headline and the fused bf16 shape against the single-process call, and the char_long path
(B=32 T=1000 L=600 V=29, a character-level transducer on 40 s utterances: U = 601, every
lattice on the stripe kernel, two CTAs of a cluster): the stripe kernel against its plain
version (also f64 past U = 352, and U = 5000, past one cluster's reach), the dense loss,
the binding's RNNTLoss on log-probs, rnnt_score and the pruned step through it, each
against its plain route, and the window walk at the shapes of its earlier block kernel (both
duration-arc losses at B=128 T=1000 U=601 and in f64 at B=4 T=300, TDT (1, 2, 4) at B=32, the
lattice at U = 30,000 in passes), each against its plain version — checks that a full band
equals the dense loss, times each path and each kernel with CUDA events,
reads the peak memory of the fused and the unfused steps and of each train
step, and prints:

  card line, build line, one line per comparison, per shape, per timing;
  the card's name and power limit as nvidia-smi gives them;
  {"kernels": [...]} — one entry per kernel (thirteen; grad.cu's two modes
  apart, and wavefront.cu's two kernels);
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}} last.

Every check raises, so any failure ends the run with a non-zero exit and
without the last line. Without a visible CUDA device it exits at once.
Imports no JAX.
"""
from __future__ import annotations

import contextlib
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# The published H100 SXM rates (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 inputs in the tensor cores, dense
# The fused joint's products with f32 W: the least the card can do for them
# at f32 accuracy is three TF32 products on the tensor cores (495 TFLOP/s
# dense), so a third of that rate.
TF32X3_OPS_PER_S = 495e12 / 3
# The same card's issue rates at its 1.98 GHz boost clock on 132 SMs: the
# FP32 pipe retires 128 lane-instructions a clock per SM (67 TFLOP/s counts
# an FMA as two), the MUFU 16 results (ex2, rcp, ...).
FP32_INSTR_PER_S = 128 * 132 * 1.98e9
MUFU_PER_S = 16 * 132 * 1.98e9
# What one tanhf compiles to for sm_90a (scripts/sass_count.sh, the probe
# y = tanhf(x)): both of its branches, selected, so every tanh costs 2 MUFU
# results (EX2, RCP) and 9 FP32-pipe instructions (FFMA, FMUL, FADD), beside
# 4 on the ALU pipe (FSETP, FSEL, LOP3; at 64 a clock per SM never the
# binding term).
TANH_MUFU = 2
TANH_FP32 = 9

# The reference's published benchmark shapes (BASELINE.md; U = L + 1).
SHAPES = [("headline", 128, 150, 40, 28), ("large_v", 32, 150, 20, 5000),
          ("long_t", 16, 1500, 300, 50)]

# Tolerances of kernel against plain version, |a - b| <= atol + rtol·|b|.
# f32 (and bf16 inputs, which compute in f32): the prep kernel's online
# (max, sum-exp) and the plain two-pass logsumexp round differently, ~1e-7
# relative; the lattice repeats the same log-sum-exp over T+U-1 diagonals.
# f64: rounding only. bf16 gradient output: one bf16 ulp (2^-8 relative),
# both versions round one f32 value once.
TOL = {"f32": (1e-5, 1e-5), "f64": (1e-10, 1e-10), "bf16_out": (2 ** -8, 1e-6)}
# A gradient's entries span decades (coef·softmax is ~1e-5 at V=5000), so a
# fixed atol could be as large as a typical entry and let a kernel that is
# wrong across the small ones pass. Its atol is this share of the median
# nonzero |g| of the plain version; its rtol stays that of the dtype above.
GRAD_ATOL_SHARE = 1e-3

# small_test of the reference (tests/test_cpu.cpp:12-71): loss 4.495666.
SMALL_ACTS = [[[[0.1, 0.6, 0.1, 0.1, 0.1], [0.1, 0.1, 0.6, 0.1, 0.1],
                [0.1, 0.1, 0.2, 0.8, 0.1]],
               [[0.1, 0.6, 0.1, 0.1, 0.1], [0.1, 0.1, 0.2, 0.1, 0.1],
                [0.7, 0.1, 0.2, 0.1, 0.1]]]]
SMALL_COST = 4.495666


def fail_unless(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def grad_tol(want, tol_key, share=GRAD_ATOL_SHARE):
    """(rtol, atol) for a gradient: atol is ``share`` of the median nonzero
    |g| of ``want``, taken over at most ~1e7 evenly strided entries."""
    nz = want.abs()[want != 0].float()
    if not nz.numel():
        return TOL[tol_key][0], 0.0
    return TOL[tol_key][0], share * float(nz[::max(1, nz.numel() // 10 ** 7)].median())


def compare(name, got, want, tol):
    """Hold a kernel's output against the plain version's; return max abs err.
    ``tol`` is a key of TOL or an (rtol, atol) pair."""
    rtol, atol = TOL[tol] if isinstance(tol, str) else tol
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / want.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.abs()).all()) and bool(torch.isfinite(got).all())
    print(f"compare {name}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
          f"(tol rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAILED'}")
    fail_unless(ok, f"{name}: kernel disagrees with its plain version")
    return max_abs


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Kernel names of csrc/*.cu as the profiler shows them.
PORT_KERNELS = ("prep_tile_kernel", "prep_warp_kernel", "wavefront_band_kernel",
                "wavefront_stripe_kernel",
                "grad_lattice_tile_kernel", "grad_lattice_warp_kernel", "grad_fields_tile_kernel",
                "grad_fields_warp_kernel",
                "band_prep_tile_kernel", "band_prep_warp_kernel", "band_row_kernel",
                "band_cells_kernel", "band_grad_tile_kernel", "band_grad_warp_kernel",
                "ranges_kernel", "joint_w_kernel", "joint_h_kernel", "joint_prep_kernel",
                "joint_grad_g_kernel", "joint_grad_dh_kernel", "joint_grad_d_kernel",
                "joint_grad_dw_kernel", "joint_grad_db_kernel", "joint_grad_dwd_kernel",
                "sum_parts_kernel", "dur_prep_kernel", "dur_grad_kernel", "dur_sums_kernel",
                "window_warp_kernel", "window_table_kernel", "prep_many_tile_kernel",
                "prep_many_warp_kernel", "grad_many_tile_kernel", "grad_many_warp_kernel")


# The fused joint's kernels by wrapper: K6a (the layout of W, h, the prep)
# and K6b's engine kernels (the row launch: h, g, dh; the column launch: dW).
JOINT_PREP_KERNELS = ("joint_w_kernel", "joint_h_kernel", "joint_prep_kernel")
JOINT_GRAD_KERNELS = ("joint_grad_g_kernel", "joint_grad_dh_kernel", "joint_grad_dw_kernel")


def device_breakdown(tag, fn, event_ms, iters=5, top=6):
    """Device time by kernel over a few calls (torch.profiler), the share of
    it in the port's own kernels, the device kernels a call launches, and the
    device's idle share: 1 - busy / ``event_ms``, the CUDA-event time of one
    call taken without the profiler (whose own cost inflates wall). Returns
    (busy ms, idle share, kernels a call, the port's kernels' ms), or None
    where the profiler recorded no device time."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        started = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3 / iters
    # Kernel rows only: an aten op's row repeats the time of the kernels
    # it launched, and so does a user annotation's on the device (the
    # optimiser's "Optimizer.step#Adam.step" range).
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    rows = sorted(((e.self_device_time_total / 1e3 / iters, e.key) for e in device), reverse=True)
    if not rows:
        print(f"profile {tag}: the profiler recorded no device time (not measured)")
        return None
    busy = sum(r[0] for r in rows)
    idle = max(0.0, 1 - busy / event_ms)
    n_kernels = sum(e.count for e in device) / iters
    print(f"profile {tag}: device busy {busy:.4f} ms/call of {event_ms:.4f} ms "
          f"(idle share {idle:.3f}); {n_kernels:g} device kernels a call; wall under the "
          f"profiler {wall_ms:.4f} ms/call")
    # A kernel's own name: the first identifier that a '<' or '(' follows
    # ("void (anonymous namespace)::prep_tile_kernel<float, float, 4>(…").
    port = sum(ms for ms, key in rows
               if (m := re.search(r"(\w+)[<(]", key)) and m.group(1) in PORT_KERNELS)
    print(f"profile {tag}: the port's kernels {port:.4f} ms/call, other kernels "
          f"{busy - port:.4f} ms/call in {len(rows)} kinds")
    for ms, key in rows[:top]:
        print(f"profile {tag}:   {ms:.4f} ms  {key[:90]}")
    return busy, idle, n_kernels, port


def kernel_ms(fn, iters=3):
    """Device time one call of ``fn`` spends in each of the port's kernels,
    {kernel name: ms}, from torch.profiler; {} where it records none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+)[<(]", e.key)
            if m and m.group(1) in PORT_KERNELS:
                out[m.group(1)] = out.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def launch_device_ms(fn, iters=10, names=None):
    """Device time of one launch of the port's kernels that ``fn`` makes
    (for a call that launches one), from torch.profiler: their time over
    their count, so that a record the profiler drops does not read as a
    shorter call; None where it records none. ``names``: the kernel names
    to count, PORT_KERNELS by default."""
    names = PORT_KERNELS if names is None else names
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ours = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and (m := re.search(r"(\w+)[<(]", e.key)) and m.group(1) in names]
    n = sum(e.count for e in ours)
    return sum(e.self_device_time_total for e in ours) / n / 1e3 if n else None


def device_ms(fn, iters=5):
    """Device time of one call of ``fn``, all its kernels summed, from
    torch.profiler (CUDA events time the host's launches as well where they
    take longer than the kernels); None where the profiler records none."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / iters if total > 0 else None


def graph_ms(fn, n=100):
    """Time of one call of ``fn`` on the device without the host's launch
    work: ``n`` calls captured in one CUDA graph, replayed under CUDA
    events. For calls whose kernels the profiler does not record."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, 5, 1) / n
    del graph
    return ms


def bound(bytes_moved, ops, ops_rate):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def wavefront_bound(lpb, il, ll):
    """bound() of one forward_backward call: lpb and lpe read at the valid
    cells, alphas and betas written at every cell, ll_forward, ll_backward
    written; about eight operations a valid cell and direction (two adds,
    the clamps, the log-sum-exp's max, subtract, exp, log1p and add)."""
    B, T, U = lpb.shape
    valid_cells = int((il.long().clamp(0, T) * (ll.long() + 1).clamp(0, U)).sum())
    elt = lpb.element_size()
    return bound((2 * valid_cells + 2 * B * T * U) * elt + 2 * B * elt + 2 * B * 4,
                 2 * 8 * valid_cells, F32_OPS_PER_S)


def sm_clock_mhz():
    """The card's maximum SM clock as nvidia-smi reports it, MHz, or None."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def wavefront_step_instructions(library, kernel="wavefront_band_kernel"):
    """{element bytes: SASS instructions of one diagonal step of the lattice
    kernel ``kernel`` (the band kernel, or the stripe kernel)}, read with
    cuobjdump from the built library: the
    innermost loop around the alpha walk's SHFL.UP and the beta walk's
    SHFL.DOWN over the shuffles in it (the steps the compiler unrolled into
    it; as scripts/sass_count.sh prints them), the larger of the two. A warp
    issues at most one instruction a clock, so that count is a step's cycles
    at the least. {} where cuobjdump is missing."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return {}
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True).stdout
    out, elt, shfl, loops = {}, None, {}, []

    def close():
        if elt and shfl:
            per_step = []
            for k in ("UP", "DOWN"):  # the innermost loop around a shuffle of this kind,
                inner = [(b - a, a, b) for a, b in loops for x in shfl.get(k, []) if a <= x <= b]
                if inner:  # over the steps the compiler unrolled into it
                    _, a, b = min(inner)
                    per_step.append(((b - a) // 16 + 1) / sum(a <= x <= b for x in shfl[k]))
            if per_step:
                out[elt] = max(per_step)

    for line in sass.splitlines():
        if "Function :" in line:
            close()
            m = re.search(kernel + r"I([fd])i?E", line)  # the band kernel's int offsets
            elt, shfl, loops = (4 if m.group(1) == "f" else 8) if m else None, {}, []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not (elt and m):
            continue
        addr, ins = int(m.group(1), 16), m.group(2)
        if k := re.search(r"SHFL\.(UP|DOWN)", ins):
            shfl.setdefault(k.group(1), []).append(addr)
        if (b := re.search(r"\bBRA (?:\S+, )?0x([0-9a-f]+)", ins)) and int(b.group(1), 16) < addr:
            loops.append((int(b.group(1), 16), addr))
    close()
    return out


@functools.lru_cache(maxsize=4)
def library_sass(library):
    """cuobjdump -sass of the built library, once a run (the phases read
    it several times); None where cuobjdump is missing."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        return None
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True).stdout


def sass_loops(library, function, key, marks=r"SHFL\.(UP|DOWN|IDX)"):
    """{key: (marked instructions {kind: [addresses]}, loops [(start, end)])}
    of the kernel instances in the built library whose names match the regex
    ``function`` (``key`` maps its match to the key), read with cuobjdump: a
    loop ends in a conditional backward branch (the out-of-line paths of a
    shuffle in a diverged warp jump back unconditionally). ``marks`` is the
    regex of the instructions to mark, its group the kind (the shuffles by
    default). {} where cuobjdump is missing."""
    sass = library_sass(str(library))
    if sass is None:
        return {}
    out = {}
    for block in sass.split("Function :")[1:]:  # only the matching functions' lines are read
        name, _, body = block.partition("\n")
        m = re.search(function, name)
        k = key(m) if m else None
        if k is None:
            continue
        out[k] = ({}, [])
        for line in body.splitlines():
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr, ins = int(m.group(1), 16), m.group(2)
            if kind := re.search(marks, ins):
                out[k][0].setdefault(kind.group(1), []).append(addr)
            if ((b := re.match(r"@!?U?P\w+\s+BRA (?:\S+, )?0x([0-9a-f]+)", ins))
                    and int(b.group(1), 16) < addr):
                out[k][1].append((int(b.group(1), 16), addr))
    return out


def _row_steps(shfl, loops):
    """(alpha, beta) SASS instructions of a walk's row steps: the innermost
    loop around an alpha row's SHFL.UP that holds no SHFL.DOWN, and around a
    beta row's SHFL.DOWN; None where there is none."""
    steps = []
    for mine, other in (("UP", "DOWN"), ("DOWN", None)):
        inner = [b - a for a, b in loops
                 if any(a <= x <= b for x in shfl.get(mine, []))
                 and not (other and any(a <= x <= b for x in shfl.get(other, [])))]
        steps.append(min(inner) // 16 + 1 if inner else None)
    return tuple(steps)


def window_step_instructions(library):
    """{(element bytes, cells a lane, wide): (alpha, beta) SASS instructions
    of one row step of the window kernel's instance}, as
    scripts/sass_count.sh prints them (_row_steps; an earlier checkout's
    kernel, without the wide instance, keys wide False). Static counts: the
    loops over arcs and copies inside a row step count once, so a row with
    several arcs issues more. A warp issues at most one instruction a
    clock."""
    out = {}
    for k, (shfl, loops) in sass_loops(
            library, r"window_warp_kernelI([fd])Li(\d+)E(?:Lb([01])E)?",
            lambda m: ((4 if m.group(1) == "f" else 8), int(m.group(2)),
                       m.group(3) == "1")).items():
        if shfl:
            out[k] = _row_steps(shfl, loops)
    return out


def band_step_instructions(library):
    """{ceil(log2 S): SASS instructions of the row walk's two row steps}:
    the innermost loops around a SHFL.IDX (the shuffles by δ), alpha's and
    beta's, in the order of their code; and {("cells", C, 64-bit offsets):
    (alpha, beta)} of the cells walk's instances (_row_steps). Static
    counts; a warp issues at most one instruction a clock."""
    out = {}
    for k, (shfl, loops) in sass_loops(library, r"band_row_kernelILi(\d+)E",
                                       lambda m: int(m.group(1))).items():
        rows = [(a, b) for a, b in loops if any(a <= x <= b for x in shfl.get("IDX", []))]
        inner = sorted((a, b) for a, b in rows
                       if not any((c, d) != (a, b) and a <= c and d <= b for c, d in rows))
        out[k] = tuple((b - a) // 16 + 1 for a, b in inner)
    for k, (shfl, loops) in sass_loops(library, r"band_cells_kernelILi(\d+)E([ix])E",
                                       lambda m: ("cells", int(m.group(1)),
                                                  m.group(2) == "x")).items():
        if shfl:
            out[k] = _row_steps(shfl, loops)
    return out


def band_chain_floor(steps, S, il, clock_mhz, plan=None):
    """T_max rows × the SASS instructions of the longer row step of the
    walk's instance for a band of S (``plan``: the cells walk's, a step a
    row and chunk) ÷ the SM clock, ms, and that count; (None, None) where
    either is unknown (no cuobjdump, an earlier checkout's kernel)."""
    if plan is not None and not plan.row_mode:
        step = steps.get(("cells", getattr(plan, "cells", 0), getattr(plan, "offsets64", False)))
        rows = int(il.max()) * getattr(plan, "chunks", 1)
    else:
        step = steps.get(max(0, (S - 1).bit_length())) if S <= 32 else None
        rows = int(il.max())
    if not (step and all(step) and clock_mhz):
        return None, None
    n = max(step)
    return rows * n / (clock_mhz * 1e3), n


def window_bound(lpb, extra, arcs, il, ll, betas=True):
    """bound() of one window forward_backward call: the 2 + C channels read
    at the valid cells, alphas (and betas) written at every cell, the lls
    and lengths; the operations of each valid cell and direction
    (window_cell_ops)."""
    B, T, U = lpb.shape
    C = extra.shape[-1]
    dirs = 2 if betas else 1
    valid_cells = int((il.long().clamp(0, T) * (ll.long() + 1).clamp(0, U)).sum())
    elt = lpb.element_size()
    return bound(((2 + C) * valid_cells + dirs * B * T * U + dirs * B) * elt + 2 * B * 4,
                 dirs * window_cell_ops(arcs, U) * valid_cells, F32_OPS_PER_S)


def window_chain_floor(steps, elt, plan, il, clock_mhz):
    """T_max rows × the passes × the SASS instructions of the longer row
    step (alpha or beta) of the kernel instance that ``plan`` runs ÷ the SM
    clock, ms, and that count; (None, None) where either is unknown (no
    cuobjdump)."""
    step = steps.get((elt, plan.cells, plan.wide))
    if not (step and all(step) and clock_mhz):
        return None, None
    n = max(step)
    return int(il.max()) * plan.passes * n / (clock_mhz * 1e3), n


def tanh_bound(bytes_moved, n_tanh, fp32_per_tanh):
    """(ms, "bytes" or "operations", the term that binds) of a function that
    takes ``n_tanh`` tanhf, each with ``fp32_per_tanh`` FP32-pipe
    instructions of its own arithmetic beside the tanh's: bytes over the
    memory rate, the tanh's MUFU results over the MUFU rate, and the
    FP32-pipe instructions over that pipe's rate, the largest."""
    terms = {"bytes": bytes_moved / HBM_BYTES_PER_S,
             "mufu": n_tanh * TANH_MUFU / MUFU_PER_S,
             "fp32": n_tanh * (TANH_FP32 + fp32_per_tanh) / FP32_INSTR_PER_S}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def kernels_alone_ms(fn, names, iters=10):
    """Device ms a call of ``fn`` spends in the named kernels of the port:
    their profiler time over the launches of the first, which ``fn``
    launches once (so a dropped record does not read as a shorter call);
    None where the profiler records one of them nowhere."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rec = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+)[<(]", e.key)
            if m and m.group(1) in names:
                ms, n = rec.get(m.group(1), (0.0, 0))
                rec[m.group(1)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if any(n not in rec for n in names):
        return None
    return sum(ms for ms, _ in rec.values()) / rec[names[0]][1]


def make_problem(B, T, L, V, seed, dev, dtype=torch.float32):
    """Random acts and ragged lengths from a seed, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = L + 1
    acts = torch.randn((B, T, U, V), generator=g, device=dev, dtype=torch.float32).to(dtype)
    labels = torch.randint(1, V, (B, L), generator=g, device=dev, dtype=torch.int32)
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L  # the longest utterance spans the whole lattice
    return acts, labels, il, ll


def ranges_step_instructions(library):
    """{(element bytes, lanes a row): (forward clamp, backward raise, forward
    fix) SASS instructions a step} of the range kernel's three scans: the
    innermost loops around a 16-byte shared-memory store (STS.128, four
    steps each), in the order of their code. Static counts; one thread walks
    them, a warp issuing at most one instruction a clock."""
    out = {}
    for k, (sts, loops) in sass_loops(library, r"ranges_kernelI([fd])Li(\d+)E",
                                      lambda m: (4 if m.group(1) == "f" else 8, int(m.group(2))),
                                      marks=r"(STS)\.128").items():
        rows = [(a, b, sum(a <= x <= b for x in sts.get("STS", []))) for a, b in loops]
        rows = [(a, b, n) for a, b, n in rows if n]
        inner = sorted((a, b, n) for a, b, n in rows
                       if not any((c, d) != (a, b) and a <= c and d <= b for c, d, _ in rows))
        out[k] = tuple(((b - a) // 16 + 1) / (4 * n) for a, b, n in inner)
    return out


def ranges_chain_floor(steps, il, T, U, elt, clock_mhz):
    """T_max frames × the SASS instructions a step of the three scans, for
    the range kernel instance of this element size and U (its lanes a row),
    ÷ the SM clock, ms, and the instructions a frame; (None, None) where
    either is unknown."""
    from warp_transducer_tpu_torch.ops.cuda import ranges as kranges
    scan = steps.get((elt, kranges.plan(T, U).group))
    if not (scan and len(scan) == 3 and clock_mhz):
        return None, None
    n = sum(scan)
    return min(int(il.max()), T) * n / (clock_mhz * 1e3), n


def ranges_bound(il, T, U, elt):
    """bound() of one ranges_from_posteriors call on this run's lengths: α
    and β read once at the frames whose peak counts (0 .. T_b−2 of each
    utterance; none where T_b <= 0, all T where T_b > T), ll and the
    lengths read and the (B, T) starts written; three operations an element
    (two adds and a compare)."""
    tb = il.long()
    frames = int(torch.where(tb > T, T, (tb - 1).clamp_min(0)).sum())
    B = il.numel()
    return bound(2 * frames * U * elt + B * (elt + 8) + B * T * 4, 3 * frames * U, F32_OPS_PER_S)


# The JAX package's two published pruned shapes (README.md:233 and :258;
# B, T, L, V, S): the long-utterance configuration and the large-vocabulary
# one. Full size, f32, the additive joiner on the band.
PRUNED_SHAPES = [("pruned_long", 128, 1500, 300, 50, 5),
                 ("pruned_large_v", 128, 150, 20, 5000, 5)]
PRUNED_KERNELS = ("band_prep", "band_stream", "band_grad", "ranges")


def band_cell_ops(S):
    """Operations of one band cell in one direction of the lattice kernel:
    ceil(log2 S) adds of the prefix sum, ceil(log2 S) log-sum-exps of about
    six operations each (max, subtract, abs, exp, log1p, add), and four
    more (the clamp, ne - c, c + z and + lpb)."""
    steps = max(1, (S - 1).bit_length())
    return steps * 7 + 4


def band_lattice_bound(ranges, il, ll, S):
    """bound() of one band forward_backward call on this run's data: lpb
    and lpe read at the valid band cells, alphas and betas written in full,
    ranges read and the lengths and both log-likelihoods; the cell
    operations of both directions at the valid cells."""
    from warp_transducer_tpu_torch.ops import band
    B, T = ranges.shape
    n_valid = int(band.band_valid(ranges, il, ll, S).sum())
    return bound((2 * n_valid + 2 * B * T * S) * 4 + B * T * 4 + 4 * B * 4,
                 2 * band_cell_ops(S) * n_valid, F32_OPS_PER_S)


def make_pruned_problem(B, T, L, V, seed, dev):
    """Random am (B, T, V) and lm (B, U, V) of the additive joiner and
    ragged lengths from a seed, made on the card (as make_problem)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = L + 1
    am = torch.randn((B, T, V), generator=g, device=dev)
    lm = torch.randn((B, U, V), generator=g, device=dev)
    labels = torch.randint(1, V, (B, L), generator=g, device=dev, dtype=torch.int32)
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return am, lm, labels, il, ll


def pruned_step(am, lm, labels, il, ll, S, implementation="auto", band=None):
    """One pruned training step through the public entry points: the simple
    loss and its band starts, the additive joiner on the band, the pruned
    loss, and the backward through both into am.grad and lm.grad (am, lm:
    leaves that require grad). ``band``: band starts to prune with in place
    of the simple loss's own (which are returned all the same)."""
    from warp_transducer_tpu_torch import gather_banded, rnnt_loss_pruned, rnnt_loss_simple
    am.grad = lm.grad = None
    loss_s, ranges = rnnt_loss_simple(am, lm, labels, il, ll, reduction="sum",
                                      implementation=implementation, prune_range=S)
    starts = ranges if band is None else band
    band_acts = am[:, :, None, :] + gather_banded(lm, starts, S)
    loss_p = rnnt_loss_pruned(band_acts, starts, labels, il, ll, reduction="sum",
                              implementation=implementation)
    (loss_s + loss_p).backward()
    return loss_s.detach(), loss_p.detach(), ranges


def band_inputs(am, lm, labels, il, ll, S):
    """What the pruned step hands its kernels: the simple lattice (its
    alphas, betas and ll_forward), the band starts from its posteriors, the
    band, its per-row labels, and the band prep, lattice and coefficient
    fields (kernels, unit cotangent)."""
    from warp_transducer_tpu_torch import gather_banded
    from warp_transducer_tpu_torch.ops import band, prep, pruned, simple
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    with torch.no_grad():
        f = simple._factorised_lattice_inputs(am, lm, prep.label_rows(labels, lm.shape[1]), 0,
                                              "highest")
        simple_lat = kwave.forward_backward(f.lpb, f.lpe, il, ll)
        del f
        ranges = pruned.ranges_from_posteriors(simple_lat.alphas, simple_lat.betas,
                                               simple_lat.ll_forward, il, ll, S)
        band_acts = am[:, :, None, :] + gather_banded(lm, ranges, S)
        lab_band, has_lab = band.band_labels(labels, ranges, S)
        lab_row = band.label_rows(lab_band, has_lab)
        p = kband.band_prep(band_acts, lab_row, 0)
        lat = kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)
        fields = band.band_coefs(p.lpb, p.lpe, lat, ranges, has_lab, il, ll,
                                 torch.ones(am.shape[0], device=am.device), 0.0)
    return dict(simple_lat=simple_lat, ranges=ranges, band=band_acts, has_lab=has_lab,
                lab_row=lab_row, prep=p, lat=lat, fields=fields)


def pruned_kernels_vs_plain(dev, errs):
    """Each kernel of the pruned path against its plain version on the same
    inputs, at both pruned shapes; a bf16 band for the prep and gradient
    kernels; an infeasible band."""
    from warp_transducer_tpu_torch import rnnt_loss_pruned
    from warp_transducer_tpu_torch.ops import band
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import ranges as kranges

    for tag, B, T, L, V, S in PRUNED_SHAPES:
        am, lm, labels, il, ll = make_pruned_problem(B, T, L, V, seed=3, dev=dev)
        x = band_inputs(am, lm, labels, il, ll, S)
        lat = x["simple_lat"][:3]  # alphas, betas, ll_forward
        r_k = kranges.ranges_from_posteriors(*lat, il, ll, S)
        torch.cuda.synchronize()
        r_p = band.band_starts(band.posterior_peaks(*lat), il, ll, S)
        errs["ranges"] = max(errs["ranges"], compare(f"ranges {tag}", r_k, r_p, (0.0, 0.0)))
        del lat
        ranges, lab_row = x["ranges"], x["lab_row"]
        dtypes = (torch.float32, torch.bfloat16) if tag == "pruned_long" else (torch.float32,)
        for dtype in dtypes:  # f32 first: its lattice feeds the bf16 gradient check too
            f32 = dtype == torch.float32
            acts = x["band"].to(dtype)
            p_k = kband.band_prep(acts, lab_row, 0)
            torch.cuda.synchronize()
            p = band.band_prep(acts, lab_row, 0)
            e = max(compare(f"band_prep {tag} {dtype} {name}", getattr(p_k, name),
                            getattr(p, name), "f32") for name in p._fields)
            del p_k
            if f32:
                errs["band_prep"] = max(errs["band_prep"], e)
                lat_k = kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)
                torch.cuda.synchronize()
                lat = band.forward_backward(p.lpb, p.lpe, ranges, il, ll)
                e = max(compare(f"band_stream {tag} {name}", getattr(lat_k, name),
                                getattr(lat, name), "f32") for name in lat._fields)
                errs["band_stream"] = max(errs["band_stream"], e)
                fields = band.band_coefs(p.lpb, p.lpe, lat, ranges, x["has_lab"], il, ll,
                                         torch.ones(B, device=dev), 0.0)
            g_k = kband.band_grad(acts, p.denom, fields, lab_row, ranges, il, ll, 0, dtype)
            torch.cuda.synchronize()
            g_p = band.band_grad(acts, p.denom, fields, lab_row, ranges, il, ll, 0, dtype)
            e = compare(f"band_grad {tag} {dtype}", g_k, g_p,
                        grad_tol(g_p, "f32" if f32 else "bf16_out"))
            if f32:
                errs["band_grad"] = max(errs["band_grad"], e)
            del g_k, g_p, acts
        del x
        torch.cuda.empty_cache()

    # An infeasible band: U_b - 1 = 7 > T_b·(S - 1) = 3, no path reaches the
    # terminal cell. ll_forward is NEG in both versions; the cost is about
    # 1e30 and finite, the gradient exactly zero.
    B, T, U, V, S = 4, 3, 8, 6, 2
    g = torch.Generator(device=dev).manual_seed(4)
    acts = torch.randn((B, T, S, V), generator=g, device=dev)
    labels = torch.randint(1, V, (B, U - 1), generator=g, device=dev, dtype=torch.int32)
    il = torch.full((B,), T, dtype=torch.int32, device=dev)
    ll = torch.full((B,), U - 1, dtype=torch.int32, device=dev)
    ranges = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
    lab_row = band.label_rows(*band.band_labels(labels, ranges, S))
    p = band.band_prep(acts, lab_row, 0)
    lat_k = kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)
    torch.cuda.synchronize()
    lat = band.forward_backward(p.lpb, p.lpe, ranges, il, ll)
    compare("band_stream infeasible ll_forward", lat_k.ll_forward, lat.ll_forward, "f32")
    a = acts.clone().requires_grad_(True)
    cost = rnnt_loss_pruned(a, ranges, labels, il, ll, reduction="none")
    cost.sum().backward()
    fail_unless(bool((lat_k.ll_forward < -1e29).all()), "infeasible band: ll_forward is not NEG")
    fail_unless(bool(torch.isfinite(cost).all() and (cost > 1e29).all()),
                "infeasible band: cost is not a finite ~1e30")
    fail_unless(int(torch.count_nonzero(a.grad)) == 0, "infeasible band: gradient is not zero")
    print(f"infeasible band: cost {cost[0].item():.3e}, gradient zero: ok")


def pruned_main_path(dev, totals):
    """The pruned step at both shapes under the launch counters, with no
    host sync allowed, held against the same step with implementation=
    "torch". Returns {shape: (am, lm, labels, il, ll)}."""
    from warp_transducer_tpu_torch.ops import cuda as K
    problems = {}
    for tag, B, T, L, V, S in PRUNED_SHAPES:
        am, lm, labels, il, ll = make_pruned_problem(B, T, L, V, seed=5, dev=dev)
        am.requires_grad_(True)
        lm.requires_grad_(True)
        K.reset_launches()
        torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
        loss_s, loss_p, ranges = pruned_step(am, lm, labels, il, ll, S)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(K.launches)
        print(f"main path {tag} B={B} T={T} L={L} V={V} S={S}: launches {counts}")
        for k in ("wavefront",) + PRUNED_KERNELS:
            fail_unless(counts[k] > 0, f"{k} kernel was not launched on the pruned path ({tag})")
        for k, n in counts.items():
            totals[k] += n
        dam, dlm = am.grad.clone(), lm.grad.clone()
        fail_unless(all(bool(torch.isfinite(t).all()) for t in (loss_s, loss_p, dam, dlm)),
                    f"pruned step {tag}: costs or gradients not finite")
        ref_s, ref_p, ref_ranges = pruned_step(am, lm, labels, il, ll, S, implementation="torch")
        n_diff = int((ranges != ref_ranges).sum())
        print(f"ranges {tag} kernels vs plain path: {n_diff} of {B * T} differ")
        fail_unless(n_diff == 0, f"the band starts of the kernels and the plain path differ ({tag})")
        compare(f"simple cost {tag} kernels vs plain", loss_s, ref_s, "f32")
        compare(f"pruned cost {tag} kernels vs plain", loss_p, ref_p, "f32")
        # As for the dense path: the prep's rounding moves α + β − ll, and
        # exp() turns that into a relative error of the gradient.
        for name, got, want in (("am", dam, am.grad), ("lm", dlm, lm.grad)):
            rel = float((got - want).norm() / want.norm())
            print(f"grads {tag} d{name} kernels vs plain: relative norm error {rel:.3e} (tol 1e-3)")
            fail_unless(rel <= 1e-3, f"d{name} of the kernels and the plain path differ ({tag})")
        am.grad = lm.grad = None
        problems[tag] = (am, lm, labels, il, ll)
        torch.cuda.empty_cache()
    return problems


def full_band_check(dev, errs, clock_mhz, library):
    """A band over the whole headline lattice (S = U = 41, ranges = 0, the
    cells walk): rnnt_loss_pruned equals the dense rnnt_loss, costs and
    gradients; the lattice kernel equals its plain version on that band's
    lpb and lpe. Returns the lattice kernel's launches in the pruned loss's
    call, its max abs error and its timing."""
    from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_pruned
    from warp_transducer_tpu_torch.ops import band
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    tag, B, T, L, V = SHAPES[0]
    S = L + 1
    fail_unless(not kband.plan(B, T, S).row_mode, "the full band is not planned on the cells walk")
    acts, labels, il, ll = make_problem(B, T, L, V, seed=6, dev=dev)
    ranges = torch.zeros((B, T), dtype=torch.int32, device=dev)
    a = acts.requires_grad_(True)
    dense = rnnt_loss(a, labels, il, ll, reduction="none")
    (gd,) = torch.autograd.grad(dense.sum(), a)
    K.reset_launches()
    pruned = rnnt_loss_pruned(a, ranges, labels, il, ll, reduction="none")
    (gp,) = torch.autograd.grad(pruned.sum(), a)
    torch.cuda.synchronize()
    launches = K.launches["band_stream"]
    fail_unless(launches > 0, "the full band did not run the band kernels")
    compare(f"full band S=U={S} {tag}: pruned vs dense costs", pruned.detach(),
            dense.detach(), "f32")
    rel = float((gp - gd).norm() / gd.norm())
    print(f"full band S=U={S} {tag}: pruned vs dense gradient relative norm error {rel:.3e} "
          "(tol 1e-3)")
    fail_unless(rel <= 1e-3, "the full-band pruned gradient differs from the dense one")
    # The cells walk against its plain version at the shape its path gives it.
    del a, gd, gp
    with torch.no_grad():
        p = band.band_prep(acts.detach(), band.label_rows(*band.band_labels(labels, ranges, S)), 0)
    lattice = lambda: kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)  # noqa: E731
    lat_k = lattice()
    torch.cuda.synchronize()
    lat = band.forward_backward(p.lpb, p.lpe, ranges, il, ll)
    err = max(compare(f"band_stream full_band {name}", getattr(lat_k, name), getattr(lat, name),
                      "f32") for name in lat._fields)
    errs["band_stream"] = max(errs["band_stream"], err)
    event_ms, device_ms = time_ms(lattice, 10), launch_device_ms(lattice)
    plan = kband.plan(B, T, S)
    floor, step_n = band_chain_floor(band_step_instructions(library), S, il, clock_mhz, plan)
    timing = dict(
        ms=device_ms if device_ms is not None else event_ms, kernel_device_ms=device_ms,
        event_ms=event_ms,
        plain_ms=time_ms(lambda: band.forward_backward(p.lpb, p.lpe, ranges, il, ll), 1, 1),
        library_ms=None, bound=band_lattice_bound(ranges, il, ll, S),
        chain_floor_ms=floor, step_instructions=step_n,
        registers=kband.kernel_registers(T, S), plan=plan._asdict())
    print(f"time full_band B={B} T={T} S={S} band_stream: {timing['ms']:.4f} ms (a launch, "
          f"profiler; event {event_ms:.4f} ms) | plain {timing['plain_ms']:.4f} ms | bound "
          f"{timing['bound'][0]:.4f} ms ({timing['bound'][1]}) | chain floor {floor} ms "
          f"({step_n} SASS instructions a row step) | registers, local bytes "
          f"{timing['registers']}")
    return launches, err, timing


def pruned_timings(problems):
    """The pruned step (CUDA events, its device breakdown and its peak
    memory) and each pruned kernel at both shapes: ms, plain ms, library
    ms, bound. Returns ({kernel: {shape: timing}}, {shape: step ms},
    {shape: step peak MB})."""
    from warp_transducer_tpu_torch.ops import band
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import build
    from warp_transducer_tpu_torch.ops.cuda import ranges as kranges
    from warp_transducer_tpu_torch.ops.cuda import rows as R
    out, step_ms, step_mb = {k: {} for k in PRUNED_KERNELS}, {}, {}
    clock_mhz = sm_clock_mhz()
    library = build.build()
    band_steps = band_step_instructions(library)
    range_steps = ranges_step_instructions(library)
    print(f"band_stream: SASS instructions of the two row steps {band_steps} "
          f"(ceil(log2 S), or the cells walk's (C, 64-bit offsets): counts); ranges: SASS instructions a step of the three scans "
          f"{range_steps} ((element bytes, lanes a row): counts); SM clock {clock_mhz} MHz (nvidia-smi "
          "clocks.max.sm)")
    for tag, B, T, L, V, S in PRUNED_SHAPES:
        am, lm, labels, il, ll = problems[tag]
        step = lambda: pruned_step(am, lm, labels, il, ll, S)  # noqa: E731
        step_ms[tag] = time_ms(step, 5)
        step_mb[tag] = peak_mb(step)
        x = band_inputs(am.detach(), lm.detach(), labels, il, ll, S)
        ranges, acts, lab_row, p = x["ranges"], x["band"], x["lab_row"], x["prep"]
        # Data-dependent work: the lattice reads lpb/lpe and updates only at
        # valid cells, and the gradient reads the band and its fields only
        # in valid rows (both write NEG or zeros elsewhere).
        n_valid = int(band.band_valid(ranges, il, ll, S).sum())
        rows, elt = B * T * S, acts.element_size()
        print(f"time {tag} B={B} T={T} L={L} V={V} S={S}: pruned step {step_ms[tag]:.4f} ms, "
              f"peak {step_mb[tag]:.1f} MB (valid band cells {n_valid / rows:.3f} of B·T·S)")
        device_breakdown(f"{tag} pruned step", step, step_ms[tag], top=12)
        # K5a a launch and the ranges call by the profiler's device time
        # (CUDA events time the wrappers' host work as well); events beside.
        prep_k = lambda: kband.band_prep(acts, lab_row, 0)  # noqa: E731
        event_ms, dev_ms = time_ms(prep_k, 10), launch_device_ms(prep_k)
        plan = R.reduce_plan(V, elt, R.alignment(acts.data_ptr()))
        out["band_prep"][tag] = dict(
            ms=dev_ms if dev_ms is not None else event_ms, kernel_device_ms=dev_ms,
            event_ms=event_ms,
            plain_ms=time_ms(lambda: band.band_prep(acts, lab_row, 0), 2, 1),
            library_ms=time_ms(lambda: torch.logsumexp(acts, -1), 10),
            bound=bound(rows * V * elt + rows * 4 + 3 * rows * 4, 4 * rows * V, F32_OPS_PER_S),
            registers=kband.band_prep_registers(acts.dtype, plan), plan=plan._asdict())
        # K4 a launch by the profiler's device time (CUDA events time the
        # wrapper's host work as well at pruned_large_v); events beside it.
        lattice = lambda: kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)  # noqa: E731
        event_ms, dev_ms = time_ms(lattice, 10), launch_device_ms(lattice)
        floor, step_n = band_chain_floor(band_steps, S, il, clock_mhz, kband.plan(B, T, S))
        out["band_stream"][tag] = dict(
            ms=dev_ms if dev_ms is not None else event_ms, kernel_device_ms=dev_ms,
            event_ms=event_ms,
            plain_ms=time_ms(lambda: band.forward_backward(p.lpb, p.lpe, ranges, il, ll), 1, 1),
            library_ms=None, bound=band_lattice_bound(ranges, il, ll, S),
            chain_floor_ms=floor, step_instructions=step_n,
            registers=kband.kernel_registers(T, S), plan=kband.plan(B, T, S)._asdict())
        grad_args = (acts, p.denom, x["fields"], lab_row, ranges, il, ll, 0, acts.dtype)
        out["band_grad"][tag] = dict(
            ms=time_ms(lambda: kband.band_grad(*grad_args), 10),
            plain_ms=time_ms(lambda: band.band_grad(*grad_args), 2, 1),
            library_ms=time_ms(lambda: torch.softmax(acts, -1), 10),
            bound=bound((n_valid + rows) * V * elt + 5 * n_valid * 4 + B * T * 4 + 2 * B * 4,
                        4 * n_valid * V, F32_OPS_PER_S))
        # The ranges call: every kernel of it (one launch), the whole of
        # ranges_from_posteriors against posterior_peaks + band_starts.
        alphas, betas, llf = x["simple_lat"][:3]
        U = alphas.shape[2]
        ranges_k = lambda: kranges.ranges_from_posteriors(alphas, betas, llf, il, ll, S)  # noqa: E731
        event_ms, dev_ms = time_ms(ranges_k, 20), device_ms(ranges_k)
        floor, step_n = ranges_chain_floor(range_steps, il, T, U, alphas.element_size(),
                                           clock_mhz)
        out["ranges"][tag] = dict(
            ms=dev_ms if dev_ms is not None else event_ms, kernel_device_ms=dev_ms,
            event_ms=event_ms,
            plain_ms=time_ms(lambda: band.ranges_from_posteriors(alphas, betas, llf, il, ll, S),
                             1, 1),
            library_ms=None, bound=ranges_bound(il, T, U, alphas.element_size()),
            chain_floor_ms=floor, step_instructions=step_n,
            registers=kranges.kernel_registers(alphas.dtype, U), plan=kranges.plan(T, U)._asdict())
        for k in PRUNED_KERNELS:
            v = out[k][tag]
            lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
            unit = "a frame of the three scans" if k == "ranges" else "a row step"
            print(f"time {tag} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {lib}"
                  + (f" | profiler {v['kernel_device_ms']} ms, event {v['event_ms']:.4f} ms"
                     if "event_ms" in v else "")
                  + (f" | chain floor {v['chain_floor_ms']} ms ({v['step_instructions']} SASS "
                     f"instructions {unit})" if "chain_floor_ms" in v else "")
                  + (f" | registers, local bytes {v['registers']}" if "registers" in v else ""))
        del x, acts, p, grad_args, lattice, alphas, betas, llf
        torch.cuda.empty_cache()
    return out, step_ms, step_mb


# The JAX package's published fused shape (README.md, "Fused joint + loss";
# B, T, L, V, H) and a small one on which no tile divides V, H or the rows,
# with the blank in the last column.
# The char_long path: a character-level transducer on long utterances, the
# dense lattice past one block's width. LibriSpeech's 28 characters and the
# blank (V = 29); 40 s of speech at 4× subsampled 10 ms frames (T = 1000);
# about 15 characters a second (L = 600): U = 601 > 512, so every lattice
# runs on the stripe kernel (two stripes of 10 bands, two CTAs of a cluster,
# in f32). acts take 2.23 GB in f32.
CHAR_LONG_SHAPE = ("char_long", 32, 1000, 600, 29)
CHAR_LONG_S = 5  # the pruned step's band
# The f64 lattice at the same U (two stripes of 10 bands past f64's 352), at
# a smaller batch and T; and a lattice past one cluster's reach (f32 4096
# columns: U = 5000 takes ten stripes, two passes of eight CTAs, the edge
# column between them through device memory): B, T, L.
CHAR_LONG_F64 = (4, 300, 600)
CLUSTER_REACH = (2, 8, 4999)


def stripe_lattice_check(tag, B, T, L, dtype, seed, dev, errs):
    """The lattice kernel against its plain version on the prep's lpb, lpe
    of random acts (V = 6), both directions and alpha alone; the plan must
    be the stripe kernel's."""
    from warp_transducer_tpu_torch.ops import lattice, prep
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    acts, labels, il, ll = make_problem(B, T, L, 6, seed=seed, dev=dev, dtype=dtype)
    p = prep.prepare(acts, labels, 0, False)
    del acts
    plan = kwave.plan(B, T, L + 1, p.lpb.element_size(), True,
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"{tag} B={B} T={T} U={L + 1} {dtype}: lattice plan {plan._asdict()}")
    fail_unless(plan.stripes > 1, f"{tag}: the lattice is not planned on the stripe kernel")
    key = "f64" if dtype == torch.float64 else "f32"
    for betas in (True, False):
        got = kwave.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
        torch.cuda.synchronize()
        want = lattice.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
        e = max(compare(f"wavefront_stripe {tag} {dtype} betas={betas} {field}",
                        getattr(got, field), getattr(want, field), key)
                for field in ("alphas", "betas", "ll_forward", "ll_backward"))
        if dtype == torch.float32:
            errs["wavefront_stripe"] = max(errs["wavefront_stripe"], e)
    return plan


def char_long_phase(dev, totals, errs, clock_mhz, library):
    """The char_long path: the stripe kernel against its plain version (f32
    at the full shape, f64 past U = 352, f32 past one cluster's reach); then
    its main path under the launch counters (reset just before, read just
    after, no host sync allowed): ``rnnt_loss_and_grad`` on raw activations,
    the binding's ``RNNTLoss`` on log-probs (the sparse gradient),
    ``rnnt_score`` (alpha alone) and the pruned step (S = 5, whose simple
    loss's lattice is K1 at U = 601), each held against its plain route
    (costs rtol 1e-5, gradients 1e-3 by relative norm); then the timings.
    Returns the stripe kernel's entry for the kernels line (less launches
    and error) and the step's times."""
    from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_and_grad, rnnt_score
    from warp_transducer_tpu_torch.bindings import torch_binding
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import lattice
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    tag, B, T, L, V = CHAR_LONG_SHAPE
    U, S = L + 1, CHAR_LONG_S
    started = time.perf_counter()
    plan = stripe_lattice_check(tag, B, T, L, torch.float32, 60, dev, errs)
    stripe_lattice_check(f"{tag} f64", *CHAR_LONG_F64, torch.float64, 61, dev, errs)
    for dtype in (torch.float32, torch.float64):
        reach = stripe_lattice_check("past one cluster's reach", *CLUSTER_REACH, dtype, 62, dev,
                                     errs)
        fail_unless(reach.passes > 1, "the lattice past one cluster's reach takes one pass")
    torch.cuda.empty_cache()

    acts, labels, il, ll = make_problem(B, T, L, V, seed=63, dev=dev)
    lp = torch.log_softmax(acts, -1).requires_grad_(True)
    am, lm, labels_p, il_p, ll_p = make_pruned_problem(B, T, L, V, seed=64, dev=dev)
    am.requires_grad_(True)
    lm.requires_grad_(True)
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
    try:
        costs, grads = rnnt_loss_and_grad(acts, labels, il, ll)
        binding = torch_binding.RNNTLoss(reduction="sum", from_log_probs=True)(lp, labels, il, ll)
        binding.backward()
        score = rnnt_score(acts, labels, il, ll)
        loss_s, loss_p, ranges = pruned_step(am, lm, labels_p, il_p, ll_p, S)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"main path {tag} B={B} T={T} L={L} V={V}: launches {counts}")
    fail_unless(counts["wavefront_stripe"] >= 4 and counts["wavefront"] == 0,
                f"the {tag} lattices did not all run on the stripe kernel")
    for k in ("prep", "grad") + PRUNED_KERNELS:
        fail_unless(counts[k] > 0, f"{k} kernel was not launched on the {tag} path")
    for k, n in counts.items():
        totals[k] += n
    dlp, dam, dlm = lp.grad, am.grad.clone(), lm.grad.clone()
    for name, x in (("costs", costs), ("grads", grads), ("binding", binding), ("score", score),
                    ("binding grads", dlp), ("am grads", dam), ("lm grads", dlm)):
        fail_unless(bool(torch.isfinite(x).all()), f"{tag}: {name} not finite")
    fail_unless(costs.shape == (B,) and grads.shape == acts.shape, f"{tag}: shapes")

    def rel_check(name, got, want):
        rel = float((got - want).norm() / want.norm())
        print(f"grads {tag} {name} kernels vs plain: relative norm error {rel:.3e} (tol 1e-3)")
        fail_unless(rel <= 1e-3, f"{tag}: {name} of the kernels and the plain route differ")

    costs_p, grads_p = rnnt_loss_and_grad(acts, labels, il, ll, implementation="torch")
    compare(f"costs {tag} kernels vs plain", costs, costs_p, "f32")
    rel_check("rnnt_loss_and_grad", grads, grads_p)
    del grads, grads_p
    lp_p = lp.detach().clone().requires_grad_(True)
    want = rnnt_loss(lp_p, labels, il, ll, reduction="sum", log_probs_input=True,
                     implementation="torch")
    want.backward()
    compare(f"binding RNNTLoss {tag} from_log_probs vs plain", binding.detach(), want.detach(),
            "f32")
    rel_check("binding RNNTLoss from_log_probs", dlp, lp_p.grad)
    del lp_p, want
    compare(f"rnnt_score {tag} kernels vs plain", score,
            rnnt_score(acts, labels, il, ll, implementation="torch"), "f32")
    ref_s, ref_p, ref_ranges = pruned_step(am, lm, labels_p, il_p, ll_p, S, "torch", band=ranges)
    n_diff = int((ranges != ref_ranges).sum())
    print(f"ranges {tag} kernels vs plain path: {n_diff} of {B * T} differ (the plain route "
          f"prunes with the kernels' band)")
    compare(f"simple cost {tag} kernels vs plain", loss_s, ref_s, "f32")
    compare(f"pruned cost {tag} kernels vs plain", loss_p, ref_p, "f32")
    rel_check("pruned step d_am", dam, am.grad)
    rel_check("pruned step d_lm", dlm, lm.grad)
    del lp, dlp, am, lm, dam, dlm
    torch.cuda.empty_cache()

    # Timings: the stripe kernel alone on the main path's inputs (the kernel
    # prep's), and the step.
    pk = kprep.prepare(acts, labels, 0, False)
    wave_k = lambda: kwave.forward_backward(pk.lpb, pk.lpe, il, ll)  # noqa: E731
    steps = wavefront_step_instructions(library, "wavefront_stripe_kernel").get(4)
    n_max = int((il.long() + ll.long()).max())
    out = dict(
        ms=time_ms(wave_k, 5),
        kernel_device_ms=launch_device_ms(wave_k, names=("wavefront_stripe_kernel",)),
        plain_ms=time_ms(lambda: lattice.forward_backward(pk.lpb, pk.lpe, il, ll), 1, 1),
        library_ms=None, bound=wavefront_bound(pk.lpb, il, ll),
        registers=kwave.kernel_registers(U, torch.float32), step_instructions=steps,
        chain_floor_ms=n_max * steps / (clock_mhz * 1e3) if steps and clock_mhz else None,
        plan=plan._asdict())
    step = lambda: rnnt_loss_and_grad(acts, labels, il, ll)  # noqa: E731
    step_ms = [time_ms(step, 5) for _ in range(2)]
    prof = device_breakdown(tag, step, step_ms[0])
    print(f"time {tag} wavefront_stripe: {out['ms']:.4f} ms | the kernel alone "
          f"{out['kernel_device_ms']} ms (profiler) | plain {out['plain_ms']:.4f} ms | bound "
          f"{out['bound'][0]:.4f} ms ({out['bound'][1]}) | chain floor {out['chain_floor_ms']} ms "
          f"({steps} SASS instructions a step, N_max {n_max}) | registers, local bytes "
          f"{out['registers']}")
    print(f"time {tag} B={B} T={T} L={L} V={V}: loss+grad {step_ms[0]:.4f} / {step_ms[1]:.4f} ms; "
          f"phase {time.perf_counter() - started:.1f} s")
    return out, dict(ms=step_ms, idle_share=prof and prof[1], device_kernels=prof and prof[2],
                     busy_ms=prof and prof[0])


FUSED_SHAPE = ("fused", 64, 150, 20, 5000, 256)
AWKWARD_SHAPE = ("awkward", 3, 37, 8, 1003, 200)
# The shape ops/pruned_fused.py names (B, T, L, V, H, S): its band would take
# 19 GB in f32. PRUNED_FUSED_CUT_B utterances of it give a band of 2.4 GB,
# which both routes can run.
PRUNED_FUSED_SHAPE = ("pruned_fused", 128, 1500, 300, 5000, 256, 5)
PRUNED_FUSED_CUT_B = 16
# Relative norm error of the fused gradients, kernel against plain version.
# f32: the sums over rows (dW, db, dp) and over V (dh) run in another order,
# de and dp through atomics. bf16: h and g are rounded to bf16 after sums
# taken in different orders, so single elements land on neighbouring bf16
# values (2^-9 relative each).
FUSED_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Elementwise, f32: each dW element is a sum of ~10^5 terms of mixed sign
# taken in another order, so its rtol is 1e-4 and its atol 1e-2 of the median
# nonzero |g|.
FUSED_GRAD_ELEMENTWISE = (1e-4, 1e-2)
# bf16 prep: a tanh that differs in its last bit can round h to the
# neighbouring bf16 value (2^-9 relative), which moves a logit by ~1e-4.
FUSED_PREP_TOL = {torch.float32: "f32", torch.bfloat16: (1e-5, 1e-3)}


def make_joint_problem(B, T, L, V, H, seed, dev, dtype=torch.float32, blank=0, n_cols=0):
    """Random projected activations e (B, T, H) and p (B, U, H), W ~ N(0, 1/H)
    so that the logits spread as a trained joint's do, bias, labels that avoid
    ``blank`` and the last ``n_cols`` columns, and ragged lengths, from a
    seed, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = L + 1
    e = (torch.randn((B, T, H), generator=g, device=dev) * 0.5).to(dtype)
    p = (torch.randn((B, U, H), generator=g, device=dev) * 0.5).to(dtype)
    W = (torch.randn((H, V), generator=g, device=dev) / H ** 0.5).to(dtype)
    bias = torch.randn((V,), generator=g, device=dev) * 0.1
    labels = torch.randint(0, V - 1 - n_cols, (B, L), generator=g, device=dev, dtype=torch.int32)
    labels = labels + (labels >= blank).int()
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return e, p, W, bias, labels, il, ll


def joint_fields(problem, blank):
    """What the fused step hands its gradient kernels: the fused prep, the
    lattice and the coefficient fields (kernels, unit cotangent)."""
    from warp_transducer_tpu_torch.ops import gradients
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    e, p, W, bias, labels, il, ll = problem
    with torch.no_grad():
        pr = kjoint.fused_prep(e, p, W, bias, labels, il, ll, blank)
        res = kwave.forward_backward(pr.lpb, pr.lpe, il, ll)
        fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas, res.ll_forward,
                                        il, ll)
    return pr, fields


def rel_norm(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def joint_kernels_vs_plain(dev, errs):
    """The two fused joint kernels against their plain versions: at the
    fused shape in f32 and with bf16 e, p, W, and at the awkward shape."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    cases = [(FUSED_SHAPE, torch.float32, 0), (FUSED_SHAPE, torch.bfloat16, 0),
             (AWKWARD_SHAPE, torch.float32, AWKWARD_SHAPE[4] - 1),
             (AWKWARD_SHAPE, torch.bfloat16, AWKWARD_SHAPE[4] - 1)]
    for (tag, B, T, L, V, H), dtype, blank in cases:
        problem = make_joint_problem(B, T, L, V, H, seed=7, dev=dev, dtype=dtype, blank=blank)
        e, p, W, bias, labels, il, ll = problem
        name = f"{tag} {dtype}"
        p_k = kjoint.fused_prep(e, p, W, bias, labels, il, ll, blank)
        torch.cuda.synchronize()
        p_p = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, blank)
        err = max(compare(f"joint_prep {name} {f}", getattr(p_k, f), getattr(p_p, f),
                          FUSED_PREP_TOL[dtype]) for f in ("lpb", "lpe", "denom"))
        if dtype == torch.float32:
            errs["joint_prep"] = max(errs["joint_prep"], err)
        _, fields = joint_fields(problem, blank)
        g_k = kjoint.fused_grad(e, p, W, bias, labels, il, ll, p_p.denom, fields, blank)
        torch.cuda.synchronize()
        if tag == "fused":  # dW and db are sums of partials in a fixed order
            again = kjoint.fused_grad(e, p, W, bias, labels, il, ll, p_p.denom, fields, blank)
            same = [bool(torch.equal(a, b)) for a, b in zip(g_k[2:], again[2:])]
            print(f"determinism joint_grad {name}: two calls give bit-equal dW {same[0]}, "
                  f"db {same[1]}")
            fail_unless(all(same), f"joint_grad {name}: dW or db differs between two calls")
            del again
        g_p = fused_joint.fused_grad(e, p, W, bias, labels, il, ll, p_p.denom, fields, blank)
        for f, got, want in zip(("de", "dp", "dW", "db"), g_k, g_p):
            rel = rel_norm(got, want)
            print(f"joint_grad {name} {f}: relative norm error {rel:.3e} "
                  f"(tol {FUSED_GRAD_REL[dtype]:g})")
            fail_unless(rel <= FUSED_GRAD_REL[dtype] and bool(torch.isfinite(got.float()).all()),
                        f"joint_grad {name} {f}: kernel disagrees with its plain version")
            if dtype == torch.float32:
                rtol, share = FUSED_GRAD_ELEMENTWISE
                err = compare(f"joint_grad {name} {f}", got, want,
                              (rtol, grad_tol(want, "f32", share)[1]))
                errs["joint_grad"] = max(errs["joint_grad"], err)
        del p_k, p_p, g_k, g_p, fields, problem
        torch.cuda.empty_cache()


def make_joint_module(V, H, seed, dev, dtype=torch.float32, durations=()):
    """The port's Joint at the default widths (encoder and prediction 256),
    with a duration head when ``durations``, its weights drawn with numpy
    from a seed as a Flax parameter tree and loaded through
    joint_state_dict_from_flax."""
    import numpy as np
    from warp_transducer_tpu_torch.models import Joint, TransducerConfig
    from warp_transducer_tpu_torch.utils.convert import joint_state_dict_from_flax
    cfg = TransducerConfig(vocab_size=V, joint_dim=H, dtype=dtype, tdt_durations=tuple(durations))
    rng = np.random.default_rng(seed)
    layers = [("Dense_0", cfg.encoder_dim, H), ("Dense_1", cfg.prediction_dim, H),
              ("Dense_2", H, V)] + ([("DurHead_0", H, len(durations))] if durations else [])
    tree = {name: {"kernel": (rng.standard_normal((i, o)) / i ** 0.5).astype(np.float32),
                   "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}
            for name, i, o in layers}
    joint = Joint(cfg, device=dev)
    joint.load_state_dict(joint_state_dict_from_flax({"params": tree}))
    return joint


def make_model_problem(B, T, L, V, seed, dev, cfg, n_cols=0):
    """Random encoder and prediction outputs, labels (off the blank 0 and
    the last ``n_cols`` columns) and ragged lengths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = torch.randn((B, T, cfg.encoder_dim), generator=g, device=dev)
    pred = torch.randn((B, L + 1, cfg.prediction_dim), generator=g, device=dev)
    labels = torch.randint(1, V - n_cols, (B, L), generator=g, device=dev, dtype=torch.int32)
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return enc, pred, labels, il, ll


def joint_step(joint, loss_fn, enc, pred):
    """Forward and backward of ``loss_fn(enc, pred)`` (a sum of costs) into
    the joint's parameters and enc, pred; returns (loss, {name: grad})."""
    joint.zero_grad(set_to_none=True)
    enc = enc.detach().requires_grad_(True)
    pred = pred.detach().requires_grad_(True)
    loss = loss_fn(enc, pred)
    loss.backward()
    grads = {n: q.grad for n, q in joint.named_parameters()} | {"enc": enc.grad, "pred": pred.grad}
    return loss.detach(), grads


def check_step(tag, got, want, what, grad_rel=1e-3):
    """Costs rtol 1e-5 and every gradient within a relative norm error of
    ``grad_rel``: 1e-3 as the other end-to-end checks, or the bf16 kernels'
    2e-2 (FUSED_GRAD_REL) where the products take bf16 inputs."""
    compare(f"{tag} loss vs {what}", got[0], want[0], "f32")
    for n in got[1]:
        rel = rel_norm(got[1][n], want[1][n])
        print(f"{tag} d{n} vs {what}: relative norm error {rel:.3e} (tol {grad_rel:g})")
        fail_unless(rel <= grad_rel and bool(torch.isfinite(got[1][n].float()).all()),
                    f"{tag}: d{n} differs from {what}")


def peak_mb(fn):
    """Peak device memory of one call of ``fn`` above what is allocated
    before it, in MB."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def fused_main_path(dev, totals, dtype):
    """``Joint.fused_loss`` forward and backward at the fused shape, with the
    Joint's activations and W in ``dtype`` (bf16 is TransducerConfig's
    default), under the launch counters, with no host sync allowed, held
    against implementation="torch" and, in f32, against the unfused
    composition (``Joint.forward`` → ``rnnt_loss``: 4.0 GB of logits). In
    bf16 the unfused composition rounds the logits themselves to bf16, so it
    is a different function: its distance is printed, not held. Returns what
    the timings need."""
    from warp_transducer_tpu_torch import rnnt_loss
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L, V, H = FUSED_SHAPE
    f32 = dtype == torch.float32
    tag = f"{tag} {'f32' if f32 else 'bf16'}"
    joint = make_joint_module(V, H, seed=8, dev=dev, dtype=dtype)
    enc, pred, labels, il, ll = make_model_problem(B, T, L, V, seed=9, dev=dev, cfg=joint.cfg)

    def fused(implementation="auto"):
        return joint_step(joint, lambda a, b: joint.fused_loss(
            a, b, labels, il, ll, reduction="sum", implementation=implementation), enc, pred)

    def unfused():
        return joint_step(joint, lambda a, b: rnnt_loss(
            joint(a, b), labels, il, ll, blank=joint.cfg.blank, reduction="sum"), enc, pred)

    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
    got = fused()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"main path {tag} B={B} T={T} L={L} V={V} H={H}: launches {counts}")
    for k in ("joint_prep", "wavefront", "joint_grad"):
        fail_unless(counts[k] > 0, f"{k} kernel was not launched on the fused path")
    for k, n in counts.items():
        totals[k] += n
    got = (got[0], {n: g.clone() for n, g in got[1].items()})
    check_step(tag, got, fused("torch"), "the plain path", 1e-3 if f32 else FUSED_GRAD_REL[dtype])
    if f32:
        check_step(tag, got, unfused(), "the unfused composition")
    else:
        want = unfused()
        print(f"{tag}: the unfused bf16 composition (bf16 logits) differs by "
              f"{abs(float(got[0]) - float(want[0])) / abs(float(want[0])):.3e} in the loss and "
              f"{max(rel_norm(got[1][n], want[1][n]) for n in got[1]):.3e} at most in a gradient "
              f"(relative; not held)")
    return fused, unfused


def pruned_fused_path(dev, totals):
    """``rnnt_loss_simple(..., prune_range=S)`` for the band starts, then
    ``Joint.pruned_fused_loss`` forward and backward, at the full shape (the
    sweep: its band would not fit the threshold) under the launch counters
    and with no host sync allowed; then the first PRUNED_FUSED_CUT_B
    utterances on both routes, held against each other (the materialised
    route is ``rnnt_loss_pruned`` on the band: K5a, K5b) and against the
    full run's costs. Returns the cut problem for the timings."""
    from warp_transducer_tpu_torch import rnnt_loss_simple
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import pruned_fused
    tag, B, T, L, V, H, S = PRUNED_FUSED_SHAPE
    joint = make_joint_module(V, H, seed=10, dev=dev)
    enc, pred, labels, il, ll = make_model_problem(B, T, L, V, seed=11, dev=dev, cfg=joint.cfg)
    g = torch.Generator(device=dev).manual_seed(12)
    am = torch.randn((B, T, V), generator=g, device=dev)
    lm = torch.randn((B, L + 1, V), generator=g, device=dev)
    fail_unless(pruned_fused._materialize_bytes(B, T, S, H, V)
                > pruned_fused._MATERIALIZE_MB << 20, "the full shape must take the sweep")

    def step(n, ranges):
        return joint_step(joint, lambda a, b: joint.pruned_fused_loss(
            a, b, ranges[:n], labels[:n], il[:n], ll[:n], s_range=S, reduction="sum"),
            enc[:n], pred[:n])

    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    with torch.no_grad():
        _, ranges = rnnt_loss_simple(am, lm, labels, il, ll, prune_range=S)
    joint.zero_grad(set_to_none=True)
    e_leaf = enc.detach().requires_grad_(True)
    p_leaf = pred.detach().requires_grad_(True)
    costs = joint.pruned_fused_loss(e_leaf, p_leaf, ranges, labels, il, ll, s_range=S,
                                    reduction="none")
    costs.sum().backward()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"main path {tag} B={B} T={T} L={L} V={V} H={H} S={S}: launches {counts}")
    for k in ("wavefront", "ranges", "band_stream"):
        fail_unless(counts[k] > 0, f"{k} kernel was not launched on the pruned fused path")
    for k, n in counts.items():
        totals[k] += n
    grads = [q.grad for q in joint.parameters()] + [e_leaf.grad, p_leaf.grad]
    fail_unless(bool(torch.isfinite(costs).all()) and costs.shape == (B,)
                and all(bool(torch.isfinite(x).all()) for x in grads),
                "pruned fused step: costs or gradients not finite")
    costs = costs.detach()
    feasible = float((costs < 1e29).float().mean())
    print(f"pruned fused {tag}: mean cost {float(costs[costs < 1e29].mean()):.4f}, "
          f"{feasible:.3f} of the utterances have a path inside the band")
    del am, lm, e_leaf, p_leaf, grads
    torch.cuda.empty_cache()

    n = PRUNED_FUSED_CUT_B
    old = pruned_fused._MATERIALIZE_MB
    try:
        pruned_fused._MATERIALIZE_MB = 0
        K.reset_launches()
        sweep = step(n, ranges)
        fail_unless(K.launches["band_prep"] == 0 and K.launches["band_stream"] > 0,
                    "the sweep route ran the band prep kernel")
        sweep = (sweep[0], {k: v.clone() for k, v in sweep[1].items()})
        pruned_fused._MATERIALIZE_MB = 1 << 20
        K.reset_launches()
        mat = step(n, ranges)
        fail_unless(K.launches["band_prep"] > 0 and K.launches["band_grad"] > 0,
                    "the materialised route did not run the band kernels")
    finally:
        pruned_fused._MATERIALIZE_MB = old
    check_step(f"{tag} B={n} sweep", sweep, mat, "rnnt_loss_pruned on the materialised band")
    compare(f"{tag}: the full run's first {n} costs vs the cut run", costs[:n].sum(), sweep[0],
            "f32")
    return step, ranges


def time_routes(step, ranges):
    """Both routes of rnnt_loss_pruned_fused at the cut shape, step time and
    peak memory, for the threshold note."""
    from warp_transducer_tpu_torch.ops import pruned_fused
    tag, B, T, L, V, H, S = PRUNED_FUSED_SHAPE
    n = PRUNED_FUSED_CUT_B
    old = pruned_fused._MATERIALIZE_MB
    out = {}
    try:
        for route, mb in (("sweep", 0), ("materialised", 1 << 20), ("materialised", 1 << 20),
                          ("sweep", 0)):
            pruned_fused._MATERIALIZE_MB = mb
            ms = time_ms(lambda: step(n, ranges), 2, 1)
            mem = peak_mb(lambda: step(n, ranges))
            out.setdefault(route, []).append(ms)
            print(f"time {tag} B={n} T={T} L={L} V={V} H={H} S={S} {route} route: "
                  f"{ms:.4f} ms a step, peak {mem:.1f} MB")
        pruned_fused._MATERIALIZE_MB = 0
        ms = time_ms(lambda: step(B, ranges), 2, 1)
        mem = peak_mb(lambda: step(B, ranges))
        print(f"time {tag} B={B} T={T} L={L} V={V} H={H} S={S} sweep route: {ms:.4f} ms a "
              f"step, peak {mem:.1f} MB")
        device_breakdown(f"{tag} step", lambda: step(B, ranges), ms, iters=1, top=12)
    finally:
        pruned_fused._MATERIALIZE_MB = old
    band_mb = pruned_fused._materialize_bytes(n, T, S, H, V) / 2 ** 20
    faster = min(out, key=lambda r: min(out[r]))
    print(f"threshold {tag}: at a working set of {band_mb:.0f} MB the {faster} route is the "
          f"faster (sweep {min(out['sweep']):.4f} ms, materialised "
          f"{min(out['materialised']):.4f} ms)")
    return out, ms


def fused_timings(dev, steps_by_dtype):
    """The fused and the unfused step in f32 and in bf16 (time, peak memory,
    device breakdown) and the two fused kernels at the fused shape with f32
    and with bf16 W: ms, plain ms, library ms, bound, the device time of each
    of K6b's launches and the registers ptxas gave each kernel. Returns
    ({kernel: {case: timing}}, {step: [(ms, MB)]})."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    tag, B, T, L, V, H = FUSED_SHAPE
    steps = {}
    for dtype, (fused, unfused) in steps_by_dtype.items():
        suffix = "f32" if dtype == torch.float32 else "bf16"
        for name, fn in (("fused", fused), ("unfused", unfused), ("unfused", unfused),
                         ("fused", fused)):
            ms = time_ms(fn, 3, 1)
            mem = peak_mb(fn)
            steps.setdefault(f"{name}_{suffix}", []).append((ms, mem))
            print(f"time {tag} B={B} T={T} L={L} V={V} H={H} {suffix}: {name} step {ms:.4f} ms, "
                  f"peak {mem:.1f} MB")
        device_breakdown(f"{tag} {suffix} fused step", fused, steps[f"fused_{suffix}"][0][0],
                         iters=3, top=10)
        device_breakdown(f"{tag} {suffix} unfused step", unfused,
                         steps[f"unfused_{suffix}"][0][0], iters=3, top=10)
        torch.cuda.empty_cache()

    out = {"joint_prep": {}, "joint_grad": {}}
    U = L + 1
    for dtype in (torch.float32, torch.bfloat16):
        case = f"{tag}_{'f32' if dtype == torch.float32 else 'bf16'}"
        problem = make_joint_problem(B, T, L, V, H, seed=7, dev=dev, dtype=dtype)
        e, p, W, bias, labels, il, ll = problem
        pr, fields = joint_fields(problem, 0)
        # Data-dependent work: only the rows inside each utterance's lattice.
        rows = int((il.long() * (ll.long() + 1)).sum())
        rate = TF32X3_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        in_bytes = sum(x.numel() * x.element_size() for x in (e, p, W, bias)) + B * L * 4 + 2 * B * 4
        small = B * T * U * 4
        # The library's products, timed only: on the whole h (B·T·U, H) and g.
        h = torch.tanh(e.float()[:, :, None] + p.float()[:, None]).reshape(-1, H).to(dtype)
        g = torch.randn((h.shape[0], V), device=dev).to(dtype)

        def three_products():
            torch.matmul(h, W)
            torch.matmul(g, W.t())
            torch.matmul(h.t(), g)

        prep_args = (e, p, W, bias, labels, il, ll, 0)
        grad_args = (e, p, W, bias, labels, il, ll, pr.denom, fields, 0)
        regs = kjoint.kernel_registers(dtype)
        out["joint_prep"][case] = dict(
            ms=time_ms(lambda: kjoint.fused_prep(*prep_args), 5),
            plain_ms=time_ms(lambda: fused_joint.fused_prep(*prep_args), 2, 1),
            library_ms=time_ms(lambda: torch.matmul(h, W), 5),
            bound=bound(in_bytes + 3 * small, 2 * rows * H * V, rate),
            registers={k: regs[k] for k in JOINT_PREP_KERNELS})
        out["joint_grad"][case] = dict(
            ms=time_ms(lambda: kjoint.fused_grad(*grad_args), 3),
            plain_ms=time_ms(lambda: fused_joint.fused_grad(*grad_args), 2, 1),
            library_ms=time_ms(three_products, 3),
            bound=bound(2 * in_bytes + 4 * small, 3 * 2 * rows * H * V, rate),
            launch_ms=kernel_ms(lambda: kjoint.fused_grad(*grad_args)),
            registers={k: regs[k] for k in JOINT_GRAD_KERNELS})
        print(f"time {case}: valid rows {rows} ({rows / (B * T * U):.3f} of B·T·U)")
        for k in out:
            v = out[k][case]
            print(f"time {case} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library "
                  f"{v['library_ms']:.4f} ms")
            print(f"time {case} {k}: registers, local bytes a thread {v['registers']}"
                  + (f"; device ms a launch {v['launch_ms'] or 'not measured'}"
                     if "launch_ms" in v else ""))
        del h, g, pr, fields, problem, prep_args, grad_args
        torch.cuda.empty_cache()
    return out, steps


# The JAX package's two published duration-arc shapes (bench.py:394-419 and
# README.md:285, :292; B, T, L, V): the headline and the long utterances.
# Multi-blank: K = 2 big blanks of 2 and 4 frames on the last two columns,
# sigma 0.05; TDT: durations 0, 1, 2, 4 (D = 4). Labels stay off the
# big-blank columns.
DURATION_SHAPES = [("headline", 128, 150, 40, 28), ("long_t", 16, 1500, 300, 50)]
MB_DURATIONS, MB_SIGMA = (2, 4), 0.05
TDT_DURATIONS = (0, 1, 2, 4)
TDT_NO_D0 = (1, 2)


def make_duration_problem(B, T, L, V, seed, dev, dtype=torch.float32):
    """Random token logits, duration logits (D = 4), labels below the last
    two columns and ragged lengths, from a seed, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = L + 1
    acts = torch.randn((B, T, U, V), generator=g, device=dev, dtype=torch.float32).to(dtype)
    dur = torch.randn((B, T, U, len(TDT_DURATIONS)), generator=g, device=dev).to(dtype)
    labels = torch.randint(1, V - len(MB_DURATIONS), (B, L), generator=g, device=dev,
                           dtype=torch.int32)
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return acts, dur, labels, il, ll


def log_probs_input(acts):
    """The input of the multi-blank loss on log-probs: log_softmax of the
    activations in f32, the last big-blank column (4 frames) masked to −inf
    in a quarter of the utterances (1, 5, 9, ...), as users of log-probs
    inputs mask a big blank; a leaf that requires grad."""
    lp = torch.log_softmax(acts.detach().float(), -1)
    lp[1::4, ..., -1] = -float("inf")
    return lp.requires_grad_(True)


def window_tol(chain_weight, dtype):
    """(rtol, atol) of the window lattice, kernel against plain version. The
    chain's prefix form α = c + LSE(ne − c) cancels against c, the summed
    chain weights of a row, in both versions alike but in another order of
    addition: atol is that of the dtype plus four ulps of the largest |c|
    (2^-22 of it in f32, 2^-51 in f64). No chain: the dtype's own."""
    key = "f64" if dtype == torch.float64 else "f32"
    rtol, atol = TOL[key]
    if chain_weight is None:
        return rtol, atol
    c_max = float(chain_weight[..., :-1].clamp_min(-1e4).sum(-1).abs().max())
    return rtol, atol + c_max * (2.0 ** -51 if dtype == torch.float64 else 2.0 ** -22)


def window_cell_ops(arcs, U):
    """Operations of one lattice cell in one direction of the window
    kernel: per arc a weight sum, an add and a log-sum-exp join of about six
    operations; for the chain the prefix's clamp and add, ne − c, the local
    join (six), the fix-up join and its log (eight), c + z, and the cell's
    share of the lane totals' six warp-scan joins (a lane holds ⌈U/32⌉
    cells)."""
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    share = -(-36 // max(1, -(-U // 32)))
    return n_arcs * 8 + (18 + share if arcs.chain is not None else 0)


def duration_kernels_vs_plain(dev, errs):
    """The window kernel against the plain lattice for the multi-blank and
    the TDT arcs (with and without d = 0), f32 and f64, at both shapes, and
    at K = 0 against the wavefront kernel; prep and grad with K = 2 extra
    columns at both shapes and at the large-vocabulary one, f32 and bf16, on
    raw activations and on log-probs (prep's log-probs mode, grad's sparse
    fields mode)."""
    from warp_transducer_tpu_torch.ops import gradients, multiblank, prep, rnnt, window
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    fields4 = ("alphas", "betas", "ll_forward", "ll_backward")

    def extra_cols_case(tag, B, T, L, V, dtype):
        """prep and grad with the two big-blank columns; returns the f32
        channels for the lattice checks."""
        acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=13, dev=dev,
                                                          dtype=dtype)
        cols = (V - 2, V - 1)
        f32 = dtype == torch.float32
        p_k = kprep.prepare(acts, labels, 0, False, extra_cols=cols)
        torch.cuda.synchronize()
        p = prep.prepare(acts, labels, 0, False, extra_cols=cols)
        e = max(compare(f"prep K=2 {tag} {dtype} {f}", getattr(p_k, f), getattr(p, f), "f32")
                for f in ("lpb", "lpe", "denom", "extras"))
        if f32:
            errs["prep"] = max(errs["prep"], e)
        del p_k
        arcs = window.multiblank_arcs(MB_DURATIONS)
        lat = kwindow.forward_backward(p.lpb, p.lpe, p.extras, arcs, il, ll)
        coef, cb, ce, cBs = multiblank._mb_coefs(p.lpb, p.lpe, p.extras, lat, MB_DURATIONS, il, ll)
        fields = gradients.Coefficients(coef, cb, ce)
        extra = torch.stack(cBs, dim=-1)
        args = (acts, p.denom, fields, prep.label_rows(labels, L + 1), il, ll, 0, dtype)
        g_k = kgrad.dense_grad(*args, extra_cols=cols, extra_fields=extra)
        torch.cuda.synchronize()
        g_p = gradients.dense_grad(*args, extra_cols=cols, extra_fields=extra)
        e = compare(f"grad K=2 {tag} {dtype}", g_k, g_p, grad_tol(g_p, "f32" if f32 else "bf16_out"))
        if f32:
            errs["grad_fields"] = max(errs["grad_fields"], e)
        del g_k, g_p
        log_probs_case(tag, acts, labels, il, ll, cols, dtype)
        return p, torch.log_softmax(dur.float(), -1), il, ll

    def log_probs_case(tag, acts, labels, il, ll, cols, dtype):
        """The multi-blank loss on log-probs: prep's log-probs mode with the
        two big-blank columns (a masked one among them) and grad's sparse
        fields mode with them, each bit-equal to its plain version (neither
        does arithmetic: a column read plus 0; a negation, a selection and
        one rounding)."""
        lp = log_probs_input(acts).detach().to(dtype)
        p_k = kprep.prepare(lp, labels, 0, True, extra_cols=cols)
        torch.cuda.synchronize()
        p = prep.prepare(lp, labels, 0, True, extra_cols=cols)
        for f in ("lpb", "lpe", "extras"):
            fail_unless(torch.equal(getattr(p_k, f), getattr(p, f)),
                        f"prep log-probs K=2 {tag} {dtype} {f}: the kernel differs from its "
                        "plain version")
        print(f"compare prep log-probs K=2 {tag} {dtype}: lpb, lpe, extras bit-equal "
              f"({int(torch.isneginf(p_k.extras).sum())} -inf entries)")
        del p_k
        lpb, lpe, lpB, _ = multiblank._multiblank_prep(rnnt._PLAIN, lp, labels, 0, cols,
                                                       MB_SIGMA, True)
        lat = kwindow.forward_backward(lpb, lpe, lpB, window.multiblank_arcs(MB_DURATIONS), il, ll)
        coef, cb, ce, cBs = multiblank._mb_coefs(lpb, lpe, lpB, lat, MB_DURATIONS, il, ll,
                                                 fastemit_lambda=0.1)
        args = (gradients.Coefficients(coef, cb, ce), prep.label_rows(labels, lpb.shape[2]), il,
                ll, 0, lp.shape[-1], dtype)
        kw = dict(extra_cols=cols, extra_fields=torch.stack(cBs, dim=-1))
        g_k = kgrad.sparse_grad(*args, **kw)
        torch.cuda.synchronize()
        g_p = gradients.sparse_grad(*args, **kw)
        e = compare(f"grad sparse K=2 {tag} {dtype}", g_k, g_p, "f32")
        fail_unless(torch.equal(g_k, g_p), f"grad sparse K=2 {tag} {dtype}: not bit-equal")
        if dtype == torch.float32:
            errs["grad_fields"] = max(errs["grad_fields"], e)

    def lattice_case(name, arcs, lpb, lpe, extra, il, ll, chain_weight, want=None):
        got = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)
        torch.cuda.synchronize()
        if want is None:
            want = window.forward_backward(lpb, lpe, extra, arcs, il, ll)
        tol = window_tol(chain_weight, lpb.dtype)
        e = max(compare(f"window_stream {name} {f}", getattr(got, f), getattr(want, f), tol)
                for f in fields4)
        if lpb.dtype == torch.float32:
            errs["window_stream"] = max(errs["window_stream"], e)

    for tag, B, T, L, V in DURATION_SHAPES:
        p, lpd, il, ll = extra_cols_case(tag, B, T, L, V, torch.float32)
        if tag == "headline":
            extra_cols_case(tag, B, T, L, V, torch.bfloat16)
        j0 = TDT_DURATIONS.index(0)
        for dtype in (torch.float32, torch.float64):
            name = f"{tag} {'f32' if dtype == torch.float32 else 'f64'}"
            lpb, lpe, lpB, d = (x.to(dtype) for x in (p.lpb, p.lpe, p.extras, lpd))
            lattice_case(f"multiblank {MB_DURATIONS} {name}", window.multiblank_arcs(MB_DURATIONS),
                         lpb, lpe, lpB, il, ll, lpe)
            lattice_case(f"tdt {TDT_DURATIONS} {name}", window.tdt_arcs(TDT_DURATIONS), lpb, lpe,
                         d, il, ll, lpe + d[..., j0])
            if dtype == torch.float32 or tag == "headline":
                lattice_case(f"tdt {TDT_NO_D0} {name}", window.tdt_arcs(TDT_NO_D0), lpb, lpe,
                             d[..., :2].contiguous(), il, ll, None)
            # K = 0: the dense lattice, which the wavefront kernel computes
            # along anti-diagonals and cell by cell, without the prefix form.
            lattice_case(f"K=0 vs wavefront kernel {name}", window.multiblank_arcs(()), lpb, lpe,
                         lpB[..., :0].contiguous(), il, ll, lpe,
                         want=kwave.forward_backward(lpb, lpe, il, ll))
        del p, lpd
        torch.cuda.empty_cache()
    _, B, T, L, V = SHAPES[1]
    for dtype in (torch.float32, torch.bfloat16):
        extra_cols_case("large_v", B, T, L, V, dtype)
        torch.cuda.empty_cache()


def duration_step(loss, acts, dur, labels, il, ll, implementation="auto"):
    """One training step's loss part through a public entry point: forward
    and backward into the logits (leaves that require grad). Returns the
    costs and the gradients. ``multiblank_lp``: the multi-blank loss on
    log-probs (``acts`` the log-probs) through the binding's
    ``rnnt_loss_multiblank(from_log_probs=True)``, its entry point; the
    plain twin (``implementation="torch"``) through the op route the
    binding calls."""
    from warp_transducer_tpu_torch import rnnt_loss_multiblank, rnnt_loss_tdt
    from warp_transducer_tpu_torch.bindings import torch_binding
    from warp_transducer_tpu_torch.ops import multiblank
    acts.grad = dur.grad = None
    if loss == "multiblank":
        costs = rnnt_loss_multiblank(acts, labels, il, ll, MB_DURATIONS, sigma=MB_SIGMA,
                                     reduction="none", implementation=implementation)
    elif loss == "multiblank_lp" and implementation == "auto":
        costs = torch_binding.rnnt_loss_multiblank(acts, labels, il, ll, MB_DURATIONS,
                                                   sigma=MB_SIGMA, reduction="none",
                                                   from_log_probs=True)
    elif loss == "multiblank_lp":
        costs = multiblank._multiblank_costs(acts, labels, il, ll, MB_DURATIONS, 0, None, "none",
                                             MB_SIGMA, 0.0, 0.0, True, implementation)
    else:
        costs = rnnt_loss_tdt(acts, dur, labels, il, ll, TDT_DURATIONS, reduction="none",
                              implementation=implementation)
    costs.sum().backward()
    grads = ({"tok": acts.grad, "dur": dur.grad} if loss == "tdt"
             else {"log_probs" if loss == "multiblank_lp" else "acts": acts.grad})
    return costs.detach(), grads


def duration_main_path(dev, totals):
    """The duration-arc steps at both shapes (the multi-blank loss on raw
    activations and on log-probs, the TDT loss) under the launch counters,
    with no host sync allowed, held against the same step with
    implementation="torch" (timed once there: its lattice is T steps of torch
    ops). Returns {shape: problem}."""
    from warp_transducer_tpu_torch.ops import cuda as K
    problems = {}
    for tag, B, T, L, V in DURATION_SHAPES:
        acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=14, dev=dev)
        acts.requires_grad_(True)
        dur.requires_grad_(True)
        lp = log_probs_input(acts)
        for loss in ("multiblank", "multiblank_lp", "tdt"):
            x = lp if loss == "multiblank_lp" else acts
            K.reset_launches()
            torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
            costs, grads = duration_step(loss, x, dur, labels, il, ll)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            counts = dict(K.launches)
            print(f"main path {loss} {tag} B={B} T={T} L={L} V={V}: launches {counts}")
            for k in ("prep", "window_stream", "grad_fields"):
                fail_unless(counts[k] > 0, f"{k} kernel was not launched on the {loss} path ({tag})")
            fail_unless(counts["wavefront"] == 0, f"the {loss} path ran the dense lattice ({tag})")
            for k, n in counts.items():
                totals[k] += n
            grads = {n: g.clone() for n, g in grads.items()}
            fail_unless(costs.shape == (B,) and bool(torch.isfinite(costs).all())
                        and bool((costs < 1e29).all()), f"{loss} {tag}: costs not finite")
            if loss == "multiblank_lp":  # a masked big blank has no gradient
                masked = torch.isneginf(lp)
                fail_unless(bool((grads["log_probs"][masked] == 0).all()),
                            f"multiblank_lp {tag}: a gradient at a -inf input is not 0")
                print(f"multiblank_lp {tag}: the gradient is 0 at all "
                      f"{int(masked.sum())} -inf inputs")
            started = time.perf_counter()
            costs_p, grads_p = duration_step(loss, x, dur, labels, il, ll, "torch")
            torch.cuda.synchronize()
            print(f"time {loss} {tag}: the plain step once {(time.perf_counter() - started) * 1e3:.1f} ms")
            ref = "plain"
            if loss == "multiblank_lp":
                costs_p, grads_p = log_probs_reference(tag, lp, dur, labels, il, ll, costs, grads,
                                                       costs_p, grads_p)
                ref = "plain (f64)"
            compare(f"{loss} costs {tag} kernels vs {ref}", costs, costs_p, "f32")
            # As for the dense path: the prep's rounding moves α + β − ll, and
            # exp() turns that into a relative error of the gradient.
            for n in grads:
                fail_unless(grads[n].shape == grads_p[n].shape
                            and bool(torch.isfinite(grads[n]).all()), f"{loss} {tag}: d{n} not finite")
                rel = rel_norm(grads[n], grads_p[n])
                print(f"{loss} grads {tag} d{n} kernels vs {ref}: relative norm error {rel:.3e} "
                      "(tol 1e-3)")
                fail_unless(rel <= 1e-3, f"d{n} of the kernels and the plain path differ ({loss} {tag})")
            del grads, grads_p
        acts.grad = dur.grad = lp.grad = None
        problems[tag] = (acts, dur, labels, il, ll, lp)
        torch.cuda.empty_cache()
    return problems


# The shapes that took the earlier window block kernel (the walk's
# predecessor, deleted): the char-level lattice (U = 601) at a training
# batch of 128 for both duration-arc losses, TDT without a 0 duration at
# B = 32 (no chain), f64 at B = 4 (TDT's rings take two passes), and a U
# past the wrapper's former limit (a window of 8 frames: 17 passes).
WIDE_WINDOW_SHAPE = ("char_long_B128", 128, 1000, 600, 29)
WIDE_TDT_NO_D0 = ("char_long_B32", 32, 1000, 600, 29, (1, 2, 4))
WIDE_WINDOW_F64 = ("char_long_f64", 4, 300, 600, 29)
WIDE_WINDOW_LONG_U = ("U30000", 1, 8, 29999, 5, (8,))
WIDE_CUT_B = 8  # the public losses against their plain route on this slice of the batch


def former_block_phase(dev, totals, errs, clock_mhz, library):
    """The window walk at the shapes of the earlier block kernel: the
    public losses (``rnnt_loss_multiblank``, ``rnnt_loss_tdt``, forward and
    backward) under the launch counters, the kernel against the plain
    lattice on the same channels (f32 with window_tol, f64), the public
    losses against their plain route on a slice of the batch, the plans and
    timings. Returns {case: timing} for the kernels line and the window
    kernel's launches here."""
    from warp_transducer_tpu_torch import rnnt_loss_tdt
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import window
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    steps = window_step_instructions(library)
    out, launches = {}, 0
    started = time.perf_counter()

    def lattice_case(case, arcs, lpb, lpe, extra, il, ll, chain_weight, timed=True):
        nonlocal launches
        K.reset_launches()
        got = kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)
        torch.cuda.synchronize()
        fail_unless(K.launches["window_stream"] == 1, f"{case}: the window kernel did not run")
        launches += 1
        started = time.perf_counter()
        plain = window.forward_backward(lpb, lpe, extra, arcs, il, ll)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - started) * 1e3
        rtol, atol = window_tol(chain_weight, lpb.dtype)
        fields = ("alphas", "betas", "ll_forward", "ll_backward")
        if lpb.dtype == torch.float32:
            # The walk and the f32 plain version round the prefix form's
            # cancellation each their own way, both a few ulps of max |c| off
            # the f64 value at these U (PERF.md §6): the kernel is held
            # against the plain version run in f64, at window_tol beyond the
            # f32 plain version's own largest error there.
            want64 = window.forward_backward(lpb.double(), lpe.double(), extra.double(), arcs,
                                             il, ll)
            # NEG is -1e30 in f64 and -1.0000000150e30 in f32: the reference
            # takes the f32 value at the cells no path reaches.
            want = type(want64)(*(torch.where(w.abs() < 1e29, w, p.double())
                                  for w, p in zip(want64, plain)))
            del want64
            own = {f: float((getattr(plain, f).double() - getattr(want, f)).abs().max())
                   for f in fields}
            print(f"window_stream {case}: the f32 plain version's own largest error against "
                  f"f64 {own}")
            e = max(compare(f"window_stream {case} {f} (plain in f64)", getattr(got, f),
                            getattr(want, f), (rtol, atol + own[f])) for f in fields)
            errs["window_stream"] = max(errs["window_stream"], e)
        else:
            want = plain
            max(compare(f"window_stream {case} {f}", getattr(got, f), getattr(want, f),
                        (rtol, atol)) for f in fields)
        del got, want, plain
        plan = kwindow.lattice_plan(lpb, extra, arcs)
        if not timed:
            print(f"window_stream {case}: plan {plan._asdict()}")
            return
        fn = lambda: kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)  # noqa: E731
        floor, step_n = window_chain_floor(steps, lpb.element_size(), plan, il, clock_mhz)
        dev_ms = launch_device_ms(fn, iters=5)
        t = out[case] = dict(
            ms=dev_ms if dev_ms is not None else time_ms(fn, 5), kernel_device_ms=dev_ms,
            plain_ms=plain_ms, library_ms=None, bound=window_bound(lpb, extra, arcs, il, ll),
            chain_floor_ms=floor, step_instructions=step_n,
            registers=kwindow.kernel_registers(plan, lpb.dtype), plan=plan._asdict())
        print(f"time {case} window_stream: {t['ms']:.4f} ms (a launch) | plain {plain_ms:.1f} ms "
              f"| bound {t['bound'][0]:.4f} ms ({t['bound'][1]}) | chain floor {floor} ms "
              f"({step_n} SASS instructions a row step) | registers, local bytes "
              f"{t['registers']} | plan {t['plan']}")

    def public_step(case, loss, acts, dur, labels, il, ll, durations):
        """The public loss with gradients under the counters; the plain route
        on a slice of the batch."""
        K.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        if loss == "tdt":
            acts.grad = dur.grad = None
            costs = rnnt_loss_tdt(acts, dur, labels, il, ll, durations, reduction="none")
            costs.sum().backward()
        else:
            costs, _ = duration_step(loss, acts, dur, labels, il, ll)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(K.launches)
        print(f"main path {loss} {case} B={acts.shape[0]} T={acts.shape[1]} "
              f"U={acts.shape[2]}: launches {counts}")
        for k in ("prep", "window_stream", "grad_fields"):
            fail_unless(counts[k] > 0, f"{k} kernel was not launched on the {loss} path ({case})")
        fail_unless(counts["wavefront"] == 0, f"the {loss} path ran the dense lattice ({case})")
        for k, n in counts.items():
            totals[k] += n
        fail_unless(bool(torch.isfinite(costs).all()) and bool(torch.isfinite(acts.grad).all()),
                    f"{loss} {case}: costs or gradients not finite")
        # On a slice of the batch against the plain route run in f64: the
        # two f32 routes round the lattice each its own way, 1.2e-3 apart in
        # the multi-blank gradient at U = 601 (PERF.md §6; the same at long_t
        # on log-probs), so the f64 route is the reference.
        b = min(WIDE_CUT_B, acts.shape[0])
        runs, grads = [], []
        for impl, dt in (("auto", acts.dtype), ("torch", torch.float64)):
            cut = [x[:b].detach().to(dt).requires_grad_(True) for x in (acts, dur)]
            if loss == "tdt":
                c = rnnt_loss_tdt(cut[0], cut[1], labels[:b], il[:b], ll[:b], durations,
                                  reduction="none", implementation=impl)
                grads.append(torch.autograd.grad(c.sum(), cut))
            else:
                c, g = duration_step(loss, cut[0], cut[1], labels[:b], il[:b], ll[:b], impl)
                grads.append((g["acts"].clone(),))
            runs.append(c.detach())
        key = "f64" if acts.dtype == torch.float64 else "f32"
        compare(f"{loss} costs {case} B={b} kernels vs plain (f64)", runs[0], runs[1], key)
        for g_k, g_p in zip(grads[0], grads[1]):
            # (an infeasible slice has zero gradients in both)
            rel = rel_norm(g_k, g_p) if float(g_p.norm()) > 0 else float(g_k.norm())
            print(f"{loss} grads {case} B={b} kernels vs plain (f64): relative norm error "
                  f"{rel:.3e} (tol 1e-3)")
            fail_unless(rel <= 1e-3, f"the gradients of the kernels and the plain path differ "
                        f"({loss} {case})")
        acts.grad = dur.grad = None

    for tag, B, T, L, V in (WIDE_WINDOW_SHAPE, WIDE_WINDOW_F64):
        dtype = torch.float64 if tag.endswith("f64") else torch.float32
        acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=15, dev=dev,
                                                          dtype=dtype)
        acts.requires_grad_(True)
        dur.requires_grad_(True)
        for loss in ("multiblank", "tdt"):
            public_step(tag, loss, acts, dur, labels, il, ll, TDT_DURATIONS)
        with torch.no_grad():
            p = kprep.prepare(acts.detach(), labels, 0, False, extra_cols=(V - 2, V - 1))
            lpd = torch.log_softmax(dur.detach(), -1)
            j0 = TDT_DURATIONS.index(0)
            lattice_case(f"multiblank_{tag}", window.multiblank_arcs(MB_DURATIONS), p.lpb,
                         p.lpe, p.extras, il, ll, p.lpe)
            lattice_case(f"tdt_{tag}", window.tdt_arcs(TDT_DURATIONS), p.lpb, p.lpe, lpd, il,
                         ll, p.lpe + lpd[..., j0])
        del acts, dur, p, lpd
        torch.cuda.empty_cache()
    tag, B, T, L, V, durs = WIDE_TDT_NO_D0
    acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=16, dev=dev)
    d3 = dur[..., 1:].contiguous().requires_grad_(True)
    acts.requires_grad_(True)
    public_step(tag, "tdt", acts, d3, labels, il, ll, durs)
    with torch.no_grad():
        p = kprep.prepare(acts.detach(), labels, 0, False)
        arcs = window.tdt_arcs(durs)
        lattice_case(f"tdt_no_d0_{tag}", arcs, p.lpb, p.lpe,
                     torch.log_softmax(d3.detach(), -1).contiguous(), il, ll, None)
        fail_unless(kwindow.lattice_plan(p.lpb, d3, arcs).warps > 1,
                    "TDT without a 0 duration is not planned on several warps at B = 32")
    del acts, dur, d3, p
    torch.cuda.empty_cache()
    tag, B, T, L, V, durs = WIDE_WINDOW_LONG_U
    g = torch.Generator(device=dev).manual_seed(17)
    lp = torch.log_softmax(torch.randn((B, T, L + 1, 3 + len(durs)), generator=g, device=dev) * 2,
                           -1)
    lpe = lp[..., 1].clone()
    lpe[..., L] = -1e30
    il = torch.full((B,), T, dtype=torch.int32, device=dev)
    ll = torch.full((B,), L, dtype=torch.int32, device=dev)
    lattice_case(f"multiblank_w8_{tag}", window.multiblank_arcs(durs), lp[..., 0].contiguous(),
                 lpe, lp[..., 3:].contiguous(), il, ll, lpe, timed=False)
    del lp, lpe
    torch.cuda.empty_cache()
    print(f"former block phase: {time.perf_counter() - started:.1f} s")
    return out, launches


# The duration sets past the kernels' by-value tables (no duration set is
# refused): TDT with the TDT paper's durations 0 … 8 (arXiv:2304.06795; 11
# channels, 8 blank and 8 emit arcs), the multi-blank loss with nine big
# blanks, the largest counts (D = 33, past a warp's 32 lanes; K = 16), and
# a window of 300 frames, whose rings pass a block and lie in device
# memory. Each runs on its kernels' instances of their own: K7's table
# instance, K3's and grad.cu's table of columns, K6a/K6b's kMany, K6c/K6d
# in groups of 8 columns.
MANY_TDT = tuple(range(9))
MANY_MB = tuple(range(2, 11))
WIDEST_TDT = tuple(range(33))
WIDEST_MB = tuple(range(2, 18))
LONG_WINDOW = ("w300", 4, 1500, 300, 40, (2, 4, 8, 16, 32, 64, 128, 300))
# The plain references (their lattices are T steps of torch ops) run on a
# slice of the batch: in f64 at long_t and the 300-frame window, in f32 at
# D = 33 and K = 16 at headline, and in f64 on log-probs there.
MANY_CUT_B = 2
MANY_CUT_WIDEST = 16
MANY_TRAIN_CFG = dict(vocab_size=5000, tdt_durations=MANY_TDT)


def many_problem(B, T, L, V, D, n_cols, seed, dev):
    """Token logits, duration logits (D columns), labels off the blank and
    the last ``n_cols`` columns, ragged lengths (the first utterance full),
    from a seed, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    acts = torch.randn((B, T, L + 1, V), generator=g, device=dev)
    dur = torch.randn((B, T, L + 1, max(D, 1)), generator=g, device=dev)
    labels = torch.randint(1, V - n_cols, (B, L), generator=g, device=dev, dtype=torch.int32)
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return acts, dur, labels, il, ll


def many_step(loss, x, dur, labels, il, ll, durations, implementation="auto"):
    """(costs, gradients) of one public loss forward and backward: ``tdt``
    (rnnt_loss_tdt, d tokens and d durations), ``multiblank``
    (rnnt_loss_multiblank) or ``multiblank_lp`` (the binding on log-probs;
    its plain twin through the op route the binding calls)."""
    from warp_transducer_tpu_torch import rnnt_loss_multiblank, rnnt_loss_tdt
    from warp_transducer_tpu_torch.bindings import torch_binding
    from warp_transducer_tpu_torch.ops import multiblank
    leaves = [x.detach().requires_grad_(True)]
    if loss == "tdt":
        leaves.append(dur.detach().requires_grad_(True))
        costs = rnnt_loss_tdt(*leaves, labels, il, ll, durations, reduction="none",
                              implementation=implementation)
    elif loss == "multiblank":
        costs = rnnt_loss_multiblank(leaves[0], labels, il, ll, durations, sigma=MB_SIGMA,
                                     reduction="none", implementation=implementation)
    elif implementation == "auto":
        costs = torch_binding.rnnt_loss_multiblank(leaves[0], labels, il, ll, durations,
                                                   sigma=MB_SIGMA, reduction="none",
                                                   from_log_probs=True)
    else:
        costs = multiblank._multiblank_costs(leaves[0], labels, il, ll, durations, 0, None,
                                             "none", MB_SIGMA, 0.0, 0.0, True, implementation)
    return costs.detach(), torch.autograd.grad(costs.sum(), leaves)


def many_durations_phase(dev, totals, errs):
    """The duration-arc losses at duration sets past the kernels' by-value
    tables, through the public entry points with gradients under the launch
    counters (no host sync allowed, no plain stage, the new instances
    launched), each against its plain route: TDT 0 … 8 at headline (plain
    f32) and long_t (plain f64 on a slice), the multi-blank loss with nine
    big blanks at headline, raw and through the binding on log-probs (plain
    f64), D = 33 and K = 16 at headline, the 300-frame window at B = 4,
    T = 1500, U = 301 (plain f64), the fused TDT loss with D = 9 on both
    routes and the fused multi-blank loss with K = 9 at the fused shape
    (plain route), ``make_tdt_fused_train_step`` on
    TransducerConfig(vocab_size=5000, tdt_durations=0 … 8) for ten Adam steps
    against its plain twin, then ``greedy_decode_tdt`` on that model. Then
    each new instance timed (profiler device ms) beside the by-value
    instance at the same shape. Returns ({kernel: {case: timing}},
    {kernel: {instance: launches}}, the train step's numbers)."""
    from warp_transducer_tpu_torch.models import decoding as D
    from warp_transducer_tpu_torch.models import transducer as tm
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import fused_joint, gradients, prep, tdt_fused, window
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    started = time.perf_counter()
    timings = {k: {} for k in ("window_stream", "prep", "grad_fields", "joint_prep",
                               "joint_grad", "dur_head")}
    launches = {k: {} for k in timings}

    def counted(name, fn, instances, must=()):
        """fn() under the launch counters; ``instances`` {counter: the new
        instance that this call's launches of that kernel are}."""
        K.reset_launches()
        torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = {k: n for k, n in K.launches.items() if n}
        print(f"main path {name}: launches {counts}")
        for k in tuple(instances) + tuple(must):
            fail_unless(counts.get(k, 0) > 0, f"{k} kernel was not launched on the {name} path")
        fail_unless("wavefront" not in counts, f"the {name} path ran the dense lattice")
        for k, n in counts.items():
            totals[k] += n
        for k, inst in instances.items():
            launches[k][inst] = launches[k].get(inst, 0) + counts.get(k, 0)
        return out

    def check(name, got, want, ref, tol=1e-3):
        compare(f"{name} costs kernels vs {ref}", got[0], want[0].to(got[0].dtype), "f32")
        for i, (g, w) in enumerate(zip(got[1], want[1])):
            fail_unless(g.shape == w.shape and bool(torch.isfinite(g).all()),
                        f"{name}: gradient {i} not finite")
            rel = rel_norm(g.double(), w.double()) if float(w.norm()) > 0 else float(g.norm())
            print(f"{name} gradient {i} kernels vs {ref}: relative norm error {rel:.3e} "
                  f"(tol {tol:g})")
            fail_unless(rel <= tol, f"{name}: gradient {i} differs from {ref}")

    def public(name, loss, x, dur, labels, il, ll, durations, instances, cut=None, f64=False):
        """The public loss under the counters, against the plain route on the
        first ``cut`` utterances (all by default), in f64 with ``f64``."""
        got = counted(name, lambda: many_step(loss, x, dur, labels, il, ll, durations),
                      instances)
        fail_unless(bool((got[0] < 1e29).all()), f"{name}: an utterance is infeasible")
        b = cut or x.shape[0]

        def part(t):
            return (t[:b].double() if f64 else t[:b]) if t.is_floating_point() else t[:b]

        want = many_step(loss, part(x), part(dur), labels[:b], il[:b], ll[:b], durations,
                         "torch")
        got = (got[0][:b], tuple(g[:b] for g in got[1]))
        check(name, got, want, f"plain{' (f64)' if f64 else ''} on {b} utterances")

    # The losses on logits. TDT 0 … 8 at both duration shapes; the rest at headline.
    for tag, B, T, L, V in DURATION_SHAPES:
        acts, dur, labels, il, ll = many_problem(B, T, L, V, len(MANY_TDT), 0, 30, dev)
        public(f"tdt_d9 {tag}", "tdt", acts, dur, labels, il, ll, MANY_TDT,
               {"window_stream": f"table_tdt_d9_{tag}"},
               **(dict(cut=MANY_CUT_B, f64=True) if tag == "long_t" else {}))
        del acts, dur
    _, B, T, L, V = DURATION_SHAPES[0]
    acts, dur, labels, il, ll = many_problem(B, T, L, V, len(WIDEST_TDT), len(WIDEST_MB), 31, dev)
    public("tdt_d33 headline", "tdt", acts, dur, labels, il, ll, WIDEST_TDT,
           {"window_stream": "table_tdt_d33_headline"}, cut=MANY_CUT_WIDEST)
    many = {k: "many_k9_headline" for k in ("prep", "grad_fields")}
    public("multiblank_k9 headline", "multiblank", acts, dur, labels, il, ll, MANY_MB,
           many | {"window_stream": "table_mb_k9_headline"})
    lp = torch.log_softmax(acts, -1)
    public("multiblank_lp_k9 headline", "multiblank_lp", lp, dur, labels, il, ll, MANY_MB,
           {k: "many_k9_log_probs_headline" for k in ("prep", "grad_fields")}
           | {"window_stream": "table_mb_k9_headline"}, cut=MANY_CUT_WIDEST, f64=True)
    public("multiblank_k16 headline", "multiblank", acts, dur, labels, il, ll, WIDEST_MB,
           {k: "many_k16_headline" for k in ("prep", "grad_fields")}
           | {"window_stream": "table_mb_k16_headline"}, cut=MANY_CUT_WIDEST)
    del lp
    tag, B, T, L, V, durs = LONG_WINDOW
    w_acts, w_dur, w_labels, w_il, w_ll = many_problem(B, T, L, V, 1, len(durs), 32, dev)
    public(f"multiblank_{tag} B={B} T={T} U={L + 1}", "multiblank", w_acts, w_dur, w_labels,
           w_il, w_ll, durs, {"window_stream": f"table_{tag}_rings_in_device"}, cut=MANY_CUT_B,
           f64=True)
    with torch.no_grad():
        p = kprep.prepare(w_acts, w_labels, 0, False, extra_cols=tuple(range(V - len(durs), V)))
        plan = kwindow.lattice_plan(p.lpb, p.extras, window.multiblank_arcs(durs))
        print(f"window_stream {tag}: plan {plan._asdict()}")
        fail_unless(plan.wide == kwindow.TABLE and plan.rings > 0,
                    f"the {tag} window is not planned with its rings in device memory")
    torch.cuda.empty_cache()

    # The fused losses at the fused shape, D = 9 on both routes and K = 9.
    ftag, FB, FT, FL, FV, FH = FUSED_SHAPE
    joint = make_joint_module(FV, FH, seed=33, dev=dev, durations=MANY_TDT)
    enc, pred, f_labels, f_il, f_ll = make_model_problem(FB, FT, FL, FV, seed=34, dev=dev,
                                                         cfg=joint.cfg, n_cols=len(MANY_MB))

    def tdt_fused_step(implementation="auto"):
        loss, grads = joint_step(joint, lambda a, b: joint.tdt_fused_loss(
            a, b, f_labels, f_il, f_ll, reduction="sum", sigma=VARIANT_SIGMA,
            implementation=implementation), enc, pred)
        return loss, tuple(g for g in grads.values() if g is not None)

    def mb_fused_step(implementation="auto"):
        loss, grads = joint_step(joint, lambda a, b: joint.multiblank_fused_loss(
            a, b, f_labels, f_il, f_ll, MANY_MB, reduction="sum", sigma=VARIANT_SIGMA,
            implementation=implementation), enc, pred)
        return loss, tuple(g for g in grads.values() if g is not None)

    old = tdt_fused._tdt_single_chunk
    try:
        routes = {}
        for integrated in (True, False):
            set_tdt_route(integrated)
            route = "integrated" if integrated else "composed"
            inst = ({k: f"many_d9_{ftag}" for k in ("joint_prep", "joint_grad")} if integrated
                    else {"dur_head": f"groups_d9_{ftag}"})
            routes[route] = counted(f"tdt_fused_d9 {ftag} {route}", tdt_fused_step,
                                    inst | {"window_stream": f"table_tdt_d9_{ftag}"},
                                    ("joint_prep", "joint_grad"))
        plain = tdt_fused_step("torch")
    finally:
        tdt_fused._tdt_single_chunk = old
    for route, got in routes.items():
        check(f"tdt_fused_d9 {ftag} {route}", got, plain, "the plain path")
    got = counted(f"multiblank_fused_k9 {ftag}", mb_fused_step,
                  {k: f"many_k9_{ftag}" for k in ("joint_prep", "joint_grad")}
                  | {"window_stream": f"table_mb_k9_{ftag}"})
    check(f"multiblank_fused_k9 {ftag}", got, mb_fused_step("torch"), "the plain path")
    del routes, plain, got
    torch.cuda.empty_cache()

    # The whole model at TransducerConfig()'s widths with durations 0 … 8.
    cfg = tm.TransducerConfig(**MANY_TRAIN_CFG)
    integrated = bool(tdt_fused._tdt_single_chunk(None, None, None))
    maker, kw, _, kernels = TRAIN_STEPS["tdt_fused"]
    kernels = kernels + (() if integrated else ("dur_head",))
    train, model = train_step_check(dev, totals, "tdt_fused_d9", maker, kw, cfg, kernels, 35,
                                    TRAIN_ADAM_STEPS, keep_model=True)
    _, TB, TT, TL = TRAIN_SHAPE
    batch = make_train_batch(TB, TT, TL, cfg.vocab_size, 36, dev, cfg.input_dim)
    max_symbols = 2 * TL
    decode = lambda: D.greedy_decode_tdt(model, batch["feats"], batch["feat_lengths"],  # noqa: E731
                                         max_symbols)
    torch.cuda.set_sync_debug_mode("error")  # any host sync in the decode raises
    try:
        out = decode()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check_hypotheses("greedy_tdt_d9", "tdt", out, cfg.vocab_size, max_symbols)
    train["greedy_decode_ms"] = time_ms(decode, 3, 1)
    print(f"serve greedy_tdt_d9 B={TB} T={TT} V={cfg.vocab_size}: {train['greedy_decode_ms']:.4f} "
          f"ms a call; hypotheses' lengths {out[1].tolist()[:8]} …")
    del model, batch, out
    torch.cuda.empty_cache()

    # The timings: each new instance (profiler device ms a launch) beside the
    # by-value instance at the same shape.
    def max_err(got, want):
        """The largest |got − want| over the fields of two results, at the
        cells the plain version holds finite (NEG elsewhere in both)."""
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        e = 0.0
        for a, b in pairs:
            if a is not None and b is not None:
                live = b.abs() < 1e29
                if bool(live.any()):
                    e = max(e, float((a.double() - b.double())[live].abs().max()))
        return e

    def timed(kernel, case, fn, names, bound_, plain_fn=None, library_fn=None):
        """The kernel's device ms a launch (profiler), and where the plain
        version runs, its time and the kernel's largest error against it."""
        dev_ms = launch_device_ms(fn, iters=5, names=names)
        t = timings[kernel][case] = dict(
            ms=dev_ms if dev_ms is not None else time_ms(fn, 5), kernel_device_ms=dev_ms,
            plain_ms=None, library_ms=time_ms(library_fn, 5) if library_fn else None,
            bound=bound_)
        if plain_fn:  # once, by the host clock (its lattices take seconds at these shapes)
            got = fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain_fn()
            torch.cuda.synchronize()
            t["plain_ms"] = (time.perf_counter() - t0) * 1e3
            t["max_abs_err"] = max_err(got, want)
            errs[kernel] = max(errs[kernel], t["max_abs_err"])
            del got, want
        print(f"time {case} {kernel}: {t['ms']:.4f} ms (a launch) | plain "
              f"{t['plain_ms'] if t['plain_ms'] is None else round(t['plain_ms'], 4)} ms | "
              f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]}) | library {t['library_ms']}"
              f" | largest error against the plain version {t.get('max_abs_err')}")

    def call_timed(kernel, case, fn, bound_, plain_fn=None, library_fn=None):
        dev_ms = device_ms(fn, iters=3)
        t = timings[kernel][case] = dict(
            ms=dev_ms if dev_ms is not None else time_ms(fn, 3), kernel_device_ms=dev_ms,
            plain_ms=time_ms(plain_fn, 1, 1) if plain_fn else None,
            library_ms=time_ms(library_fn, 3) if library_fn else None, bound=bound_)
        print(f"time {case} {kernel}: {t['ms']:.4f} ms (device ms a call) | plain "
              f"{t['plain_ms']} ms | bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")

    table, warp = ("window_table_kernel",), ("window_warp_kernel",)
    with torch.no_grad():
        for tag, B, T, L, V in DURATION_SHAPES:
            acts, dur, labels, il, ll = many_problem(B, T, L, V, len(MANY_TDT), 0, 30, dev)
            p = kprep.prepare(acts, labels, 0, False)
            for name, durs, names in (("tdt_d9", MANY_TDT, table),
                                      ("tdt_d4", TDT_DURATIONS, warp)):
                lpd = torch.log_softmax(dur[..., :len(durs)], -1).contiguous()
                arcs = window.tdt_arcs(durs)
                fn = lambda: kwindow.forward_backward(p.lpb, p.lpe, lpd, arcs, il, ll)  # noqa: E731
                # the plain lattice (seconds a call) once, at the new instance's headline
                plain_fn = ((lambda: window.forward_backward(p.lpb, p.lpe, lpd, arcs, il, ll))
                            if tag == "headline" and name == "tdt_d9" else None)
                timed("window_stream", f"{name}_{tag}", fn, names,
                      window_bound(p.lpb, lpd, arcs, il, ll), plain_fn)
            del acts, dur, p, lpd
        _, B, T, L, V = DURATION_SHAPES[0]
        U, rows = L + 1, B * T * (L + 1)
        acts, dur, labels, il, ll = many_problem(B, T, L, V, len(WIDEST_TDT), len(WIDEST_MB),
                                                 31, dev)
        lp = torch.log_softmax(acts, -1)
        labels_u = prep.label_rows(labels, U)
        n_big = acts.numel()
        for K_ in (9, 2):
            cols = tuple(range(V - K_, V))
            suffix = f"k{K_}_headline"
            many_inst = K_ > 8
            p_names = (("prep_many_tile_kernel", "prep_many_warp_kernel") if many_inst
                       else ("prep_tile_kernel", "prep_warp_kernel"))
            g_names = (("grad_many_tile_kernel", "grad_many_warp_kernel") if many_inst
                       else ("grad_fields_tile_kernel", "grad_fields_warp_kernel"))
            timed("prep", suffix, lambda: kprep.prepare(acts, labels, 0, False, extra_cols=cols),
                  p_names, bound(n_big * 4 + B * L * 4 + (3 + K_) * rows * 4, 4 * n_big,
                                 F32_OPS_PER_S),
                  lambda: prep.prepare(acts, labels, 0, False, extra_cols=cols),
                  lambda: torch.logsumexp(acts, -1))
            idx = torch.cat([torch.zeros((B, T, U, 1), dtype=torch.long, device=dev),
                             labels_u.long()[:, None, :, None].expand(B, T, U, 1),
                             torch.arange(V - K_, V, device=dev).expand(B, T, U, K_)], -1)
            timed("prep", f"{suffix}_log_probs",
                  lambda: kprep.prepare(lp, labels, 0, True, extra_cols=cols), p_names,
                  bound(2 * (2 + K_) * rows * 4 + B * L * 4, 0, F32_OPS_PER_S),
                  lambda: prep.prepare(lp, labels, 0, True, extra_cols=cols),
                  lambda: torch.gather(lp, 3, idx))
            pr = kprep.prepare(acts, labels, 0, False, extra_cols=cols)
            arcs = window.multiblank_arcs(tuple(range(2, 2 + K_)) if K_ > 2 else MB_DURATIONS)
            lat = kwindow.forward_backward(pr.lpb, pr.lpe, pr.extras, arcs, il, ll)
            fields = gradients.coefficients(pr.lpb, pr.lpe, lat.alphas, lat.betas,
                                            lat.ll_forward, il, ll)
            extra = pr.extras.exp().contiguous()
            kw = dict(extra_cols=cols, extra_fields=extra)
            timed("grad_fields", suffix, lambda: kgrad.dense_grad(
                acts, pr.denom, fields, labels_u, il, ll, 0, acts.dtype, **kw), g_names,
                bound(2 * n_big * 4 + (4 + K_) * rows * 4, 3 * n_big, F32_OPS_PER_S),
                lambda: gradients.dense_grad(acts, pr.denom, fields, labels_u, il, ll, 0,
                                             acts.dtype, **kw))
            timed("grad_fields", f"{suffix}_sparse", lambda: kgrad.sparse_grad(
                fields, labels_u, il, ll, 0, V, acts.dtype, **kw), g_names,
                bound(n_big * 4 + (3 + K_) * rows * 4, 0, F32_OPS_PER_S),
                lambda: gradients.sparse_grad(fields, labels_u, il, ll, 0, V, acts.dtype, **kw))
            timed("window_stream", f"mb_{suffix}",
                  lambda: kwindow.forward_backward(pr.lpb, pr.lpe, pr.extras, arcs, il, ll),
                  table if K_ > 2 else warp, window_bound(pr.lpb, pr.extras, arcs, il, ll))
            del pr, lat, fields, extra, idx
        p = kprep.prepare(acts, labels, 0, False)
        lpd = torch.log_softmax(dur, -1).contiguous()
        arcs = window.tdt_arcs(WIDEST_TDT)
        timed("window_stream", "tdt_d33_headline",
              lambda: kwindow.forward_backward(p.lpb, p.lpe, lpd, arcs, il, ll), table,
              window_bound(p.lpb, lpd, arcs, il, ll))
        pr = kprep.prepare(acts, labels, 0, False, extra_cols=tuple(range(V - 16, V)))
        arcs = window.multiblank_arcs(WIDEST_MB)
        timed("window_stream", "mb_k16_headline",
              lambda: kwindow.forward_backward(pr.lpb, pr.lpe, pr.extras, arcs, il, ll), table,
              window_bound(pr.lpb, pr.extras, arcs, il, ll))
        del pr
        del acts, dur, lp, p, lpd
        tag, B, T, L, V, durs = LONG_WINDOW
        cols = tuple(range(V - len(durs), V))
        p = kprep.prepare(w_acts, w_labels, 0, False, extra_cols=cols)
        for name, ds, names in ((f"{tag}_rings_in_device", durs, table),
                                (f"mb_k2_{tag}_shape", MB_DURATIONS, warp)):
            ex = p.extras[..., :len(ds)].contiguous()
            arcs = window.multiblank_arcs(ds)
            timed("window_stream", name,
                  lambda: kwindow.forward_backward(p.lpb, p.lpe, ex, arcs, w_il, w_ll), names,
                  window_bound(p.lpb, ex, arcs, w_il, w_ll))
        del p, ex, w_acts, w_dur
        torch.cuda.empty_cache()
        # K6a/K6b (K = 9 beside K = 2, D = 9 beside D = 4) and K6c/K6d (D = 9
        # beside D = 4) at the fused shape, f32.
        problem = make_joint_problem(FB, FT, FL, FV, FH, seed=37, dev=dev, n_cols=9)
        e, p, W, bias, labels, il, ll = problem
        rows = int((il.long() * (ll.long() + 1)).sum())
        g = torch.Generator(device=dev).manual_seed(38)
        args = (e, p, W, bias, labels, il, ll, 0)
        denom = kjoint.fused_prep(*args).denom
        f = [torch.rand((FB, FT, FL + 1), generator=g, device=dev)
             * gradients._valid_cells((FB, FT, FL + 1), il, ll, dev) for _ in range(3 + 9)]
        fields = gradients.Coefficients(*f[:3])
        in_bytes = sum(x.numel() * x.element_size() for x in (e, p, W, bias))
        small = FB * FT * (FL + 1) * 4
        for n in (9, 2):
            cols = tuple(range(FV - n, FV))
            cX = torch.stack(f[3:3 + n], -1)
            call_timed("joint_prep", f"k{n}_{ftag}",
                       lambda: kjoint.fused_prep(*args, extra_cols=cols),
                       bound(in_bytes + 3 * small + rows * n * 4, 2 * rows * FH * FV,
                             TF32X3_OPS_PER_S))
            call_timed("joint_grad", f"k{n}_{ftag}",
                       lambda: kjoint.fused_grad(*args[:-1], denom, fields, 0,
                                                 extra=(cols, cX)),
                       bound(2 * in_bytes + 4 * small + rows * n * 4, 6 * rows * FH * FV,
                             TF32X3_OPS_PER_S))
        for n in (9, 4):
            Wd = torch.randn((FH, n), generator=g, device=dev) / FH ** 0.5
            bias_d = torch.randn((n,), generator=g, device=dev) * 0.1
            gd = torch.stack(f[3:3 + n], -1) - 0.5 * f[0][..., None]
            head = (Wd.numel() + n) * 4
            call_timed("joint_prep", f"d{n}_{ftag}",
                       lambda: kjoint.fused_prep(*args, dur_head=(Wd, bias_d)),
                       bound(in_bytes + 3 * small + rows * n * 4 + head,
                             2 * rows * FH * (FV + n), TF32X3_OPS_PER_S))
            call_timed("joint_grad", f"d{n}_{ftag}",
                       lambda: kjoint.fused_grad(*args[:-1], denom, fields, 0,
                                                 dur_head=(Wd, gd)),
                       bound(2 * in_bytes + 4 * small + rows * n * 4 + 2 * head,
                             6 * rows * FH * FV + 4 * rows * FH * n, TF32X3_OPS_PER_S))
            ep = (e.numel() + p.numel()) * 4
            call_timed("dur_head", f"prep_d{n}_{ftag}",
                       lambda: kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll),
                       tanh_bound(ep + head + rows * n * 4, rows * FH, 1 + n),
                       lambda: fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll))
            call_timed("dur_head", f"grad_d{n}_{ftag}",
                       lambda: kjoint.dur_head_grad(e, p, Wd, gd, il, ll),
                       tanh_bound(2 * ep + 2 * Wd.numel() * 4 + rows * n * 4, rows * FH,
                                  5 + 2 * n),
                       lambda: fused_joint.dur_head_grad(e, p, Wd, gd, il, ll))
        del problem, e, p, W, f, fields, denom
    torch.cuda.empty_cache()
    print(f"many durations phase: {time.perf_counter() - started:.1f} s")
    return timings, launches, train


def log_probs_reference(tag, lp, dur, labels, il, ll, costs, grads, costs_p, grads_p):
    """The reference of the multi-blank step on log-probs: the plain route
    in f64 on the same log-probs. Its f32 gradient is a sparse set of arc
    posteriors exp(α + β − ll), which the f32 lattice's rounding moves by up
    to 7.4e-4 of the gradient's norm at long_t in the plain route and 6.1e-4
    in the kernels' (PERF.md §6), so the two f32 routes are compared
    here (printed) and each against the f64 route. The kernel route in f64 is
    held to the f64 plain route at f64 tolerance (costs rtol / atol 1e-10,
    the gradient's relative norm 1e-9). Returns the f64 plain route's costs
    and gradients."""
    rel32 = rel_norm(grads["log_probs"], grads_p["log_probs"])
    print(f"multiblank_lp {tag}: the kernel and the plain route in f32: costs max abs "
          f"{float((costs - costs_p).abs().max()):.3e}, gradient relative norm {rel32:.3e} "
          "(printed)")
    x64 = lp.detach().double().requires_grad_(True)
    costs_64, grads_64 = duration_step("multiblank_lp", x64, dur, labels, il, ll, "torch")
    grads_64 = {n: g.clone() for n, g in grads_64.items()}
    costs_k64, grads_k64 = duration_step("multiblank_lp", x64, dur, labels, il, ll)
    torch.cuda.synchronize()
    compare(f"multiblank_lp costs {tag} kernels vs plain, both f64", costs_k64, costs_64, "f64")
    g_k, g_p = grads_k64["log_probs"], grads_64["log_probs"]
    rel64 = float((g_k - g_p).norm() / g_p.norm())
    print(f"multiblank_lp grads {tag} kernels vs plain, both f64: relative norm error "
          f"{rel64:.3e} (tol 1e-9)")
    fail_unless(rel64 <= 1e-9, f"the f64 kernel and plain routes differ (multiblank_lp {tag})")
    print(f"multiblank_lp grads {tag} plain f32 vs plain f64: relative norm error "
          f"{rel_norm(grads_p['log_probs'], grads_64['log_probs']):.3e} (printed)")
    return costs_64, grads_64


def duration_timings(problems):
    """The three steps (CUDA events, device breakdown) and, at both shapes:
    the window kernel for each family, prep and grad with K = 2 (on raw
    activations, and on log-probs: prep's log-probs mode, grad's sparse
    fields mode), the coefficient passes. Returns ({kernel: {case:
    timing}}, {case: step ms})."""
    from warp_transducer_tpu_torch.ops import gradients, multiblank, prep, rnnt, tdt, window
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    from warp_transducer_tpu_torch.ops.cuda import build
    out, step_ms = {"window_stream": {}, "prep": {}, "grad_fields": {}}, {}
    clock_mhz = sm_clock_mhz()
    window_steps = window_step_instructions(build.build())
    print(f"window_stream: SASS instructions a row step (alpha, beta) {window_steps} "
          f"((element bytes, cells a lane, wide): counts); SM clock {clock_mhz} MHz")
    for tag, B, T, L, V in DURATION_SHAPES:
        acts, dur, labels, il, ll, lp = problems[tag]
        U = L + 1
        long_t = tag == "long_t"
        iters, plain_iters = (5, 1) if long_t else (20, 2)
        for loss in ("multiblank", "multiblank_lp", "tdt"):
            x = lp if loss == "multiblank_lp" else acts
            step = lambda: duration_step(loss, x, dur, labels, il, ll)  # noqa: E731
            step_ms[f"{loss}_{tag}"] = ms = time_ms(step, iters)
            print(f"time {loss} {tag} B={B} T={T} L={L} V={V}: step {ms:.4f} ms")
            device_breakdown(f"{loss} {tag} step", step, ms, top=8)
        with torch.no_grad():
            a = acts.detach()
            cols = (V - 2, V - 1)
            n_big, n_small, elt = B * T * U * V, B * T * U, a.element_size()
            valid_cells = int((il.long() * (ll.long() + 1)).sum())
            p = kprep.prepare(a, labels, 0, False, extra_cols=cols)
            lpd = torch.log_softmax(dur.detach(), -1)
            mb_arcs, tdt_arcs = window.multiblank_arcs(MB_DURATIONS), window.tdt_arcs(TDT_DURATIONS)
            cases = {"multiblank": (mb_arcs, p.extras), "tdt": (tdt_arcs, lpd)}
            lats = {}
            for loss, (arcs, extra) in cases.items():
                C = extra.shape[-1]
                lats[loss] = kwindow.forward_backward(p.lpb, p.lpe, extra, arcs, il, ll)
                win_k = lambda: kwindow.forward_backward(p.lpb, p.lpe, extra, arcs, il, ll)  # noqa: E731
                plan = kwindow.lattice_plan(p.lpb, extra, arcs)
                floor, step_n = window_chain_floor(window_steps, 4, plan, il, clock_mhz)
                v = out["window_stream"][f"{loss}_{tag}"] = dict(
                    ms=time_ms(win_k, iters), kernel_device_ms=launch_device_ms(win_k),
                    plain_ms=time_ms(lambda: window.forward_backward(p.lpb, p.lpe, extra, arcs,
                                                                     il, ll), plain_iters, 0),
                    library_ms=None,
                    # Data-dependent: the channels are read at valid cells only;
                    # every cell of alphas and betas is written.
                    bound=window_bound(p.lpb, extra, arcs, il, ll),
                    registers=kwindow.kernel_registers(plan, p.lpb.dtype),
                    step_instructions=step_n, chain_floor_ms=floor)
                per_row = v["kernel_device_ms"] or v["ms"]
                print(f"time {tag} window_stream {loss}: {per_row * 1e3 / T:.3f} us a row of "
                      f"U={U} (both directions side by side; plan {plan._asdict()}); the kernel "
                      f"a launch {v['kernel_device_ms']} ms (profiler), chain floor {floor} ms "
                      f"({step_n} SASS instructions a row step), registers, local bytes "
                      f"{v['registers']}")
            prep_k = lambda: kprep.prepare(a, labels, 0, False, extra_cols=cols)  # noqa: E731
            out["prep"][f"{tag}_k2"] = dict(
                ms=time_ms(prep_k, iters), device_ms=device_ms(prep_k),
                kernel_device_ms=launch_device_ms(prep_k),
                plain_ms=time_ms(lambda: prep.prepare(a, labels, 0, False, extra_cols=cols),
                                 plain_iters, 1),
                library_ms=time_ms(lambda: torch.logsumexp(a, -1), iters),
                bound=bound(n_big * elt + B * U * 4 + 5 * n_small * 4, 4 * n_big, F32_OPS_PER_S))
            coef, cb, ce, cBs = multiblank._mb_coefs(p.lpb, p.lpe, p.extras, lats["multiblank"],
                                                     MB_DURATIONS, il, ll)
            fields, extra_f = gradients.Coefficients(coef, cb, ce), torch.stack(cBs, dim=-1)
            g_args = (a, p.denom, fields, prep.label_rows(labels, U), il, ll, 0, a.dtype)
            out["grad_fields"][f"multiblank_{tag}_k2"] = dict(
                ms=time_ms(lambda: kgrad.dense_grad(*g_args, extra_cols=cols, extra_fields=extra_f),
                           iters),
                plain_ms=time_ms(lambda: gradients.dense_grad(*g_args, extra_cols=cols,
                                                              extra_fields=extra_f), plain_iters, 1),
                library_ms=time_ms(lambda: torch.softmax(a, -1), iters),
                bound=bound((n_big + valid_cells * V) * elt + 6 * valid_cells * 4 + B * U * 4
                            + 2 * B * 4, 4 * valid_cells * V, F32_OPS_PER_S))
            # On log-probs: prep reads the blank, label and K columns as given
            # (no reduction) and writes lpb, lpe and the K extras; the sparse
            # gradient writes every element and reads cb, ce and the K
            # posteriors of the valid rows. Neither has a single library call.
            lp_in = lp.detach()
            prep_lp = lambda: kprep.prepare(lp_in, labels, 0, True, extra_cols=cols)  # noqa: E731
            out["prep"][f"{tag}_lp_k2"] = dict(
                ms=time_ms(prep_lp, iters), device_ms=device_ms(prep_lp),
                kernel_device_ms=launch_device_ms(prep_lp),
                plain_ms=time_ms(lambda: prep.prepare(lp_in, labels, 0, True, extra_cols=cols),
                                 plain_iters, 1),
                library_ms=None,
                bound=bound(4 * n_small * lp_in.element_size() + B * U * 4 + 4 * n_small * 4,
                            4 * n_small, F32_OPS_PER_S))
            lpb_l, lpe_l, lpB_l, _ = multiblank._multiblank_prep(rnnt._KERNELS, lp_in, labels, 0,
                                                                cols, MB_SIGMA, True)
            lat_l = kwindow.forward_backward(lpb_l, lpe_l, lpB_l, mb_arcs, il, ll)
            coef_l, cb_l, ce_l, cBs_l = multiblank._mb_coefs(lpb_l, lpe_l, lpB_l, lat_l,
                                                             MB_DURATIONS, il, ll)
            s_args = (gradients.Coefficients(coef_l, cb_l, ce_l), prep.label_rows(labels, U), il,
                      ll, 0, V, lp_in.dtype)
            s_kw = dict(extra_cols=cols, extra_fields=torch.stack(cBs_l, dim=-1))
            sparse_k = lambda: kgrad.sparse_grad(*s_args, **s_kw)  # noqa: E731
            out["grad_fields"][f"multiblank_lp_{tag}_k2"] = dict(
                ms=time_ms(sparse_k, iters), device_ms=device_ms(sparse_k),
                kernel_device_ms=launch_device_ms(sparse_k),
                plain_ms=time_ms(lambda: gradients.sparse_grad(*s_args, **s_kw), plain_iters, 1),
                library_ms=None,
                bound=bound(n_big * lp_in.element_size() + 4 * valid_cells * 4 + B * U * 4
                            + 2 * B * 4, 0, F32_OPS_PER_S))
            del lat_l, coef_l, cb_l, ce_l, cBs_l, s_args, s_kw, lpb_l, lpe_l, lpB_l
            coef_ms = {
                "multiblank": time_ms(lambda: multiblank._mb_coefs(
                    p.lpb, p.lpe, p.extras, lats["multiblank"], MB_DURATIONS, il, ll), iters),
                "tdt": time_ms(lambda: tdt._tdt_coefs(p.lpb, p.lpe, lpd, lats["tdt"], TDT_DURATIONS,
                                                      il, ll), iters)}
            print(f"time {tag}: coefficient passes (plain torch on {n_small} cells) multiblank "
                  f"{coef_ms['multiblank']:.4f} ms, tdt {coef_ms['tdt']:.4f} ms "
                  f"(valid cells {valid_cells / n_small:.3f} of B·T·U)")
            for k, cases_k in out.items():
                for case, v in cases_k.items():
                    if tag not in case:
                        continue
                    lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
                    print(f"time {case} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                          f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {lib}"
                          + (f" | device ms {v['device_ms']}, the kernel alone "
                             f"{v['kernel_device_ms']} (profiler)" if "device_ms" in v else ""))
            del p, lpd, lats, fields, extra_f, g_args, coef, cb, ce, cBs, a, lp_in
        torch.cuda.empty_cache()
    return out, step_ms


# The fused duration-arc losses run at the fused shape with the settings of
# the unfused ones above: K = 2 big blanks of 2 and 4 frames on the last two
# columns, sigma 0.05; D = 4 durations 0, 1, 2, 4, sigma 0.05 (the JAX
# package's bench.py:478 and :494). On the awkward shape the blank is column
# V - 3, in the last, partial tile of V beside the two big blanks.
VARIANT_CASES = [(FUSED_SHAPE, torch.float32, 0), (FUSED_SHAPE, torch.bfloat16, 0),
                 (AWKWARD_SHAPE, torch.float32, AWKWARD_SHAPE[4] - 3),
                 (AWKWARD_SHAPE, torch.bfloat16, AWKWARD_SHAPE[4] - 3)]
VARIANT_SIGMA = 0.05


def make_dur_head(H, seed, dev):
    """Wd (H, D) ~ N(0, 1/H) and bias_d (D,) in f32, from a seed, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = len(TDT_DURATIONS)
    return (torch.randn((H, D), generator=g, device=dev) / H ** 0.5,
            torch.randn((D,), generator=g, device=dev) * 0.1)


def variant_fields(problem, blank, Wd, bias_d):
    """What the two fused duration-arc steps hand their gradient kernels
    (kernels, unit cotangent, sigma as above): for the multi-blank loss the
    coefficient fields and the K = 2 big-blank fields cX, for the TDT loss
    the coefficient fields and the duration head's cotangent g_dur; and the
    denominator both share."""
    from warp_transducer_tpu_torch.ops import gradients, multiblank, tdt, window
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    e, p, W, bias, labels, il, ll = problem
    V = W.shape[1]
    cols = (V - 2, V - 1)
    with torch.no_grad():
        pr = kjoint.fused_prep(e, p, W, bias, labels, il, ll, blank, extra_cols=cols,
                               dur_head=(Wd, bias_d))
        lpb, lpe = pr.lpb - VARIANT_SIGMA, torch.clamp_min(pr.lpe - VARIANT_SIGMA, -1.0e30)
        lpB = pr.extras - VARIANT_SIGMA
        lat = kwindow.forward_backward(lpb, lpe, lpB, window.multiblank_arcs(MB_DURATIONS), il, ll)
        coef, cb, ce, cBs = multiblank._mb_coefs(lpb, lpe, lpB, lat, MB_DURATIONS, il, ll)
        mb = (gradients.Coefficients(coef.contiguous(), cb.contiguous(), ce.contiguous()),
              torch.stack(cBs, dim=-1))
        lpd = torch.log_softmax(pr.dur, dim=-1)
        lat = kwindow.forward_backward(lpb, lpe, lpd, window.tdt_arcs(TDT_DURATIONS), il, ll)
        coef, cb, ce, cb_js, ce_js = tdt._tdt_coefs(lpb, lpe, lpd, lat, TDT_DURATIONS, il, ll)
        g_dur = coef[..., None] * torch.exp(lpd) - torch.stack(
            [cb_js[j] + ce_js[j] for j in range(len(TDT_DURATIONS))], dim=-1)
        td = (gradients.Coefficients(coef.contiguous(), cb.contiguous(), ce.contiguous()),
              g_dur.contiguous())
    return pr.denom, cols, mb, td


def check_fused_grads(name, got, want, dtype, errs):
    """The fused gradients by relative norm error (dWd, which never sees a
    rounded h, at the f32 tolerance), and in f32 also elementwise."""
    for f, g, w in zip(("de", "dp", "dW", "db", "dWd"), got, want):
        tol = FUSED_GRAD_REL[torch.float32 if f == "dWd" else dtype]
        rel = rel_norm(g, w)
        print(f"{name} {f}: relative norm error {rel:.3e} (tol {tol:g})")
        fail_unless(rel <= tol and bool(torch.isfinite(g.float()).all()),
                    f"{name} {f}: kernel disagrees with its plain version")
        if dtype == torch.float32:
            rtol, share = FUSED_GRAD_ELEMENTWISE
            key = "dur_head" if name.startswith("dur_head") else "joint_grad"
            errs[key] = max(errs[key], compare(f"{name} {f}", g, w,
                                               (rtol, grad_tol(w, "f32", share)[1])))


def variant_kernels_vs_plain(dev, errs):
    """joint_prep and joint_grad with K = 2 extra columns and with the D = 4
    duration head, and the standalone duration-head pair, against their
    plain versions: at the fused shape and at the awkward one, f32 and
    bf16 e, p, W."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    for (tag, B, T, L, V, H), dtype, blank in VARIANT_CASES:
        problem = make_joint_problem(B, T, L, V, H, seed=15, dev=dev, dtype=dtype, blank=blank,
                                     n_cols=2)
        e, p, W, bias, labels, il, ll = problem
        Wd, bias_d = make_dur_head(H, 16, dev)
        f32 = dtype == torch.float32
        name = f"{tag} {dtype}"
        denom, cols, (mb_fields, cX), (td_fields, g_dur) = variant_fields(problem, blank, Wd, bias_d)
        args = (e, p, W, bias, labels, il, ll, blank)
        for hook, kw in (("K=2", {"extra_cols": cols}), ("D=4", {"dur_head": (Wd, bias_d)})):
            p_k = kjoint.fused_prep(*args, **kw)
            torch.cuda.synchronize()
            p_p = fused_joint.fused_prep(*args, **kw)
            out = [("lpb", p_k.lpb, p_p.lpb, FUSED_PREP_TOL[dtype]),
                   ("lpe", p_k.lpe, p_p.lpe, FUSED_PREP_TOL[dtype]),
                   ("denom", p_k.denom, p_p.denom, FUSED_PREP_TOL[dtype])]
            if hook == "K=2":
                out.append(("lpX", p_k.extras, p_p.extras, FUSED_PREP_TOL[dtype]))
            else:  # the duration logits never see the rounded h: f32 tolerance for both
                out.append(("dlog", p_k.dur, p_p.dur, "f32"))
            err = max(compare(f"joint_prep {hook} {name} {f}", a, b, tol) for f, a, b, tol in out)
            if f32:
                errs["joint_prep"] = max(errs["joint_prep"], err)
            del p_k, p_p, out
        g_args = args[:-1] + (denom,)
        for hook, fields, kw in (("K=2", mb_fields, {"extra": (cols, cX)}),
                                 ("D=4", td_fields, {"dur_head": (Wd, g_dur)})):
            g_k = kjoint.fused_grad(*g_args, fields, blank, **kw)
            torch.cuda.synchronize()
            g_p = fused_joint.fused_grad(*g_args, fields, blank, **kw)
            check_fused_grads(f"joint_grad {hook} {name}", g_k, g_p, dtype, errs)
            del g_k, g_p
        d_k = kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll)
        torch.cuda.synchronize()
        d_p = fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll)
        err = compare(f"dur_head prep {name}", d_k, d_p, "f32")
        if f32:
            errs["dur_head"] = max(errs["dur_head"], err)
        g_k = kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll)
        torch.cuda.synchronize()
        g_p = fused_joint.dur_head_grad(e, p, Wd, g_dur, il, ll)
        # de2 and dp2 come back in the type of e and p: one more bf16 rounding.
        for f, g, w in zip(("de2", "dp2", "dWd"), g_k, g_p):
            tol = FUSED_GRAD_REL[torch.float32 if f == "dWd" else dtype]
            rel = rel_norm(g, w)
            print(f"dur_head grad {name} {f}: relative norm error {rel:.3e} (tol {tol:g})")
            fail_unless(rel <= tol and bool(torch.isfinite(g.float()).all()),
                        f"dur_head grad {name} {f}: kernel disagrees with its plain version")
            if f32:
                rtol, share = FUSED_GRAD_ELEMENTWISE
                errs["dur_head"] = max(errs["dur_head"], compare(
                    f"dur_head grad {name} {f}", g, w, (rtol, grad_tol(w, "f32", share)[1])))
        del d_k, d_p, g_k, g_p, problem, denom, mb_fields, cX, td_fields, g_dur
        torch.cuda.empty_cache()


def set_tdt_route(integrated):
    """Patch the route predicate of ops/tdt_fused.py; returns the old one."""
    from warp_transducer_tpu_torch.ops import tdt_fused
    old = tdt_fused._tdt_single_chunk
    tdt_fused._tdt_single_chunk = lambda e, p, W: integrated
    return old


def variant_main_path(dev, totals):
    """``Joint.multiblank_fused_loss`` and ``Joint.tdt_fused_loss`` (on both
    of its routes) forward and backward at the fused shape under the launch
    counters, with no host sync allowed, each held against
    implementation="torch" and against its unfused composition
    (``Joint.forward`` → ``rnnt_loss_multiblank``; ``Joint.tdt`` →
    ``rnnt_loss_tdt``), the two TDT routes against each other. Returns the
    step functions for the timings."""
    from warp_transducer_tpu_torch import rnnt_loss_multiblank, rnnt_loss_tdt
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import tdt_fused
    tag, B, T, L, V, H = FUSED_SHAPE
    joint = make_joint_module(V, H, seed=17, dev=dev, durations=TDT_DURATIONS)
    enc, pred, labels, il, ll = make_model_problem(B, T, L, V, seed=18, dev=dev, cfg=joint.cfg,
                                                   n_cols=2)
    blank = joint.cfg.blank
    rows = int((il.long() * (ll.long() + 1)).sum())
    print(f"main path fused duration-arc steps {tag}: valid rows {rows} "
          f"({rows / (B * T * (L + 1)):.3f} of B·T·U)")

    def mb_fused(implementation="auto"):
        return joint_step(joint, lambda a, b: joint.multiblank_fused_loss(
            a, b, labels, il, ll, MB_DURATIONS, reduction="sum", sigma=VARIANT_SIGMA,
            implementation=implementation), enc, pred)

    def mb_unfused():
        return joint_step(joint, lambda a, b: rnnt_loss_multiblank(
            joint(a, b), labels, il, ll, MB_DURATIONS, blank=blank, reduction="sum",
            sigma=VARIANT_SIGMA), enc, pred)

    def tdt_fused_step(implementation="auto"):
        return joint_step(joint, lambda a, b: joint.tdt_fused_loss(
            a, b, labels, il, ll, reduction="sum", sigma=VARIANT_SIGMA,
            implementation=implementation), enc, pred)

    def tdt_unfused():
        return joint_step(joint, lambda a, b: rnnt_loss_tdt(
            *joint.tdt(a, b), labels, il, ll, TDT_DURATIONS, blank=blank, reduction="sum",
            sigma=VARIANT_SIGMA), enc, pred)

    def counted(name, step, must, must_not=()):
        K.reset_launches()
        torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
        got = step()
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(K.launches)
        print(f"main path {name} {tag} B={B} T={T} L={L} V={V} H={H}: launches {counts}")
        for k in must:
            fail_unless(counts[k] > 0, f"{k} kernel was not launched on the {name} path")
        for k in must_not:
            fail_unless(counts[k] == 0, f"{k} kernel was launched on the {name} path")
        for k, n in counts.items():
            totals[k] += n
        # A gradient of a parameter the loss does not reach stays None.
        return got[0], {n: g.clone() for n, g in got[1].items() if g is not None}

    def without_none(step):
        loss, grads = step
        return loss, {n: g for n, g in grads.items() if g is not None}

    fused_kernels = ("joint_prep", "joint_grad", "window_stream")
    got = counted("multiblank_fused", mb_fused, fused_kernels, ("wavefront", "dur_head"))
    check_step(f"multiblank_fused {tag}", got, without_none(mb_fused("torch")), "the plain path")
    check_step(f"multiblank_fused {tag}", got, without_none(mb_unfused()),
               "the unfused composition")
    del got
    torch.cuda.empty_cache()

    default_integrated = bool(tdt_fused._tdt_single_chunk(None, None, None))
    old = set_tdt_route(True)
    try:
        integrated = counted("tdt_fused integrated", tdt_fused_step, fused_kernels,
                             ("wavefront", "dur_head"))
        set_tdt_route(False)
        composed = counted("tdt_fused composed", tdt_fused_step, fused_kernels + ("dur_head",),
                           ("wavefront",))
    finally:
        tdt_fused._tdt_single_chunk = old
    print(f"tdt_fused {tag}: the module's rule takes the "
          f"{'integrated' if default_integrated else 'composed'} route")
    check_step(f"tdt_fused {tag} integrated", integrated, composed, "the composed route")
    check_step(f"tdt_fused {tag} integrated", integrated, tdt_fused_step("torch"),
               "the plain path")
    unfused = tdt_unfused()
    check_step(f"tdt_fused {tag} integrated", integrated, unfused, "the unfused composition")
    check_step(f"tdt_fused {tag} composed", composed, unfused, "the unfused composition")
    return mb_fused, mb_unfused, tdt_fused_step, tdt_unfused


def variant_timings(dev, mb_fused, mb_unfused, tdt_fused_step, tdt_unfused):
    """The two fused duration-arc steps beside their unfused compositions
    (time, peak memory, device breakdown), the TDT step on both routes, and
    the kernels at the fused shape: joint_prep and joint_grad with K = 0,
    K = 2 and D = 4 in f32 and with K = 2 and D = 4 in bf16, and the
    duration-head pair. Returns ({kernel: {case: timing}}, {step: (ms, MB)},
    {route: [ms]})."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    tag, B, T, L, V, H = FUSED_SHAPE
    steps = {}
    for name, fn in (("multiblank_fused", mb_fused), ("multiblank_unfused", mb_unfused),
                     ("tdt_unfused", tdt_unfused)):
        ms = time_ms(fn, 3, 1)
        steps[name] = (ms, peak_mb(fn))
        print(f"time {tag} B={B} T={T} L={L} V={V} H={H}: {name} step {ms:.4f} ms, "
              f"peak {steps[name][1]:.1f} MB")
    routes = {}
    from warp_transducer_tpu_torch.ops import tdt_fused
    old = tdt_fused._tdt_single_chunk
    try:
        for route in ("integrated", "composed", "composed", "integrated") * 2:
            set_tdt_route(route == "integrated")
            ms = time_ms(tdt_fused_step, 3, 1)
            mem = peak_mb(tdt_fused_step)
            routes.setdefault(route, []).append(ms)
            steps[f"tdt_fused_{route}"] = (min(routes[route]), mem)
            print(f"time {tag} B={B} T={T} L={L} V={V} H={H}: tdt_fused step, {route} route "
                  f"{ms:.4f} ms, peak {mem:.1f} MB")
        set_tdt_route(True)
        device_breakdown(f"{tag} tdt_fused integrated step", tdt_fused_step,
                         min(routes["integrated"]), iters=3, top=10)
        set_tdt_route(False)
        device_breakdown(f"{tag} tdt_fused composed step", tdt_fused_step,
                         min(routes["composed"]), iters=3, top=10)
    finally:
        tdt_fused._tdt_single_chunk = old
    median = {r: statistics.median(ms) for r, ms in routes.items()}
    faster = min(median, key=median.get)
    print(f"route {tag}: the {faster} route of rnnt_loss_tdt_fused_joint is the faster by the "
          f"median of {len(routes[faster])} readings (integrated {median['integrated']:.4f} ms, "
          f"least {min(routes['integrated']):.4f}; composed {median['composed']:.4f} ms, least "
          f"{min(routes['composed']):.4f})")
    device_breakdown(f"{tag} multiblank_fused step", mb_fused, steps["multiblank_fused"][0],
                     iters=3, top=10)
    torch.cuda.empty_cache()

    out = {"joint_prep": {}, "joint_grad": {}, "dur_head": {}}
    U, D = L + 1, len(TDT_DURATIONS)
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        suffix = "f32" if f32 else "bf16"
        problem = make_joint_problem(B, T, L, V, H, seed=15, dev=dev, dtype=dtype, n_cols=2)
        e, p, W, bias, labels, il, ll = problem
        Wd, bias_d = make_dur_head(H, 16, dev)
        denom, cols, (mb_fields, cX), (td_fields, g_dur) = variant_fields(problem, 0, Wd, bias_d)
        rows = int((il.long() * (ll.long() + 1)).sum())
        rate = TF32X3_OPS_PER_S if f32 else BF16_OPS_PER_S
        in_bytes = sum(x.numel() * x.element_size() for x in (e, p, W, bias)) + B * L * 4 + 2 * B * 4
        small = B * T * U * 4
        head_bytes = (Wd.numel() + bias_d.numel()) * 4
        h32 = torch.tanh(e.float()[:, :, None] + p.float()[:, None]).reshape(-1, H)
        h, g = h32.to(dtype), torch.randn((h32.shape[0], V), device=dev).to(dtype)
        gd2 = g_dur.reshape(-1, D)

        def three_products():
            torch.matmul(h, W)
            torch.matmul(g, W.t())
            torch.matmul(h.t(), g)

        def prep_library(with_dur):
            torch.matmul(h, W)
            if with_dur:
                torch.matmul(h32, Wd)

        def grad_library(with_dur):
            three_products()
            if with_dur:
                torch.matmul(gd2, Wd.t())
                torch.matmul(h32.t(), gd2)

        args = (e, p, W, bias, labels, il, ll, 0)
        g_args = args[:-1] + (denom,)
        # (case, prep hooks, grad fields and hooks, K, D)
        cases = [("k2", {"extra_cols": cols}, mb_fields, {"extra": (cols, cX)}, 2, 0),
                 ("d4", {"dur_head": (Wd, bias_d)}, td_fields, {"dur_head": (Wd, g_dur)}, 0, D)]
        if f32:
            cases.insert(0, ("k0", {}, mb_fields, {}, 0, 0))
        for case, pkw, fields, gkw, n_k, n_d in cases:
            key = f"{tag}_{suffix}_{case}"
            # Bytes: the inputs once, the (B, T, U) fields, the K or D values a
            # valid row; operations: the products on the valid rows.
            per_row = rows * (n_k + n_d) * 4 + (head_bytes if n_d else 0)
            out["joint_prep"][key] = dict(
                ms=time_ms(lambda: kjoint.fused_prep(*args, **pkw), 5),
                plain_ms=time_ms(lambda: fused_joint.fused_prep(*args, **pkw), 2, 1),
                library_ms=time_ms(lambda: prep_library(n_d > 0), 5),
                bound=bound(in_bytes + 3 * small + per_row, 2 * rows * H * (V + n_d), rate))
            out["joint_grad"][key] = dict(
                ms=time_ms(lambda: kjoint.fused_grad(*g_args, fields, 0, **gkw), 3),
                plain_ms=time_ms(lambda: fused_joint.fused_grad(*g_args, fields, 0, **gkw), 2, 1),
                library_ms=time_ms(lambda: grad_library(n_d > 0), 3),
                bound=bound(2 * in_bytes + 4 * small + per_row + (head_bytes if n_d else 0),
                            3 * 2 * rows * H * V + 2 * 2 * rows * H * n_d, rate),
                launch_ms=kernel_ms(lambda: kjoint.fused_grad(*g_args, fields, 0, **gkw)))
        if f32:
            ep_bytes = (e.numel() + p.numel()) * 4
            # Event times, the profiler's device times of every kernel a call
            # launches and of the kernels alone (without the wrapper's running
            # sums and zero fills), and the library's.
            prep_k = lambda: kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll)  # noqa: E731
            prep_lib = lambda: torch.matmul(h32, Wd)  # noqa: E731
            grad_k = lambda: kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll)  # noqa: E731
            grad_lib = lambda: (torch.matmul(gd2, Wd.t()), torch.matmul(h32.t(), gd2))  # noqa: E731
            # Bounds: e, p (and g_dur, de2, dp2) once, dlog or the D values a
            # valid row; the R·H tanh with their own FP32 work: an add and D
            # FMAs (prep); an add, D FMAs to dh, two for (1 − h²)·dh, two adds
            # to de2 and dp2, D FMAs to dWd (gradient).
            out["dur_head"][f"{tag}_prep"] = dict(
                ms=time_ms(prep_k, 10), device_ms=device_ms(prep_k),
                kernel_device_ms=kernels_alone_ms(prep_k, ("dur_prep_kernel",)),
                plain_ms=time_ms(lambda: fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll), 2, 1),
                library_ms=time_ms(prep_lib, 10), library_device_ms=device_ms(prep_lib),
                library_graph_ms=graph_ms(prep_lib),
                bound=tanh_bound(ep_bytes + head_bytes + rows * D * 4 + 2 * B * 4, rows * H,
                                 1 + D))
            out["dur_head"][f"{tag}_grad"] = dict(
                ms=time_ms(grad_k, 10), device_ms=device_ms(grad_k),
                kernel_device_ms=kernels_alone_ms(grad_k, ("dur_grad_kernel", "dur_sums_kernel")),
                plain_ms=time_ms(lambda: fused_joint.dur_head_grad(e, p, Wd, g_dur, il, ll), 2, 1),
                library_ms=time_ms(grad_lib, 10), library_device_ms=device_ms(grad_lib),
                library_graph_ms=graph_ms(grad_lib),
                bound=tanh_bound(2 * ep_bytes + 2 * Wd.numel() * 4 + rows * D * 4 + 2 * B * 4,
                                 rows * H, 5 + 2 * D))
        print(f"time {tag} {suffix}: valid rows {rows} ({rows / (B * T * U):.3f} of B·T·U)")
        for k, cases_k in out.items():
            for key, v in cases_k.items():
                if suffix not in key and k != "dur_head":
                    continue
                if k == "dur_head" and not f32:
                    continue
                print(f"time {key} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                      f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library "
                      f"{v['library_ms']:.4f} ms"
                      + (f" | device ms a launch {v['launch_ms'] or 'not measured'}"
                         if "launch_ms" in v else "")
                      + (f" | device ms {v['device_ms']}, the kernels alone "
                         f"{v['kernel_device_ms']}, library device ms "
                         f"{v['library_device_ms']} (profiler), {v['library_graph_ms']:.4f} "
                         f"(100 calls in a CUDA graph); bound by {v['bound'][2]}"
                         if "device_ms" in v else ""))
        del h32, h, g, gd2, denom, mb_fields, cX, td_fields, g_dur, problem, args, g_args, cases
        torch.cuda.empty_cache()
    return out, steps, routes


# The training surface at the repo's own model width: TransducerConfig()
# (encoder 256 wide, 4 blocks, 4 heads, conv kernel 15; prediction and joint
# 256; 80 input features; bf16 activations, f32 parameters), B = 64 utterances
# of T = 150 frames and L = 20 labels. Vocabularies: 128 (the config's) for the
# steps on the dense logits, 5000 (the published fused shape's) for the fused
# and pruned ones.
TRAIN_SHAPE = ("train", 64, 150, 20)
TRAIN_S = 5
TRAIN_BIG_BLANKS = (2, 4)
# step: (make_* of models/transducer.py, its arguments, vocabulary, the
# counters it must raise).
TRAIN_STEPS = {
    "dense": ("make_train_step", {}, 128, ("prep", "wavefront", "grad")),
    "fused": ("make_fused_train_step", {}, 5000, ("joint_prep", "wavefront", "joint_grad")),
    "pruned": ("make_pruned_train_step", dict(s_range=TRAIN_S), 5000,
               ("wavefront", "ranges", "band_prep", "band_stream", "band_grad")),
    "pruned_fused": ("make_pruned_fused_train_step", dict(s_range=TRAIN_S), 5000,
                     ("wavefront", "ranges", "band_stream")),
    "tdt": ("make_tdt_train_step", {}, 128, ("prep", "window_stream", "grad_fields")),
    "tdt_fused": ("make_tdt_fused_train_step", {}, 5000,
                  ("joint_prep", "joint_grad", "window_stream")),
    "multiblank": ("make_multiblank_train_step", dict(big_blank_durations=TRAIN_BIG_BLANKS), 128,
                   ("prep", "window_stream", "grad_fields")),
    "multiblank_fused": ("make_multiblank_fused_train_step",
                         dict(big_blank_durations=TRAIN_BIG_BLANKS), 5000,
                         ("joint_prep", "joint_grad", "window_stream")),
}
# Tolerances of a train step against its plain twin, relative norm errors.
# What the loss hands back to the model (the gradient of each tensor that
# enters a loss entry point): FUSED_GRAD_REL[bf16] for the three fused-joint
# losses (their kernels take bf16 products) and for any bf16 tensor, 1e-3
# for the rest (the f32 logits of the dense, pruned and duration-arc losses,
# as the end-to-end checks above). Every parameter: FUSED_GRAD_REL[bf16],
# since the model's bf16 activations round every product of the backward: a
# twin whose loss gradient differs in the last f32 bits (on an H100, 2.7e-5
# at the dense step's logits) reaches the deepest layers about a bf16 ulp
# away (3.45e-3 at encoder.input_proj.weight; 8e-6 in an f32 model; PERF.md).
TRAIN_LOSS_INPUT_REL = 1e-3
TRAIN_BF16_REL = FUSED_GRAD_REL[torch.bfloat16]
TRAIN_FUSED_ENTRIES = ("rnnt_loss_fused_joint", "rnnt_loss_multiblank_fused_joint",
                       "rnnt_loss_tdt_fused_joint")
# The loss entry points models/transducer.py calls, whose inputs are watched.
TRAIN_LOSS_ENTRIES = ("rnnt_loss", "rnnt_loss_tdt", "rnnt_loss_multiblank", "rnnt_loss_simple",
                      "rnnt_loss_pruned", "rnnt_loss_fused_joint", "rnnt_loss_pruned_fused",
                      "rnnt_loss_multiblank_fused_joint", "rnnt_loss_tdt_fused_joint")
TRAIN_ADAM_STEPS = 10


def make_train_batch(B, T, L, V, seed, dev, input_dim, n_cols=0):
    """Features from a seeded generator on the card, labels off the blank 0
    and the last ``n_cols`` columns, ragged lengths (T_b in [T/2, T], L_b in
    [L/2, L], the first utterance at both maxima)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return {"feats": torch.randn((B, T, input_dim), generator=g, device=dev),
            "feat_lengths": il,
            "labels": torch.randint(1, V - n_cols, (B, L), generator=g, device=dev,
                                    dtype=torch.int32),
            "label_lengths": ll}


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of every plain stage of the losses
    (``ops/rnnt.py::_PLAIN``) while entered: a step on the kernels must make
    none. Yields the list of the stages called."""
    from warp_transducer_tpu_torch.ops import rnnt as rnnt_module
    space, saved, calls = rnnt_module._PLAIN, dict(vars(rnnt_module._PLAIN)), []

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(space, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(space, name, fn)


@contextlib.contextmanager
def loss_inputs():
    """While entered, every floating tensor that requires grad and enters
    one of TRAIN_LOSS_ENTRIES from ``models/transducer.py`` keeps its
    gradient (``retain_grad``); yields the list of (entry, position,
    tensor)."""
    from warp_transducer_tpu_torch.models import transducer as tm
    saved, seen = {name: getattr(tm, name) for name in TRAIN_LOSS_ENTRIES}, []

    def watched(name, fn):
        def call(*args, **kwargs):
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor) and a.is_floating_point() and a.requires_grad:
                    a.retain_grad()
                    seen.append((name, i, a))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(tm, name, watched(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(tm, name, fn)


def check_loss_inputs(tag, got, want):
    """The gradient of each tensor the step handed to a loss entry point,
    against the plain twin's: TRAIN_BF16_REL for a bf16 tensor or a fused
    joint's input, else TRAIN_LOSS_INPUT_REL. Returns the largest error."""
    fail_unless(len(got) == len(want) and got, f"{tag}: the twins' losses took other inputs")
    worst = 0.0
    for (name, i, a), (_, _, b) in zip(got, want):
        err = rel_norm(a.grad, b.grad)
        tol = (TRAIN_BF16_REL if a.dtype == torch.bfloat16 or name in TRAIN_FUSED_ENTRIES
               else TRAIN_LOSS_INPUT_REL)
        print(f"{tag} d(input {i} of {name}) {tuple(a.shape)} {a.dtype} vs the plain twin: "
              f"relative norm error {err:.3e} (tol {tol:g})")
        fail_unless(err <= tol and bool(torch.isfinite(a.grad).all()),
                    f"{tag}: the gradient of input {i} of {name} differs from the plain twin's")
        worst = max(worst, err)
    return worst


def param_grads(model):
    return {n: None if q.grad is None else q.grad.clone() for n, q in model.named_parameters()}


def check_param_grads(tag, got, want, tol):
    """Every parameter's gradient within a relative norm error of ``tol``,
    each error measured against at least 1e-3 of the norm of the whole
    gradient (a gradient that is zero in exact arithmetic, the attention's
    key bias, holds rounding noise on both sides). A parameter the loss does
    not reach has no gradient on either side. Returns the largest error."""
    reached = [w for w in want.values() if w is not None]
    floor = 1e-3 * float(torch.stack([w.float().norm() for w in reached]).norm())
    worst, worst_name = 0.0, None
    for n, w in want.items():
        fail_unless((got[n] is None) == (w is None), f"{tag}: d{n} reached on one side only")
        if w is None:
            continue
        fail_unless(bool(torch.isfinite(got[n]).all()), f"{tag}: d{n} is not finite")
        err = float((got[n].float() - w.float()).norm()) / max(float(w.float().norm()), floor)
        if err > worst:
            worst, worst_name = err, n
    whole = rel_norm(torch.cat([g.float().ravel() for g in got.values() if g is not None]),
                     torch.cat([w.float().ravel() for w in reached]))
    print(f"{tag} parameter gradients vs the plain twin: {len(reached)} reached, largest "
          f"relative norm error {worst:.3e} (d{worst_name}; tol {tol:g}); all as one vector "
          f"{whole:.3e}")
    fail_unless(worst <= tol, f"{tag}: d{worst_name} differs from the plain twin's")
    return worst


def train_phase(dev, totals):
    """Each of the eight train steps of ``models/transducer.py`` on the whole
    model at TRAIN_SHAPE, through ``train_step_check``. Returns {step:
    numbers}."""
    from warp_transducer_tpu_torch.models import transducer as tm
    from warp_transducer_tpu_torch.ops import tdt_fused
    integrated = bool(tdt_fused._tdt_single_chunk(None, None, None))
    results = {}
    for seed, (name, (maker, kw, V, kernels)) in enumerate(TRAIN_STEPS.items(), start=40):
        if name == "tdt_fused" and not integrated:
            kernels = kernels + ("dur_head",)  # the module's rule: the composed route
        cfg = tm.TransducerConfig(vocab_size=V,
                                  tdt_durations=TDT_DURATIONS if "tdt" in name else ())
        results[name] = train_step_check(dev, totals, name, maker, kw, cfg, kernels, seed,
                                         TRAIN_ADAM_STEPS)
    return results


def train_step_check(dev, totals, name, maker, kw, cfg, kernels, seed, adam_steps,
                     keep_model=False):
    """One train step of ``models/transducer.py`` (``maker`` with ``kw``) on
    the whole model of ``cfg`` at TRAIN_SHAPE: one step (forward, loss,
    backward, Adam) under the launch counters with no host sync allowed,
    which must launch ``kernels`` and call no plain stage; the same step
    through the plain versions on a twin with the same weights and batch
    (loss at f32 rtol 1e-5, the gradients of the losses' inputs by
    ``check_loss_inputs``, every parameter's by ``check_param_grads``); then
    ``adam_steps`` more steps on the same batch, each timed by CUDA events,
    after which the loss must be lower; the device breakdown (idle share,
    the port's kernels' share of busy time) and the peak memory of a step.
    Returns its numbers (and the trained model, with ``keep_model``)."""
    from warp_transducer_tpu_torch.models import transducer as tm
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L = TRAIN_SHAPE
    V = cfg.vocab_size
    model = tm.Transducer(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    twin = tm.Transducer(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    n_params = sum(q.numel() for q in model.parameters())
    batch = make_train_batch(B, T, L, V, seed, dev, cfg.input_dim,
                             n_cols=len(TRAIN_BIG_BLANKS) if "multiblank" in name else 0)
    step = getattr(tm, maker)(model, torch.optim.Adam(model.parameters(), lr=1e-3), **kw)
    twin_step = getattr(tm, maker)(twin, torch.optim.Adam(twin.parameters(), lr=1e-3),
                                   implementation="torch", **kw)
    K.reset_launches()
    with plain_calls() as calls, loss_inputs() as inputs:
        torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
        try:
            loss = step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {k: n for k, n in K.launches.items() if n}
    print(f"train {name} {tag} B={B} T={T} L={L} V={V} joint {cfg.joint_dim} ({n_params} "
          f"parameters): launches {counts}; plain stages called {len(calls)}")
    for k in kernels:
        fail_unless(counts.get(k, 0) > 0, f"{k} kernel was not launched by the {name} step")
    fail_unless(not calls, f"the {name} step ran plain stages: {sorted(set(calls))}")
    for k, n in counts.items():
        totals[k] += n
    grads = param_grads(model)
    K.reset_launches()
    started = time.perf_counter()
    with loss_inputs() as twin_inputs:
        twin_loss = twin_step(batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - started
    fail_unless(not any(K.launches.values()), f"the plain {name} step launched a kernel")
    compare(f"train {name} loss vs the plain twin", loss, twin_loss, "f32")
    input_err = check_loss_inputs(f"train {name}", inputs, twin_inputs)
    grad_err = check_param_grads(f"train {name}", grads, param_grads(twin), TRAIN_BF16_REL)
    del twin, twin_step, grads, inputs, twin_inputs
    torch.cuda.empty_cache()
    # adam_steps more steps on the same batch, each between two events
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(adam_steps)]
    losses = []
    for start, end in events:
        start.record()
        losses.append(step(batch))
        end.record()
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    before, after = float(loss), float(losses[-1])
    print(f"train {name}: loss {before:.4f} -> {after:.4f} after {adam_steps} Adam "
          f"steps (lr 1e-3); step {step_ms:.4f} ms (median of {adam_steps}, CUDA "
          f"events); the plain twin's step {plain_s * 1e3:.1f} ms once (host clock)")
    fail_unless(after < before, f"{name}: {adam_steps} Adam steps did not lower the loss")
    prof = device_breakdown(f"train {name} step", lambda: step(batch), step_ms, top=8)
    mb = peak_mb(lambda: step(batch))
    print(f"train {name}: peak {mb:.1f} MB above the model, its optimiser state and the batch")
    out = {
        "vocab": V, "joint_dim": cfg.joint_dim, "params": n_params, "launches": counts,
        "loss_before": before, "loss_after": after, "loss_input_grad_rel_err": input_err,
        "param_grad_rel_err": grad_err, "step_ms": step_ms,
        "idle_share": prof and prof[1], "busy_ms": prof and prof[0],
        "port_kernels_ms": prof and prof[3],
        "port_share_of_busy": prof and prof[3] / prof[0], "peak_mb": mb,
        "plain_step_ms_once": plain_s * 1e3}
    del step, batch, losses
    torch.cuda.empty_cache()
    return (out, model) if keep_model else out


# The fused shape at joint width 2048: above the widest configuration of the
# JAX package's own (H = 1024, README.md's large-vocabulary shape), where the
# fused joint's products stream 16 k-slices of h and W (bf16; 64 with f32 W)
# through each block's ring (csrc/joint.cuh, the plan). The train step runs
# the whole model of TransducerConfig(vocab_size=5000, joint_dim=2048), bf16.
WIDE_SHAPE = ("wide", 64, 150, 20, 5000, 2048)
WIDE_TRAIN_CFG = dict(vocab_size=5000, joint_dim=2048)
WIDE_ADAM_STEPS = 3


def wide_kernels_vs_plain(dev, errs):
    """At WIDE_SHAPE, f32 and bf16: joint_prep with K = 2 big-blank columns
    and the D = 4 duration head against its plain version; joint_grad with
    neither hook, with the K = 2 fields and with the duration head, each
    against its plain version, dW, db and dWd bit-equal over two calls; in
    f32 the standalone duration-head pair against theirs."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    tag, B, T, L, V, H = WIDE_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        name = f"{tag} {'f32' if dtype == torch.float32 else 'bf16'}"
        problem = make_joint_problem(B, T, L, V, H, seed=27, dev=dev, dtype=dtype, n_cols=2)
        e, p, W, bias, labels, il, ll = problem
        Wd, bias_d = make_dur_head(H, seed=28, dev=dev)
        denom, cols, mb, td = variant_fields(problem, 0, Wd, bias_d)
        hooks = dict(extra_cols=cols, dur_head=(Wd, bias_d))
        p_k = kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0, **hooks)
        torch.cuda.synchronize()
        p_p = fused_joint.fused_prep(e, p, W, bias, labels, il, ll, 0, **hooks)
        err = max(compare(f"joint_prep {name} K=2 D=4 {f}", getattr(p_k, f), getattr(p_p, f),
                          FUSED_PREP_TOL[dtype]) for f in ("lpb", "lpe", "denom", "extras"))
        err_d = compare(f"joint_prep {name} dlog", p_k.dur, p_p.dur, "f32")
        if dtype == torch.float32:
            errs["joint_prep"] = max(errs["joint_prep"], err, err_d)
        del p_k, p_p
        for hook, fields, kw in (("K=0", mb[0], {}), ("K=2", mb[0], {"extra": (cols, mb[1])}),
                                 ("D=4", td[0], {"dur_head": (Wd, td[1])})):
            args = (e, p, W, bias, labels, il, ll, denom, fields, 0)
            g_k = kjoint.fused_grad(*args, **kw)
            again = kjoint.fused_grad(*args, **kw)
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, b)) for a, b in zip(g_k[2:], again[2:])]
            print(f"determinism joint_grad {name} {hook}: two calls give bit-equal dW, db"
                  f"{', dWd' if len(same) == 3 else ''} {same}")
            fail_unless(all(same), f"joint_grad {name} {hook}: dW, db or dWd differs")
            del again
            check_fused_grads(f"joint_grad {name} {hook}", g_k,
                              fused_joint.fused_grad(*args, **kw), dtype, errs)
            del g_k
            torch.cuda.empty_cache()
        if dtype == torch.float32:
            g_dur = td[1]
            got = kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll)
            torch.cuda.synchronize()
            errs["dur_head"] = max(errs["dur_head"], compare(
                f"dur_head_prep {name}", got,
                fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll), "f32"))
            got = kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll)
            again = kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll)
            torch.cuda.synchronize()
            fail_unless(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                        f"dur_head_grad {name}: two calls differ")
            check_fused_grads(f"dur_head_grad {name}", got,
                              fused_joint.dur_head_grad(e, p, Wd, g_dur, il, ll), dtype, errs)
        del problem, denom, mb, td
        torch.cuda.empty_cache()


def wide_main_path(dev, totals):
    """``Joint.fused_loss``, ``Joint.multiblank_fused_loss`` (K = 2) and
    ``Joint.tdt_fused_loss`` on both routes (D = 4) at WIDE_SHAPE, f32 and
    bf16, each under the launch counters with no host sync allowed, held
    against implementation="torch" (costs rtol 1e-5, gradients 1e-3 in f32
    and FUSED_GRAD_REL in bf16). Returns {dtype: the fused step's functions}
    for the timings."""
    from warp_transducer_tpu_torch import rnnt_loss
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L, V, H = WIDE_SHAPE
    steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        name = f"{tag} {'f32' if f32 else 'bf16'}"
        joint = make_joint_module(V, H, seed=29, dev=dev, dtype=dtype, durations=TDT_DURATIONS)
        enc, pred, labels, il, ll = make_model_problem(B, T, L, V, seed=30, dev=dev,
                                                       cfg=joint.cfg, n_cols=2)

        def loss_step(method, implementation="auto", joint=joint, enc=enc, pred=pred,
                      labels=labels, il=il, ll=ll, **kw):
            return joint_step(joint, lambda a, b: getattr(joint, method)(
                a, b, labels, il, ll, reduction="sum", implementation=implementation, **kw),
                enc, pred)

        cases = [("fused", "fused_loss", {}, None,
                  ("joint_prep", "wavefront", "joint_grad")),
                 ("multiblank_fused", "multiblank_fused_loss",
                  dict(big_blank_durations=MB_DURATIONS, sigma=VARIANT_SIGMA), None,
                  ("joint_prep", "window_stream", "joint_grad")),
                 ("tdt_fused integrated", "tdt_fused_loss", dict(sigma=VARIANT_SIGMA), True,
                  ("joint_prep", "window_stream", "joint_grad")),
                 ("tdt_fused composed", "tdt_fused_loss", dict(sigma=VARIANT_SIGMA), False,
                  ("joint_prep", "window_stream", "joint_grad", "dur_head"))]
        for case, method, kw, integrated, kernels in cases:
            old = set_tdt_route(integrated) if integrated is not None else None
            try:
                K.reset_launches()
                torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
                got = loss_step(method, **kw)
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                counts = dict(K.launches)
                print(f"main path {case} {name} B={B} T={T} L={L} V={V} H={H}: launches "
                      f"{counts}")
                for k in kernels:
                    fail_unless(counts[k] > 0, f"{k} kernel was not launched on the {case} "
                                f"path at H={H}")
                for k, n in counts.items():
                    totals[k] += n
                got = (got[0], {n: g.clone() for n, g in got[1].items() if g is not None})
                want = loss_step(method, "torch", **kw)
                want = (want[0], {n: g for n, g in want[1].items() if g is not None})
                check_step(f"{case} {name}", got, want, "the plain path",
                           1e-3 if f32 else FUSED_GRAD_REL[dtype])
            finally:
                if old is not None:
                    from warp_transducer_tpu_torch.ops import tdt_fused
                    tdt_fused._tdt_single_chunk = old
            del got, want
            torch.cuda.empty_cache()
        steps[dtype] = (lambda f=loss_step: f("fused_loss"),
                        lambda f=loss_step: f("fused_loss", "torch"),
                        lambda joint=joint, enc=enc, pred=pred, labels=labels, il=il, ll=ll:
                        joint_step(joint, lambda a, b: rnnt_loss(
                            joint(a, b), labels, il, ll, blank=joint.cfg.blank, reduction="sum"),
                            enc, pred))
    return steps


def wide_timings(dev, steps):
    """At WIDE_SHAPE, f32 and bf16: the fused step beside the plain route
    and the unfused composition (ms, peak MB), and the kernels: K6a, K6b (the
    device ms of each of its kernels a call apart), the dWd kernel, K6c and
    K6d, each beside its plain version, the library's products and its
    bound, with the registers ptxas gave them and the plan's shared memory.
    Returns ({kernel: {case: timing}}, {step: (ms, MB)})."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    tag, B, T, L, V, H = WIDE_SHAPE
    U = L + 1
    step_out = {}
    for dtype, (fused, plain, unfused) in steps.items():
        suffix = "f32" if dtype == torch.float32 else "bf16"
        for name, fn in (("fused", fused), ("plain", plain), ("unfused", unfused)):
            ms = time_ms(fn, 1, 1)
            step_out[f"{name}_{suffix}"] = (ms, peak_mb(fn))
            print(f"time {tag} B={B} T={T} L={L} V={V} H={H} {suffix}: {name} step {ms:.4f} ms, "
                  f"peak {step_out[f'{name}_{suffix}'][1]:.1f} MB")
        torch.cuda.empty_cache()
    out = {"joint_prep": {}, "joint_grad": {}, "dur_head": {}}
    for dtype in (torch.float32, torch.bfloat16):
        suffix = "f32" if dtype == torch.float32 else "bf16"
        case = f"{tag}_{suffix}"
        problem = make_joint_problem(B, T, L, V, H, seed=7, dev=dev, dtype=dtype)
        e, p, W, bias, labels, il, ll = problem
        pr, fields = joint_fields(problem, 0)
        rows = int((il.long() * (ll.long() + 1)).sum())
        rate = TF32X3_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        in_bytes = sum(x.numel() * x.element_size() for x in (e, p, W, bias)) + B * L * 4 + 2 * B * 4
        small = B * T * U * 4
        prep_args = (e, p, W, bias, labels, il, ll, 0)
        grad_args = (e, p, W, bias, labels, il, ll, pr.denom, fields, 0)
        prep_k = lambda: kjoint.fused_prep(*prep_args)  # noqa: E731
        grad_k = lambda: kjoint.fused_grad(*grad_args)  # noqa: E731
        regs = kjoint.kernel_registers(dtype)
        plan = kjoint.kernel_plan(H, V, dtype)
        h = torch.tanh(e.float()[:, :, None] + p.float()[:, None]).reshape(-1, H).to(dtype)
        out["joint_prep"][case] = dict(
            ms=sum(kernel_ms(prep_k, 3).values()) or time_ms(prep_k, 3, 1),
            event_ms=time_ms(prep_k, 3, 1),
            plain_ms=time_ms(lambda: fused_joint.fused_prep(*prep_args), 1, 1),
            library_ms=time_ms(lambda: torch.matmul(h, W), 3),
            bound=bound(in_bytes + 3 * small, 2 * rows * H * V, rate),
            registers={k: regs[k] for k in JOINT_PREP_KERNELS},
            smem=plan.prep_smem, plan=plan._asdict())
        g = torch.randn((h.shape[0], V), device=dev).to(dtype)
        launches = kernel_ms(grad_k, 2)
        out["joint_grad"][case] = dict(
            ms=time_ms(grad_k, 2, 1),
            plain_ms=time_ms(lambda: fused_joint.fused_grad(*grad_args), 1, 1),
            library_ms=time_ms(lambda: (torch.matmul(h, W), torch.matmul(g, W.t()),
                                        torch.matmul(h.t(), g)), 2),
            bound=bound(2 * in_bytes + 4 * small, 3 * 2 * rows * H * V, rate),
            launch_ms=launches,
            registers={k: regs[k] for k in JOINT_GRAD_KERNELS},
            smem={"g": plan.g_smem, "dh": plan.dh_smem, "dW": plan.dw_smem})
        del g, h
        torch.cuda.empty_cache()
        if dtype == torch.float32:  # the duration head: Wd, g_dur in f32 whatever W's type
            Wd, bias_d = make_dur_head(H, seed=16, dev=dev)
            valid = ((torch.arange(T, device=dev)[None, :, None] < il[:, None, None])
                     & (torch.arange(U, device=dev)[None, None, :] <= ll[:, None, None]))
            g_dur = (torch.randn((B, T, U, len(TDT_DURATIONS)), device=dev)
                     * valid[..., None]).contiguous()
            D = Wd.shape[1]
            h32 = torch.tanh(e[:, :, None] + p[:, None]).reshape(-1, H)
            gd2 = g_dur.reshape(-1, D)
            ep_bytes = (e.numel() + p.numel()) * 4
            prep_d = lambda: kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll)  # noqa: E731
            grad_d = lambda: kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll)  # noqa: E731
            tdt_grad = lambda: kjoint.fused_grad(*grad_args, dur_head=(Wd, g_dur))  # noqa: E731
            out["dur_head"][f"{case}_prep"] = dict(
                ms=kernels_alone_ms(prep_d, ("dur_prep_kernel",)) or time_ms(prep_d, 5),
                event_ms=time_ms(prep_d, 5),
                plain_ms=time_ms(lambda: fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll), 1, 1),
                library_ms=time_ms(lambda: torch.matmul(h32, Wd), 5),
                bound=tanh_bound(ep_bytes + rows * D * 4 + 2 * B * 4, rows * H, 1 + D))
            out["dur_head"][f"{case}_grad"] = dict(
                ms=kernels_alone_ms(grad_d, ("dur_grad_kernel", "dur_sums_kernel"))
                or time_ms(grad_d, 5),
                event_ms=time_ms(grad_d, 5),
                plain_ms=time_ms(lambda: fused_joint.dur_head_grad(e, p, Wd, g_dur, il, ll), 1, 1),
                library_ms=time_ms(lambda: (torch.matmul(gd2, Wd.t()),
                                            torch.matmul(h32.t(), gd2)), 5),
                bound=tanh_bound(2 * ep_bytes + 2 * Wd.numel() * 4 + rows * D * 4 + 2 * B * 4,
                                 rows * H, 5 + 2 * D))
            # The dWd kernel inside K6b with the duration head: its R·H tanh
            # and the 2·R·H·D FMAs of hᵀ·g_dur.
            out["dur_head"][f"{case}_dwd"] = dict(
                ms=launch_device_ms(tdt_grad, 2, ("joint_grad_dwd_kernel",)),
                plain_ms=time_ms(lambda: torch.matmul(
                    torch.tanh(e[:, :, None] + p[:, None]).reshape(-1, H).t(), gd2), 2, 1),
                library_ms=time_ms(lambda: torch.matmul(h32.t(), gd2), 5),
                bound=tanh_bound(ep_bytes + rows * D * 4 + H * D * 4, rows * H, 2 * D))
            del h32, gd2, g_dur, valid
        print(f"time {case}: valid rows {rows} ({rows / (B * T * U):.3f} of B·T·U); plan {plan}")
        for k in out:
            for key, v in out[k].items():
                if not key.startswith(case):
                    continue
                print(f"time {key} {k}: {v['ms']} ms | plain {v['plain_ms']:.4f} ms | bound "
                      f"{v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {v['library_ms']:.4f} ms"
                      + (f" | registers {v['registers']}" if "registers" in v else "")
                      + (f" | device ms a launch {v['launch_ms'] or 'not measured'}"
                         if "launch_ms" in v else ""))
        del pr, fields, problem, prep_args, grad_args
        torch.cuda.empty_cache()
    return out, step_out


def wide_phase(dev, totals, errs):
    """The fused joint at WIDE_SHAPE: its kernels against their plain
    versions, its losses under the launch counters against the plain path,
    the fused train step of TransducerConfig(**WIDE_TRAIN_CFG) against its
    plain twin over WIDE_ADAM_STEPS Adam steps, the timings. Returns
    (kernel timings, step timings, the train step's numbers)."""
    from warp_transducer_tpu_torch.models import transducer as tm
    started = time.perf_counter()
    wide_kernels_vs_plain(dev, errs)
    steps = wide_main_path(dev, totals)
    kernel_t, step_t = wide_timings(dev, steps)
    del steps
    torch.cuda.empty_cache()
    maker, kw, _, kernels = TRAIN_STEPS["fused"]
    train = train_step_check(dev, totals, "fused_wide", maker, kw,
                             tm.TransducerConfig(**WIDE_TRAIN_CFG), kernels, 47, WIDE_ADAM_STEPS)
    print(f"wide phase: {time.perf_counter() - started:.1f} s")
    return kernel_t, step_t, train


def binding_check(dev, totals):
    """``bindings.torch_binding.RNNTLoss`` on CUDA tensors at the headline
    shape: its launches (prep, wavefront, grad) with no host sync allowed,
    and its value and gradient against the port's ``rnnt_loss`` under the
    binding's conventions (shape (1,), "mean" over B)."""
    from warp_transducer_tpu_torch import rnnt_loss
    from warp_transducer_tpu_torch.bindings import torch_binding
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L, V = SHAPES[0]
    acts, labels, il, ll = make_problem(B, T, L, V, seed=50, dev=dev)
    a = acts.clone().requires_grad_(True)
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = torch_binding.RNNTLoss(reduction="mean")(a, labels, il, ll)
        got.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {k: n for k, n in K.launches.items() if n}
    print(f"binding RNNTLoss {tag} B={B} T={T} L={L} V={V} on CUDA tensors: launches {counts}")
    for k in ("prep", "wavefront", "grad"):
        fail_unless(counts.get(k, 0) > 0, f"{k} kernel was not launched by the binding")
    for k, n in counts.items():
        totals[k] += n
    fail_unless(got.shape == (1,) and got.device == a.device, "the binding's mean is not shape (1,)")
    r = acts.clone().requires_grad_(True)
    want = rnnt_loss(r, labels, il, ll, reduction="sum") / B
    want.backward()
    compare(f"binding {tag} mean vs rnnt_loss sum / B", got.detach()[0], want.detach(), "f32")
    compare(f"binding {tag} gradient vs rnnt_loss's", a.grad, r.grad, grad_tol(r.grad, "f32"))
    multiblank_log_probs_binding_check(dev, totals)


def multiblank_log_probs_binding_check(dev, totals):
    """``rnnt_loss_multiblank(from_log_probs=True, reduction="mean")`` of the
    binding on CUDA tensors at the duration-arc headline shape (a masked
    big blank in a quarter of the utterances): its launches with no host
    sync allowed, against the port's op route it calls (the sum over B)."""
    from warp_transducer_tpu_torch.bindings import torch_binding
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import multiblank
    tag, B, T, L, V = DURATION_SHAPES[0]
    acts, _, labels, il, ll = make_duration_problem(B, T, L, V, seed=51, dev=dev)
    lp = log_probs_input(acts).detach()
    a = lp.clone().requires_grad_(True)
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = torch_binding.rnnt_loss_multiblank(a, labels, il, ll, MB_DURATIONS, sigma=MB_SIGMA,
                                                 reduction="mean", from_log_probs=True)
        got.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {k: n for k, n in K.launches.items() if n}
    print(f"binding rnnt_loss_multiblank(from_log_probs=True) {tag} B={B} T={T} L={L} V={V} on "
          f"CUDA tensors: launches {counts}")
    for k in ("prep", "window_stream", "grad_fields"):
        fail_unless(counts.get(k, 0) > 0, f"{k} kernel was not launched by the binding (log-probs)")
    fail_unless(not counts.get("wavefront"), "the binding's multi-blank loss ran the dense lattice")
    for k, n in counts.items():
        totals[k] += n
    fail_unless(got.shape == (1,) and got.device == a.device, "the binding's mean is not shape (1,)")
    r = lp.clone().requires_grad_(True)
    want = multiblank._multiblank_costs(r, labels, il, ll, MB_DURATIONS, 0, None, "sum", MB_SIGMA,
                                        0.0, 0.0, True, "auto") / B
    want.backward()
    compare(f"binding multiblank log-probs {tag} mean vs the op route's sum / B", got.detach()[0],
            want.detach(), "f32")
    compare(f"binding multiblank log-probs {tag} gradient vs the op route's", a.grad, r.grad,
            grad_tol(r.grad, "f32"))
    fail_unless(bool((a.grad[torch.isneginf(lp)] == 0).all()),
                "the binding's log-probs gradient is not 0 at a -inf input")


# The inference side (models/decoding.py, ops/alignment.py), at the train
# phase's width and batch: the five decoders on the whole model of
# TransducerConfig() (vocabulary 128; the multi-blank family's big blanks on
# its last two columns, the TDT family's duration head TDT_DURATIONS), beam
# 4 and 3 expansions (the JAX package's defaults), max_symbols = 2·L; and the
# three Viterbi alignments at DURATION_SHAPES. The duration-arc families pass
# SERVE_SIGMA to the decoder, the alignment and the loss alike.
SERVE_BEAM, SERVE_EXPANSIONS, SERVE_SIGMA = 4, 3, MB_SIGMA
SERVE_ITERS = 3  # CUDA-event readings of a decode call (the median is kept)
# Rescoring tolerance: the decode step and the full lattice take their
# products in other shapes, so a path's log-prob differs in the last f32 bits
# of each of its T+U arcs.
SERVE_ATOL, SERVE_RTOL = 1e-3, 1e-5


def serve_tol(score):
    return SERVE_ATOL + SERVE_RTOL * score.abs()


@contextlib.contextmanager
def ieee_f32():
    """f32 matrix products and convolutions in IEEE f32 (TF32 off) inside
    the block."""
    from warp_transducer_tpu_torch.utils.options import matmul_precision
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        flags, name, value = conv, "fp32_precision", "ieee"
    else:
        flags, name, value = torch.backends.cudnn, "allow_tf32", False
    old = getattr(flags, name)
    setattr(flags, name, value)
    try:
        with matmul_precision("highest"):
            yield
    finally:
        setattr(flags, name, old)


def device_busy(tag, fn, event_ms, top=4):
    """Device time of one call of ``fn`` from the profiler's raw kernel
    records (CUDA activity alone): busy ms, the idle share 1 - busy /
    ``event_ms`` and the device kernels of the call. ``device_breakdown``'s
    parsed event tree costs the host seconds for every 10k events, and a
    decode or an alignment launches 10k-200k kernels. None where the
    profiler records no device time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0
               and not getattr(e, "is_user_annotation", lambda: False)()]
    if not kernels:
        print(f"profile {tag}: the profiler recorded no device time (not measured)")
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e6
    busy = sum(by_name.values())
    idle = max(0.0, 1 - busy / event_ms)
    print(f"profile {tag}: device busy {busy:.4f} ms of {event_ms:.4f} ms (idle share "
          f"{idle:.3f}); {len(kernels)} device kernels a call in {len(by_name)} kinds")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile {tag}:   {ms:.4f} ms  {name[:90]}")
    return busy, idle, len(kernels)


def serve_decoders(std, tdt, feats, fl, max_symbols, merge=True):
    """{decoder: (lattice family, call)} for the five decoders (greedy_decode
    with and without the big blanks)."""
    from warp_transducer_tpu_torch.models import decoding as D
    beam = dict(beam=SERVE_BEAM, merge=merge)
    return {
        "greedy": ("dense", lambda: D.greedy_decode(std, feats, fl, max_symbols)),
        "greedy_big_blanks": ("multiblank", lambda: D.greedy_decode(
            std, feats, fl, max_symbols, big_blank_durations=TRAIN_BIG_BLANKS)),
        "greedy_tdt": ("tdt", lambda: D.greedy_decode_tdt(tdt, feats, fl, max_symbols)),
        "beam": ("dense", lambda: D.beam_search_decode(std, feats, fl, max_symbols,
                                                       expansions=SERVE_EXPANSIONS, **beam)),
        "beam_multiblank": ("multiblank", lambda: D.beam_search_decode_multiblank(
            std, feats, fl, max_symbols, big_blank_durations=TRAIN_BIG_BLANKS,
            sigma=SERVE_SIGMA, **beam)),
        "beam_tdt": ("tdt", lambda: D.beam_search_decode_tdt(tdt, feats, fl, max_symbols,
                                                             sigma=SERVE_SIGMA, **beam)),
    }


def rescore(family, model, feats, fl, tokens, n):
    """(Viterbi score, marginal log-likelihood) of each utterance's ``tokens``
    (B, L) with ``n`` (B,) labels, the whole batch in one call each, on the
    full-lattice logits of the model: the dense family through
    ``rnnt_viterbi_align`` and ``rnnt_score`` (prep, wavefront), the
    duration-arc ones through their alignment and loss (prep, window)."""
    import warp_transducer_tpu_torch as W
    labels = tokens.contiguous()
    with torch.no_grad():
        if family == "tdt":
            tok, dur = (x.float().contiguous() for x in model.tdt_logits(feats, fl, labels))
            vit = W.tdt_viterbi_align(tok, dur, labels, fl, n, TDT_DURATIONS, sigma=SERVE_SIGMA)
            return vit.score, -W.rnnt_loss_tdt(tok, dur, labels, fl, n, TDT_DURATIONS,
                                               sigma=SERVE_SIGMA, reduction="none")
        acts = model(feats, fl, labels).float().contiguous()
    if family == "multiblank":
        vit = W.multiblank_viterbi_align(acts, labels, fl, n, TRAIN_BIG_BLANKS, sigma=SERVE_SIGMA)
        return vit.score, -W.rnnt_loss_multiblank(acts, labels, fl, n, TRAIN_BIG_BLANKS,
                                                  sigma=SERVE_SIGMA, reduction="none")
    return W.rnnt_viterbi_align(acts, labels, fl, n).score, -W.rnnt_score(acts, labels, fl, n)


def check_hypotheses(name, family, out, V, max_symbols):
    """Tokens in [0, V) with no blank (nor big blank for the multi-blank
    family) among the first n, n <= max_symbols; beams sorted best-first
    with a finite best score. Returns the best hypothesis (tokens, n,
    score or None)."""
    tokens, n = out[0], out[1]
    if len(out) == 3:
        scores = out[2]
        fail_unless(bool((scores[:, 1:] <= scores[:, :-1]).all()), f"{name}: beams not sorted")
        fail_unless(bool(torch.isfinite(scores[:, 0]).all() and (scores[:, 0] > -1e29).all()),
                    f"{name}: a best hypothesis did not finish")
        tokens, n, best = tokens[:, 0], n[:, 0], scores[:, 0]
    else:
        best = None
    used = torch.arange(max_symbols, device=tokens.device)[None] < n[:, None]
    banned = [0] + ([V - 2, V - 1] if family == "multiblank" else [])
    fail_unless(bool(((n >= 0) & (n <= max_symbols)).all()), f"{name}: a count above max_symbols")
    fail_unless(bool(((tokens >= 0) & (tokens < V)).all()), f"{name}: a token outside [0, V)")
    fail_unless(not bool((torch.isin(tokens, torch.tensor(banned, device=tokens.device))
                          & used).any()), f"{name}: a blank or big blank among the tokens")
    return tokens, n, best


def decode_phase(dev, totals):
    """The five decoders at TRAIN_SHAPE on the whole model, in bf16 (the
    config's default) and in f32 with TF32 off: each call with no host sync
    allowed, timed (median of SERVE_ITERS CUDA-event readings) and profiled.
    On the f32 outputs: the hypotheses' checks, each family's best
    hypotheses rescored in one batched call (launch counters on), held at
    Viterbi <= marginal and beam score <= marginal (merged beams), and with
    merge=False at beam score <= Viterbi (one path's score is at most the
    best path's); the share of Viterbi - tol <= pooled score is printed,
    and so is the share of greedy sequences equal to the CPU's."""
    import copy

    from warp_transducer_tpu_torch.models import transducer as tm
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L = TRAIN_SHAPE
    V, max_symbols = 128, 2 * L
    batch = make_train_batch(B, T, L, V, 70, dev, tm.TransducerConfig().input_dim,
                             n_cols=len(TRAIN_BIG_BLANKS))
    feats, fl = batch["feats"], batch["feat_lengths"]
    results, f32_out, models = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        std = tm.Transducer(tm.TransducerConfig(vocab_size=V, dtype=dtype), device=dev,
                            generator=torch.Generator().manual_seed(71))
        tdt = tm.Transducer(tm.TransducerConfig(vocab_size=V, dtype=dtype,
                                                tdt_durations=TDT_DURATIONS),
                            device=dev, generator=torch.Generator().manual_seed(72))
        with ieee_f32() if dtype == torch.float32 else contextlib.nullcontext():
            for name, (family, run) in serve_decoders(std, tdt, feats, fl,
                                                      max_symbols).items():
                torch.cuda.set_sync_debug_mode("error")  # any host sync in the decode raises
                try:
                    out = run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                events = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)) for _ in range(SERVE_ITERS)]
                for start, end in events:
                    start.record()
                    run()
                    end.record()
                torch.cuda.synchronize()
                ms = statistics.median(s.elapsed_time(e) for s, e in events)
                prof = device_busy(f"serve {name} {dname}", run, ms)
                print(f"serve {name} {dname} B={B} T={T} V={V} max_symbols={max_symbols}: "
                      f"{ms:.4f} ms a call (median of {SERVE_ITERS}, CUDA events); no host sync")
                results[f"{name}_{dname}"] = {
                    "ms": ms, "busy_ms": prof and prof[0], "idle_share": prof and prof[1],
                    "device_kernels": prof and prof[2], "no_host_sync": True}
                if dtype == torch.float32:
                    f32_out[name] = (family, out)
            if dtype == torch.float32:
                models = {"std": std, "tdt": tdt}
                unmerged = {f"{name}_unmerged": (family, run()) for name, (family, run) in
                            serve_decoders(std, tdt, feats, fl, max_symbols, merge=False).items()
                            if name.startswith("beam")}
        del std, tdt
        torch.cuda.empty_cache()

    # ---- the checks, in f32 with TF32 off
    checks, lower = {}, {}
    K.reset_launches()
    with ieee_f32():
        for name, (family, out) in (f32_out | unmerged).items():
            tokens, n, best = check_hypotheses(name, family, out, V, max_symbols)
            model = models["tdt" if family == "tdt" else "std"]
            vit, ll = rescore(family, model, feats, fl, tokens, n)
            has = n > 0
            fail_unless(bool(torch.isfinite(vit[has]).all() and torch.isfinite(ll[has]).all()),
                        f"{name}: a decoded hypothesis has no path in its lattice")
            tol = serve_tol(ll)
            fail_unless(bool((vit <= ll + tol)[has].all()), f"{name}: Viterbi above the marginal")
            worst = {"viterbi_minus_marginal": float((vit - ll)[has].max())}
            if best is not None and name.endswith("_unmerged"):
                # one path's score: at most the best path's
                fail_unless(bool((best <= vit + serve_tol(vit))[has].all()),
                            f"{name}: the beam's path scores above the Viterbi path")
                worst["beam_minus_viterbi"] = float((best - vit)[has].max())
            elif best is not None:
                # a pooled score sums distinct paths of its hypothesis
                fail_unless(bool((best <= ll + tol)[has].all()),
                            f"{name}: the pooled beam score is above the marginal")
                worst["beam_minus_marginal"] = float((best - ll)[has].max())
                held = (vit - serve_tol(vit) <= best)[has]
                lower[name] = {"share": float(held.float().mean()),
                               "largest_viterbi_minus_beam": float((vit - best)[has].max())}
            checks[name] = {"rescored": int(has.sum())} | worst
            print(f"serve check {name} (f32, TF32 off): {int(has.sum())} of {B} hypotheses with "
                  f"n > 0 rescored; Viterbi <= marginal held; {worst} (tol {SERVE_ATOL:g} + "
                  f"{SERVE_RTOL:g}·|score|)"
                  + (f"; Viterbi - tol <= beam score in {lower[name]['share']:.3f} of them "
                     f"(largest Viterbi - beam {lower[name]['largest_viterbi_minus_beam']:.4f}; "
                     "printed, not held: a beam may drop its best hypothesis's best path)"
                     if name in lower else ""))
    torch.cuda.synchronize()
    counts = {k: v for k, v in K.launches.items() if v}
    print(f"serve rescoring launches {counts}")
    for k in ("prep", "wavefront", "window_stream"):
        fail_unless(counts.get(k, 0) > 0, f"{k} kernel was not launched by the serve rescoring")
    for k, v in counts.items():
        totals[k] += v

    # ---- the greedy sequences against the CPU's (f32, printed)
    same = {}
    with ieee_f32():
        cpu = {k: copy.deepcopy(m).cpu() for k, m in models.items()}
        decoders = serve_decoders(cpu["std"], cpu["tdt"], feats.cpu(), fl.cpu(), max_symbols)
        for name in ("greedy", "greedy_big_blanks", "greedy_tdt"):
            tokens, n = decoders[name][1]()
            got_t, got_n = (x.cpu() for x in f32_out[name][1][:2])
            same[name] = float(((got_t == tokens).all(1) & (got_n == n)).float().mean())
    print(f"serve greedy sequences equal to the CPU's (f32, TF32 off): {same} (printed, not held)")
    return {"shape": {"B": B, "T": T, "L": L, "V": V, "max_symbols": max_symbols,
                      "beam": SERVE_BEAM, "expansions": SERVE_EXPANSIONS, "sigma": SERVE_SIGMA},
            "decoders": results, "checks": checks, "viterbi_below_pooled": lower,
            "greedy_equal_to_cpu": same, "launches": counts}


def resum_path(lpb, lpe, arcs, codes, il, ll, dense):
    """The log-prob of each utterance's path re-summed from its weights,
    and the emit frames the path implies, after checking that it is a path:
    its steps a prefix of ``codes``, L_b emits, and frames adding up to T_b
    (dense: T_b - 1 advances, the terminal blank in the score). ``codes``:
    the dense encoding (1 emit, 0 advance) or the multi-blank one (0 emit,
    m frames), ``arcs`` (B, T, U, A) and the lookup m -> family for the
    latter."""
    B, T, U = lpb.shape
    valid = codes >= 0
    emit = valid & (codes == (1 if dense else 0))
    frames = (valid & ~emit).long() if dense else torch.where(emit | ~valid, 0, codes).long()
    shift = lambda x: torch.nn.functional.pad(x.cumsum(1)[:, :-1], (1, 0))  # noqa: E731
    u, t = shift(emit.long()), shift(frames)
    n_steps = valid.sum(1)
    fail_unless(bool((valid == (torch.arange(codes.shape[1], device=codes.device)
                                 < n_steps[:, None])).all()), "a path has a gap")
    fail_unless(bool((emit.sum(1) == ll).all()), "a path emits another number of labels")
    want_frames = il.long() - 1 if dense else il.long()
    fail_unless(bool((frames.sum(1) == want_frames).all()), "a path consumes other frames")
    b = torch.arange(B, device=codes.device)[:, None].expand_as(codes)
    tc, uc = t.clamp(0, T - 1), u.clamp(0, U - 1)
    if dense:
        w = torch.where(emit, lpe[b, tc, uc], lpb[b, tc, uc])
    else:
        fam, lookup = arcs
        w = torch.where(emit, lpe[b, tc, uc], fam[b, tc, uc, lookup[codes.long().clamp_min(0)]])
    total = torch.where(valid, w, 0.0).sum(1)
    if dense:
        total = total + lpb[b[:, 0], il.long() - 1, ll.long()]
    ef = torch.full((B, U), -1, dtype=torch.long, device=codes.device)
    ef.scatter_(1, torch.where(emit, u, U - 1), torch.where(emit, t, -1))
    return total, ef[:, :U - 1]


def check_tdt_emits(out, il, ll):
    """Each label's frame and duration: a duration of the model, the next
    label at or after the frame this one lands on, the last landing inside
    the utterance, -1 beyond the labels."""
    ef, ed = out.emit_frames.long(), out.emit_durations.long()
    U1 = ef.shape[1]
    inside = torch.arange(U1, device=ef.device)[None] < ll[:, None]
    durs = torch.tensor(TDT_DURATIONS, device=ef.device)
    fail_unless(bool(((ef >= 0) & torch.isin(ed, durs))[inside].all()),
                "tdt: an emission without a frame or with another duration")
    fail_unless(bool(((ef == -1) & (ed == -1))[~inside].all()), "tdt: padding is not -1")
    land = ef + ed
    nxt = torch.nn.functional.pad(ef[:, 1:], (0, 1), value=-1)
    both = inside & torch.nn.functional.pad(inside[:, 1:], (0, 1), value=False)
    fail_unless(bool((nxt >= land)[both].all()), "tdt: a label before the previous one landed")
    last = (ll.long() - 1).clamp_min(0)
    has = ll > 0
    fail_unless(bool((land.gather(1, last[:, None])[:, 0] < il.long())[has].all()),
                "tdt: the last label lands past the utterance")


def align_phase(dev, totals):
    """The three alignments at DURATION_SHAPES, f32 (and the headline shape
    in f64), from seeded inputs on the card: the kernel route (prep.cu)
    under the launch counters with no host sync allowed, against
    implementation="torch" on the card (scores rtol 1e-5; f64 paths equal;
    the f32 path agreement printed); the path re-summed from its lpb / lpe
    (and big-blank) weights, rtol 1e-5 atol 1e-3; score <= -loss + tol
    through rnnt_score (K1) or the duration-arc loss (K7); each call timed
    at long_t."""
    import warp_transducer_tpu_torch as W
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import multiblank, rnnt, tdt
    kw = {"dense": {}, "multiblank": dict(sigma=SERVE_SIGMA), "tdt": dict(sigma=SERVE_SIGMA)}
    results, counts = {}, dict.fromkeys(K.launches, 0)

    def align(family, acts, dur, labels, il, ll, **extra):
        if family == "dense":
            return W.rnnt_viterbi_align(acts, labels, il, ll, **extra)
        if family == "tdt":
            return W.tdt_viterbi_align(acts, dur, labels, il, ll, TDT_DURATIONS,
                                       **kw["tdt"], **extra)
        return W.multiblank_viterbi_align(acts, labels, il, ll, MB_DURATIONS,
                                          **kw["multiblank"], **extra)

    def marginal(family, acts, dur, labels, il, ll):
        if family == "dense":
            return -W.rnnt_score(acts, labels, il, ll)
        if family == "tdt":
            return -W.rnnt_loss_tdt(acts, dur, labels, il, ll, TDT_DURATIONS, reduction="none",
                                    **kw["tdt"])
        return -W.rnnt_loss_multiblank(acts, labels, il, ll, MB_DURATIONS, reduction="none",
                                       **kw["multiblank"])

    cases = [(tag, B, T, L, V, torch.float32) for tag, B, T, L, V in DURATION_SHAPES]
    cases.append(DURATION_SHAPES[0] + (torch.float64,))
    for tag, B, T, L, V, dtype in cases:
        acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=80, dev=dev)
        acts, dur = acts.to(dtype), dur.to(dtype)
        dname = "f64" if dtype == torch.float64 else "f32"
        for family in ("dense", "multiblank", "tdt"):
            case = f"{family}_{tag}_{dname}"
            K.reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                out = align(family, acts, dur, labels, il, ll)
                end.record()
                ll_all = marginal(family, acts, dur, labels, il, ll)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            fail_unless(K.launches["prep"] > 0, f"{case}: the prep kernel was not launched")
            fail_unless(K.launches["wavefront" if family == "dense" else "window_stream"] > 0,
                        f"{case}: the loss's lattice kernel was not launched")
            for k, v in K.launches.items():
                counts[k] += v
            plain = align(family, acts, dur, labels, il, ll, implementation="torch")
            tol_key = "f64" if dtype == torch.float64 else (1e-5, 1e-5)
            compare(f"align {case} score kernel route vs plain", out.score, plain.score, tol_key)
            fail_unless(bool((out.score <= ll_all + serve_tol(ll_all)).all()),
                        f"{case}: the Viterbi score is above -loss")
            fields = out._fields[1:]
            agree = torch.stack([(getattr(out, f) == getattr(plain, f)).all(1)
                                 for f in fields]).all(0)
            share = float(agree.float().mean())
            if dtype == torch.float64:
                fail_unless(share == 1.0, f"{case}: the f64 paths differ from the plain route's")
            # the path against its weights, from the kernel route's prep
            eng = rnnt._KERNELS
            if family == "dense":
                p = eng.prepare(acts, labels, 0, False)
                total, ef = resum_path(p.lpb, p.lpe, None, out.path, il, ll, dense=True)
            elif family == "multiblank":
                idx = multiblank._resolve_indices(V, 0, MB_DURATIONS, None)[1]
                lpb, lpe, lpB, _ = multiblank._multiblank_prep(eng, acts, labels, 0, idx,
                                                               SERVE_SIGMA)
                lookup = torch.zeros(max(MB_DURATIONS) + 1, dtype=torch.long, device=dev)
                for j, m in enumerate(MB_DURATIONS, start=1):
                    lookup[m] = j
                fam = torch.cat((lpb[..., None], lpB), -1)
                total, ef = resum_path(lpb, lpe, (fam, lookup), out.path, il, ll, dense=False)
            else:
                check_tdt_emits(out, il, ll)
                total = ef = None
            if total is not None:
                compare(f"align {case} path re-summed vs score", total, out.score, (1e-5, 1e-3))
                fail_unless(bool((ef == out.emit_frames.long()).all()),
                            f"{case}: emit_frames disagree with the path")
            entry = {"path_agreement_with_plain": share}
            if tag == "long_t":
                ms = start.elapsed_time(end)  # the checked call (the headline shape warmed up)
                prof = device_busy(f"align {case}", lambda: align(family, acts, dur, labels, il,
                                                                  ll), ms, top=3)
                entry |= {"ms": ms, "busy_ms": prof and prof[0], "idle_share": prof and prof[1],
                          "device_kernels": prof and prof[2]}
                print(f"time align {case} B={B} T={T} L={L} V={V}: {ms:.2f} ms a call (CUDA "
                      f"events); path agreement with the plain route {share:.3f} (printed)")
            results[case] = entry
        del acts, dur
        torch.cuda.empty_cache()
    counts = {k: v for k, v in counts.items() if v}
    print(f"align launches {counts}")
    for k, v in counts.items():
        totals[k] += v
    return {"cases": results, "launches": counts}


def serve_phase(dev, totals):
    """The inference side: the decoders (``decode_phase``), then the
    alignments (``align_phase``)."""
    started = time.perf_counter()
    out = {"decode": decode_phase(dev, totals), "align": align_phase(dev, totals)}
    out["seconds"] = time.perf_counter() - started
    print(f"serve phase: {out['seconds']:.1f} s")
    return out


# The data-parallel wrappers of parallel/sharding.py: NCCL at world size 1 in
# this process at the shapes above (the "mean" each wrapper defaults to), and
# two gloo ranks sharing the card (NCCL refuses two ranks on one GPU), each a
# process of this script with half of the batch.
PARALLEL_READINGS = 5  # CUDA-event readings of a call (the median is kept)
PARALLEL_RANKS = 2
PARALLEL_WORKER_TIMEOUT_S = 300
PARALLEL_GLOO_SEEDS = {"rnnt": 40, "fused": 41}


def grad_step(fn, leaves):
    """``fn(*leaves)`` (a scalar) and its gradients w.r.t. fresh leaves."""
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss = fn(*leaves)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def parallel_cases(dev):
    """Each wrapper at full width, one at a time: (name, leaves, wrapper(mesh,
    *leaves), local(*leaves), kernels the wrapper must launch, the relative
    norm error allowed where two local calls differ, a route context)."""
    from warp_transducer_tpu_torch import (rnnt_loss, rnnt_loss_fused_joint, rnnt_loss_multiblank,
                                           rnnt_loss_multiblank_fused_joint,
                                           rnnt_loss_pruned_fused, rnnt_loss_simple,
                                           rnnt_loss_tdt, rnnt_loss_tdt_fused_joint)
    from warp_transducer_tpu_torch.ops import pruned_fused
    from warp_transducer_tpu_torch.parallel import sharding as S
    none = contextlib.nullcontext
    tag, B, T, L, V = SHAPES[0]
    acts, labels, il, ll = make_problem(B, T, L, V, seed=30, dev=dev)
    lens = (labels, il, ll)
    yield (f"data_parallel_rnnt_loss {tag}", [acts],
           lambda m, a: S.data_parallel_rnnt_loss(a, *lens, m),
           lambda a: rnnt_loss(a, *lens), ("prep", "wavefront", "grad"), 1e-3, none)
    yield (f"auto_sharded_rnnt_loss {tag}", [acts],
           lambda m, a: S.auto_sharded_rnnt_loss(a, *lens, m).to_local(),
           lambda a: rnnt_loss(a, *lens), ("prep", "wavefront", "grad"), 1e-3, none)
    del acts
    acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=31, dev=dev)
    lens = (labels, il, ll)
    yield (f"data_parallel_multiblank_loss {tag}", [acts],
           lambda m, a: S.data_parallel_multiblank_loss(a, *lens, MB_DURATIONS, m, sigma=MB_SIGMA),
           lambda a: rnnt_loss_multiblank(a, *lens, MB_DURATIONS, sigma=MB_SIGMA),
           ("prep", "window_stream", "grad_fields"), 1e-3, none)
    yield (f"data_parallel_tdt_loss {tag}", [acts, dur],
           lambda m, a, d: S.data_parallel_tdt_loss(a, d, *lens, TDT_DURATIONS, m),
           lambda a, d: rnnt_loss_tdt(a, d, *lens, TDT_DURATIONS),
           ("prep", "window_stream", "grad_fields"), 1e-3, none)
    del acts, dur
    tag, B, T, L, V, H = FUSED_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        e, p, W, bias, labels, il, ll = make_joint_problem(B, T, L, V, H, seed=32, dev=dev,
                                                           dtype=dtype)
        lens = (labels, il, ll)
        yield (f"data_parallel_fused_joint_loss {tag} {str(dtype)[6:]}", [e, p, W, bias],
               lambda m, *x: S.data_parallel_fused_joint_loss(*x, *lens, m),
               lambda *x: rnnt_loss_fused_joint(*x, *lens),
               ("joint_prep", "wavefront", "joint_grad"), FUSED_GRAD_REL[dtype], none)
    e, p, W, bias, labels, il, ll = make_joint_problem(B, T, L, V, H, seed=33, dev=dev, n_cols=2)
    Wd, bias_d = make_dur_head(H, seed=34, dev=dev)
    lens = (labels, il, ll)
    yield (f"data_parallel_tdt_fused_loss {tag} f32", [e, p, W, bias, Wd, bias_d],
           lambda m, *x: S.data_parallel_tdt_fused_loss(*x, *lens, TDT_DURATIONS, m,
                                                        sigma=VARIANT_SIGMA),
           lambda *x: rnnt_loss_tdt_fused_joint(*x, *lens, TDT_DURATIONS, sigma=VARIANT_SIGMA),
           ("joint_prep", "joint_grad", "window_stream"), FUSED_GRAD_REL[torch.float32], none)
    yield (f"data_parallel_multiblank_fused_loss {tag} f32", [e, p, W, bias],
           lambda m, *x: S.data_parallel_multiblank_fused_loss(*x, *lens, MB_DURATIONS, m,
                                                               sigma=VARIANT_SIGMA),
           lambda *x: rnnt_loss_multiblank_fused_joint(*x, *lens, MB_DURATIONS,
                                                      sigma=VARIANT_SIGMA),
           ("joint_prep", "joint_grad", "window_stream"), FUSED_GRAD_REL[torch.float32], none)
    del e, p, W, bias, Wd, bias_d
    tag, _, T, L, V, H, S_range = PRUNED_FUSED_SHAPE
    B = PRUNED_FUSED_CUT_B
    e, p, W, bias, labels, il, ll = make_joint_problem(B, T, L, V, H, seed=35, dev=dev)
    g = torch.Generator(device=dev).manual_seed(36)
    with torch.no_grad():
        _, ranges = rnnt_loss_simple(torch.randn((B, T, V), generator=g, device=dev),
                                     torch.randn((B, L + 1, V), generator=g, device=dev),
                                     labels, il, ll, prune_range=S_range)
    lens = (ranges, labels, il, ll)

    @contextlib.contextmanager
    def route(mb):
        old = pruned_fused._MATERIALIZE_MB
        pruned_fused._MATERIALIZE_MB = mb
        try:
            yield
        finally:
            pruned_fused._MATERIALIZE_MB = old

    for name, mb, must in (("sweep", 0, ("band_stream",)),
                           ("materialised", 1 << 20, ("band_prep", "band_stream", "band_grad"))):
        yield (f"data_parallel_pruned_fused_loss {tag} B={B} {name}", [e, p, W, bias],
               lambda m, *x: S.data_parallel_pruned_fused_loss(*x, *lens, S_range, m),
               lambda *x: rnnt_loss_pruned_fused(*x, *lens, S_range), must,
               FUSED_GRAD_REL[torch.float32], functools.partial(route, mb))


def same_or_close(name, got, want, again, rel_tol):
    """Bit for bit where two local calls (``want``, ``again``) are; else,
    where a kernel adds with atomics (K6b's de and dp), within ``rel_tol``
    by relative norm. Returns whether it was held bit for bit."""
    if torch.equal(want, again):
        fail_unless(torch.equal(got, want), f"{name}: the wrapper is not bit-equal to the local "
                    f"call (relative norm error {rel_norm(got, want):.3e})")
        return True
    rel, noise = rel_norm(got, want), rel_norm(again, want)
    print(f"{name}: two local calls differ by {noise:.3e} (atomics); the wrapper by {rel:.3e} "
          f"(tol {rel_tol:g})")
    fail_unless(rel <= rel_tol, f"{name}: the wrapper differs from the local call")
    return False


def event_readings(fn, n=PARALLEL_READINGS):
    """``n`` CUDA-event readings of one call each, after a warm-up call, ms."""
    fn()
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def collectives_ms(mesh, dev, loss_dtype, replicated, iters=10):
    """The wrapper's communication alone, on ``mesh``'s data axis: the batch
    check (an all_reduce of two integers and a host sync; CUDA events) and
    the all_reduces of the total and of each replicated gradient (CUDA
    events, and the device time of what the profiler records for them,
    kernels or copies, with their names; None where it records nothing)."""
    from warp_transducer_tpu_torch.parallel import sharding as S
    group = mesh.get_group(S.DATA_AXIS)
    bufs = [torch.zeros((), dtype=loss_dtype, device=dev)] + [torch.zeros_like(x)
                                                              for x in replicated]

    def all_reduces():
        for b in bufs:
            torch.distributed.all_reduce(b, group=group)

    out = {"batch_check_event_ms": time_ms(lambda: S._axis_group(mesh, S.DATA_AXIS, "mean", 1,
                                                                 dev), iters),
           "all_reduce_event_ms": time_ms(all_reduces, iters), "all_reduces": len(bufs)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            all_reduces()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    out["all_reduce_device_ms"] = (sum(e.self_device_time_total for e in rows) / 1e3 / iters
                                   if rows else None)
    out["all_reduce_records"] = sorted({e.key[:60] for e in rows})
    return out


# About 10 ms of device work at 1.98 GHz, queued ahead of a call whose host
# time is read: a call that waits for the device takes about that long.
PARALLEL_SLEEP_CYCLES = 20_000_000


def host_ms_behind(fn):
    """Host ms of ``fn()`` issued behind PARALLEL_SLEEP_CYCLES of queued
    device work (``torch.cuda._sleep``)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(PARALLEL_SLEEP_CYCLES)
    started = time.perf_counter()
    fn()
    host = (time.perf_counter() - started) * 1e3
    torch.cuda.synchronize()
    return host


@contextlib.contextmanager
def without_batch_check(mesh):
    """The wrappers with their batch check (an all_reduce and a host sync)
    taken out: ``_axis_group`` hands back the axis's group as it is."""
    from warp_transducer_tpu_torch.parallel import sharding as S
    real_check, group = S._axis_group, mesh.get_group(S.DATA_AXIS)
    S._axis_group = lambda *args: group
    try:
        yield
    finally:
        S._axis_group = real_check


def blocking_probe(mesh, dev, wrapper, local, leaves):
    """Which part of a wrapper's call waits for the device: the host ms of
    the local step, the wrapper's step with and without its batch check, and
    a bare all_reduce, each behind the queued sleep (its own ms beside)."""
    from warp_transducer_tpu_torch.parallel import sharding as S
    group = mesh.get_group(S.DATA_AXIS)
    buf = torch.zeros((), device=dev)
    out = {"sleep_ms": time_ms(lambda: torch.cuda._sleep(PARALLEL_SLEEP_CYCLES), 3, 1),
           "local_step": host_ms_behind(lambda: grad_step(local, leaves)),
           "wrapper_step": host_ms_behind(lambda: grad_step(lambda *x: wrapper(mesh, *x),
                                                            leaves)),
           "all_reduce": host_ms_behind(lambda: torch.distributed.all_reduce(buf, group=group))}
    with without_batch_check(mesh):
        out["wrapper_step_without_check"] = host_ms_behind(
            lambda: grad_step(lambda *x: wrapper(mesh, *x), leaves))
    return out


def parallel_nccl(dev, totals):
    """Every wrapper at full width on an NCCL group of this process alone:
    under the launch counters, held against the local call (bit for bit
    where that is reproducible), again with the batch check taken out under
    set_sync_debug_mode("error"), and timed beside the local call."""
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.parallel import sharding as S
    mesh = S.make_mesh()
    fail_unless(torch.distributed.get_backend() == "nccl" and mesh.shape == (1,)
                and mesh.device_type == "cuda", "make_mesh() did not build an NCCL mesh on the card")
    out = {}
    for name, leaves, wrapper, local, must, rel_tol, route in parallel_cases(dev):
        with route():
            want, again = grad_step(local, leaves), grad_step(local, leaves)
            K.reset_launches()
            got = grad_step(lambda *x: wrapper(mesh, *x), leaves)
            torch.cuda.synchronize()
            counts = dict(K.launches)
            print(f"main path parallel {name}: launches {counts}")
            for k in must:
                fail_unless(counts[k] > 0, f"{k} kernel was not launched by {name}")
            for k, n in counts.items():
                totals[k] += n
            with without_batch_check(mesh):
                torch.cuda.set_sync_debug_mode("error")  # any host sync after the check raises
                try:
                    unchecked = grad_step(lambda *x: wrapper(mesh, *x), leaves)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            loss_dtype = want[0].dtype
            exact = []
            for run in (got, unchecked):
                exact.append(same_or_close(f"{name} loss", run[0], want[0], again[0], rel_tol))
                exact += [same_or_close(f"{name} grad {i}", g, w, a, rel_tol)
                          for i, (g, w, a) in enumerate(zip(run[1], want[1], again[1]))]
            del got, unchecked, want, again
            readings = {"local": [], "wrapper": []}
            for who in ("local", "wrapper", "wrapper", "local"):
                fn = local if who == "local" else (lambda *x: wrapper(mesh, *x))
                readings[who] += event_readings(lambda: grad_step(fn, leaves))
            comm = collectives_ms(mesh, dev, loss_dtype, [x for x in leaves if x.dim() < 3])
            comm["host_ms_behind_sleep"] = blocking_probe(mesh, dev, wrapper, local, leaves)
        ms = {who: statistics.median(r) for who, r in readings.items()}
        print(f"time parallel {name}: wrapper {ms['wrapper']:.4f} ms | local {ms['local']:.4f} ms "
              f"(median of {len(readings['local'])} CUDA-event readings, forward and backward) | "
              f"batch check {comm['batch_check_event_ms']:.4f} ms (events) | "
              f"{comm['all_reduces']} all_reduces {comm['all_reduce_event_ms']:.4f} ms (events), "
              f"device {comm['all_reduce_device_ms']} ms (profiler: {comm['all_reduce_records']}) "
              f"| bit-equal {sum(exact)} of {len(exact)} outputs | host ms behind a queued "
              f"sleep: {comm['host_ms_behind_sleep']}")
        out[name] = {"wrapper_ms": ms["wrapper"], "local_ms": ms["local"],
                     "readings": readings, **comm, "bit_equal": [sum(exact), len(exact)],
                     "launches": {k: n for k, n in counts.items() if n}}
        torch.cuda.empty_cache()
    return out


def parallel_gloo_problems(dev):
    """The two gloo cases' global problems, from seeds: (name, leaves,
    labels and lengths, wrapper's name, local call)."""
    from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_fused_joint
    tag, B, T, L, V = SHAPES[0]
    acts, labels, il, ll = make_problem(B, T, L, V, seed=PARALLEL_GLOO_SEEDS["rnnt"], dev=dev)
    yield f"rnnt {tag}", [acts], (labels, il, ll), "data_parallel_rnnt_loss", rnnt_loss
    tag, B, T, L, V, H = FUSED_SHAPE
    e, p, W, bias, labels, il, ll = make_joint_problem(
        B, T, L, V, H, seed=PARALLEL_GLOO_SEEDS["fused"], dev=dev, dtype=torch.bfloat16)
    yield (f"fused {tag} bf16", [e, p, W, bias], (labels, il, ll),
           "data_parallel_fused_joint_loss", rnnt_loss_fused_joint)


def parallel_worker(rank, store, out_dir):
    """One of the gloo ranks: its half of each problem through the wrapper
    ("mean"), the loss and the gradients saved for the parent."""
    from warp_transducer_tpu_torch.parallel import sharding as S
    torch.cuda.set_device(0)
    S.initialize_distributed(backend="gloo", init_method=f"file://{store}",
                             world_size=PARALLEL_RANKS, rank=rank)
    try:
        mesh = S.make_mesh()
        dev = torch.device("cuda", 0)
        results = {}
        for name, leaves, lens, wrapper, _ in parallel_gloo_problems(dev):
            b = leaves[0].shape[0] // PARALLEL_RANKS
            rows = slice(rank * b, (rank + 1) * b)
            shard = [x if x.dim() < 3 else x[rows] for x in leaves]  # W and bias whole
            fn = getattr(S, wrapper)
            loss, grads = grad_step(lambda *x: fn(*x, *(t[rows] for t in lens), mesh), shard)
            results[name] = {"loss": loss.cpu(), "grads": [g.cpu() for g in grads]}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def parallel_gloo(dev, tmp):
    """Two gloo ranks on the one card, each a process of this script,
    against the single-process call: the loss rtol 1e-5 (2^-7, one bf16 ulp,
    where the costs are bf16); the sharded inputs'
    gradients at the train phase's relative norm (1e-3; 2e-2 with bf16
    products); every rank's W and bias gradients at 1e-4 (f32) / 2e-2
    (bf16), so a world-size factor fails."""
    script = str(Path(__file__).resolve())
    procs = []
    started = time.perf_counter()
    try:
        for rank in range(PARALLEL_RANKS):
            log = open(Path(tmp) / f"worker{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, script, "--parallel-worker", str(rank), str(Path(tmp) / "gloo"),
                 tmp], stdout=log, stderr=subprocess.STDOUT), log))
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, started + PARALLEL_WORKER_TIMEOUT_S - time.perf_counter()))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        fail_unless(proc.returncode == 0, f"gloo rank {rank} failed:\n"
                    + (Path(tmp) / f"worker{rank}.log").read_text()[-4000:])
    seconds = time.perf_counter() - started
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(PARALLEL_RANKS)]
    out = {"seconds": seconds}
    for name, leaves, lens, _, local in parallel_gloo_problems(dev):
        bf16 = leaves[0].dtype == torch.bfloat16
        loss, grads = grad_step(lambda *x: local(*x, *lens), leaves)
        rels = {}
        for r in ranks:  # bf16 costs: each path rounds its sum to bf16 once or twice
            compare(f"parallel gloo {name} loss", r[name]["loss"], loss.cpu(),
                    (2 ** -7, 0.0) if loss.dtype == torch.bfloat16 else "f32")
        for i, (x, g) in enumerate(zip(leaves, grads)):
            if x.dim() < 3:  # replicated: every rank holds the whole gradient
                tol = 2e-2 if bf16 else 1e-4
                got = [r[name]["grads"][i] for r in ranks]
            else:
                tol = 2e-2 if bf16 else 1e-3
                got = [torch.cat([r[name]["grads"][i] for r in ranks])]
            rels[i] = max(rel_norm(x_.to(dev), g) for x_ in got)
            print(f"parallel gloo {name} grad {i}: relative norm error {rels[i]:.3e} (tol {tol:g})")
            fail_unless(rels[i] <= tol, f"parallel gloo {name}: gradient {i} differs from the "
                        "single-process call")
        out[name] = {"grad_rel_norm": rels}
    print(f"parallel gloo: {PARALLEL_RANKS} ranks on one card, {seconds:.1f} s with their start")
    return out


def parallel_phase(dev, totals):
    """The data-parallel wrappers: NCCL at world size 1 in this process
    (``parallel_nccl``), then two gloo ranks on the card (``parallel_gloo``);
    the process group is destroyed before the phase returns."""
    import tempfile

    from warp_transducer_tpu_torch.parallel import sharding as S
    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(dev)
        S.initialize_distributed(init_method=f"file://{tmp}/nccl", world_size=1, rank=0)
        try:
            out = {"nccl": parallel_nccl(dev, totals)}
        finally:
            torch.distributed.destroy_process_group()
        out["gloo"] = parallel_gloo(dev, tmp)
    out["seconds"] = time.perf_counter() - started
    print(f"parallel phase: {out['seconds']:.1f} s")
    return out


_PHASE = {"name": "setup", "at": time.perf_counter()}


def phase_seconds(next_name):
    """Print the seconds since the last mark, under the phase that ended
    (the script's own clock; the run's limit is on the whole of it)."""
    now = time.perf_counter()
    print(f"seconds of phase {_PHASE['name']}: {now - _PHASE['at']:.1f}", flush=True)
    _PHASE.update(name=next_name, at=now)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is visible; this script runs only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_and_grad, rnnt_score
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import gradients, lattice, prep
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import build
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {name} | nvidia-smi: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")

    started = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - started:.2f} s (nvcc, csrc/*.cu -> "
          f"{build.build_root()}/{build.LIB_NAME})")

    errs = dict.fromkeys(K.launches, 0.0)

    phase_seconds("3")
    # ---- 3. every kernel against its plain version, at the main path's shapes
    def kernel_vs_plain(tag, B, T, L, V, dtype, full):
        acts, labels, il, ll = make_problem(B, T, L, V, seed=1, dev=dev, dtype=dtype)
        f32 = "f64" if dtype == torch.float64 else "f32"
        p_k = kprep.prepare(acts, labels, 0, False)
        torch.cuda.synchronize()
        p = prep.prepare(acts, labels, 0, False)
        e = max(compare(f"prep {tag} {dtype} {field}", getattr(p_k, field), getattr(p, field), f32)
                for field in ("lpb", "lpe", "denom"))
        if dtype == torch.float32:
            errs["prep"] = max(errs["prep"], e)
        if full:  # log-prob inputs: no reduction, lpb/lpe read directly
            lp = torch.log_softmax(acts.float(), -1).to(dtype)
            lp_k = kprep.prepare(lp, labels, 0, True)
            torch.cuda.synchronize()
            lp_p = prep.prepare(lp, labels, 0, True)
            for field in ("lpb", "lpe"):
                compare(f"prep {tag} {dtype} log_probs_input {field}", getattr(lp_k, field),
                        getattr(lp_p, field), f32)
        if dtype == torch.bfloat16:
            res = lattice.forward_backward(p.lpb, p.lpe, il, ll)
        else:
            for betas in ((False, True) if full else (True,)):  # ends with betas
                r_k = kwave.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
                torch.cuda.synchronize()
                res = lattice.forward_backward(p.lpb, p.lpe, il, ll, compute_betas=betas)
                e = max(compare(f"wavefront {tag} {dtype} betas={betas} {field}",
                                getattr(r_k, field), getattr(res, field), f32)
                        for field in ("alphas", "betas", "ll_forward", "ll_backward"))
                if dtype == torch.float32:
                    errs["wavefront"] = max(errs["wavefront"], e)
        if dtype == torch.float64:
            return
        labels_u = prep.label_rows(labels, L + 1)
        tol_key = "f32" if dtype == torch.float32 else "bf16_out"
        # The lattice mode, with a cotangent scale and FastEmit, as the
        # backward calls it; dense, and sparse on the same lattice.
        scale = torch.linspace(0.5, 1.5, B, device=dev)
        lat = (p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, labels_u, il, ll, 0)
        g_k = kgrad.grad_wrt_acts(acts, p.denom, *lat, dtype, scale, 0.1)
        torch.cuda.synchronize()
        g_p = gradients.grad_wrt_acts(acts, p.denom, *lat, dtype, scale, 0.1)
        e = compare(f"grad lattice mode {tag} {dtype}", g_k, g_p, grad_tol(g_p, tol_key))
        del g_k, g_p
        if full:
            g_k = kgrad.grad_wrt_log_probs(*lat, V, dtype, scale, 0.1)
            torch.cuda.synchronize()
            g_p = gradients.grad_wrt_log_probs(*lat, V, dtype, scale, 0.1)
            e = max(e, compare(f"grad lattice mode {tag} {dtype} sparse", g_k, g_p,
                               grad_tol(g_p, tol_key)))
            del g_k, g_p
        if dtype == torch.float32:
            errs["grad"] = max(errs["grad"], e)
        # The fields mode, K = 0 (and sparse) and K = 2 extra columns.
        fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
        extra = torch.stack((fields.cb, fields.ce), -1)
        cols = (V - 2, V - 1)
        for K_cols in (0, 2):
            kw = dict(extra_cols=cols, extra_fields=extra) if K_cols else {}
            g_k = kgrad.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype, **kw)
            torch.cuda.synchronize()
            g_p = gradients.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype, **kw)
            e = compare(f"grad fields mode K={K_cols} {tag} {dtype}", g_k, g_p,
                        grad_tol(g_p, tol_key))
            del g_k, g_p
            if dtype == torch.float32:
                errs["grad_fields"] = max(errs["grad_fields"], e)
        if full:
            g_k = kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
            torch.cuda.synchronize()
            g_p = gradients.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
            compare(f"grad fields mode {tag} {dtype} sparse", g_k, g_p, grad_tol(g_p, tol_key))
            del g_k, g_p
            # sparse with K = 2 extra columns (the multi-blank loss on
            # log-probs): bit-equal, it does no arithmetic
            kw = dict(extra_cols=cols, extra_fields=extra)
            g_k = kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, dtype, **kw)
            torch.cuda.synchronize()
            g_p = gradients.sparse_grad(fields, labels_u, il, ll, 0, V, dtype, **kw)
            e = compare(f"grad fields mode K=2 {tag} {dtype} sparse", g_k, g_p,
                        grad_tol(g_p, tol_key))
            fail_unless(torch.equal(g_k, g_p), f"grad sparse K=2 {tag} {dtype}: not bit-equal")
            if dtype == torch.float32:
                errs["grad_fields"] = max(errs["grad_fields"], e)
            del g_k, g_p

    for tag, B, T, L, V in SHAPES:
        kernel_vs_plain(tag, B, T, L, V, torch.float32, full=(tag == "headline"))
    _, B, T, L, V = SHAPES[0]
    kernel_vs_plain("headline", B, T, L, V, torch.bfloat16, full=False)
    kernel_vs_plain("headline", B, T, L, V, torch.float64, full=True)
    torch.cuda.synchronize()

    phase_seconds("4")
    # ---- 4. the main path, through the entry points a user calls
    small = torch.tensor(SMALL_ACTS, device=dev)
    small_args = (torch.tensor([[1, 2]], device=dev, dtype=torch.int32),
                  torch.tensor([2], device=dev, dtype=torch.int32),
                  torch.tensor([2], device=dev, dtype=torch.int32))
    small_cost = float(rnnt_loss_and_grad(small, *small_args)[0][0])
    print(f"small_test on the card: {small_cost:.6f} (reference {SMALL_COST})")
    fail_unless(abs(small_cost - SMALL_COST) < 1e-5, "small_test cost is wrong on the card")
    fail_unless(abs(float(rnnt_score(small, *small_args)[0]) - SMALL_COST) < 1e-5,
                "small_test score is wrong on the card")

    totals = {k: 0 for k in K.launches}
    problems = {}
    # The dense backward computes its coefficients inside the lattice mode of
    # grad.cu: gradients.coefficients, the plain (B, T, U) passes, must not run.
    coefficient_calls = []
    plain_coefficients = gradients.coefficients

    def counted_coefficients(*args, **kwargs):
        coefficient_calls.append(1)
        return plain_coefficients(*args, **kwargs)

    for tag, B, T, L, V in SHAPES:
        acts, labels, il, ll = make_problem(B, T, L, V, seed=2, dev=dev)
        a = acts.clone().requires_grad_(True)
        K.reset_launches()
        coefficient_calls.clear()
        gradients.coefficients = counted_coefficients
        torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
        try:
            loss = rnnt_loss(a, labels, il, ll, reduction="sum")
            loss.backward()
            costs, grads = rnnt_loss_and_grad(acts, labels, il, ll)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            gradients.coefficients = plain_coefficients
        torch.cuda.synchronize()
        counts = dict(K.launches)
        print(f"main path {tag} B={B} T={T} L={L} V={V}: launches {counts}; "
              f"gradients.coefficients called {len(coefficient_calls)} times")
        for k in ("prep", "wavefront", "grad"):
            fail_unless(counts[k] > 0, f"{k} kernel was not launched on the main path ({tag})")
        fail_unless(counts["grad_fields"] == 0 and not coefficient_calls,
                    f"the dense path ran the coefficient passes or the fields mode ({tag})")
        for k, n in counts.items():
            totals[k] += n
        fail_unless(bool(torch.isfinite(costs).all()) and costs.shape == (B,), "costs not finite")
        fail_unless(bool(torch.isfinite(grads).all()) and grads.shape == acts.shape,
                    "gradients not finite")
        fail_unless(abs(loss.item() - costs.sum().item()) <= 1e-5 * abs(costs.sum().item()),
                    "rnnt_loss and rnnt_loss_and_grad disagree")
        fail_unless(bool(torch.equal(a.grad, grads)), "backward and rnnt_loss_and_grad disagree")
        del a, loss
        costs_p, grads_p = rnnt_loss_and_grad(acts, labels, il, ll, implementation="torch")
        compare(f"costs {tag} kernels vs plain", costs, costs_p, "f32")
        # The prep's rounding (online vs two-pass logsumexp) moves alpha + beta - ll
        # by about |ll|·2^-24 per diagonal; exp() turns that into a relative
        # error of the gradient, ~1e-4 at |ll| ~ 4000 and 1800 diagonals.
        rel = float((grads - grads_p).norm() / grads_p.norm())
        print(f"grads {tag} kernels vs plain: relative norm error {rel:.3e} (tol 1e-3)")
        fail_unless(rel <= 1e-3, f"gradients of the kernels and the plain version differ ({tag})")
        del grads, grads_p
        problems[tag] = (acts, labels, il, ll)
        torch.cuda.empty_cache()

    phase_seconds("5")
    # ---- 5. timings, CUDA events after warm-up
    from warp_transducer_tpu_torch.ops import rnnt as rnnt_module
    folded_grads = rnnt_module._grads

    def fields_grads(eng, acts, prepped, res, labels, il, ll, blank, log_probs_input, scale,
                     fastemit_lambda):
        """The dense backward without the fold (the parent's ``_grads``): the
        plain (B, T, U) coefficient passes, then the fields mode."""
        fields = gradients.coefficients(prepped.lpb, prepped.lpe, res.alphas, res.betas,
                                        res.ll_forward, il, ll, scale, fastemit_lambda)
        return eng.dense_grad(acts, prepped.denom, fields, prep.label_rows(labels, acts.shape[2]),
                              il, ll, blank, acts.dtype)

    def unfolded(fn):
        def run():
            rnnt_module._grads = fields_grads
            try:
                return fn()
            finally:
                rnnt_module._grads = folded_grads
        return run

    def per_shape(tag, B, T, L, V):
        acts, labels, il, ll = problems[tag]
        U = L + 1
        n_big, n_small = B * T * U * V, B * T * U
        elt = acts.element_size()
        p = kprep.prepare(acts, labels, 0, False)
        res = kwave.forward_backward(p.lpb, p.lpe, il, ll)
        fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
        extra, cols = torch.stack((fields.cb, fields.ce), -1), (V - 2, V - 1)
        labels_u = prep.label_rows(labels, U)
        lat = (p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, labels_u, il, ll, 0)
        # Data-dependent work: the lattice reads lpb/lpe and updates only at
        # valid cells (it writes NEG elsewhere), and the gradients read acts
        # only in valid rows (they write zeros elsewhere).
        valid_cells = int((il.long() * (ll.long() + 1)).sum())
        iters = 20 if tag == "headline" else 5
        plain_iters = 2 if tag == "long_t" else 5
        out = {}
        step = lambda: rnnt_loss_and_grad(acts, labels, il, ll)  # noqa: E731
        # The step with the fold and without it, in turns.
        loss_grad, old_a, loss_grad_b, old_b = (time_ms(fn, iters)
                                                for fn in (step, unfolded(step)) * 2)
        print(f"time {tag}: loss+grad {loss_grad:.4f} / {loss_grad_b:.4f} ms; without the fold "
              f"(gradients.coefficients, then the fields mode) {old_a:.4f} / {old_b:.4f} ms")
        prep_k = lambda: kprep.prepare(acts, labels, 0, False)  # noqa: E731
        out["prep"] = dict(
            ms=time_ms(prep_k, iters), device_ms=device_ms(prep_k),
            kernel_device_ms=launch_device_ms(prep_k),
            plain_ms=time_ms(lambda: prep.prepare(acts, labels, 0, False), plain_iters, 1),
            library_ms=time_ms(lambda: torch.logsumexp(acts, -1), iters),
            bound=bound(n_big * elt + B * U * 4 + 3 * n_small * 4, 4 * n_big, F32_OPS_PER_S))
        wave_k = lambda: kwave.forward_backward(p.lpb, p.lpe, il, ll)  # noqa: E731
        n_max = int((il.long() + ll.long()).max())  # the longest lattice's diagonals
        wave_step = wave_steps.get(p.lpb.element_size())
        out["wavefront"] = dict(
            ms=time_ms(wave_k, iters), device_ms=device_ms(wave_k),
            kernel_device_ms=launch_device_ms(wave_k),
            plain_ms=time_ms(lambda: lattice.forward_backward(p.lpb, p.lpe, il, ll),
                             plain_iters, 1),
            library_ms=None, bound=wavefront_bound(p.lpb, il, ll),
            registers=kwave.kernel_registers(U, p.lpb.dtype), step_instructions=wave_step,
            chain_floor_ms=(n_max * wave_step / (clock_mhz * 1e3)
                            if wave_step and clock_mhz else None))
        softmax_ms = time_ms(lambda: torch.softmax(acts, -1), iters)
        # Each gradient reads acts in valid rows and writes every element,
        # reads the labels and lengths, and per valid row its own scalars:
        # the lattice mode α, β, lpb, lpe and denom (β's shifted reads are
        # of the same tensor) and ll a row of the batch; the fields mode
        # coef, cb, ce, denom and the K extra fields.
        grad_bytes = (n_big + valid_cells * V) * elt + B * U * 4 + 2 * B * 4
        out["grad"] = dict(
            ms=time_ms(lambda: kgrad.grad_wrt_acts(acts, p.denom, *lat, acts.dtype), iters),
            plain_ms=time_ms(lambda: gradients.grad_wrt_acts(acts, p.denom, *lat, acts.dtype),
                             plain_iters, 1),
            library_ms=softmax_ms,
            bound=bound(grad_bytes + 5 * valid_cells * 4 + B * 4, 4 * valid_cells * V,
                        F32_OPS_PER_S))
        for K_cols in (0, 2):
            kw = dict(extra_cols=cols, extra_fields=extra) if K_cols else {}
            g_args = (acts, p.denom, fields, labels_u, il, ll, 0, acts.dtype)
            out["grad_fields" + ("_k2" if K_cols else "")] = dict(
                ms=time_ms(lambda: kgrad.dense_grad(*g_args, **kw), iters),
                plain_ms=time_ms(lambda: gradients.dense_grad(*g_args, **kw), plain_iters, 1),
                library_ms=softmax_ms,
                bound=bound(grad_bytes + (4 + K_cols) * valid_cells * 4, 4 * valid_cells * V,
                            F32_OPS_PER_S))
        print(f"time {tag} B={B} T={T} L={L} V={V}: loss+grad {loss_grad:.4f} ms "
              f"(valid cells {valid_cells / n_small:.3f} of B·T·U)")
        prof = device_breakdown(tag, step, loss_grad)
        prof_old = device_breakdown(f"{tag} without the fold", unfolded(step), old_a)
        if prof and prof_old:
            fail_unless(prof[2] < prof_old[2], f"the folded step launches no fewer device kernels "
                        f"than the unfolded one ({tag})")
        for k, v in out.items():
            lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
            print(f"time {tag} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {lib}"
                  + (f" | device ms {v['device_ms']}, the kernel alone {v['kernel_device_ms']} "
                     f"(profiler)" if "device_ms" in v else "")
                  + (f" | chain floor {v['chain_floor_ms']} ms ({v['step_instructions']} SASS "
                     f"instructions a step), registers, local bytes {v['registers']}"
                     if "chain_floor_ms" in v else ""))
        step_info = dict(ms=loss_grad, ms_again=loss_grad_b, unfolded_ms=[old_a, old_b],
                         idle_share=prof and prof[1], device_kernels=prof and prof[2],
                         unfolded_idle_share=prof_old and prof_old[1],
                         unfolded_device_kernels=prof_old and prof_old[2])
        return step_info, out

    # The lattice kernel's chain floor: N_max diagonals × the SASS
    # instructions of one step ÷ the SM clock (a warp issues one a clock).
    clock_mhz = sm_clock_mhz()
    wave_steps = wavefront_step_instructions(build.build())
    print(f"wavefront: SASS instructions a step {wave_steps} (element bytes: count); "
          f"SM clock {clock_mhz} MHz (nvidia-smi clocks.max.sm)")
    timings = {tag: per_shape(tag, B, T, L, V) for tag, B, T, L, V in SHAPES}
    del problems
    torch.cuda.empty_cache()

    phase_seconds("5b")
    # ---- 5b. the char_long path: the dense lattice past one block's width on
    # the stripe kernel (f32; f64 past U = 352; past one cluster's reach), its
    # main path under the launch counters against the plain routes, timings
    stripe_timing, char_long_step = char_long_phase(dev, totals, errs, clock_mhz, build.build())
    torch.cuda.empty_cache()

    phase_seconds("6")
    # ---- 6. the pruned path: its kernels against their plain versions, the
    # pruned step under the launch counters, the full band, the timings
    pruned_kernels_vs_plain(dev, errs)
    pruned_problems = pruned_main_path(dev, totals)
    row_err = errs["band_stream"]  # the row walk's, at the pruned shapes
    cells_launches, cells_err, cells_timing = full_band_check(dev, errs, clock_mhz, build.build())
    band_timings, step_ms, step_mb = pruned_timings(pruned_problems)
    del pruned_problems
    torch.cuda.empty_cache()

    phase_seconds("7")
    # ---- 7. the fused joint+loss: its two kernels against their plain
    # versions, the fused step against the unfused composition, the pruned
    # fused step on both routes, the timings and peak memories
    joint_kernels_vs_plain(dev, errs)
    fused_steps_by_dtype = {dtype: fused_main_path(dev, totals, dtype)
                            for dtype in (torch.float32, torch.bfloat16)}
    joint_timings, fused_steps = fused_timings(dev, fused_steps_by_dtype)
    del fused_steps_by_dtype
    torch.cuda.empty_cache()
    pf_step, pf_ranges = pruned_fused_path(dev, totals)
    route_ms, pf_full_ms = time_routes(pf_step, pf_ranges)
    del pf_step, pf_ranges
    torch.cuda.empty_cache()

    phase_seconds("8")
    # ---- 8. the duration-arc losses: the window kernel and the extra
    # columns of prep and grad against their plain versions, both steps
    # under the launch counters, the timings
    duration_kernels_vs_plain(dev, errs)
    duration_problems = duration_main_path(dev, totals)
    duration_kernel_ms, duration_step_ms = duration_timings(duration_problems)
    del duration_problems
    torch.cuda.empty_cache()

    phase_seconds("8b")
    # ---- 8b. the window walk at the shapes of the earlier block kernel (B =
    # 128 at U = 601, TDT without a 0 duration, f64, U = 30,000): the public
    # losses under the counters, the kernel against the plain lattice
    former_window, former_window_launches = former_block_phase(dev, totals, errs, clock_mhz,
                                                               build.build())

    phase_seconds("9")
    # ---- 9. the duration-arc losses fused into the joint: joint_prep and
    # joint_grad with the extra columns and with the duration head, and the
    # duration-head pair, against their plain versions; both steps under the
    # launch counters against their unfused compositions, the TDT step on
    # both routes; the timings and peak memories
    variant_kernels_vs_plain(dev, errs)
    variant_steps = variant_main_path(dev, totals)
    variant_kernel_ms, variant_step, variant_routes = variant_timings(dev, *variant_steps)
    del variant_steps
    torch.cuda.empty_cache()

    phase_seconds("9b")
    # ---- 9b. the fused joint at joint width 2048 (deep k-slice streams): its
    # kernels with and without the hooks against their plain versions, the
    # four fused losses under the launch counters against the plain path, the
    # fused train step of the whole model at joint_dim 2048, the timings
    wide_kernel_ms, wide_step, wide_train = wide_phase(dev, totals, errs)

    phase_seconds("9c")
    # ---- 9c. duration sets past the kernels' by-value tables: TDT 0 … 8
    # (headline, long_t, fused on both routes, the whole model's train step
    # and its greedy decoder), nine and sixteen big blanks (raw, on
    # log-probs, fused), D = 33, a 300-frame window with its rings in device
    # memory, each against its plain route; the new instances timed beside
    # the by-value ones
    many_timing, many_launches, many_train = many_durations_phase(dev, totals, errs)

    phase_seconds("10")
    # ---- 10. the training surface: the eight train steps of the whole model
    # at its own width, each under the launch counters against its plain
    # twin, ten Adam steps, the timings; the binding on CUDA tensors
    train = train_phase(dev, totals)
    binding_check(dev, totals)

    phase_seconds("11")
    # ---- 11. the inference side: the five decoders at the train phase's
    # width and batch, with no host sync, their best hypotheses rescored
    # through the alignments and the losses' kernels; the three alignments
    # at the duration-arc shapes against the plain route and their own paths
    serve = serve_phase(dev, totals)

    phase_seconds("12")
    # ---- 12. the data-parallel wrappers of parallel/sharding.py: NCCL at
    # world size 1 at the shapes above, bit-equal to the local calls and
    # timed beside them; two gloo ranks sharing the card
    parallel = parallel_phase(dev, totals)

    sources = {
        "prep": ("warp_transducer_tpu_torch/csrc/prep.cu",
                 "warp_transducer_tpu/ops/pallas/prep_fused.py:31"),
        "wavefront": ("warp_transducer_tpu_torch/csrc/wavefront.cu",
                      "warp_transducer_tpu/ops/pallas/wavefront_stream.py:49"),
        # the lattice mode (the dense backward) and the fields mode (the
        # multi-blank loss and the TDT token head) of one source
        "grad": ("warp_transducer_tpu_torch/csrc/grad.cu",
                 "warp_transducer_tpu/ops/gradients.py:60"),
        "grad_fields": ("warp_transducer_tpu_torch/csrc/grad.cu",
                        "warp_transducer_tpu/ops/multiblank.py:268"),
    }

    def timing(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"]} | {
                    k: t[k] for k in ("device_ms", "kernel_device_ms", "chain_floor_ms",
                                      "step_instructions", "registers") if k in t}

    kernels = []
    for k, (source, replaces) in sources.items():
        head = timings["headline"][1][k]
        entry = {"name": k, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": totals[k], "max_abs_err": errs[k], "ms": head["ms"],
                 "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
                 "bound_by": head["bound"][1], "library_ms": head["library_ms"],
                 "shape": "headline B=128 T=150 L=40 V=28 f32",
                 "by_shape": {tag: timing(t[1][k]) | {"loss_grad": t[0]}
                              for tag, t in timings.items()}}
        if k == "wavefront":
            entry["also_replaces"] = "warp_transducer_tpu/ops/pallas/wavefront.py:72"
        elif k != "grad":  # with two extra columns; and those of the multi-blank step
            entry["by_shape"].update({f"{tag}_k2": timing(t[1][f"{k}_k2"])
                                      for tag, t in timings.items() if f"{k}_k2" in t[1]})
            entry["by_shape"].update({case: timing(t) for case, t in duration_kernel_ms[k].items()})
        if k == "grad_fields":
            entry["also_replaces"] = "warp_transducer_tpu/ops/tdt.py:296"
        kernels.append(entry)
    # The lattice past one block's width: the stripe kernel of the same
    # source, its own counter, at char_long.
    kernels.append({
        "name": "wavefront_stripe", "route": "cuda",
        "source": "warp_transducer_tpu_torch/csrc/wavefront.cu",
        "replaces": "warp_transducer_tpu/ops/pallas/wavefront_stream.py:49",
        "also_replaces": "warp_transducer_tpu/ops/pallas/wavefront.py:72",
        "launches": totals["wavefront_stripe"], "max_abs_err": errs["wavefront_stripe"],
        "ms": stripe_timing["ms"], "plain_ms": stripe_timing["plain_ms"],
        "bound_ms": stripe_timing["bound"][0], "bound_by": stripe_timing["bound"][1],
        "library_ms": None, "shape": "char_long B=32 T=1000 L=600 V=29 f32",
        "kernel": "wavefront_stripe_kernel"} | {
            k: stripe_timing[k] for k in ("kernel_device_ms", "chain_floor_ms",
                                          "step_instructions", "registers", "plan")}
        | {"loss_grad": char_long_step})
    pruned_sources = {
        "band_prep": ("warp_transducer_tpu_torch/csrc/band_prep.cu",
                      "warp_transducer_tpu/ops/pallas/band_pipeline.py:70"),
        "band_stream": ("warp_transducer_tpu_torch/csrc/band_stream.cu",
                        "warp_transducer_tpu/ops/pallas/band_stream.py:115"),
        "band_grad": ("warp_transducer_tpu_torch/csrc/band_grad.cu",
                      "warp_transducer_tpu/ops/pallas/band_pipeline.py:135"),
        "ranges": ("warp_transducer_tpu_torch/csrc/ranges.cu",
                   "warp_transducer_tpu/ops/pruned.py:94"),
    }
    band_extra = ("kernel_device_ms", "event_ms", "chain_floor_ms", "step_instructions",
                  "registers", "plan")
    for k, (source, replaces) in pruned_sources.items():
        head = band_timings[k]["pruned_long"]
        entry = {
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": totals[k], "max_abs_err": errs[k], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "shape": "pruned_long B=128 T=1500 L=300 V=50 S=5 f32",
            "by_shape": {tag: {"ms": t["ms"], "plain_ms": t["plain_ms"],
                               "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                               "library_ms": t["library_ms"], "pruned_step_ms": step_ms[tag],
                               "pruned_step_peak_mb": step_mb[tag]}
                         | {x: t[x] for x in band_extra if x in t}
                         for tag, t in band_timings[k].items()}}
        if k == "ranges":  # the whole of ranges_from_posteriors: argmax and scans
            entry["chain_floor_ms"] = head["chain_floor_ms"]
        if k == "band_stream":  # the row walk (S <= 32), the cells walk above
            entry["chain_floor_ms"] = head["chain_floor_ms"]
            entry["by_shape"]["full_band"] = timing(cells_timing) | {"plan": cells_timing["plan"]}
            # One wrapper and counter; the plan picks the kernel by S, and
            # every band of the main paths (S = 5) takes the row walk.
            fail_unless(all(kband.plan(B, T, S).row_mode for _, B, T, _, _, S in PRUNED_SHAPES)
                        and kband.plan(*PRUNED_FUSED_SHAPE[1:3], PRUNED_FUSED_SHAPE[-1]).row_mode,
                        "a band of the main paths is not planned on the row walk")
            entry["kernels"] = {
                "band_row_kernel": {"shapes": [tag for tag, *_ in PRUNED_SHAPES]
                                    + [PRUNED_FUSED_SHAPE[0]],
                                    "launches": totals[k], "max_abs_err": row_err},
                "band_cells_kernel": {"shapes": ["full_band B=128 T=150 S=41"],
                                      "launches_full_band": cells_launches,
                                      "max_abs_err": cells_err,
                                      "ms": cells_timing["ms"],
                                      "plain_ms": cells_timing["plain_ms"],
                                      "bound_ms": cells_timing["bound"][0],
                                      "chain_floor_ms": cells_timing["chain_floor_ms"]}}
        kernels.append(entry)
    joint_sources = {
        "joint_prep": ("warp_transducer_tpu_torch/csrc/joint_prep.cu",
                       "warp_transducer_tpu/ops/pallas/joint_fused.py:123"),
        "joint_grad": ("warp_transducer_tpu_torch/csrc/joint_grad.cu",
                       "warp_transducer_tpu/ops/pallas/joint_fused.py:283"),
    }
    # The gradient's column launch (dW, db) has a source of its own.
    also_source = {"joint_grad": "warp_transducer_tpu_torch/csrc/joint_grad_cols.cu"}
    fused_step_ms = {name: min(ms for ms, _ in runs) for name, runs in fused_steps.items()}
    fused_peak_mb = {name: max(mb for _, mb in runs) for name, runs in fused_steps.items()}

    def step_fields(suffix):  # the fused and unfused steps with W of this type
        return {f"{name}_{what}": table[f"{name}_{suffix}"]
                for name in ("fused", "unfused")
                for what, table in (("step_ms", fused_step_ms), ("peak_mb", fused_peak_mb))}

    for k, (source, replaces) in joint_sources.items():
        head = joint_timings[k]["fused_f32"]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": totals[k], "max_abs_err": errs[k], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "shape": "fused B=64 T=150 L=20 V=5000 H=256 f32",
            **({"also_source": also_source[k]} if k in also_source else {}),
            "by_shape": {case: {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                                "library_ms": t["library_ms"],
                                "registers": t["registers"],
                                "launch_ms": t.get("launch_ms"),
                                **step_fields(case.rsplit("_", 1)[1])}
                         for case, t in joint_timings[k].items()} | {
                # with K = 2 big-blank columns (k2) and the D = 4 duration
                # head (d4), beside K = 0 (k0) taken in the same phase
                case: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                       "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                       "launch_ms": t.get("launch_ms")}
                for case, t in variant_kernel_ms[k].items()} | {
                # at joint width 2048
                case: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                       "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                       "registers": t["registers"], "smem": t["smem"],
                       "launch_ms": t.get("launch_ms"),
                       **{f"{name}_{what}": wide_step[f"{name}_{case.rsplit('_', 1)[1]}"][i]
                          for name in ("fused", "plain", "unfused")
                          for i, what in enumerate(("step_ms", "peak_mb"))}}
                for case, t in wide_kernel_ms[k].items()}})
    head = duration_kernel_ms["window_stream"]["multiblank_headline"]
    kernels.append({
        "name": "window_stream", "route": "cuda",
        "source": "warp_transducer_tpu_torch/csrc/window_stream.cu",
        "replaces": "warp_transducer_tpu/ops/pallas/window_stream.py:104",
        "launches": totals["window_stream"], "max_abs_err": errs["window_stream"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": head["library_ms"],
        "shape": "multiblank headline B=128 T=150 L=40 V=28 durations (2, 4) f32",
        "by_shape": {case: timing(t) | {"step_ms": duration_step_ms[case]}
                     for case, t in duration_kernel_ms["window_stream"].items()}
        | {case: timing(t) | {"plan": t["plan"]} for case, t in former_window.items()},
        "launches_former_block_shapes": former_window_launches})
    head = variant_kernel_ms["dur_head"]["fused_prep"]
    kernels.append({
        "name": "dur_head", "route": "cuda",
        "source": "warp_transducer_tpu_torch/csrc/dur_head.cu",
        "replaces": "warp_transducer_tpu/ops/pallas/joint_fused.py:824",
        "also_replaces": "warp_transducer_tpu/ops/pallas/joint_fused.py:837",
        "launches": totals["dur_head"], "max_abs_err": errs["dur_head"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": head["library_ms"],
        "shape": "the prep kernel at fused B=64 T=150 L=20 H=256 D=4 f32",
        "by_shape": {case: timing(t) | {"bound_term": t["bound"][2],
                                        "library_device_ms": t["library_device_ms"],
                                        "library_graph_ms": t["library_graph_ms"]}
                     for case, t in variant_kernel_ms["dur_head"].items()} | {
                         case: timing(t) | {"bound_term": t["bound"][2]}
                         for case, t in wide_kernel_ms["dur_head"].items()}})
    # The instances past eight columns or arcs (and K7's rings in device
    # memory) under their kernels' entries: their launches on this run's
    # main paths (phase 9c) and their timings beside the by-value instance.
    for entry in kernels:
        if entry["name"] in many_timing:
            entry["past_eight"] = {
                "launches": many_launches[entry["name"]],
                "by_shape": {case: timing(t) for case, t in many_timing[entry["name"]].items()}}
    print(json.dumps({"many_durations": {"train_step": many_train}}))
    print(json.dumps({"fused_duration_arc": {
        "steps": {name: {"ms": ms, "peak_mb": mb} for name, (ms, mb) in variant_step.items()},
        "tdt_routes_ms": variant_routes}}))
    print(json.dumps({"pruned_fused": {
        "full_sweep_step_ms": pf_full_ms, "cut_batch": PRUNED_FUSED_CUT_B,
        "cut_sweep_step_ms": min(route_ms["sweep"]),
        "cut_materialised_step_ms": min(route_ms["materialised"])}}))
    print(json.dumps({"train": {"shape": dict(zip(("B", "T", "L"), TRAIN_SHAPE[1:])),
                                "steps": train}}))
    print(json.dumps({"wide": {"shape": dict(zip(("B", "T", "L", "V", "H"), WIDE_SHAPE[1:])),
                               "steps": {name: {"ms": ms, "peak_mb": mb}
                                         for name, (ms, mb) in wide_step.items()},
                               "train_step": wide_train}}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"parallel": parallel}))
    phase_seconds("report")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
