#!/usr/bin/env python3
"""Smoke run of warp_transducer_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of warp_transducer_tpu_torch/csrc from this
checkout, holds each kernel against its plain PyTorch version on the card,
drives the main paths with every launch counter read — the dense loss
(``rnnt_loss(...).backward()`` and ``rnnt_loss_and_grad``) at the
reference's published shapes, the pruned step (``rnnt_loss_simple``
with ``prune_range`` → ``gather_banded`` → ``rnnt_loss_pruned``, backward
through both) at the JAX package's two published pruned shapes, the fused
joint+loss step (``Joint.fused_loss`` forward and backward, weights loaded
through ``joint_state_dict_from_flax``) at the JAX package's published
fused shape, held against the unfused composition, and the pruned fused
step (``rnnt_loss_simple`` → ``Joint.pruned_fused_loss``) at the shape whose
band would not fit, and the two duration-arc steps
(``rnnt_loss_multiblank`` with big blanks of 2 and 4 frames,
``rnnt_loss_tdt`` with durations 0, 1, 2, 4, forward and backward) at the
JAX package's two published shapes for them, and the same two losses fused
into the joint (``Joint.multiblank_fused_loss``, ``Joint.tdt_fused_loss`` on
both of its routes) at the fused shape, held against their unfused
compositions — checks that a full band equals the dense loss, times each
path and each kernel with CUDA events, reads the peak memory of the fused
and the unfused steps, and prints:

  card line, build line, one line per comparison, per shape, per timing;
  the card's name and power limit as nvidia-smi gives them;
  {"kernels": [...]} — one entry per kernel (eleven);
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}} last.

Every check raises, so any failure ends the run with a non-zero exit and
without the last line. Without a visible CUDA device it exits at once.
Imports no JAX.
"""
from __future__ import annotations

import json
import re
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
PORT_KERNELS = ("prep_kernel", "wavefront_kernel", "grad_kernel", "band_prep_kernel",
                "band_kernel", "band_grad_kernel", "band_starts_kernel", "joint_prep_kernel",
                "joint_grad_rows_kernel", "joint_grad_cols_kernel", "joint_grad_dwd_kernel",
                "sum_parts_kernel", "dur_prep_kernel", "dur_grad_kernel", "window_kernel")


def device_breakdown(tag, fn, event_ms, iters=5, top=6):
    """Device time by kernel over a few calls (torch.profiler), the share of
    it in the port's own kernels, and the device's idle share:
    1 - busy / ``event_ms``, the CUDA-event time of one call taken without
    the profiler (whose own cost inflates wall)."""
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
    # it launched.
    rows = sorted(((e.self_device_time_total / 1e3 / iters, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print(f"profile {tag}: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[0] for r in rows)
    print(f"profile {tag}: device busy {busy:.4f} ms/call of {event_ms:.4f} ms "
          f"(idle share {max(0.0, 1 - busy / event_ms):.3f}); wall under the profiler "
          f"{wall_ms:.4f} ms/call")
    # A kernel's own name: the first identifier that a '<' or '(' follows
    # ("void (anonymous namespace)::prep_kernel<float, float>(float const*, …").
    port = sum(ms for ms, key in rows
               if (m := re.search(r"(\w+)[<(]", key)) and m.group(1) in PORT_KERNELS)
    print(f"profile {tag}: the port's kernels {port:.4f} ms/call, other kernels "
          f"{busy - port:.4f} ms/call in {len(rows)} kinds")
    for ms, key in rows[:top]:
        print(f"profile {tag}:   {ms:.4f} ms  {key[:90]}")


def bound(bytes_moved, ops, ops_rate):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def pruned_step(am, lm, labels, il, ll, S, implementation="auto"):
    """One pruned training step through the public entry points: the simple
    loss and its band starts, the additive joiner on the band, the pruned
    loss, and the backward through both into am.grad and lm.grad (am, lm:
    leaves that require grad)."""
    from warp_transducer_tpu_torch import gather_banded, rnnt_loss_pruned, rnnt_loss_simple
    am.grad = lm.grad = None
    loss_s, ranges = rnnt_loss_simple(am, lm, labels, il, ll, reduction="sum",
                                      implementation=implementation, prune_range=S)
    band_acts = am[:, :, None, :] + gather_banded(lm, ranges, S)
    loss_p = rnnt_loss_pruned(band_acts, ranges, labels, il, ll, reduction="sum",
                              implementation=implementation)
    (loss_s + loss_p).backward()
    return loss_s.detach(), loss_p.detach(), ranges


def band_inputs(am, lm, labels, il, ll, S):
    """What the pruned step hands its kernels: the posterior peaks of the
    simple lattice, the band starts, the band, its per-row labels, and the
    band prep, lattice and coefficient fields (kernels, unit cotangent)."""
    from warp_transducer_tpu_torch import gather_banded
    from warp_transducer_tpu_torch.ops import band, prep, simple
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import ranges as kranges
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    with torch.no_grad():
        f = simple._factorised_lattice_inputs(am, lm, prep.label_rows(labels, lm.shape[1]), 0,
                                              "highest")
        res = kwave.forward_backward(f.lpb, f.lpe, il, ll)
        best_u = band.posterior_peaks(res.alphas, res.betas, res.ll_forward)
        del f, res
        ranges = kranges.band_starts(best_u, il, ll, S)
        band_acts = am[:, :, None, :] + gather_banded(lm, ranges, S)
        lab_band, has_lab = band.band_labels(labels, ranges, S)
        lab_row = band.label_rows(lab_band, has_lab)
        p = kband.band_prep(band_acts, lab_row, 0)
        lat = kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)
        fields = band.band_coefs(p.lpb, p.lpe, lat, ranges, has_lab, il, ll,
                                 torch.ones(am.shape[0], device=am.device), 0.0)
    return dict(best_u=best_u, ranges=ranges, band=band_acts, has_lab=has_lab, lab_row=lab_row,
                prep=p, lat=lat, fields=fields)


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
        r_k = kranges.band_starts(x["best_u"], il, ll, S)
        torch.cuda.synchronize()
        r_p = band.band_starts(x["best_u"], il, ll, S)
        errs["ranges"] = max(errs["ranges"], compare(f"ranges {tag}", r_k, r_p, (0.0, 0.0)))
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


def full_band_check(dev):
    """A band over the whole headline lattice (S = U = 41, ranges = 0, the
    lattice kernel in two 32-lane chunks): rnnt_loss_pruned equals the dense
    rnnt_loss, costs and gradients."""
    from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_pruned
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L, V = SHAPES[0]
    acts, labels, il, ll = make_problem(B, T, L, V, seed=6, dev=dev)
    a = acts.requires_grad_(True)
    dense = rnnt_loss(a, labels, il, ll, reduction="none")
    (gd,) = torch.autograd.grad(dense.sum(), a)
    K.reset_launches()
    pruned = rnnt_loss_pruned(a, torch.zeros((B, T), dtype=torch.int32, device=dev), labels, il,
                              ll, reduction="none")
    (gp,) = torch.autograd.grad(pruned.sum(), a)
    torch.cuda.synchronize()
    fail_unless(K.launches["band_stream"] > 0, "the full band did not run the band kernels")
    compare(f"full band S=U={L + 1} {tag}: pruned vs dense costs", pruned.detach(),
            dense.detach(), "f32")
    rel = float((gp - gd).norm() / gd.norm())
    print(f"full band S=U={L + 1} {tag}: pruned vs dense gradient relative norm error {rel:.3e} "
          "(tol 1e-3)")
    fail_unless(rel <= 1e-3, "the full-band pruned gradient differs from the dense one")


def pruned_timings(problems):
    """The pruned step (CUDA events, and its device breakdown) and each
    pruned kernel at both shapes: ms, plain ms, library ms, bound.
    Returns ({kernel: {shape: timing}}, {shape: step ms})."""
    from warp_transducer_tpu_torch.ops import band
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import ranges as kranges
    out, step_ms = {k: {} for k in PRUNED_KERNELS}, {}
    for tag, B, T, L, V, S in PRUNED_SHAPES:
        am, lm, labels, il, ll = problems[tag]
        step_ms[tag] = time_ms(lambda: pruned_step(am, lm, labels, il, ll, S), 5)
        x = band_inputs(am.detach(), lm.detach(), labels, il, ll, S)
        ranges, acts, lab_row, p = x["ranges"], x["band"], x["lab_row"], x["prep"]
        # Data-dependent work: the lattice reads lpb/lpe and updates only at
        # valid cells, and the gradient reads the band and its fields only
        # in valid rows (both write NEG or zeros elsewhere).
        n_valid = int(band.band_valid(ranges, il, ll, S).sum())
        rows, elt = B * T * S, acts.element_size()
        print(f"time {tag} B={B} T={T} L={L} V={V} S={S}: pruned step {step_ms[tag]:.4f} ms "
              f"(valid band cells {n_valid / rows:.3f} of B·T·S)")
        device_breakdown(f"{tag} pruned step", lambda: pruned_step(am, lm, labels, il, ll, S),
                         step_ms[tag], top=12)
        out["band_prep"][tag] = dict(
            ms=time_ms(lambda: kband.band_prep(acts, lab_row, 0), 10),
            plain_ms=time_ms(lambda: band.band_prep(acts, lab_row, 0), 2, 1),
            library_ms=time_ms(lambda: torch.logsumexp(acts, -1), 10),
            bound=bound(rows * V * elt + rows * 4 + 3 * rows * 4, 4 * rows * V, F32_OPS_PER_S))
        out["band_stream"][tag] = dict(
            ms=time_ms(lambda: kband.forward_backward(p.lpb, p.lpe, ranges, il, ll), 10),
            plain_ms=time_ms(lambda: band.forward_backward(p.lpb, p.lpe, ranges, il, ll), 1, 1),
            library_ms=None,
            bound=bound((2 * n_valid + 2 * rows) * 4 + B * T * 4 + 4 * B * 4,
                        2 * band_cell_ops(S) * n_valid, F32_OPS_PER_S))
        grad_args = (acts, p.denom, x["fields"], lab_row, ranges, il, ll, 0, acts.dtype)
        out["band_grad"][tag] = dict(
            ms=time_ms(lambda: kband.band_grad(*grad_args), 10),
            plain_ms=time_ms(lambda: band.band_grad(*grad_args), 2, 1),
            library_ms=time_ms(lambda: torch.softmax(acts, -1), 10),
            bound=bound((n_valid + rows) * V * elt + 5 * n_valid * 4 + B * T * 4 + 2 * B * 4,
                        4 * n_valid * V, F32_OPS_PER_S))
        out["ranges"][tag] = dict(
            ms=time_ms(lambda: kranges.band_starts(x["best_u"], il, ll, S), 20),
            plain_ms=time_ms(lambda: band.band_starts(x["best_u"], il, ll, S), 1, 1),
            library_ms=None,
            bound=bound(2 * B * T * 4 + 2 * B * 4, 4 * 3 * B * T, F32_OPS_PER_S))
        for k in PRUNED_KERNELS:
            v = out[k][tag]
            lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
            print(f"time {tag} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {lib}")
        del x, acts, p, grad_args
        torch.cuda.empty_cache()
    return out, step_ms


# The JAX package's published fused shape (README.md, "Fused joint + loss";
# B, T, L, V, H) and a small one on which no tile divides V, H or the rows,
# with the blank in the last column.
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


def check_step(tag, got, want, what):
    """Costs rtol 1e-5 and every gradient within a relative norm error of
    1e-3, as the other end-to-end checks."""
    compare(f"{tag} loss vs {what}", got[0], want[0], "f32")
    for n in got[1]:
        rel = rel_norm(got[1][n], want[1][n])
        print(f"{tag} d{n} vs {what}: relative norm error {rel:.3e} (tol 1e-3)")
        fail_unless(rel <= 1e-3 and bool(torch.isfinite(got[1][n]).all()),
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


def fused_main_path(dev, totals):
    """``Joint.fused_loss`` forward and backward at the fused shape under
    the launch counters, with no host sync allowed, held against
    implementation="torch" and against the unfused composition
    (``Joint.forward`` → ``rnnt_loss``: 4.0 GB of logits). Returns what the
    timings need."""
    from warp_transducer_tpu_torch import rnnt_loss
    from warp_transducer_tpu_torch.ops import cuda as K
    tag, B, T, L, V, H = FUSED_SHAPE
    joint = make_joint_module(V, H, seed=8, dev=dev)
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
    check_step(tag, got, fused("torch"), "the plain path")
    check_step(tag, got, unfused(), "the unfused composition")
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


def fused_timings(dev, fused, unfused):
    """The fused and the unfused step (time, peak memory, device breakdown)
    and the two fused kernels at the fused shape in f32 and bf16: ms, plain
    ms, library ms, bound. Returns ({kernel: {case: timing}}, step times)."""
    from warp_transducer_tpu_torch.ops import fused_joint
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    tag, B, T, L, V, H = FUSED_SHAPE
    steps = {}
    for name, fn in (("fused", fused), ("unfused", unfused), ("unfused", unfused),
                     ("fused", fused)):
        ms = time_ms(fn, 3, 1)
        mem = peak_mb(fn)
        steps.setdefault(name, []).append((ms, mem))
        print(f"time {tag} B={B} T={T} L={L} V={V} H={H}: {name} step {ms:.4f} ms, "
              f"peak {mem:.1f} MB")
    device_breakdown(f"{tag} fused step", fused, steps["fused"][0][0], iters=3, top=10)
    device_breakdown(f"{tag} unfused step", unfused, steps["unfused"][0][0], iters=3, top=10)
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
        rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
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
        out["joint_prep"][case] = dict(
            ms=time_ms(lambda: kjoint.fused_prep(*prep_args), 5),
            plain_ms=time_ms(lambda: fused_joint.fused_prep(*prep_args), 2, 1),
            library_ms=time_ms(lambda: torch.matmul(h, W), 5),
            bound=bound(in_bytes + 3 * small, 2 * rows * H * V, rate))
        out["joint_grad"][case] = dict(
            ms=time_ms(lambda: kjoint.fused_grad(*grad_args), 3),
            plain_ms=time_ms(lambda: fused_joint.fused_grad(*grad_args), 2, 1),
            library_ms=time_ms(three_products, 3),
            bound=bound(2 * in_bytes + 4 * small, 3 * 2 * rows * H * V, rate))
        print(f"time {case}: valid rows {rows} ({rows / (B * T * U):.3f} of B·T·U)")
        for k in out:
            v = out[k][case]
            print(f"time {case} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library "
                  f"{v['library_ms']:.4f} ms")
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
    """Operations of one lattice cell in one direction of the window kernel:
    per arc a weight sum, an add and a log-sum-exp of about six operations;
    for the chain two block scans of ceil(log2 U) steps (an add, and a
    log-sum-exp) and four more (the clamp, ne − c, c + z, the select)."""
    n_arcs = len(arcs.blank_arcs) + len(arcs.emit_arcs)
    steps = max(1, (U - 1).bit_length())
    return n_arcs * 8 + (steps * 7 + 4 if arcs.chain is not None else 0)


def duration_kernels_vs_plain(dev, errs):
    """The window kernel against the plain lattice for the multi-blank and
    the TDT arcs (with and without d = 0), f32 and f64, at both shapes, and
    at K = 0 against the wavefront kernel; prep and grad with K = 2 extra
    columns at both shapes and at the large-vocabulary one, f32 and bf16."""
    from warp_transducer_tpu_torch.ops import gradients, multiblank, prep, window
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
            errs["grad"] = max(errs["grad"], e)
        return p, torch.log_softmax(dur.float(), -1), il, ll

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
    costs and the gradients."""
    from warp_transducer_tpu_torch import rnnt_loss_multiblank, rnnt_loss_tdt
    acts.grad = dur.grad = None
    if loss == "multiblank":
        costs = rnnt_loss_multiblank(acts, labels, il, ll, MB_DURATIONS, sigma=MB_SIGMA,
                                     reduction="none", implementation=implementation)
    else:
        costs = rnnt_loss_tdt(acts, dur, labels, il, ll, TDT_DURATIONS, reduction="none",
                              implementation=implementation)
    costs.sum().backward()
    grads = {"acts": acts.grad} if loss == "multiblank" else {"tok": acts.grad, "dur": dur.grad}
    return costs.detach(), grads


def duration_main_path(dev, totals):
    """Both duration-arc steps at both shapes under the launch counters,
    with no host sync allowed, held against the same step with
    implementation="torch" (timed once there: its lattice is T steps of torch
    ops). Returns {shape: problem}."""
    from warp_transducer_tpu_torch.ops import cuda as K
    problems = {}
    for tag, B, T, L, V in DURATION_SHAPES:
        acts, dur, labels, il, ll = make_duration_problem(B, T, L, V, seed=14, dev=dev)
        acts.requires_grad_(True)
        dur.requires_grad_(True)
        for loss in ("multiblank", "tdt"):
            K.reset_launches()
            torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
            costs, grads = duration_step(loss, acts, dur, labels, il, ll)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            counts = dict(K.launches)
            print(f"main path {loss} {tag} B={B} T={T} L={L} V={V}: launches {counts}")
            for k in ("prep", "window_stream", "grad"):
                fail_unless(counts[k] > 0, f"{k} kernel was not launched on the {loss} path ({tag})")
            fail_unless(counts["wavefront"] == 0, f"the {loss} path ran the dense lattice ({tag})")
            for k, n in counts.items():
                totals[k] += n
            grads = {n: g.clone() for n, g in grads.items()}
            fail_unless(costs.shape == (B,) and bool(torch.isfinite(costs).all())
                        and bool((costs < 1e29).all()), f"{loss} {tag}: costs not finite")
            started = time.perf_counter()
            costs_p, grads_p = duration_step(loss, acts, dur, labels, il, ll, "torch")
            torch.cuda.synchronize()
            print(f"time {loss} {tag}: the plain step once {(time.perf_counter() - started) * 1e3:.1f} ms")
            compare(f"{loss} costs {tag} kernels vs plain", costs, costs_p, "f32")
            # As for the dense path: the prep's rounding moves α + β − ll, and
            # exp() turns that into a relative error of the gradient.
            for n in grads:
                fail_unless(grads[n].shape == grads_p[n].shape
                            and bool(torch.isfinite(grads[n]).all()), f"{loss} {tag}: d{n} not finite")
                rel = rel_norm(grads[n], grads_p[n])
                print(f"{loss} grads {tag} d{n} kernels vs plain: relative norm error {rel:.3e} "
                      "(tol 1e-3)")
                fail_unless(rel <= 1e-3, f"d{n} of the kernels and the plain path differ ({loss} {tag})")
            del grads, grads_p
        acts.grad = dur.grad = None
        problems[tag] = (acts, dur, labels, il, ll)
        torch.cuda.empty_cache()
    return problems


def duration_timings(problems):
    """Both steps (CUDA events, device breakdown) and, at both shapes: the
    window kernel for each family, prep and grad with K = 2, the coefficient
    passes. Returns ({kernel: {case: timing}}, {case: step ms})."""
    from warp_transducer_tpu_torch.ops import gradients, multiblank, prep, tdt, window
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    out, step_ms = {"window_stream": {}, "prep": {}, "grad": {}}, {}
    for tag, B, T, L, V in DURATION_SHAPES:
        acts, dur, labels, il, ll = problems[tag]
        U = L + 1
        long_t = tag == "long_t"
        iters, plain_iters = (5, 1) if long_t else (20, 2)
        for loss in ("multiblank", "tdt"):
            step = lambda: duration_step(loss, acts, dur, labels, il, ll)  # noqa: E731
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
                v = out["window_stream"][f"{loss}_{tag}"] = dict(
                    ms=time_ms(lambda: kwindow.forward_backward(p.lpb, p.lpe, extra, arcs, il, ll),
                               iters),
                    plain_ms=time_ms(lambda: window.forward_backward(p.lpb, p.lpe, extra, arcs,
                                                                     il, ll), plain_iters, 0),
                    library_ms=None,
                    # Data-dependent: the channels are read at valid cells only;
                    # every cell of alphas and betas is written.
                    bound=bound(((2 + C) * valid_cells + 2 * n_small) * 4 + 4 * B * 4,
                                2 * window_cell_ops(arcs, U) * valid_cells, F32_OPS_PER_S))
                print(f"time {tag} window_stream {loss}: {v['ms'] * 1e3 / T:.3f} us a row of "
                      f"U={U} (both directions side by side, B={B} blocks each)")
            out["prep"][f"{tag}_k2"] = dict(
                ms=time_ms(lambda: kprep.prepare(a, labels, 0, False, extra_cols=cols), iters),
                plain_ms=time_ms(lambda: prep.prepare(a, labels, 0, False, extra_cols=cols),
                                 plain_iters, 1),
                library_ms=time_ms(lambda: torch.logsumexp(a, -1), iters),
                bound=bound(n_big * elt + B * U * 4 + 5 * n_small * 4, 4 * n_big, F32_OPS_PER_S))
            coef, cb, ce, cBs = multiblank._mb_coefs(p.lpb, p.lpe, p.extras, lats["multiblank"],
                                                     MB_DURATIONS, il, ll)
            fields, extra_f = gradients.Coefficients(coef, cb, ce), torch.stack(cBs, dim=-1)
            g_args = (a, p.denom, fields, prep.label_rows(labels, U), il, ll, 0, a.dtype)
            out["grad"][f"{tag}_k2"] = dict(
                ms=time_ms(lambda: kgrad.dense_grad(*g_args, extra_cols=cols, extra_fields=extra_f),
                           iters),
                plain_ms=time_ms(lambda: gradients.dense_grad(*g_args, extra_cols=cols,
                                                              extra_fields=extra_f), plain_iters, 1),
                library_ms=time_ms(lambda: torch.softmax(a, -1), iters),
                bound=bound((n_big + valid_cells * V) * elt + 6 * valid_cells * 4 + B * U * 4
                            + 2 * B * 4, 4 * valid_cells * V, F32_OPS_PER_S))
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
                          f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {lib}")
            del p, lpd, lats, fields, extra_f, g_args, coef, cb, ce, cBs, a
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
        rate = F32_OPS_PER_S if f32 else BF16_OPS_PER_S
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
                            3 * 2 * rows * H * V + 2 * 2 * rows * H * n_d, rate))
        if f32:
            ep_bytes = (e.numel() + p.numel()) * 4
            out["dur_head"][f"{tag}_prep"] = dict(
                ms=time_ms(lambda: kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll), 10),
                plain_ms=time_ms(lambda: fused_joint.dur_head_prep(e, p, Wd, bias_d, il, ll), 2, 1),
                library_ms=time_ms(lambda: torch.matmul(h32, Wd), 10),
                bound=bound(ep_bytes + head_bytes + rows * D * 4 + 2 * B * 4, 2 * rows * H * D,
                            F32_OPS_PER_S))
            out["dur_head"][f"{tag}_grad"] = dict(
                ms=time_ms(lambda: kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll), 10),
                plain_ms=time_ms(lambda: fused_joint.dur_head_grad(e, p, Wd, g_dur, il, ll), 2, 1),
                library_ms=time_ms(lambda: (torch.matmul(gd2, Wd.t()), torch.matmul(h32.t(), gd2)),
                                   10),
                bound=bound(2 * ep_bytes + 2 * Wd.numel() * 4 + rows * D * 4 + 2 * B * 4,
                            4 * rows * H * D, F32_OPS_PER_S))
        print(f"time {tag} {suffix}: valid rows {rows} ({rows / (B * T * U):.3f} of B·T·U)")
        for k, cases_k in out.items():
            for key, v in cases_k.items():
                if suffix not in key and k != "dur_head":
                    continue
                if k == "dur_head" and not f32:
                    continue
                print(f"time {key} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                      f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library "
                      f"{v['library_ms']:.4f} ms")
        del h32, h, g, gd2, denom, mb_fields, cX, td_fields, g_dur, problem, args, g_args, cases
        torch.cuda.empty_cache()
    return out, steps, routes


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device is visible; this script runs only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from warp_transducer_tpu_torch import rnnt_loss, rnnt_loss_and_grad, rnnt_score
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import gradients, lattice, prep
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
          f"{build.BUILD_ROOT.name}/{build.LIB_NAME})")

    errs = dict.fromkeys(K.launches, 0.0)

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
        fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
        labels_u = prep.label_rows(labels, L + 1)
        g_k = kgrad.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype)
        torch.cuda.synchronize()
        g_p = gradients.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0, dtype)
        tol_key = "f32" if dtype == torch.float32 else "bf16_out"
        e = compare(f"grad {tag} {dtype}", g_k, g_p, grad_tol(g_p, tol_key))
        del g_k, g_p
        if full:  # the sparse (log_probs_input) convention of the same kernel
            g_k = kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
            torch.cuda.synchronize()
            g_p = gradients.sparse_grad(fields, labels_u, il, ll, 0, V, dtype)
            e = max(e, compare(f"grad {tag} {dtype} sparse", g_k, g_p, grad_tol(g_p, tol_key)))
            del g_k, g_p
        if dtype == torch.float32:
            errs["grad"] = max(errs["grad"], e)

    for tag, B, T, L, V in SHAPES:
        kernel_vs_plain(tag, B, T, L, V, torch.float32, full=(tag == "headline"))
    _, B, T, L, V = SHAPES[0]
    kernel_vs_plain("headline", B, T, L, V, torch.bfloat16, full=False)
    kernel_vs_plain("headline", B, T, L, V, torch.float64, full=True)
    torch.cuda.synchronize()

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
    for tag, B, T, L, V in SHAPES:
        acts, labels, il, ll = make_problem(B, T, L, V, seed=2, dev=dev)
        a = acts.clone().requires_grad_(True)
        K.reset_launches()
        torch.cuda.set_sync_debug_mode("error")  # any host sync on the path raises
        loss = rnnt_loss(a, labels, il, ll, reduction="sum")
        loss.backward()
        costs, grads = rnnt_loss_and_grad(acts, labels, il, ll)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(K.launches)
        print(f"main path {tag} B={B} T={T} L={L} V={V}: launches {counts}")
        for k in ("prep", "wavefront", "grad"):
            fail_unless(counts[k] > 0, f"{k} kernel was not launched on the main path ({tag})")
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

    # ---- 5. timings, CUDA events after warm-up
    def per_shape(tag, B, T, L, V):
        acts, labels, il, ll = problems[tag]
        U = L + 1
        n_big, n_small = B * T * U * V, B * T * U
        elt = acts.element_size()
        p = kprep.prepare(acts, labels, 0, False)
        res = kwave.forward_backward(p.lpb, p.lpe, il, ll)
        fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, il, ll)
        labels_u = prep.label_rows(labels, U)
        # Data-dependent work: the lattice reads lpb/lpe and updates only at
        # valid cells (it writes NEG elsewhere), and the gradient reads acts
        # and its four (B,T,U) fields only in valid rows (it writes zeros
        # elsewhere).
        valid_cells = int((il.long() * (ll.long() + 1)).sum())
        iters = 20 if tag == "headline" else 5
        plain_iters = 2 if tag == "long_t" else 5
        out = {}
        loss_grad = time_ms(lambda: rnnt_loss_and_grad(acts, labels, il, ll), iters)
        out["prep"] = dict(
            ms=time_ms(lambda: kprep.prepare(acts, labels, 0, False), iters),
            plain_ms=time_ms(lambda: prep.prepare(acts, labels, 0, False), plain_iters, 1),
            library_ms=time_ms(lambda: torch.logsumexp(acts, -1), iters),
            bound=bound(n_big * elt + B * U * 4 + 3 * n_small * 4, 4 * n_big, F32_OPS_PER_S))
        out["wavefront"] = dict(
            ms=time_ms(lambda: kwave.forward_backward(p.lpb, p.lpe, il, ll), iters),
            plain_ms=time_ms(lambda: lattice.forward_backward(p.lpb, p.lpe, il, ll),
                             plain_iters, 1),
            library_ms=None,
            bound=bound((2 * valid_cells + 2 * n_small) * 4 + 4 * B * 4, 2 * 8 * valid_cells,
                        F32_OPS_PER_S))
        out["grad"] = dict(
            ms=time_ms(lambda: kgrad.dense_grad(acts, p.denom, fields, labels_u, il, ll, 0,
                                                acts.dtype), iters),
            plain_ms=time_ms(lambda: gradients.dense_grad(acts, p.denom, fields, labels_u, il,
                                                          ll, 0, acts.dtype), plain_iters, 1),
            library_ms=time_ms(lambda: torch.softmax(acts, -1), iters),
            bound=bound((n_big + valid_cells * V) * elt + 4 * valid_cells * 4 + B * U * 4 + 2 * B * 4,
                        4 * valid_cells * V, F32_OPS_PER_S))
        print(f"time {tag} B={B} T={T} L={L} V={V}: loss+grad {loss_grad:.4f} ms "
              f"(valid cells {valid_cells / n_small:.3f} of B·T·U)")
        device_breakdown(tag, lambda: rnnt_loss_and_grad(acts, labels, il, ll), loss_grad)
        for k, v in out.items():
            lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
            print(f"time {tag} {k}: {v['ms']:.4f} ms | plain {v['plain_ms']:.4f} ms | "
                  f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) | library {lib}")
        return loss_grad, out

    timings = {tag: per_shape(tag, B, T, L, V) for tag, B, T, L, V in SHAPES}
    del problems
    torch.cuda.empty_cache()

    # ---- 6. the pruned path: its kernels against their plain versions, the
    # pruned step under the launch counters, the full band, the timings
    pruned_kernels_vs_plain(dev, errs)
    pruned_problems = pruned_main_path(dev, totals)
    full_band_check(dev)
    band_timings, step_ms = pruned_timings(pruned_problems)
    del pruned_problems
    torch.cuda.empty_cache()

    # ---- 7. the fused joint+loss: its two kernels against their plain
    # versions, the fused step against the unfused composition, the pruned
    # fused step on both routes, the timings and peak memories
    joint_kernels_vs_plain(dev, errs)
    fused, unfused = fused_main_path(dev, totals)
    joint_timings, fused_steps = fused_timings(dev, fused, unfused)
    del fused, unfused
    torch.cuda.empty_cache()
    pf_step, pf_ranges = pruned_fused_path(dev, totals)
    route_ms, pf_full_ms = time_routes(pf_step, pf_ranges)
    del pf_step, pf_ranges
    torch.cuda.empty_cache()

    # ---- 8. the duration-arc losses: the window kernel and the extra
    # columns of prep and grad against their plain versions, both steps
    # under the launch counters, the timings
    duration_kernels_vs_plain(dev, errs)
    duration_problems = duration_main_path(dev, totals)
    duration_kernel_ms, duration_step_ms = duration_timings(duration_problems)
    del duration_problems
    torch.cuda.empty_cache()

    # ---- 9. the duration-arc losses fused into the joint: joint_prep and
    # joint_grad with the extra columns and with the duration head, and the
    # duration-head pair, against their plain versions; both steps under the
    # launch counters against their unfused compositions, the TDT step on
    # both routes; the timings and peak memories
    variant_kernels_vs_plain(dev, errs)
    variant_steps = variant_main_path(dev, totals)
    variant_kernel_ms, variant_step, variant_routes = variant_timings(dev, *variant_steps)
    del variant_steps

    sources = {
        "prep": ("warp_transducer_tpu_torch/csrc/prep.cu",
                 "warp_transducer_tpu/ops/pallas/prep_fused.py:31"),
        "wavefront": ("warp_transducer_tpu_torch/csrc/wavefront.cu",
                      "warp_transducer_tpu/ops/pallas/wavefront_stream.py:49"),
        "grad": ("warp_transducer_tpu_torch/csrc/grad.cu",
                 "warp_transducer_tpu/ops/gradients.py:60"),
    }
    kernels = []
    for k, (source, replaces) in sources.items():
        head = timings["headline"][1][k]
        entry = {"name": k, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": totals[k], "max_abs_err": errs[k], "ms": head["ms"],
                 "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
                 "bound_by": head["bound"][1], "library_ms": head["library_ms"],
                 "shape": "headline B=128 T=150 L=40 V=28 f32",
                 "by_shape": {tag: {"ms": t[1][k]["ms"], "plain_ms": t[1][k]["plain_ms"],
                                    "bound_ms": t[1][k]["bound"][0],
                                    "bound_by": t[1][k]["bound"][1],
                                    "library_ms": t[1][k]["library_ms"],
                                    "loss_grad_ms": t[0]}
                              for tag, t in timings.items()}}
        if k == "wavefront":
            entry["also_replaces"] = "warp_transducer_tpu/ops/pallas/wavefront.py:72"
        else:  # with the two big-blank columns of the multi-blank step
            entry["by_shape"].update({
                case: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                       "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
                for case, t in duration_kernel_ms[k].items()})
        kernels.append(entry)
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
    for k, (source, replaces) in pruned_sources.items():
        head = band_timings[k]["pruned_long"]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": totals[k], "max_abs_err": errs[k], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "shape": "pruned_long B=128 T=1500 L=300 V=50 S=5 f32",
            "by_shape": {tag: {"ms": t["ms"], "plain_ms": t["plain_ms"],
                               "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                               "library_ms": t["library_ms"], "pruned_step_ms": step_ms[tag]}
                         for tag, t in band_timings[k].items()}})
    joint_sources = {
        "joint_prep": ("warp_transducer_tpu_torch/csrc/joint_prep.cu",
                       "warp_transducer_tpu/ops/pallas/joint_fused.py:123"),
        "joint_grad": ("warp_transducer_tpu_torch/csrc/joint_grad.cu",
                       "warp_transducer_tpu/ops/pallas/joint_fused.py:283"),
    }
    fused_step_ms = {name: min(ms for ms, _ in runs) for name, runs in fused_steps.items()}
    fused_peak_mb = {name: max(mb for _, mb in runs) for name, runs in fused_steps.items()}
    for k, (source, replaces) in joint_sources.items():
        head = joint_timings[k]["fused_f32"]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": totals[k], "max_abs_err": errs[k], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
            "bound_by": head["bound"][1], "library_ms": head["library_ms"],
            "shape": "fused B=64 T=150 L=20 V=5000 H=256 f32",
            "by_shape": {case: {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                                "library_ms": t["library_ms"],
                                "fused_step_ms": fused_step_ms["fused"],
                                "unfused_step_ms": fused_step_ms["unfused"],
                                "fused_peak_mb": fused_peak_mb["fused"],
                                "unfused_peak_mb": fused_peak_mb["unfused"]}
                         for case, t in joint_timings[k].items()} | {
                # with K = 2 big-blank columns (k2) and the D = 4 duration
                # head (d4), beside K = 0 (k0) taken in the same phase
                case: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                       "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
                for case, t in variant_kernel_ms[k].items()}})
    head = duration_kernel_ms["window_stream"]["multiblank_headline"]
    kernels.append({
        "name": "window_stream", "route": "cuda",
        "source": "warp_transducer_tpu_torch/csrc/window_stream.cu",
        "replaces": "warp_transducer_tpu/ops/pallas/window_stream.py:104",
        "launches": totals["window_stream"], "max_abs_err": errs["window_stream"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": head["library_ms"],
        "shape": "multiblank headline B=128 T=150 L=40 V=28 durations (2, 4) f32",
        "by_shape": {case: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                            "step_ms": duration_step_ms[case]}
                     for case, t in duration_kernel_ms["window_stream"].items()}})
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
        "by_shape": {case: {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                            "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
                     for case, t in variant_kernel_ms["dur_head"].items()}})
    print(json.dumps({"fused_duration_arc": {
        "steps": {name: {"ms": ms, "peak_mb": mb} for name, (ms, mb) in variant_step.items()},
        "tdt_routes_ms": variant_routes}}))
    print(json.dumps({"pruned_fused": {
        "full_sweep_step_ms": pf_full_ms, "cut_batch": PRUNED_FUSED_CUT_B,
        "cut_sweep_step_ms": min(route_ms["sweep"]),
        "cut_materialised_step_ms": min(route_ms["materialised"])}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
