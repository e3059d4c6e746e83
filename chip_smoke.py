#!/usr/bin/env python3
"""Smoke run of warp_transducer_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of warp_transducer_tpu_torch/csrc from this
checkout, holds each kernel against its plain PyTorch version on the card,
drives the two main paths with every launch counter read — the dense loss
(``rnnt_loss(...).backward()`` and ``rnnt_loss_and_grad``) at the
reference's published shapes, and the pruned step (``rnnt_loss_simple``
with ``prune_range`` → ``gather_banded`` → ``rnnt_loss_pruned``, backward
through both) at the JAX package's two published pruned shapes — checks
that a full band equals the dense loss, times each path and each kernel
with CUDA events, and prints:

  card line, build line, one line per comparison, per shape, per timing;
  the card's name and power limit as nvidia-smi gives them;
  {"kernels": [...]} — one entry per kernel;
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}} last.

Every check raises, so any failure ends the run with a non-zero exit and
without the last line. Without a visible CUDA device it exits at once.
Imports no JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

# The published H100 SXM rates (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores

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


def grad_tol(want, tol_key):
    """(rtol, atol) for a gradient: atol is GRAD_ATOL_SHARE of the median
    nonzero |g| of ``want``, taken over at most ~1e7 evenly strided entries."""
    nz = want.abs()[want != 0].float()
    if not nz.numel():
        return TOL[tol_key][0], 0.0
    return TOL[tol_key][0], GRAD_ATOL_SHARE * float(nz[::max(1, nz.numel() // 10 ** 7)].median())


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
                "band_kernel", "band_grad_kernel", "band_starts_kernel")


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
    port = sum(ms for ms, key in rows if "at::" not in key and
               re.split(r"[<(]", key.split("(anonymous namespace)::")[-1])[0] in PORT_KERNELS)
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
