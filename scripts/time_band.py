"""Time the band kernels of the pruned path on one GPU, two checkouts in
turns: the band lattice kernel (csrc/band_stream.cu), the band prep (K5a,
csrc/band_prep.cu) and the band starts (csrc/ranges.cu).

    python scripts/time_band.py [--root DIR] [--iters N]

Times the package of ``--root`` (a parent commit unpacked beside this
checkout) and this checkout, in the order parent, this, this, parent, each
in a process of its own, at three shapes:

* pruned_long (128, 1500, 300, 50, S = 5) and pruned_large_v (128, 150, 20,
  5000, S = 5): chip_smoke.py's pruned main path (its problems, seed 5: the
  simple loss's lattice and band starts, the additive joiner on the band,
  the band prep);
* full_band (128, 150, 40, 28, S = U = 41): the band over the whole
  headline lattice (ranges 0), lpb and lpe by the plain band prep of
  chip_smoke.make_problem's acts (seed 2), which the cells walk takes (one
  warp, three cells a lane; the lattice kernel only).

For each: ``kernel_ms``, the profiler's device time of one launch of the
lattice kernel (chip_smoke.launch_device_ms over this file's kernel names);
``ms``, CUDA events over ``--iters`` calls (the wrapper's host work too);
the roofline bound (chip_smoke.py's, bytes over 3.35 TB/s or operations
over 67 TFLOP/s); T_max, the longest utterance's rows; for this checkout
the plan, the registers of the kernel the shape runs and its chain floor:
T_max × the SASS instructions of the longer row step, alpha or beta
(chip_smoke.band_step_instructions: the row walk's, and the cells walk's
by instance; read with cuobjdump from the built library) ÷ the SM clock
that nvidia-smi reports. At the two pruned shapes
also the pruned step (chip_smoke.pruned_step, forward and backward: CUDA
events, and its peak device memory above what it starts with); ``band_prep``: ``ops/cuda/band.py::band_prep`` on the band (the
profiler's device time a launch, events beside it, bound, for this
checkout its plan and registers); and ``ranges``:
``ops/pruned.py::ranges_from_posteriors`` on the simple lattice, every
kernel of the call by the profiler (a parent's posterior argmax in torch
and its scan kernel; this checkout's one kernel), events beside it,
chip_smoke.ranges_bound, and for this checkout the registers and the
scans' chain floor (chip_smoke.ranges_chain_floor); and ``ranges_sweep``,
that call's profiler ms on random posteriors at eight (B, T, U) around
the pruned shapes (``SWEEP``: B from 16 to 256, T 150 to 1500, U 21 to
301). Prints the card's name and power limit and one JSON object. Imports no JAX; without a CUDA device
it says so and exits 0.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = [("pruned_long", 128, 1500, 300, 50, 5), ("pruned_large_v", 128, 150, 20, 5000, 5),
          ("full_band", 128, 150, 40, 28, 41)]
# ranges_from_posteriors on random posteriors of these (B, T, U), f32, S = 5:
# the pruned shapes' lattices and their neighbours in B, T and U.
SWEEP = [(128, 150, 21), (128, 500, 101), (128, 1500, 101), (128, 500, 301), (128, 1500, 301),
         (16, 1500, 301), (32, 1500, 301), (256, 1500, 301)]
# The band lattice kernel's names in this checkout and its parents, and
# the band prep's.
KERNELS = ("band_kernel", "band_row_kernel", "band_chunk_kernel", "band_cells_kernel")
PREP_KERNELS = ("band_prep_kernel", "band_prep_tile_kernel", "band_prep_warp_kernel")


def smoke():
    """This checkout's chip_smoke.py, loaded by path (the package under
    test may be another checkout's)."""
    spec = importlib.util.spec_from_file_location("band_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(tag, B, T, L, V, S, dev, sm):
    """(lpb, lpe, ranges, input lengths, label lengths) as the main path
    gives them, and chip_smoke.band_inputs' dict at the pruned shapes."""
    from warp_transducer_tpu_torch.ops import band
    if tag == "full_band":
        acts, labels, il, ll = sm.make_problem(B, T, L, V, seed=2, dev=dev)
        ranges = torch.zeros((B, T), dtype=torch.int32, device=dev)
        p = band.band_prep(acts, band.label_rows(*band.band_labels(labels, ranges, S)), 0)
        return (p.lpb, p.lpe, ranges, il, ll), None
    am, lm, labels, il, ll = sm.make_pruned_problem(B, T, L, V, seed=5, dev=dev)
    x = sm.band_inputs(am, lm, labels, il, ll, S)
    x["problem"] = (am.requires_grad_(True), lm.requires_grad_(True), labels, il, ll)
    return (x["prep"].lpb, x["prep"].lpe, x["ranges"], il, ll), x


def one(root, iters):
    """Time the package of ``root``; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from warp_transducer_tpu_torch.ops import pruned
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import build
    from warp_transducer_tpu_torch.ops.cuda import ranges as kranges
    from warp_transducer_tpu_torch.ops.cuda import rows as R
    sm = smoke()
    dev = torch.device("cuda", 0)
    new = hasattr(kranges, "ranges_from_posteriors")
    clock_mhz = sm.sm_clock_mhz()
    library = build.build()
    steps = sm.band_step_instructions(library)
    range_steps = sm.ranges_step_instructions(library) if new else {}
    out = {"root": str(root), "sm_clock_mhz": clock_mhz,
           "steps": {str(k): v for k, v in steps.items()},
           "range_steps": {f"{elt} bytes, G {g}": n for (elt, g), n in range_steps.items()}}
    for tag, B, T, L, V, S in SHAPES:
        (lpb, lpe, ranges, il, ll), x = inputs(tag, B, T, L, V, S, dev, sm)
        fn = lambda: kband.forward_backward(lpb, lpe, ranges, il, ll)  # noqa: E731
        r = {"kernel_ms": sm.launch_device_ms(fn, iters=20, names=KERNELS),
             "ms": sm.time_ms(fn, iters), "bound_ms": sm.band_lattice_bound(ranges, il, ll, S)[0],
             "t_max": int(il.max()), "plan": kband.plan(B, T, S)._asdict(),
             "registers": (kband.kernel_registers(T, S) if hasattr(kband, "cells")
                           else kband.kernel_registers(S))}
        r["chain_floor_ms"], r["step_instructions"] = sm.band_chain_floor(
            steps, S, il, clock_mhz, kband.plan(B, T, S))
        if x is not None:
            step = lambda: sm.pruned_step(*x["problem"], S)  # noqa: E731
            r["step_ms"], r["step_peak_mb"] = sm.time_ms(step, 5), sm.peak_mb(step)
            acts, lab_row = x["band"], x["lab_row"]
            prep = lambda: kband.band_prep(acts, lab_row, 0)  # noqa: E731
            rows, elt = B * T * S, acts.element_size()
            r["band_prep"] = {
                "kernel_ms": sm.launch_device_ms(prep, iters=20, names=PREP_KERNELS),
                "ms": sm.time_ms(prep, iters),
                "bound_ms": sm.bound(rows * V * elt + 4 * rows * 4, 4 * rows * V,
                                     sm.F32_OPS_PER_S)[0]}
            alphas, betas, llf = x["simple_lat"][:3]
            U = alphas.shape[2]
            starts = lambda: pruned.ranges_from_posteriors(alphas, betas, llf, il, ll, S)  # noqa: E731
            r["ranges"] = {"device_ms": sm.device_ms(starts, iters=20),
                           "ms": sm.time_ms(starts, iters),
                           "bound_ms": sm.ranges_bound(il, T, U, alphas.element_size())[0]}
            if new:
                plan = R.reduce_plan(V, elt, R.alignment(acts.data_ptr()))
                r["band_prep"]["plan"] = plan._asdict()
                r["band_prep"]["registers"] = kband.band_prep_registers(acts.dtype, plan)
                r["ranges"]["plan"] = kranges.plan(T, U)._asdict()
                r["ranges"]["registers"] = kranges.kernel_registers(alphas.dtype, U)
                r["ranges"]["chain_floor_ms"], r["ranges"]["step_instructions"] = \
                    sm.ranges_chain_floor(range_steps, il, T, U, alphas.element_size(), clock_mhz)
            del acts, lab_row, prep, alphas, betas, llf, starts, step
        out[tag] = r
        del lpb, lpe, ranges, il, ll, fn, x
        torch.cuda.empty_cache()
    out["ranges_sweep"] = sweep(pruned, sm, dev)
    print(json.dumps(out))


def sweep(pruned, sm, dev):
    """{"BxTxU": profiler ms} of ranges_from_posteriors on random f32
    posteriors (seed 0) at the SWEEP shapes, T_b in [T/2, T] (one at T), the
    label lengths in [(U-1)/2, U-1]."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B, T, U in SWEEP:
        alphas, betas = (torch.randn((B, T, U), generator=g, device=dev) for _ in range(2))
        llf = torch.randn((B,), generator=g, device=dev)
        il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        ll = torch.randint((U - 1) // 2, U, (B,), generator=g, device=dev, dtype=torch.int32)
        il[0] = T
        out[f"{B}x{T}x{U}"] = sm.device_ms(
            lambda: pruned.ranges_from_posteriors(alphas, betas, llf, il, ll, 5), iters=20)
        del alphas, betas
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(HERE / "build" / "parent"),
                        help="the parent checkout, timed first and last")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_band.py: no CUDA device is visible; nothing timed")
        return
    if args.one:
        one(args.one, args.iters)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    runs = []
    for label, root in (("parent", args.root), ("this", str(HERE)), ("this", str(HERE)),
                        ("parent", args.root)):
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--iters",
                               str(args.iters)], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"time_band.py: the {label} run failed:\n{proc.stdout}\n{proc.stderr}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(f"{label}: " + " | ".join(
            f"{tag} band_stream {r[tag]['kernel_ms']} ms a launch, event {r[tag]['ms']:.4f} ms, "
            f"chain floor {r[tag]['chain_floor_ms']} ms, registers {r[tag]['registers']}"
            + (f"; pruned step {r[tag]['step_ms']:.4f} ms, peak {r[tag]['step_peak_mb']:.1f} MB"
               if "step_ms" in r[tag] else "")
            + "".join(f"; {k} {r[tag][k].get('kernel_ms', r[tag][k].get('device_ms'))} ms "
                      f"(profiler), event {r[tag][k]['ms']:.4f} ms, bound "
                      f"{r[tag][k]['bound_ms']:.4f} ms, registers {r[tag][k].get('registers')}"
                      for k in ("band_prep", "ranges") if k in r[tag])
            for tag, *_ in SHAPES) + " | ranges sweep (profiler ms) " + json.dumps(r["ranges_sweep"]),
            flush=True)
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
