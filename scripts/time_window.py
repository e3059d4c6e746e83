"""Time the window lattice kernel (csrc/window_stream.cu) on one GPU, two
checkouts in turns.

    python scripts/time_window.py [--root DIR] [--iters N]

Times ``ops/cuda/window.py::forward_backward`` (alpha and beta) of the
package of ``--root`` (a parent commit unpacked beside this checkout) and of
this checkout, in the order parent, this, this, parent, each in a process of
its own, for both duration-arc families (multi-blank with big blanks of 2
and 4 frames, its channels from the prep kernel with the two extra columns;
TDT with durations 0, 1, 2, 4, its duration log-probs by log_softmax) at
shapes made by chip_smoke.make_duration_problem (seed 14, the main path's):
headline (128, 150, 40, 28), long_t (16, 1500, 300, 50), the fused shape's
lattice (64, 150, 20; the lattice does not depend on V, so V = 28 stands in
for 5000), both sides of one warp's 17 cells (100, 150, U = 544 and 545),
and the shapes that took the earlier block kernel: B = 128, T = 1000, U =
601 (a character-level model's labels at a training batch), B = 32 on the
same U with TDT durations (1, 2, 4) beside the two families (no duration 0:
no chain), and f64 at B = 4, T = 300, U = 601.

For each: ``kernel_ms``, the profiler's device time of the window kernel
over its launches (``alpha_kernel_ms``: the same without betas, alpha's
walk alone; ``warps_kernel_ms``: with 1, 2 and 4 warps a lattice forced,
where the plan takes more than one); ``ms``, CUDA events over ``--iters`` calls (the
wrapper's host work too); the bytes bound (chip_smoke.window_bound); T_max;
for this checkout the plan, the registers of the kernel the shape runs and
its chain floor: T_max × the SASS instructions of the longer row step
(chip_smoke.window_step_instructions, read with cuobjdump from the built
library) ÷ the SM clock that nvidia-smi reports. Prints the card's name and
power limit and one JSON object. Imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SHAPES = [("headline", 128, 150, 40, 28), ("long_t", 16, 1500, 300, 50),
          ("fused", 64, 150, 20, 28),
          # both sides of one warp's cap: with B = 100 the plan keeps one warp
          # a lattice up to 17 cells a lane (U = 544 f32), two above
          ("cap_warp", 100, 150, 543, 28), ("cap_block", 100, 150, 544, 28),
          # the shapes of the earlier block kernel
          ("B128_U601", 128, 1000, 600, 28), ("B32_U601", 32, 1000, 600, 28),
          ("f64_B4_U601", 4, 300, 600, 28)]
# The window kernel's names in this checkout and its parents.
KERNELS = ("window_kernel", "window_warp_kernel", "window_block_kernel")


def smoke():
    """This checkout's chip_smoke.py, loaded by path (the package under
    test may be another checkout's)."""
    spec = importlib.util.spec_from_file_location("window_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(fn, iters=20):
    """Device ms of one launch of the window kernel: the profiler's time of
    the kernel over its launches, or None where it records none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms, n = 0.0, 0
    for e in prof.key_averages():
        m = re.search(r"(\w+)[<(]", e.key)
        if (e.device_type == torch.autograd.DeviceType.CUDA and m and m.group(1) in KERNELS
                and e.self_device_time_total > 0):
            ms, n = ms + e.self_device_time_total / 1e3, n + e.count
    return ms / n if n else None


def one(root, iters):
    """Time the package of ``root``; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from warp_transducer_tpu_torch.ops import window
    from warp_transducer_tpu_torch.ops.cuda import build
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    sm = smoke()
    dev = torch.device("cuda", 0)
    clock_mhz = sm.sm_clock_mhz()
    new = hasattr(kwindow, "lattice_plan")
    steps = sm.window_step_instructions(build.build()) if new else {}
    out = {"root": str(root), "sm_clock_mhz": clock_mhz, "step_instructions": {
        f"{elt}_{c}_{'wide' if w else 'narrow'}": v for (elt, c, w), v in steps.items()}}
    for tag, B, T, L, V in SHAPES:
        acts, dur, labels, il, ll = sm.make_duration_problem(B, T, L, V, seed=14, dev=dev)
        p = kprep.prepare(acts, labels, 0, False, extra_cols=(V - 2, V - 1))
        lpd = torch.log_softmax(dur, -1)
        del acts, dur
        dtype = torch.float64 if tag.startswith("f64") else torch.float32
        lpb, lpe, lpB, lpd = (x.to(dtype) for x in (p.lpb, p.lpe, p.extras, lpd))
        families = [("multiblank", window.multiblank_arcs(sm.MB_DURATIONS), lpB),
                    ("tdt", window.tdt_arcs(sm.TDT_DURATIONS), lpd)]
        if tag == "B32_U601":  # TDT without a 0 duration: no chain
            families.append(("tdt_no_d0", window.tdt_arcs((1, 2, 4)),
                             torch.log_softmax(lpd[..., 1:], -1).contiguous()))
        for family, arcs, extra in families:
            fn = lambda: kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll)  # noqa: E731
            alpha = lambda: kwindow.forward_backward(lpb, lpe, extra, arcs, il, ll,  # noqa: E731
                                                     compute_betas=False)
            r = {"kernel_ms": kernel_ms(fn), "alpha_kernel_ms": kernel_ms(alpha),
                 "ms": sm.time_ms(fn, iters),
                 "bound_ms": sm.window_bound(lpb, extra, arcs, il, ll)[0],
                 "t_max": int(il.max())}
            if new:
                plan = kwindow.lattice_plan(lpb, extra, arcs)
                r["plan"] = plan._asdict()
                r["registers"] = kwindow.kernel_registers(plan, dtype)
                r["chain_floor_ms"], r["step_instructions"] = sm.window_chain_floor(
                    steps, lpb.element_size(), plan, il, clock_mhz)
                if plan.warps > 1:  # the alternatives, in the same process
                    r["warps_kernel_ms"] = {
                        g: kernel_ms(lambda: kwindow.launch(lpb, lpe, extra, arcs, il, ll,
                                                            warps=g))
                        for g in (1, 2, 4) if g != plan.warps
                        and kwindow.lattice_plan(lpb, extra, arcs, warps=g).passes == 1}
            out[f"{family}_{tag}"] = r
        del p, lpd, lpb, lpe, lpB, il, ll, labels
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(HERE / "build" / "parent"),
                        help="the parent checkout, timed first and last")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_window.py: no CUDA device is visible")
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
            sys.exit(f"time_window.py: the {label} run failed:\n{proc.stdout}\n{proc.stderr}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(f"{label}: " + " | ".join(
            f"{case} kernel {v['kernel_ms']} ms, event {v['ms']:.4f} ms"
            + (f", chain floor {v['chain_floor_ms']} ms, registers {v['registers']}"
               if "registers" in v else "")
            for case, v in r.items() if isinstance(v, dict) and "kernel_ms" in v), flush=True)
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
