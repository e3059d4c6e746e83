"""Time the lattice kernel (csrc/wavefront.cu) on one GPU, two checkouts in
turns.

    python scripts/time_wavefront.py [--root DIR] [--iters N]

Times ``ops/cuda/wavefront.py::forward_backward`` (alpha and beta) of the
package of ``--root`` (a parent commit unpacked beside this checkout) and
of this checkout, in the order parent, this, this, parent, each in a
process of its own, at four shapes:

* the dense shapes of chip_smoke.py, headline (128, 150, 40, 28), large_v
  (32, 150, 20, 5000) and long_t (16, 1500, 300, 50): lpb and lpe by the
  plain prep from chip_smoke.make_problem's acts (seed 2, its main path);
* pruned_long (128, 1500, 300, 50): the simple loss's lattice, lpb and lpe
  of the additive joiner from chip_smoke.make_pruned_problem (seed 5);
* char_long (32, 1000, 600, 29; chip_smoke.CHAR_LONG_SHAPE): U = 601, past
  one block's width (the stripe kernel; the parent of that kernel ran its
  block kernel there), lpb and lpe as for the dense shapes, and beside the
  kernel the dense step ``rnnt_loss_and_grad`` (CUDA events, and the
  profiler's device time of all its kernels).

``--shapes`` picks some of them (all by default).

For each: ``kernel_ms``, the profiler's device time of the lattice kernel
over its launches; ``ms``, CUDA events over ``--iters`` calls (the
wrapper's host work too); the roofline bound (chip_smoke.py's, bytes over
3.35 TB/s or operations over 67 TFLOP/s); N_max, the longest lattice's
diagonals; for this checkout the registers of the kernel the shape runs and
its chain floor: N_max × the SASS instructions of one diagonal step
(chip_smoke.wavefront_step_instructions, read with cuobjdump from the built
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
SHAPES = [("headline", 128, 150, 40, 28), ("large_v", 32, 150, 20, 5000),
          ("long_t", 16, 1500, 300, 50), ("pruned_long", 128, 1500, 300, 50),
          ("char_long", 32, 1000, 600, 29)]
# The lattice kernel's names in this checkout and its parents.
KERNELS = ("wavefront_kernel", "wavefront_band_kernel", "wavefront_block_kernel",
           "wavefront_stripe_kernel")


def smoke():
    """This checkout's chip_smoke.py, loaded by path (the package under
    test may be another checkout's)."""
    spec = importlib.util.spec_from_file_location("wavefront_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(fn, iters=20):
    """Device ms of one launch of the lattice kernel: the profiler's time of
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


def lattice_inputs(tag, B, T, L, V, dev, sm):
    """(lpb, lpe, input lengths, label lengths) as the main path gives them."""
    from warp_transducer_tpu_torch.ops import prep, simple
    if tag == "pruned_long":
        am, lm, labels, il, ll = sm.make_pruned_problem(B, T, L, V, seed=5, dev=dev)
        f = simple._factorised_lattice_inputs(am, lm, prep.label_rows(labels, L + 1), 0,
                                              "highest")
        return f.lpb, f.lpe, il, ll
    acts, labels, il, ll = sm.make_problem(B, T, L, V, seed=2, dev=dev)
    p = prep.prepare(acts, labels, 0, False)
    return p.lpb, p.lpe, il, ll


def step_times(B, T, L, V, dev, sm, iters):
    """The dense step rnnt_loss_and_grad on chip_smoke.make_problem's acts:
    CUDA-event ms and the profiler's device ms of all its kernels."""
    from warp_transducer_tpu_torch import rnnt_loss_and_grad
    acts, labels, il, ll = sm.make_problem(B, T, L, V, seed=2, dev=dev)
    step = lambda: rnnt_loss_and_grad(acts, labels, il, ll)  # noqa: E731
    return {"step_ms": sm.time_ms(step, iters), "step_device_ms": sm.device_ms(step)}


def lattice_kernel(plan):
    """The kernel a plan of this checkout or a parent's launches."""
    if hasattr(plan, "stripes"):
        return "wavefront_band_kernel" if plan.stripes == 1 else "wavefront_stripe_kernel"
    return "wavefront_band_kernel" if plan.band_mode else "wavefront_block_kernel"


def one(root, iters, shapes):
    """Time the package of ``root``; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from warp_transducer_tpu_torch.ops.cuda import build
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    sm = smoke()
    dev = torch.device("cuda", 0)
    clock_mhz = sm.sm_clock_mhz()
    steps = ({k: sm.wavefront_step_instructions(build.build(), k)
              for k in ("wavefront_band_kernel", "wavefront_stripe_kernel")}
             if hasattr(kwave, "plan") else {})
    out = {"root": str(root), "sm_clock_mhz": clock_mhz}
    for tag, B, T, L, V in SHAPES:
        if tag not in shapes:
            continue
        lpb, lpe, il, ll = lattice_inputs(tag, B, T, L, V, dev, sm)
        fn = lambda: kwave.forward_backward(lpb, lpe, il, ll)  # noqa: E731
        r = {"kernel_ms": kernel_ms(fn), "ms": sm.time_ms(fn, iters),
             "bound_ms": sm.wavefront_bound(lpb, il, ll)[0],
             "n_max": int((il.long() + ll.long()).max())}
        if hasattr(kwave, "plan"):
            p = kwave.plan(B, T, L + 1, lpb.element_size(), True,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
            r["plan"] = p._asdict()
            r["registers"] = kwave.kernel_registers(L + 1, lpb.dtype)
            r["kernel"] = lattice_kernel(p)
            step = steps.get(r["kernel"], {}).get(lpb.element_size())
            r["step_instructions"] = step
            r["chain_floor_ms"] = (r["n_max"] * step / (clock_mhz * 1e3)
                                   if step and clock_mhz else None)
        del lpb, lpe, il, ll, fn
        torch.cuda.empty_cache()
        if tag == "char_long":
            r.update(step_times(B, T, L, V, dev, sm, iters))
            torch.cuda.empty_cache()
        out[tag] = r
    print(json.dumps(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(HERE / "build" / "parent"),
                        help="the parent checkout, timed first and last")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--shapes", default=",".join(tag for tag, *_ in SHAPES),
                        help="comma-separated shapes to time")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_wavefront.py: no CUDA device is visible")
    shapes = args.shapes.split(",")
    if args.one:
        one(args.one, args.iters, shapes)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    runs = []
    for label, root in (("parent", args.root), ("this", str(HERE)), ("this", str(HERE)),
                        ("parent", args.root)):
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--iters",
                               str(args.iters), "--shapes", args.shapes],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"time_wavefront.py: the {label} run failed:\n{proc.stdout}\n{proc.stderr}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(f"{label}: " + " | ".join(
            f"{tag} kernel {r[tag]['kernel_ms']} ms, event {r[tag]['ms']:.4f} ms"
            + (f", chain floor {r[tag]['chain_floor_ms']} ms, registers {r[tag]['registers']}"
               if "registers" in r[tag] else "")
            for tag, *_ in SHAPES if tag in shapes), flush=True)
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
