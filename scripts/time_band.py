"""Time the band lattice kernel (csrc/band_stream.cu) on one GPU, two
checkouts in turns.

    python scripts/time_band.py [--root DIR] [--iters N]

Times ``ops/cuda/band.py::forward_backward`` (alpha and beta) of the
package of ``--root`` (a parent commit unpacked beside this checkout) and
of this checkout, in the order parent, this, this, parent, each in a
process of its own, at three shapes:

* pruned_long (128, 1500, 300, 50, S = 5) and pruned_large_v (128, 150, 20,
  5000, S = 5): the band lattice of chip_smoke.py's pruned main path (its
  problems, seed 5: the simple loss's band starts, the additive joiner on
  the band, the band prep);
* full_band (128, 150, 40, 28, S = U = 41): the band over the whole
  headline lattice (ranges 0), lpb and lpe by the plain band prep of
  chip_smoke.make_problem's acts (seed 2), which the chunk kernel takes.

For each: ``kernel_ms``, the profiler's device time of one launch of the
lattice kernel (chip_smoke.launch_device_ms over this file's kernel names);
``ms``, CUDA events over ``--iters`` calls (the
wrapper's host work too); the roofline bound (chip_smoke.py's, bytes over
3.35 TB/s or operations over 67 TFLOP/s); T_max, the longest utterance's
rows; for this checkout the plan, the registers of the kernel the shape
runs and its chain floor: T_max × the SASS instructions of the longer row
step, alpha or beta (chip_smoke.band_step_instructions, read with cuobjdump
from the built library) ÷ the SM clock that nvidia-smi reports. Prints the
card's name and power limit and one JSON object. Imports no JAX; without a
CUDA device it says so and exits 0.
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
# The band lattice kernel's names in this checkout and its parents.
KERNELS = ("band_kernel", "band_row_kernel", "band_chunk_kernel")


def smoke():
    """This checkout's chip_smoke.py, loaded by path (the package under
    test may be another checkout's)."""
    spec = importlib.util.spec_from_file_location("band_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lattice_inputs(tag, B, T, L, V, S, dev, sm):
    """(lpb, lpe, ranges, input lengths, label lengths) as the main path
    gives them."""
    from warp_transducer_tpu_torch.ops import band
    if tag == "full_band":
        acts, labels, il, ll = sm.make_problem(B, T, L, V, seed=2, dev=dev)
        ranges = torch.zeros((B, T), dtype=torch.int32, device=dev)
        p = band.band_prep(acts, band.label_rows(*band.band_labels(labels, ranges, S)), 0)
        return p.lpb, p.lpe, ranges, il, ll
    am, lm, labels, il, ll = sm.make_pruned_problem(B, T, L, V, seed=5, dev=dev)
    x = sm.band_inputs(am, lm, labels, il, ll, S)
    return x["prep"].lpb, x["prep"].lpe, x["ranges"], il, ll


def one(root, iters):
    """Time the package of ``root``; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import build
    sm = smoke()
    dev = torch.device("cuda", 0)
    new = hasattr(kband, "plan")
    clock_mhz = sm.sm_clock_mhz()
    steps = sm.band_step_instructions(build.build()) if new else {}
    out = {"root": str(root), "sm_clock_mhz": clock_mhz, "steps": steps}
    for tag, B, T, L, V, S in SHAPES:
        lpb, lpe, ranges, il, ll = lattice_inputs(tag, B, T, L, V, S, dev, sm)
        fn = lambda: kband.forward_backward(lpb, lpe, ranges, il, ll)  # noqa: E731
        r = {"kernel_ms": sm.launch_device_ms(fn, iters=20, names=KERNELS),
             "ms": sm.time_ms(fn, iters), "bound_ms": sm.band_lattice_bound(ranges, il, ll, S)[0],
             "t_max": int(il.max())}
        if new:
            r["plan"] = kband.plan(B, T, S)._asdict()
            r["registers"] = kband.kernel_registers(S)
            r["chain_floor_ms"], r["step_instructions"] = sm.band_chain_floor(steps, S, il,
                                                                               clock_mhz)
        out[tag] = r
        del lpb, lpe, ranges, il, ll, fn
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
            f"{tag} kernel {r[tag]['kernel_ms']} ms, event {r[tag]['ms']:.4f} ms"
            + (f", chain floor {r[tag]['chain_floor_ms']} ms, registers {r[tag]['registers']}"
               if "registers" in r[tag] else "")
            for tag, *_ in SHAPES), flush=True)
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
