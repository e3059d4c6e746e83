"""Time the two earlier kernels that the redesigns left running past their
new kernels' caps, beside those new kernels, on one GPU.

    python scripts/time_earlier_kernels.py [--iters N]

* ``window_block_kernel`` (csrc/window_stream.cu, a block a lattice), which the
  window plan (ops/cuda/window.py::plan) takes where it cannot split a
  lattice over warps: at B = 128, T = 1000, U = 601 for the multi-blank loss
  (big blanks of 2 and 4 frames) and for TDT with durations (0, 1, 2, 4),
  and at B = 32 for TDT with durations (1, 2, 4) (no duration 0, so no
  in-row chain); beside them ``window_warp_kernel`` at B = 32 on the same U
  for the multi-blank loss and TDT (0, 1, 2, 4), where the plan takes it.
  Inputs from chip_smoke.make_duration_problem (seed 14): the prep kernel's
  lpb, lpe and big-blank columns, or log_softmax of the duration logits.
* ``band_chunk_kernel`` (csrc/band_stream.cu, 32-lane chunks of a band), which the
  band plan takes above S = 32: at the full band (B = 128, T = 150, L = 40,
  S = U = 41; chip_smoke's full-band check), band prep of the activations.

For each: the plan, ``kernel_ms`` (the profiler's device time of the kernel
over its launches; one launch a call), ``ms`` (CUDA events over ``--iters``
calls, the wrapper's host work too), the roofline bound (chip_smoke's:
bytes over 3.35 TB/s or operations over 67 TFLOP/s), the registers and the
chain floor: the rows the longest lattice walks (T_max) × the SASS
instructions of one row step ÷ the SM clock that nvidia-smi reports. A row
step of the warp kernel is chip_smoke.window_step_instructions'; of the two
block kernels, whose threads meet at a barrier every row, the innermost loop
around a barrier (BAR.SYNC), read with cuobjdump from the built library: the
least a row step issues. Prints the card's name and power limit and one JSON
object. Measurement only: it changes no kernel. Imports no JAX.
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
# (case, B, T, L, family, durations): the window kernel's cases.
WINDOW_CASES = [("multiblank_B128", 128, 1000, 600, "multiblank", (2, 4)),
                ("tdt_B128", 128, 1000, 600, "tdt", (0, 1, 2, 4)),
                ("tdt_no_d0_B32", 32, 1000, 600, "tdt", (1, 2, 4)),
                ("multiblank_B32", 32, 1000, 600, "multiblank", (2, 4)),
                ("tdt_B32", 32, 1000, 600, "tdt", (0, 1, 2, 4))]
WINDOW_KERNELS = ("window_warp_kernel", "window_block_kernel")
FULL_BAND = ("full_band", 128, 150, 40, 28, 41)


def smoke():
    spec = importlib.util.spec_from_file_location("earlier_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def barrier_step(sm, library, function):
    """SASS instructions of the innermost loop around a barrier in the
    kernel instances whose names match ``function``: {instance: count}."""
    out = {}
    for k, (bars, loops) in sm.sass_loops(library, function, lambda m: m.group(0),
                                          marks=r"(BAR)\.SYNC").items():
        inner = [b - a for a, b in loops if any(a <= x <= b for x in bars.get("BAR", []))]
        if inner:
            out[k] = min(inner) // 16 + 1
    return out


def floor(t_max, step, clock_mhz):
    return t_max * step / (clock_mhz * 1e3) if step and clock_mhz else None


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_earlier_kernels.py: no CUDA device is visible")
    sys.path.insert(0, str(HERE))
    from warp_transducer_tpu_torch.ops import band, window
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import build
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    sm = smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    library = build.build()
    clock_mhz = sm.sm_clock_mhz()
    warp_steps = sm.window_step_instructions(library)
    block_steps = barrier_step(sm, library, r"window_block_kernelI[fd]\w*")
    chunk_steps = barrier_step(sm, library, r"band_chunk_kernel\w*")
    out = {"card": smi, "sm_clock_mhz": clock_mhz,
           "window_block_barrier_loop": block_steps, "band_chunk_barrier_loop": chunk_steps}
    for case, B, T, L, family, durations in WINDOW_CASES:
        V = 28
        acts, dur, labels, il, ll = sm.make_duration_problem(B, T, L, V, seed=14, dev=dev)
        if family == "multiblank":
            p = kprep.prepare(acts, labels, 0, False, extra_cols=(V - 2, V - 1))
            extra, arcs = p.extras, window.multiblank_arcs(durations)
        else:
            p = kprep.prepare(acts, labels, 0, False)
            extra = torch.log_softmax(dur[..., :len(durations)], -1).contiguous()
            arcs = window.tdt_arcs(durations)
        del acts, dur
        fn = lambda: kwindow.forward_backward(p.lpb, p.lpe, extra, arcs, il, ll)  # noqa: E731
        plan = sm.window_plan(p.lpb, extra, arcs)
        t_max = int(il.max())
        r = {"plan": plan._asdict(), "kernel": WINDOW_KERNELS[0 if plan.warp_mode else 1],
             "kernel_ms": sm.launch_device_ms(fn, iters=5, names=WINDOW_KERNELS),
             "ms": sm.time_ms(fn, args.iters), "launches_a_call": 1,
             "bound_ms": sm.window_bound(p.lpb, extra, arcs, il, ll)[0],
             "registers": kwindow.kernel_registers(plan, L + 1, p.lpb.dtype), "t_max": t_max}
        if plan.warp_mode:
            r["chain_floor_ms"], r["step_instructions"] = sm.window_chain_floor(
                warp_steps, 4, plan, il, clock_mhz)
        else:
            step = max(block_steps.values(), default=None) if block_steps else None
            r["step_instructions"] = step
            r["chain_floor_ms"] = floor(t_max, step, clock_mhz)
        out[case] = r
        print(f"{case} B={B} T={T} U={L + 1} {durations}: {r['kernel']} {r['kernel_ms']} ms "
              f"(event {r['ms']:.4f}) | bound {r['bound_ms']:.4f} | chain floor "
              f"{r['chain_floor_ms']} | registers {r['registers']} | plan {r['plan']}", flush=True)
        del p, extra, il, ll, labels, fn
        torch.cuda.empty_cache()
    tag, B, T, L, V, S = FULL_BAND
    acts, labels, il, ll = sm.make_problem(B, T, L, V, seed=2, dev=dev)
    ranges = torch.zeros((B, T), dtype=torch.int32, device=dev)
    p = band.band_prep(acts, band.label_rows(*band.band_labels(labels, ranges, S)), 0)
    fn = lambda: kband.forward_backward(p.lpb, p.lpe, ranges, il, ll)  # noqa: E731
    step = max(chunk_steps.values(), default=None) if chunk_steps else None
    r = {"plan": kband.plan(B, T, S)._asdict(),
         "kernel_ms": sm.launch_device_ms(fn, iters=20, names=("band_chunk_kernel",)),
         "ms": sm.time_ms(fn, args.iters), "launches_a_call": 1,
         "bound_ms": sm.band_lattice_bound(ranges, il, ll, S)[0],
         "registers": kband.kernel_registers(S), "t_max": int(il.max()),
         "step_instructions": step, "chain_floor_ms": floor(int(il.max()), step, clock_mhz)}
    out[tag] = r
    print(f"{tag} B={B} T={T} S={S}: band_chunk_kernel {r['kernel_ms']} ms (event "
          f"{r['ms']:.4f}) | bound {r['bound_ms']:.4f} | chain floor {r['chain_floor_ms']} | "
          f"registers {r['registers']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
