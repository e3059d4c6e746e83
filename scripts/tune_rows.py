"""Time the row passes of csrc/rows.cuh in both modes across V on one GPU.

    python scripts/tune_rows.py [--elements N] [--vs V ...]

For each V, a dense lattice of B·T·U rows (T = 150, U = 41, B chosen so
that B·T·U·V is about N elements, f32 and bf16) goes through the gradient
kernel's lattice mode (``ops/cuda/grad.py::grad_wrt_acts``) with the
planner's choice forced to the tile mode and to the warp mode, beside
``torch.softmax`` on the same tensor; K5b (``ops/cuda/band.py::band_grad``)
the same on a (B, T, 5, V) band. CUDA events after warm-up, 20 calls each.
Prints one line per case and one JSON object with every time, and the card's
name and power limit. It chose ``ops/cuda/rows.py::TILE_MAX_V``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VS = (28, 50, 64, 128, 256, 384, 512, 768, 1024, 2048, 5000)


def time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def forced_plan(rows, V, elt, mode):
    """The planner's plan for V with its mode forced (a tile as the planner
    would size it), as the kernels' host array; None where no tile fits."""
    pl = rows.plan(V, elt)
    if mode == rows.WARP:
        pl = pl._replace(mode=rows.WARP, rows=rows.WARP_ROWS)
    elif pl.mode == rows.WARP:
        r = min(rows.MAX_TILE_ROWS, rows.THREADS * rows.VECS_PER_THREAD * pl.vec // V)
        r -= r % (pl.vec // math.gcd(V, pl.vec))
        if r < 1:
            return None
        pl = pl._replace(mode=rows.TILE, rows=r)
    return (ctypes.c_uint * 5)(*pl)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--elements", type=int, default=2 ** 25)
    parser.add_argument("--vs", type=int, nargs="+", default=VS, help="the V to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tune_rows.py: no CUDA device is visible")
    from warp_transducer_tpu_torch.ops import band, prep
    from warp_transducer_tpu_torch.ops.cuda import band as kband
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import rows
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    planner = rows.host_plan
    out = []
    g = torch.Generator(device=dev).manual_seed(0)
    for V in args.vs:
        T, U = 150, 41
        B = max(1, round(args.elements / (T * U * V)))
        for dtype in (torch.float32, torch.bfloat16):
            acts = torch.randn((B, T, U, V), generator=g, device=dev).to(dtype)
            labels = torch.randint(1, V, (B, U - 1), generator=g, device=dev, dtype=torch.int32)
            il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
            ll = torch.randint((U - 1) // 2, U, (B,), generator=g, device=dev, dtype=torch.int32)
            p = kprep.prepare(acts, labels, 0, False)
            res = kwave.forward_backward(p.lpb, p.lpe, il, ll)
            lat = (p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward,
                   prep.label_rows(labels, U), il, ll)
            S = 5
            bacts = acts[:, :, :S].contiguous()
            ranges = torch.zeros((B, T), dtype=torch.int32, device=dev)
            lab_row = band.label_rows(*band.band_labels(labels, ranges, S))
            bp = kband.band_prep(bacts, lab_row, 0)
            fields = band.Coefficients(bp.lpb.exp(), bp.lpb.exp(), bp.lpe.exp())
            case = {"V": V, "dtype": str(dtype).split(".")[1], "rows": B * T * U,
                    "softmax_ms": time_ms(lambda: torch.softmax(acts, -1)),
                    "band_softmax_ms": time_ms(lambda: torch.softmax(bacts, -1))}
            for mode in (rows.TILE, rows.WARP):
                forced = forced_plan(rows, V, acts.element_size(), mode)
                if forced is None:
                    continue
                name = "tile" if mode == rows.TILE else "warp"
                rows.host_plan = lambda *_, arr=forced: arr
                try:
                    case[f"grad_{name}_ms"] = time_ms(
                        lambda: kgrad.grad_wrt_acts(acts, p.denom, *lat, 0, dtype))
                    case[f"band_grad_{name}_ms"] = time_ms(
                        lambda: kband.band_grad(bacts, bp.denom, fields, lab_row, ranges, il, ll,
                                                0, dtype))
                finally:
                    rows.host_plan = planner
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in case.items()), flush=True)
            out.append(case)
            del acts, p, res, lat, bacts, bp, fields
            torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"tune_rows": out}))


if __name__ == "__main__":
    main()
