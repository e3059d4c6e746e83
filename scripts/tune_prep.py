"""Time the prep kernel (csrc/prep.cu on csrc/reduce.cuh) on one GPU.

    python scripts/tune_prep.py [--elements N] [--vs V ...]
    python scripts/tune_prep.py --shapes [--root DIR]

Sweep (the default): for each V, f32 and bf16 activations of about N
elements (T = 150, U = 41, B to match) go through ``prepare`` with the
kernel's own plan, with the tile mode forced at every group size that fits
(1 to 32 threads a row) and with the warp mode forced, beside
``torch.logsumexp`` on the same tensor. It chose ``REDUCE_TILE_MAX_V`` and
``GROUP_BYTES`` of ``ops/cuda/rows.py``.

``--shapes``: ``prepare`` alone at the reference's three dense shapes
(K = 0) and at headline and long_t with K = 2 extra columns, f32, event
and device ms (torch.profiler), beside ``torch.logsumexp`` and the bytes
bound. Only ``prepare`` is called, so ``--root`` may name another
checkout (a parent commit unpacked beside this one) to time its kernel in
the same call.

Kernel times are the profiler's device time of the prep kernel alone
(``*_ms`` in the sweep, ``kernel_ms`` with ``--shapes``): at these sizes
a call's host work (the label rows, the outputs' allocation, the launch)
takes about as long as the kernel, so CUDA events time the host. With
``--shapes`` also: ``ms``, CUDA events after warm-up (20 calls, 5 at the
large shapes), and ``device_ms``, every kernel the call launches. Prints
one line per case, the card's name and power limit, and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
VS = (1, 2, 5, 12, 28, 50, 64, 100, 128, 192, 256, 320, 384, 512, 768, 1024, 2048, 5000)
SHAPES = [("headline", 128, 150, 40, 28, 0), ("large_v", 32, 150, 20, 5000, 0),
          ("long_t", 16, 1500, 300, 50, 0), ("headline_k2", 128, 150, 40, 28, 2),
          ("long_t_k2", 16, 1500, 300, 50, 2)]


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


def device_ms(fn, iters=10, match=""):
    """Device time of one call (torch.profiler): all its kernels summed,
    over the calls; or, with ``match``, that of one launch of the kernels
    whose name holds it, over their count (a record the profiler drops
    then does not read as a shorter call). None where it records none."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key]
    total, count = sum(e.self_device_time_total for e in rows), sum(e.count for e in rows)
    if total <= 0:
        return None
    return total / 1e3 / (count if match else iters)


def tile_plans(rows, V, elt):
    """{group: plan} of the tile mode at V for every group size, the tile
    sized as the planner sizes it (also above its switch point)."""
    p = rows.reduce_plan(V, elt)
    r = min(rows.MAX_TILE_ROWS, rows.THREADS * rows.VECS_PER_THREAD * p.vec // V)
    r -= r % (p.vec // math.gcd(V, p.vec))
    if r < 1:
        return {}
    out = {}
    for g in (1, 2, 4, 8, 16, 32):
        m = -(-V // g)
        if g < 32 and m % 2 == 0:
            m += 1
        q = p._replace(mode=rows.TILE, rows=r, group=g, stride=m * g)
        if rows.reduce_smem_bytes(q, 4) <= 48 * 1024:
            out[g] = q
    return out


def sweep(args, dev):
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import rows

    out = []
    g = torch.Generator(device=dev).manual_seed(0)
    for V in args.vs:
        T, U = 150, 41
        B = max(1, round(args.elements / (T * U * V)))
        for dtype in (torch.float32, torch.bfloat16):
            acts = torch.randn((B, T, U, V), generator=g, device=dev).to(dtype)
            labels = torch.randint(0, V, (B, U - 1), generator=g, device=dev, dtype=torch.int32)
            elt = acts.element_size()
            own = rows.reduce_plan(V, elt)
            case = {"V": V, "dtype": str(dtype).split(".")[1], "rows": B * T * U,
                    "plan": "tile" if own.mode == rows.TILE else "warp", "group": own.group,
                    "own_ms": device_ms(lambda: kprep.prepare(acts, labels, 0, False),
                                        match="prep_"),
                    "logsumexp_ms": device_ms(lambda: torch.logsumexp(acts, -1))}
            for grp, p in tile_plans(rows, V, elt).items():
                case[f"tile_g{grp}_ms"] = device_ms(
                    lambda: kprep.prepare_planned(acts, labels, 0, False, p), match="prep_")
            warp = own._replace(mode=rows.WARP, rows=rows.WARP_ROWS, group=32, stride=V)
            case["warp_ms"] = device_ms(
                lambda: kprep.prepare_planned(acts, labels, 0, False, warp), match="prep_")
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in case.items()), flush=True)
            out.append(case)
            del acts, labels
            torch.cuda.empty_cache()
    return {"tune_prep": out}


def shapes(dev):
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep

    out = {}
    for tag, B, T, L, V, n_cols in SHAPES:
        g = torch.Generator(device=dev).manual_seed(1)
        U = L + 1
        acts = torch.randn((B, T, U, V), generator=g, device=dev)
        labels = torch.randint(1, V, (B, L), generator=g, device=dev, dtype=torch.int32)
        cols = tuple(range(V - n_cols, V))
        iters = 20 if V == 28 else 5
        run = lambda: kprep.prepare(acts, labels, 0, False, extra_cols=cols)  # noqa: E731
        lse = lambda: torch.logsumexp(acts, -1)  # noqa: E731
        n_rows = B * T * U
        bound_ms = (acts.numel() * 4 + B * U * 4 + (3 + n_cols) * n_rows * 4) \
            / HBM_BYTES_PER_S * 1e3
        out[tag] = v = {"ms": time_ms(run, iters), "device_ms": device_ms(run),
                        "kernel_ms": device_ms(run, match="prep"),
                        "logsumexp_ms": time_ms(lse, iters), "logsumexp_device_ms": device_ms(lse),
                        "bound_ms": bound_ms}
        print(f"{tag} B={B} T={T} L={L} V={V} K={n_cols}: " +
              " ".join(f"{k}={x:.4f}" if x is not None else f"{k}=None" for k, x in v.items()),
              flush=True)
        del acts, labels
        torch.cuda.empty_cache()
    return {"prep_shapes": out}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--elements", type=int, default=2 ** 25)
    parser.add_argument("--vs", type=int, nargs="+", default=VS, help="the V to time")
    parser.add_argument("--shapes", action="store_true", help="time the dense shapes only")
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="the checkout whose package is timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tune_prep.py: no CUDA device is visible")
    sys.path.insert(0, str(Path(args.root).resolve()))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; package {args.root}")
    result = shapes(dev) if args.shapes else sweep(args, dev)
    print(smi)
    print(json.dumps(result | {"root": args.root}))


if __name__ == "__main__":
    main()
