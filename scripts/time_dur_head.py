"""Time the standalone duration-head kernels (csrc/dur_head.cu) on one GPU.

    python scripts/time_dur_head.py [--root DIR] [--iters N] [--heads D[@H] ...]

At the fused TDT shape of chip_smoke.py (B=64, T=150, L=20, H=256, f32; e,
p and the lengths made from the same seed as its kernel timings, so 0.564
of the cells are valid; g_dur random, zero outside the lattice) it times
``dur_head_prep`` and ``dur_head_grad`` for each head of ``--heads`` (D
columns, at joint width H where given: by default D = 4, 9, 16, 33 and 9 at
H = 2048) and prints, for each:

* ``kernel_ms``: the profiler's device time of the kernels themselves a
  call (the prep kernel; the gradient kernel and the kernels that add its
  partials), over the launches of the first one found, and each one's ms a
  launch;
* ``device_ms``: every kernel the call launches (the wrapper's running sums
  of the lengths, zero fills);
* ``ms``: CUDA events over ``--iters`` calls after warm-up (host work too);
* the library's yardsticks on a materialised h32 (B·T·U, H): ``h32@Wd``
  (prep) and ``g_dur@Wdᵀ``, ``h32ᵀ@g_dur`` (gradient), 100 calls in a CUDA
  graph and by the profiler.

``--root`` names another checkout (a parent commit unpacked beside this
one) whose package is timed instead, so that two trees can be compared in
one call: run parent, this, this, parent. Prints the card's name and power
limit and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

B, T, L, V, H = 64, 150, 20, 5000, 256
HEADS = ("4", "9", "16", "33", "9@2048")
# The kernels of a call, its main kernel first (the gradient's instance past
# 8 columns, or an earlier tree's by-value or grouped one).
KERNELS = {"prep": ("dur_prep_kernel",),
           "grad": ("dur_grad_many_kernel", "dur_grad_kernel", "dur_sums_kernel",
                    "sum_parts_kernel")}


def time_ms(fn, iters):
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


def profile(fn, iters=20):
    """{kernel name: (device ms summed, launches)} over ``iters`` calls."""
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
            name = m.group(1) if m else e.key[:40]
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return out


def kernel_ms(fn, names, iters=20):
    """(device ms a call of the named kernels that the call launches: their
    time over the launches of the first of them found, once a call, so a
    dropped record does not read as a shorter call; {name: ms a launch}), or
    (None, {})."""
    rec = profile(fn, iters)
    ours = {n: rec[n] for n in names if n in rec}
    if not ours:
        return None, {}
    return (sum(ms for ms, _ in ours.values()) / next(iter(ours.values()))[1],
            {n: ms / k for n, (ms, k) in ours.items()})


def device_ms(fn, iters=20):
    rec = profile(fn, iters)
    return sum(ms for ms, _ in rec.values()) / iters if rec else None


def graph_ms(fn, n=100):
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
    ms = time_ms(graph.replay, 5) / n
    del graph
    return ms


def problem(dev, D, H):
    """chip_smoke.make_joint_problem's draws (seed 15) and make_dur_head's
    (seed 16), then g_dur."""
    g = torch.Generator(device=dev).manual_seed(15)
    U = L + 1
    e = torch.randn((B, T, H), generator=g, device=dev) * 0.5
    p = torch.randn((B, U, H), generator=g, device=dev) * 0.5
    torch.randn((H, V), generator=g, device=dev)  # W
    torch.randn((V,), generator=g, device=dev)  # bias
    torch.randint(0, V - 3, (B, L), generator=g, device=dev, dtype=torch.int32)  # labels
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    g = torch.Generator(device=dev).manual_seed(16)
    Wd = torch.randn((H, D), generator=g, device=dev) / H ** 0.5
    bias_d = torch.randn((D,), generator=g, device=dev) * 0.1
    valid = ((torch.arange(T, device=dev)[None, :, None] < il[:, None, None])
             & (torch.arange(U, device=dev)[None, None, :] <= ll[:, None, None]))
    g_dur = torch.randn((B, T, U, D), device=dev) * valid[..., None]
    return e, p, Wd, bias_d, g_dur.contiguous(), il, ll


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="checkout whose warp_transducer_tpu_torch is timed")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--heads", nargs="+", default=HEADS,
                        help="duration heads: D columns, or D@H at joint width H")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_dur_head.py: no CUDA device is visible")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; package {args.root}")
    result = {"card": smi, "root": args.root}
    for head in args.heads:
        D, _, width = head.partition("@")
        D, Hh = int(D), int(width or H)
        e, p, Wd, bias_d, g_dur, il, ll = problem(dev, D, Hh)
        rows = int((il.long() * (ll.long() + 1)).sum())
        h32 = torch.tanh(e[:, :, None] + p[:, None]).reshape(-1, Hh)
        gd2 = g_dur.reshape(-1, D)
        calls = {
            "prep": (lambda: kjoint.dur_head_prep(e, p, Wd, bias_d, il, ll),
                     lambda: torch.matmul(h32, Wd)),
            "grad": (lambda: kjoint.dur_head_grad(e, p, Wd, g_dur, il, ll),
                     lambda: (torch.matmul(gd2, Wd.t()), torch.matmul(h32.t(), gd2))),
        }
        out = result[f"D{D}_H{Hh}"] = {"valid_rows": rows}
        for name, (fn, lib_fn) in calls.items():
            alone, launches = kernel_ms(fn, KERNELS[name])
            r = {"kernel_ms": alone, "launch_ms": launches, "device_ms": device_ms(fn),
                 "ms": time_ms(fn, args.iters), "library_graph_ms": graph_ms(lib_fn),
                 "library_device_ms": device_ms(lib_fn)}
            out[name] = r
            print(f"D={D} H={Hh} {name}: kernel {r['kernel_ms']} ms | device {r['device_ms']} ms"
                  f" | event {r['ms']:.4f} ms | library {r['library_graph_ms']:.4f} ms (graph), "
                  f"{r['library_device_ms']} ms (profiler); a launch {r['launch_ms']}",
                  flush=True)
        del e, p, h32, gd2, g_dur, calls
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
