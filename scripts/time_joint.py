"""Time the fused joint kernels (csrc/joint_prep.cu, joint_grad.cu,
joint_grad_cols.cu, dur_head.cu) on one GPU.

    python scripts/time_joint.py [--root DIR] [--widths 256,1024,2048] [--hooks] [--full]
                                 [--dur-only] [--iters N]

At the fused shape of chip_smoke.py (B=64, T=150, L=20, V=5000; e, p, W,
bias and the lengths drawn as its kernel timings draw them, seed 7, so 0.62
of the B·T·U rows are valid) and each joint width H of ``--widths``, with W
in f32 and in bf16, it prints the profiler's device time of K6a a call (all
the kernels ``fused_prep`` launches: the layout of W, h and the prep kernel,
or the one prep kernel of an older tree) and of K6b a call (every kernel of
``fused_grad``), each kernel's ms a launch and launches a call. Only the
kernels are timed: the fields they take (the prep, the lattice, the
coefficients) are made once beforehand. The kernel names of this tree and of
the trees before the wgmma engine are both counted, so that ``--root`` can
time a parent.

``--hooks`` adds K6a and K6b with K = 2 big-blank columns (the last two) and
with the D = 4 duration head (device ms a call), the dWd kernel's ms a launch
inside K6b (``joint_grad_dwd_kernel``), and K6c (``dur_prep_kernel``) and
K6d (``dur_grad_kernel`` with ``dur_sums_kernel``) a call, these two at
every width before any fused kernel runs in the process (``--dur-only``:
that pass alone).

``--full`` (implies ``--hooks``) adds, for each case: the registers and
spills of the kernels (``kernel_registers``) and the plan (``kernel_plan``),
K6b's counted launches a call, the plain versions' ms (with and without the
hooks) and the library's (``h@W``; for K6b the three products ``h@W``,
``g@Wᵀ``, ``hᵀ@g`` in W's type, over all B·T·U rows; ``h32@Wd`` and the
duration head's two products), the operations bound (2·R·H·V for K6a,
3·2·R·H·V for K6b, R the valid rows, over 989 TFLOP/s with bf16 W and over
495 / 3 with f32 W, whose least work is three TF32 products), and the
duration head's tanh-inclusive bounds (chip_smoke.py's ``tanh_bound``).

``--root`` names another checkout (a parent commit unpacked beside this
one) whose package is timed instead, so that two trees compare in one call:
run parent, this, this, parent and take the median of each pair. Prints the
card's name and power limit and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

B, T, L, V, D = 64, 150, 20, 5000, 4
# chip_smoke.py's rates: the tensor cores' (bf16; f32 W as three TF32
# products, 495 / 3 TFLOP/s), HBM, and the FP32 pipe's and the MUFU's issue
# rates with a tanhf's share of each (2 MUFU results, 9 FP32-pipe
# instructions).
TF32X3_OPS_PER_S, BF16_OPS_PER_S, HBM_BYTES_PER_S = 495e12 / 3, 989e12, 3.35e12
FP32_INSTR_PER_S, MUFU_PER_S = 128 * 132 * 1.98e9, 16 * 132 * 1.98e9
TANH_MUFU, TANH_FP32 = 2, 9
# The kernels of a K6a and of a K6b call, this tree's and those of the trees
# before the wgmma engine (joint_grad_rows_kernel, joint_grad_cols_kernel).
PREP = ("joint_w_kernel", "joint_h_kernel", "joint_prep_kernel")
GRAD = ("joint_w_kernel", "joint_h_kernel", "joint_grad_g_kernel", "joint_grad_dh_kernel",
        "joint_grad_d_kernel", "joint_grad_dw_kernel", "joint_grad_db_kernel",
        "joint_grad_rows_kernel", "joint_grad_cols_kernel", "sum_parts_kernel")


def time_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn, iters):
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


def launch_ms(fn, names, iters):
    """({name: device ms a launch}, {name: launches a call}, device ms a call
    of the named kernels), from the profiler over ``iters`` calls."""
    rec = profile(fn, iters)
    ours = {n: rec[n] for n in names if n in rec}
    return ({n: ms / k for n, (ms, k) in ours.items()},
            {n: k / iters for n, (_, k) in ours.items()},
            sum(ms for ms, _ in ours.values()) / iters if ours else None)


def tanh_bound_ms(bytes_moved, n_tanh, fp32_per_tanh):
    """chip_smoke.tanh_bound: the largest of bytes over HBM, the tanh's MUFU
    results and the FP32-pipe instructions over their rates."""
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, n_tanh * TANH_MUFU / MUFU_PER_S,
                     n_tanh * (TANH_FP32 + fp32_per_tanh) / FP32_INSTR_PER_S)


def problem(H, dtype, dev):
    """chip_smoke.make_joint_problem's draws at seed 7."""
    g = torch.Generator(device=dev).manual_seed(7)
    U = L + 1
    e = (torch.randn((B, T, H), generator=g, device=dev) * 0.5).to(dtype)
    p = (torch.randn((B, U, H), generator=g, device=dev) * 0.5).to(dtype)
    W = (torch.randn((H, V), generator=g, device=dev) / H ** 0.5).to(dtype)
    bias = torch.randn((V,), generator=g, device=dev) * 0.1
    labels = torch.randint(0, V - 1, (B, L), generator=g, device=dev, dtype=torch.int32)
    labels = labels + (labels >= 0).int()
    il = torch.randint(T // 2, T + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    ll = torch.randint(L // 2, L + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    il[0], ll[0] = T, L
    return e, p, W, bias, labels, il, ll


def dur_inputs(H, il, ll, dev, gradients):
    """The duration head's Wd (H, D), bias_d (D,) and g_dur (B, T, U, D),
    zero outside the lattice, drawn at seed 16, with the generator (the
    hooks draw their extra fields after them) and the valid cells."""
    g = torch.Generator(device=dev).manual_seed(16)
    Wd = torch.randn((H, D), generator=g, device=dev) / H ** 0.5
    bias_d = torch.randn((D,), generator=g, device=dev) * 0.1
    valid = gradients._valid_cells((B, T, L + 1), il, ll, dev)
    g_dur = (torch.randn((B, T, L + 1, D), generator=g, device=dev)
             * valid[..., None]).contiguous()
    return Wd, bias_d, g_dur, g, valid


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                        help="checkout whose warp_transducer_tpu_torch is timed")
    parser.add_argument("--widths", default="256,1024", help="joint widths H, comma-separated")
    parser.add_argument("--hooks", action="store_true",
                        help="also K = 2 and D = 4, the dWd kernel, K6c and K6d")
    parser.add_argument("--full", action="store_true",
                        help="also registers, plan, plain, library, bound (implies --hooks)")
    parser.add_argument("--dur-only", action="store_true",
                        help="only K6c and K6d, the pass --hooks runs first")
    parser.add_argument("--iters", type=int, default=10, help="calls under the profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_joint.py: no CUDA device is visible")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from warp_transducer_tpu_torch.ops import cuda as K
    from warp_transducer_tpu_torch.ops import fused_joint, gradients
    from warp_transducer_tpu_torch.ops.cuda import joint as kjoint
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; package {args.root}", flush=True)
    result = {"card": smi, "root": args.root, "shape": dict(B=B, T=T, L=L, V=V), "cases": {}}
    widths = [int(x) for x in args.widths.split(",")]
    # K6c and K6d before any fused kernel runs in the process: the denser
    # kernels that run before them otherwise change the card's clocks, and
    # the times of the same code with them (2-4.6% at the fused shape).
    dur_first = {}
    for H in widths if args.hooks or args.full or args.dur_only else ():
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            e, p, _, _, _, il, ll = problem(H, dtype, dev)
            Wd, bias_d, g_dur, _, _ = dur_inputs(H, il, ll, dev, gradients)
            dur_first[H, tag] = {
                "dur_prep_ms_a_call": launch_ms(lambda: kjoint.dur_head_prep(
                    e, p, Wd, bias_d, il, ll), ("dur_prep_kernel",), args.iters)[2],
                "dur_grad_ms_a_call": launch_ms(lambda: kjoint.dur_head_grad(
                    e, p, Wd, g_dur, il, ll), ("dur_grad_kernel", "dur_sums_kernel"),
                    args.iters)[2]}
            print(f"H={H} {tag} K6c, K6d: {dur_first[H, tag]}", flush=True)
    if args.dur_only:
        result["dur_head"] = {f"H{H}_{tag}": v for (H, tag), v in dur_first.items()}
        print(json.dumps(result))
        return
    for H in widths:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            e, p, W, bias, labels, il, ll = problem(H, dtype, dev)
            with torch.no_grad():
                pr = kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0)
                res = kwave.forward_backward(pr.lpb, pr.lpe, il, ll)
                fields = gradients.coefficients(pr.lpb, pr.lpe, res.alphas, res.betas,
                                                res.ll_forward, il, ll)
            if args.hooks or args.full:  # the duration head's inputs
                rows = int((il.long() * (ll.long() + 1)).sum())
                Wd, bias_d, g_dur, g, valid = dur_inputs(H, il, ll, dev, gradients)
            prep = lambda: kjoint.fused_prep(e, p, W, bias, labels, il, ll, 0)  # noqa: E731
            grad = lambda: kjoint.fused_grad(e, p, W, bias, labels, il, ll,  # noqa: E731
                                             pr.denom, fields, 0)
            k6a, k6a_n, k6a_call = launch_ms(prep, PREP, args.iters)
            k6b, k6b_n, k6b_call = launch_ms(grad, GRAD, args.iters)
            case = {"k6a_ms_a_call": k6a_call, "k6b_ms_a_call": k6b_call,
                    "k6a_ms_a_launch": k6a, "k6a_launches_a_call": k6a_n,
                    "k6b_ms_a_launch": k6b, "k6b_launches_a_call": k6b_n}
            print(f"H={H} {tag}: K6a {k6a_call} ms a call, K6b {k6b_call} ms a call; a launch "
                  f"{k6a} / {k6b}, launches a call {k6a_n} / {k6b_n}", flush=True)
            if args.hooks or args.full:
                cols = (V - 2, V - 1)
                cX = (torch.rand((B, T, L + 1, 2), generator=g, device=dev)
                      * valid[..., None]).contiguous()
                hooks = {"prep_k2": (PREP, lambda kj: kj.fused_prep(
                             e, p, W, bias, labels, il, ll, 0, extra_cols=cols)),
                         "prep_d4": (PREP, lambda kj: kj.fused_prep(
                             e, p, W, bias, labels, il, ll, 0, dur_head=(Wd, bias_d))),
                         "grad_k2": (GRAD, lambda kj: kj.fused_grad(
                             e, p, W, bias, labels, il, ll, pr.denom, fields, 0,
                             extra=(cols, cX))),
                         "grad_d4": (GRAD + ("joint_grad_dwd_kernel",), lambda kj: kj.fused_grad(
                             e, p, W, bias, labels, il, ll, pr.denom, fields, 0,
                             dur_head=(Wd, g_dur)))}
                case["hooks"] = {name: {"ms_a_call": launch_ms(lambda: fn(kjoint), names, 3)[2]}
                                 for name, (names, fn) in hooks.items()}
                tdt_grad = lambda: kjoint.fused_grad(  # noqa: E731
                    e, p, W, bias, labels, il, ll, pr.denom, fields, 0, dur_head=(Wd, g_dur))
                dwd, _, _ = launch_ms(tdt_grad, ("joint_grad_dwd_kernel",), 3)
                case["dur_head"] = {"joint_grad_dwd_kernel_ms": dwd.get("joint_grad_dwd_kernel")}
                case["dur_head"].update(dur_first.get((H, tag), {}))
                print(f"H={H} {tag} hooks: {json.dumps(case['hooks'])}; {case['dur_head']}",
                      flush=True)
            if args.full:
                rate = TF32X3_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
                K.reset_launches()
                grad()
                torch.cuda.synchronize()
                case["joint_grad_launches_a_call"] = K.launches["joint_grad"]
                case["registers"] = kjoint.kernel_registers(dtype)
                case["plan"] = kjoint.kernel_plan(H, V, dtype)._asdict()
                case["valid_rows"] = rows
                case["bound_ms"] = {"joint_prep": 2 * rows * H * V / rate * 1e3,
                                    "joint_grad": 3 * 2 * rows * H * V / rate * 1e3}
                case["plain_ms"] = {
                    "joint_prep": time_ms(lambda: fused_joint.fused_prep(
                        e, p, W, bias, labels, il, ll, 0), 2),
                    "joint_grad": time_ms(lambda: fused_joint.fused_grad(
                        e, p, W, bias, labels, il, ll, pr.denom, fields, 0), 2)}
                for name, (_, fn) in hooks.items():
                    case["hooks"][name]["plain_ms"] = time_ms(lambda: fn(fused_joint), 1)
                h = torch.tanh(e.float()[:, :, None] + p.float()[:, None]).reshape(-1, H).to(dtype)
                gl = torch.randn((h.shape[0], V), device=dev).to(dtype)
                case["library_ms"] = {
                    "joint_prep": time_ms(lambda: torch.matmul(h, W), 5),
                    "joint_grad": time_ms(lambda: (torch.matmul(h, W), torch.matmul(gl, W.t()),
                                                   torch.matmul(h.t(), gl)), 3)}
                del gl
                h32 = torch.tanh(e.float()[:, :, None] + p.float()[:, None]).reshape(-1, H)
                gd2 = g_dur.reshape(-1, D)
                case["dur_head"].update({
                    "library_prep_ms": time_ms(lambda: torch.matmul(h32, Wd), 5),
                    "library_grad_ms": time_ms(lambda: (torch.matmul(gd2, Wd.t()),
                                                        torch.matmul(h32.t(), gd2)), 5),
                    "plain_prep_ms": time_ms(lambda: fused_joint.dur_head_prep(
                        e, p, Wd, bias_d, il, ll), 2),
                    "plain_grad_ms": time_ms(lambda: fused_joint.dur_head_grad(
                        e, p, Wd, g_dur, il, ll), 2),
                    "prep_bound_ms": tanh_bound_ms(4 * (e.numel() + p.numel() + rows * D),
                                                   rows * H, 1 + D),
                    "grad_bound_ms": tanh_bound_ms(4 * (2 * e.numel() + 2 * p.numel() + rows * D),
                                                   rows * H, 5 + 2 * D)})
                del h, h32
                print(f"H={H} {tag} full: {json.dumps({k: v for k, v in case.items()})}",
                      flush=True)
            result["cases"][f"H{H}_{tag}"] = case
            del e, p, W, pr, res, fields
            torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
