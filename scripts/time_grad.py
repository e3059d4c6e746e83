"""Time the gradient kernel (csrc/grad.cu) in each of its modes, and the prep
kernel on log-probs, on one GPU, two checkouts in turns.

    python scripts/time_grad.py [--root DIR] [--iters N]

Times the package of ``--root`` (a parent commit unpacked beside this
checkout) and of this checkout, in the order parent, this, this, parent,
each in a process of its own:

* at chip_smoke.SHAPES (headline, large_v, long_t; f32, chip_smoke's main
  path draw, seed 2): the lattice mode dense (``grad_wrt_acts``) and sparse
  (``grad_wrt_log_probs``), the fields mode dense with K = 0 and K = 2
  extra columns (``dense_grad``) and sparse with K = 0 and, where the
  checkout has it, K = 2 (``sparse_grad``);
* at chip_smoke.DURATION_SHAPES (headline, long_t; seed 14, the big blanks
  of 2 and 4 frames on the last two columns, log-probs from
  chip_smoke.log_probs_input): the sparse fields mode on the fields of the
  multi-blank loss on log-probs (where the checkout has it), with the K = 2
  big-blank columns, without them, and with the two columns moved to 1 and
  V - 1 (the widest span); and the prep kernel on those log-probs with the
  two columns.

For each: ``kernel_ms``, the profiler's device time of the kernel over its
launches; ``ms``, CUDA events over ``--iters`` calls (the wrapper's host
work too); the bytes bound. Prints the card's name and power limit and one
JSON object. Imports no JAX.
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
KERNELS = ("grad_lattice_tile_kernel", "grad_lattice_warp_kernel", "grad_fields_tile_kernel",
           "grad_fields_warp_kernel", "grad_kernel", "prep_tile_kernel", "prep_warp_kernel",
           "prep_kernel")


def smoke():
    """This checkout's chip_smoke.py, loaded by path (the package under
    test may be another checkout's)."""
    spec = importlib.util.spec_from_file_location("grad_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(fn, iters=20):
    """Device ms of one launch of the kernel ``fn`` launches: the profiler's
    time of the kernels in KERNELS over their launches, or None where it
    records none."""
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
    from warp_transducer_tpu_torch.ops import gradients, multiblank, prep, window
    from warp_transducer_tpu_torch.ops.cuda import grad as kgrad
    from warp_transducer_tpu_torch.ops.cuda import prep as kprep
    from warp_transducer_tpu_torch.ops.cuda import wavefront as kwave
    from warp_transducer_tpu_torch.ops.cuda import window as kwindow
    sm = smoke()
    dev = torch.device("cuda", 0)
    out = {"root": str(root)}

    def case(name, fn, bytes_moved):
        out[name] = {"kernel_ms": kernel_ms(fn), "ms": sm.time_ms(fn, iters),
                     "bound_ms": bytes_moved / sm.HBM_BYTES_PER_S * 1e3}

    log_probs = hasattr(multiblank, "_multiblank_costs")  # the sparse mode takes columns
    for tag, B, T, L, V in sm.SHAPES:
        acts, labels, il, ll = sm.make_problem(B, T, L, V, seed=2, dev=dev)
        U = L + 1
        p = kprep.prepare(acts, labels, 0, False)
        res = kwave.forward_backward(p.lpb, p.lpe, il, ll)
        labels_u = prep.label_rows(labels, U)
        lat = (p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward, labels_u, il, ll, 0)
        fields = gradients.coefficients(p.lpb, p.lpe, res.alphas, res.betas, res.ll_forward,
                                        il, ll)
        extra, cols = torch.stack((fields.cb, fields.ce), -1), (V - 2, V - 1)
        n_big, cells = B * T * U * V * 4, int((il.long() * (ll.long() + 1)).sum())
        case(f"lattice_dense_{tag}", lambda: kgrad.grad_wrt_acts(acts, p.denom, *lat),
             n_big + cells * V * 4 + 5 * cells * 4)
        case(f"lattice_sparse_{tag}", lambda: kgrad.grad_wrt_log_probs(*lat, V, torch.float32),
             n_big + 4 * cells * 4)
        g_args = (acts, p.denom, fields, labels_u, il, ll, 0, torch.float32)
        case(f"fields_dense_k0_{tag}", lambda: kgrad.dense_grad(*g_args),
             n_big + cells * V * 4 + 4 * cells * 4)
        case(f"fields_dense_k2_{tag}",
             lambda: kgrad.dense_grad(*g_args, extra_cols=cols, extra_fields=extra),
             n_big + cells * V * 4 + 6 * cells * 4)
        case(f"fields_sparse_k0_{tag}",
             lambda: kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, torch.float32),
             n_big + 2 * cells * 4)
        if log_probs:
            case(f"fields_sparse_k2_{tag}",
                 lambda: kgrad.sparse_grad(fields, labels_u, il, ll, 0, V, torch.float32,
                                           extra_cols=cols, extra_fields=extra),
                 n_big + 4 * cells * 4)
        del acts, p, res, lat, fields, extra, g_args
        torch.cuda.empty_cache()
    # The multi-blank loss on log-probs: its prep and its sparse gradient.
    for tag, B, T, L, V in sm.DURATION_SHAPES:
        acts, _, labels, il, ll = sm.make_duration_problem(B, T, L, V, seed=14, dev=dev)
        U, cols = L + 1, (V - 2, V - 1)
        lp = sm.log_probs_input(acts).detach()
        del acts
        n_small, cells = B * T * U, int((il.long() * (ll.long() + 1)).sum())
        case(f"prep_log_probs_k2_{tag}",
             lambda: kprep.prepare(lp, labels, 0, True, extra_cols=cols),
             8 * n_small * 4 + B * U * 4)
        if log_probs:
            p = kprep.prepare(lp, labels, 0, True, extra_cols=cols)
            lpb, lpe, lpB = p.lpb - sm.MB_SIGMA, p.lpe - sm.MB_SIGMA, p.extras - sm.MB_SIGMA
            lat = kwindow.forward_backward(lpb, lpe, lpB, window.multiblank_arcs(sm.MB_DURATIONS),
                                           il, ll)
            coef, cb, ce, cBs = multiblank._mb_coefs(lpb, lpe, lpB, lat, sm.MB_DURATIONS, il, ll)
            s_args = (gradients.Coefficients(coef, cb, ce), prep.label_rows(labels, U), il, ll,
                      0, V, torch.float32)
            s_kw = dict(extra_cols=cols, extra_fields=torch.stack(cBs, -1))
            case(f"fields_sparse_k2_mb_{tag}", lambda: kgrad.sparse_grad(*s_args, **s_kw),
                 n_small * V * 4 + 4 * cells * 4)
            case(f"fields_sparse_k0_mb_{tag}", lambda: kgrad.sparse_grad(*s_args),
                 n_small * V * 4 + 2 * cells * 4)
            # the two columns at the row's ends: every element checks them
            spread = dict(s_kw, extra_cols=(1, V - 1))
            case(f"fields_sparse_k2_spread_{tag}", lambda: kgrad.sparse_grad(*s_args, **spread),
                 n_small * V * 4 + 4 * cells * 4)
            del p, lat, s_args, s_kw
        del lp
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
        sys.exit("time_grad.py: no CUDA device is visible")
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
            sys.exit(f"time_grad.py: the {label} run failed:\n{proc.stdout}\n{proc.stderr}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(f"{label}: " + " | ".join(
            f"{name} kernel {v['kernel_ms']} ms, event {v['ms']:.4f} ms, bound {v['bound_ms']:.4f}"
            for name, v in r.items() if isinstance(v, dict)), flush=True)
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
