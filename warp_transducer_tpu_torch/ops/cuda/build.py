"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` per source compiles in seconds; all of them start together, and
their objects are linked into one shared library that ``ctypes`` loads.
The library goes to ``<build root>/<hash>/``, keyed by a hash of the
sources and flags, on the first CUDA call, and the time of each ``nvcc``
is printed once. The build root is ``build/torch_kernels/`` of the
repository for a checkout (the package's parent holds ``pyproject.toml``)
and the per-user cache (``$XDG_CACHE_HOME`` or ``~/.cache``, then
``warp_transducer_tpu_torch/torch_kernels``) for an installed copy. A
missing ``nvcc`` or a failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libwtt_kernels.so"


class NvccError(RuntimeError):
    pass


def build_root() -> Path:
    """Where the library is built: the repository's ``build/torch_kernels``
    for a checkout, else the per-user cache directory (an installed copy's
    parent is ``site-packages``, no place for build outputs)."""
    if (_PKG.parent / "pyproject.toml").is_file():
        return _PKG.parent / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "warp_transducer_tpu_torch" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise NvccError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of warp_transducer_tpu_torch are built from source on first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_parallel(commands):
    """Start every command at once; raise with the output of any failure.
    Returns each command's wall time in seconds, from the common start to
    its end (a thread a command drains its output as it comes)."""
    started = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outs, seconds = [""] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        seconds[i] = time.perf_counter() - started

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    failed = [f"$ {' '.join(cmd)}\n{out}" for cmd, proc, out in zip(commands, procs, outs)
              if proc.returncode != 0]
    if failed:
        raise NvccError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library, unless a library of
    the same sources is already built; return its path."""
    out_dir = build_root() / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        seconds = _run_parallel([
            [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            for cu, obj in zip(cus, objs)
        ])
        staged = Path(tmp) / LIB_NAME
        (link,) = _run_parallel([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
                                  str(staged)]])
        print("nvcc seconds (all started together): "
              + ", ".join(f"{cu.name} {t:.2f}" for cu, t in zip(cus, seconds))
              + f"; link {link:.2f}", flush=True)
        os.replace(staged, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wtt_prep.argtypes = [p, i, p, p, p, p, p, p, i, p, ll, i, i, i, i, i, p]
    lib.wtt_prep_planned.argtypes = lib.wtt_prep.argtypes[:-1] + [p, p]
    lib.wtt_reduce_plan.argtypes = [i, i, i, p]
    lib.wtt_reduce_plan.restype = None
    lib.wtt_wavefront.argtypes = [p, p, i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.wtt_wavefront_plan.argtypes = [i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wtt_wavefront_plan.restype = None
    lib.wtt_window_stream.argtypes = [p, p, p, i, i, p, i, i, p, p, p, p, p, p, p, i, i, i, i,
                                      p, p, p]
    lib.wtt_window_stream_warps.argtypes = lib.wtt_window_stream.argtypes[:-3] + [i, p, p, p]
    lib.wtt_window_plan.argtypes = [i] * 13 + [ctypes.POINTER(ctypes.c_int)]
    lib.wtt_window_plan.restype = None
    lib.wtt_grad.argtypes = [p, i, p, p, p, p, p, p, i, p, p, p, p, p, ll, i, i, i, i, i, p, p]
    lib.wtt_grad_lattice.argtypes = [p, i, p, p, p, p, p, p, p, ll, ctypes.c_double, p, p, p, p,
                                     ll, i, i, i, i, i, p, p]
    lib.wtt_band_prep.argtypes = [p, i, p, p, p, p, ll, i, i, p]
    lib.wtt_band_prep_planned.argtypes = lib.wtt_band_prep.argtypes[:-1] + [p, p]
    lib.wtt_band_stream.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p, p]
    lib.wtt_band_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wtt_band_plan.restype = None
    lib.wtt_band_grad.argtypes = [p, i, p, p, p, p, p, p, p, p, p, ll, i, i, i, i, p, p]
    lib.wtt_ranges.argtypes = [p, p, p, i, p, p, p, i, i, i, i, p]
    lib.wtt_ranges_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wtt_ranges_plan.restype = None
    joint = [p, p, p, i, p, p, p, p]  # e, p, W, its type, bias, lab_full, offsets, label lengths
    dims = [i, i, i, i, i, i, p]  # B, T, U, H, V, blank, stream
    # lpb, lpe, denom; lpx, its columns, K, their device table; Wd, bias_d, dlog, D; the
    # scratch Wᵀ, h, the chunk
    lib.wtt_joint_prep.argtypes = joint + [p, p, p, p, p, i, p, p, p, p, i, p, p, i] + dims
    # denom, coef, cb, ce; cx, its columns, K, their device table
    fields = [p, p, p, p, p, p, i, p]
    # the rows row_begin .. + chunk − 1, dh's splits; the scratch Wᵀ, W, h, hᵀ, g, gᵀ, the
    # partials of db and dh
    chunk = [ll, i, i, p, p, p, p, p, p, p, p]
    lib.wtt_joint_grad_rows.argtypes = joint + fields + [p, p, i, p, p] + chunk + dims
    # offsets, label lengths, W's type; hᵀ, gᵀ, db partials; dW, its slices, db; the chunk,
    # dW's splits, accumulate, finish
    lib.wtt_joint_grad_cols.argtypes = [p, p, i, p, p, p, p, p, p, ll, i, i, i, i] + dims[:5] + [p]
    lib.wtt_joint_weights.argtypes = [p, i, i, i, p, p, p]
    lib.wtt_joint_h.argtypes = [p, p, p, p, i, i, i, i, ll, i, i, p, p, p]
    lib.wtt_joint_grad_dwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.wtt_dur_head_prep.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wtt_dur_head_grad.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wtt_dur_head_plan.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wtt_dur_head_part_floats.argtypes = [i, i, i, i, i]
    lib.wtt_dur_head_part_floats.restype = ctypes.c_longlong
    lib.wtt_dur_head_plan.restype = None
    for fn in (lib.wtt_prep, lib.wtt_prep_planned, lib.wtt_wavefront, lib.wtt_window_stream,
               lib.wtt_window_stream_warps,
               lib.wtt_grad, lib.wtt_grad_lattice, lib.wtt_band_prep, lib.wtt_band_prep_planned,
               lib.wtt_band_stream, lib.wtt_band_grad, lib.wtt_ranges, lib.wtt_joint_prep,
               lib.wtt_joint_grad_rows, lib.wtt_joint_grad_cols, lib.wtt_joint_grad_dwd,
               lib.wtt_joint_weights, lib.wtt_joint_h,
               lib.wtt_dur_head_prep, lib.wtt_dur_head_grad):
        fn.restype = ctypes.c_int
    # What the joint kernels' tiling needs at a given H (and V), for the wrapper's checks.
    lib.wtt_joint_plan.argtypes = [i, i, i, ll, ctypes.POINTER(ctypes.c_longlong)]
    lib.wtt_joint_plan.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    for fn in (lib.wtt_joint_prep_attrs, lib.wtt_joint_grad_rows_attrs, lib.wtt_wavefront_attrs):
        fn.argtypes = [i, i, ip, ip]
        fn.restype = i
    lib.wtt_joint_grad_cols_attrs.argtypes = [i, ip, ip]
    lib.wtt_joint_grad_cols_attrs.restype = i
    for fn in (lib.wtt_joint_prep_smem, lib.wtt_joint_grad_rows_smem, lib.wtt_joint_grad_cols_smem,
               lib.wtt_joint_grad_dwd_smem):
        fn.argtypes = [i]
        fn.restype = ll
    lib.wtt_window_attrs.argtypes = [i, i, i, ip, ip]
    lib.wtt_window_attrs.restype = i
    lib.wtt_band_attrs.argtypes = [i, i, ip, ip]
    lib.wtt_band_attrs.restype = i
    lib.wtt_band_prep_attrs.argtypes = [i, i, i, ip, ip]
    lib.wtt_band_prep_attrs.restype = i
    lib.wtt_ranges_attrs.argtypes = [i, i, ip, ip]
    lib.wtt_ranges_attrs.restype = i
    lib.wtt_dur_head_smem.argtypes = []
    lib.wtt_dur_head_smem.restype = ll
    lib.wtt_error_string.argtypes = [i]
    lib.wtt_error_string.restype = ctypes.c_char_p
    return lib

