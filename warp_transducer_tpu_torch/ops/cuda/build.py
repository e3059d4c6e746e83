"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` per source compiles in seconds; all of them start together, and
their objects are linked into one shared library that ``ctypes`` loads.
The library goes to ``build/torch_kernels/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, on the first CUDA call.
A missing ``nvcc`` or a failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libwtt_kernels.so"


class NvccError(RuntimeError):
    pass


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
    """Start every command at once; raise with the output of any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    failed = []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise NvccError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library, unless a library of
    the same sources is already built; return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
        _run_parallel([
            [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            for cu, obj in zip(cus, objs)
        ])
        staged = Path(tmp) / LIB_NAME
        _run_parallel([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(staged)]])
        os.replace(staged, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wtt_prep.argtypes = [p, i, p, p, p, p, p, p, i, ll, i, i, i, i, i, p]
    lib.wtt_wavefront.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.wtt_window_stream.argtypes = [p, p, p, i, i, p, i, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.wtt_grad.argtypes = [p, i, p, p, p, p, p, p, i, p, p, p, p, ll, i, i, i, i, i, p]
    lib.wtt_band_prep.argtypes = [p, i, p, p, p, p, ll, i, i, p]
    lib.wtt_band_stream.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.wtt_band_grad.argtypes = [p, i, p, p, p, p, p, p, p, p, p, ll, i, i, i, i, p]
    lib.wtt_band_starts.argtypes = [p, p, p, p, i, i, i, p]
    joint = [p, p, p, i, p, p, p, p]  # e, p, W, its type, bias, lab_full, offsets, label lengths
    dims = [i, i, i, i, i, i, p]  # B, T, U, H, V, blank, stream
    # lpb, lpe, denom; lpx, its columns, K; Wd, bias_d, dlog, D
    lib.wtt_joint_prep.argtypes = joint + [p, p, p, p, p, i, p, p, p, i] + dims
    fields = [p, p, p, p, p, p, i]  # denom, coef, cb, ce; cx, its columns, K
    lib.wtt_joint_grad_rows.argtypes = joint + fields + [p, p, i, p, p] + dims
    lib.wtt_joint_grad_cols.argtypes = joint + fields + [p, p, p, p, i] + dims
    lib.wtt_joint_grad_dwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.wtt_dur_head_prep.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.wtt_dur_head_grad.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.wtt_prep, lib.wtt_wavefront, lib.wtt_window_stream, lib.wtt_grad,
               lib.wtt_band_prep,
               lib.wtt_band_stream, lib.wtt_band_grad, lib.wtt_band_starts, lib.wtt_joint_prep,
               lib.wtt_joint_grad_rows, lib.wtt_joint_grad_cols, lib.wtt_joint_grad_dwd,
               lib.wtt_dur_head_prep, lib.wtt_dur_head_grad):
        fn.restype = ctypes.c_int
    # What the joint kernels' tiling needs at a given H, for the wrapper's checks.
    lib.wtt_joint_max_h.argtypes = []
    lib.wtt_joint_max_h.restype = i
    lib.wtt_joint_grad_stripe.argtypes = [i]
    lib.wtt_joint_grad_stripe.restype = i
    for fn in (lib.wtt_joint_prep_smem, lib.wtt_joint_grad_smem, lib.wtt_dur_head_smem):
        fn.argtypes = [i]
        fn.restype = ll
    lib.wtt_error_string.argtypes = [i]
    lib.wtt_error_string.restype = ctypes.c_char_p
    return lib

