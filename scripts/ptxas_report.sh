#!/bin/sh
# Registers, shared memory and spills of the port's CUDA kernels, as
# `nvcc -Xptxas -v` reports them for sm_90a.
#
#   sh scripts/ptxas_report.sh window_stream prep grad
#
# compiles warp_transducer_tpu_torch/csrc/<name>.cu for each name (all of
# csrc/*.cu when none is given) with the flags of ops/cuda/build.py and
# prints, per kernel instantiation, its name and the "Used N registers" and
# spill lines. Needs nvcc (PATH, or /usr/local/cuda/bin).
set -e
cd "$(dirname "$0")/.."
NVCC=$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)
CSRC=warp_transducer_tpu_torch/csrc
[ $# -gt 0 ] || set -- $(ls $CSRC/*.cu | xargs -n1 basename | sed 's/\.cu$//')
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT
for k in "$@"; do
  echo "== $k.cu"
  $NVCC -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v \
    -c $CSRC/$k.cu -o "$OUT/$k.o" 2>&1 | c++filt \
    | grep -E "error|warning|Compiling entry|bytes stack frame|Used [0-9]+ registers" \
    | sed -e 's/^ptxas info *: //' -e 's/^ *//'
done
