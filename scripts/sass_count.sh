#!/bin/sh
# What the duration-head kernels and tanhf compile to on sm_90a: the SASS
# of a probe kernel y[i] = tanhf(x[i]) (its MUFU and FP32-pipe instructions
# give the tanh's share of a bound), then an opcode histogram of each kernel
# instantiation of csrc/<name>.cu.
#
#   sh scripts/sass_count.sh [name ...]
#
# with the flags of ops/cuda/build.py; dur_head when no name is given.
# Needs nvcc and cuobjdump (PATH, or /usr/local/cuda/bin).
set -e
cd "$(dirname "$0")/.."
BIN=$(dirname "$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)")
FLAGS="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3"
[ $# -gt 0 ] || set -- dur_head
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT
cat > "$OUT/probe.cu" <<'EOF'
extern "C" __global__ void tanh_probe(const float* x, float* y) {
  y[threadIdx.x] = tanhf(x[threadIdx.x]);
}
EOF
$BIN/nvcc $FLAGS -cubin -o "$OUT/probe.cubin" "$OUT/probe.cu"
echo "== tanhf probe (SASS)"
$BIN/cuobjdump -sass "$OUT/probe.cubin" | grep -E '^[[:space:]]+/\*[0-9a-f]{4}\*/' | sed 's/;.*//' \
  | grep -v -E ' (NOP|BRA 0x[0-9a-f]+)$'
for k in "$@"; do
  $BIN/nvcc $FLAGS -cubin -o "$OUT/$k.cubin" warp_transducer_tpu_torch/csrc/$k.cu
  echo "== $k.cu: opcodes a function (static count)"
  $BIN/cuobjdump -sass "$OUT/$k.cubin" | awk '
    /Function :/ { if (fn) dump(); fn = $3; delete n; next }
    /^[ \t]+\/\*[0-9a-f][0-9a-f][0-9a-f][0-9a-f]\*\// {
      op = $2; if (op ~ /^@/) op = $3; sub(/\..*/, "", op); sub(/;$/, "", op); n[op]++ }
    function dump(  s, o) { s = fn ":"; for (o in n) s = s " " o "=" n[o]; print s }
    END { if (fn) dump() }' | c++filt
done
