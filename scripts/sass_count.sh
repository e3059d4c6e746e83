#!/bin/sh
# What the duration-head kernels and tanhf compile to on sm_90a: the SASS
# of a probe kernel y[i] = tanhf(x[i]) (its MUFU and FP32-pipe instructions
# give the tanh's share of a bound), then an opcode histogram of each kernel
# instantiation of csrc/<name>.cu, and the instructions of the innermost loop
# around each kind of shuffle over the shuffles of that kind in it (for
# wavefront.cu a step of the alpha walk, SHFL.UP, and of the beta walk,
# SHFL.DOWN, however many steps the compiler unrolled: a warp issues at most
# one instruction a clock, so that count is a step's cycles at the least).
# For window_stream.cu it also prints the instructions of one row step of
# each warp-kernel instance: alpha's, the innermost loop (a conditional
# backward branch; a diverged shuffle's out-of-line path jumps back
# unconditionally) around a SHFL.UP that holds no SHFL.DOWN, and beta's, the
# innermost loop around a SHFL.DOWN (static counts: the loops over arcs and
# copies inside a row count once; the narrow instances, and with
# window_stream_wide the wide ones). For band_stream.cu, the two row steps of each row-walk instance as
# chip_smoke.band_step_instructions reads them: the innermost loops around
# a SHFL.IDX (the shuffles by δ), in the order of their code; and of each
# cells-walk instance, alpha's and beta's step as for window_stream.cu. For ranges.cu, the instructions a step of the three scans as
# chip_smoke.ranges_step_instructions reads them, and the SASS of each scan
# loop of the f32 kernel with 32 lanes a row.
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
  echo "== $k.cu: instructions a shuffle in the innermost loop around each kind, a function"
  $BIN/cuobjdump -sass "$OUT/$k.cubin" | awk '
    function hex(h,  i, c, v) { v = 0; h = tolower(h)
      for (i = 1; i <= length(h); i++) { c = index("0123456789abcdef", substr(h, i, 1)); v = v * 16 + c - 1 }
      return v }
    function dump(  s, k, i, best, bi, a, m) { if (!fn) return; s = fn ":"
      for (k in kinds) { best = 0
        for (i = 1; i <= nb; i++) for (a in at) if (kind[a] == k && at[a] >= lo[i] && at[a] <= hi[i])
          if (!best || hi[i] - lo[i] < best) { best = hi[i] - lo[i]; bi = i }
        m = 0
        if (best) for (a in at) if (kind[a] == k && at[a] >= lo[bi] && at[a] <= hi[bi]) m++
        s = s " " k "=" (best ? (best / 16 + 1) / m : 0) }
      print s }
    /Function :/ { dump(); fn = $3; nb = 0; delete at; delete kind; delete kinds; next }
    match($0, /\/\*[0-9a-f][0-9a-f][0-9a-f][0-9a-f]+\*\//) {
      addr = hex(substr($0, RSTART + 2, RLENGTH - 4))
      if (match($0, /SHFL\.(UP|DOWN)/)) { k = substr($0, RSTART, RLENGTH); at[addr] = addr; kind[addr] = k; kinds[k] = 1 }
      if (match($0, /BRA 0x[0-9a-f]+/)) { t = hex(substr($0, RSTART + 6, RLENGTH - 6))
        if (t < addr) { nb++; lo[nb] = t; hi[nb] = addr } } }
    END { dump() }' | c++filt
  if [ "$k" = band_stream ]; then
    echo "== $k.cu: instructions of the two row steps (ceil(log2 S), or (cells, C, 64-bit):"
    echo "   alpha, beta)"
    python3 -c 'import sys; sys.path.insert(0, "."); import chip_smoke
print(chip_smoke.band_step_instructions(sys.argv[1]))' "$OUT/$k.cubin"
    continue
  fi
  if [ "$k" = ranges ]; then
    echo "== $k.cu: instructions a step of the three scans ((element bytes, G): forward clamp,"
    echo "   backward raise, forward fix), then the SASS of each scan loop of the f32 kernel, G = 32"
    python3 - "$OUT/$k.cubin" "$BIN/cuobjdump" <<'EOF'
import re, subprocess, sys
sys.path.insert(0, ".")
import chip_smoke
print(chip_smoke.ranges_step_instructions(sys.argv[1]))
sts, loops = chip_smoke.sass_loops(sys.argv[1], r"ranges_kernelIfLi32E", lambda m: 4,
                                   marks=r"(STS)\.128")[4]
sass = subprocess.run([sys.argv[2], "-sass", sys.argv[1]], capture_output=True, text=True).stdout
body = sass[sass.index("ranges_kernelIfLi32E"):].split("Function :")[0]
for a, b in sorted(loops):
    if any(a <= x <= b for x in sts.get("STS", [])):
        print(f"-- loop {a:#x}..{b:#x}")
        for line in body.splitlines():
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m and a <= int(m.group(1), 16) <= b:
                print("  ", m.group(2))
EOF
    continue
  fi
  case $k in window_stream | window_stream_wide) ;; *) continue ;; esac
  echo "== $k.cu: instructions of one row step (alpha, beta), a function"
  $BIN/cuobjdump -sass "$OUT/$k.cubin" | awk '
    function hex(h,  i, c, v) { v = 0; h = tolower(h)
      for (i = 1; i <= length(h); i++) { c = index("0123456789abcdef", substr(h, i, 1)); v = v * 16 + c - 1 }
      return v }
    function holds(i, k,  a) { for (a in at) if (kind[a] == k && at[a] >= lo[i] && at[a] <= hi[i]) return 1
      return 0 }
    function step(k, other,  i, best) { best = 0
      for (i = 1; i <= nb; i++) if (holds(i, k) && !(other != "" && holds(i, other)))
        if (!best || hi[i] - lo[i] < best) best = hi[i] - lo[i]
      return best ? best / 16 + 1 : 0 }
    function dump() { if (fn) print fn ": alpha=" step("SHFL.UP", "SHFL.DOWN") " beta=" step("SHFL.DOWN", "") }
    /Function :/ { dump(); fn = $3; nb = 0; delete at; delete kind; next }
    match($0, /\/\*[0-9a-f][0-9a-f][0-9a-f][0-9a-f]+\*\//) {
      addr = hex(substr($0, RSTART + 2, RLENGTH - 4))
      if (match($0, /SHFL\.(UP|DOWN)/)) { at[addr] = addr; kind[addr] = substr($0, RSTART, RLENGTH) }
      if (match($0, /@!?U?P[0-9T]+ +BRA 0x[0-9a-f]+/)) { s = substr($0, RSTART, RLENGTH)
        t = hex(substr(s, index(s, "0x") + 2))
        if (t < addr) { nb++; lo[nb] = t; hi[nb] = addr } } }
    END { dump() }' | c++filt | grep window_warp_kernel
done
