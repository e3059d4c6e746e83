// The wide instances of the pending-window lattice kernel
// (csrc/window_walk.cuh: up to 16 warps a lattice, arcs of three channels,
// 64-bit offsets, passes of columns), built apart from the narrow ones in
// window_stream.cu so that the two compile in parallel.
#include "window_walk.cuh"

namespace wtt_window {

const void* wide_kernel(int elt, int cells) {
  if (elt == 4) return warp_kernel_of<float, 1, max_cells(4), true>(cells);
  if (elt == 8) return warp_kernel_of<double, 1, max_cells(8), true>(cells);
  return nullptr;
}

}  // namespace wtt_window
