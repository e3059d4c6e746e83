// The table instance's pending form of the pending-window lattice kernel
// (csrc/window_walk.cuh::window_table_kernel with kPend: alpha's arrivals
// in one pending window whatever the number of arcs), built apart from the
// other instances so that they compile in parallel.
#include "window_walk.cuh"

namespace wtt_window {

const void* pending_kernel(int elt, int cells) {
  if (elt == 4) return table_kernel_of<float, 1, pending_max_cells(4), true>(cells);
  if (elt == 8) return table_kernel_of<double, 1, pending_max_cells(8), true>(cells);
  return nullptr;
}

}  // namespace wtt_window
