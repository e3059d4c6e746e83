// The table instance's rings form of the pending-window lattice kernel
// (csrc/window_walk.cuh::window_table_kernel: the wide walk over any number
// of arcs and channels, its arc table read from device memory, alpha's
// departures in a ring for each arc, its rings in device memory where they
// pass a block), built apart from the other instances so that they compile
// in parallel.
#include "window_walk.cuh"

namespace wtt_window {

const void* table_kernel(int elt, int cells) {
  if (elt == 4) return table_kernel_of<float, 1, max_cells(4), false>(cells);
  if (elt == 8) return table_kernel_of<double, 1, max_cells(8), false>(cells);
  return nullptr;
}

}  // namespace wtt_window
