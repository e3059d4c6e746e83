// The table instances of the pending-window lattice kernel
// (csrc/window_walk.cuh::window_table_kernel: the wide walk over any number
// of arcs and channels, its arc table read from device memory, its rings in
// device memory where they pass a block), built apart from the narrow and
// the wide ones so that the three compile in parallel.
#include "window_walk.cuh"

namespace wtt_window {

const void* table_kernel(int elt, int cells) {
  if (elt == 4) return table_kernel_of<float, 1, max_cells(4)>(cells);
  if (elt == 8) return table_kernel_of<double, 1, max_cells(8)>(cells);
  return nullptr;
}

}  // namespace wtt_window
