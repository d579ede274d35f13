// Host entry point of the plane window (plane_window.cuh): the number of
// blocks of a window launch, which sizes the fused-CG kernels' per-block
// partial sums (kernels/fused_cg.py).
#include "plane_window.cuh"

extern "C" int dpt_window_nblocks(int nx, int ny, int nz) {
  const dim3 g = dpt::window_grid(nx, ny, nz);
  return static_cast<int>(g.x * g.y * g.z);
}
