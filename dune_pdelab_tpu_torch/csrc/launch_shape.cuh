// Launch sizing shared by the z-marching kernels (stencil27.cu,
// structured_fused.cu): how many z planes one block marches.
#pragma once

#include <cuda_runtime.h>

namespace dpt {

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Blocks of `kernel` the whole card keeps resident at once (at least 1).
template <typename K>
inline int resident_blocks(K kernel, int threads, size_t dyn_smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dyn_smem);
  return (sms * per_sm > 0) ? sms * per_sm : 1;
}

// z planes per block: enough z chunks that a grid of blocks_xy tiles per
// chunk gives the card about four rounds of resident blocks (so small
// multigrid levels still fill every SM), but at least zmin planes per
// chunk where nz allows.
inline int z_chunk(int slots, int blocks_xy, int nz, int zmin) {
  int chunks = cdiv(4 * slots, blocks_xy);
  const int most = cdiv(nz, zmin);
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  return cdiv(nz, chunks);
}

}  // namespace dpt
