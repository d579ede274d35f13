// Shared machinery of the 27-tap (k = 1, 3D) lattice kernels: a block owns a
// BX x BY tile of the (x, y) plane and marches it along a chunk of ZCH z
// planes. Three tile planes (each with a one-point halo) live in a shared
// memory ring; every plane of the chunk is read from device memory once
// (plus two halo planes per chunk and the tile's x/y halo, mostly served by
// L2), so the kernels stream their vectors at about one read per point. The
// next plane's loads are kept in flight in registers while the current
// plane is computed.
// Out-of-grid neighbours read as 0.
//
// Grid layout: x fastest, flat index ((z * ny) + y) * nx + x, matching the
// port's (nz, ny, nx) C-order DOF grids (dim 0 fastest).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dpt {

constexpr int BX = 32;            // threads along x: one warp per tile row
constexpr int BY = 8;             // tile rows
constexpr int ZCH = 32;           // z planes marched by one block
constexpr int TX = BX + 2;        // tile width with halo
constexpr int TY = BY + 2;
constexpr int TILE = TX * TY;
constexpr int NTHREADS = BX * BY;

// Tap weights w[(dz+1)*9 + (dy+1)*3 + (dx+1)], passed by value (kernel
// parameters sit in the constant bank).
template <typename T>
struct Taps {
  T w[27];
};

template <typename T>
inline Taps<T> make_taps(const double* w) {
  Taps<T> t;
  for (int i = 0; i < 27; ++i) t.w[i] = static_cast<T>(w[i]);
  return t;
}

inline dim3 window_grid(int nx, int ny, int nz) {
  return dim3((nx + BX - 1) / BX, (ny + BY - 1) / BY, (nz + ZCH - 1) / ZCH);
}

__host__ __device__ inline int64_t flat_index(int x, int y, int z, int nx, int ny) {
  return (static_cast<int64_t>(z) * ny + y) * nx + x;
}

__device__ inline int block_linear() {
  return blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
}

__device__ inline bool on_face(int x, int y, int z, int nx, int ny, int nz) {
  return x == 0 || y == 0 || z == 0 || x == nx - 1 || y == ny - 1 || z == nz - 1;
}

// A tile plane (with halo) is TILE values; each thread holds at most two of
// them in registers between the global load and the shared-memory store.
static_assert(TILE <= 2 * NTHREADS, "a tile plane must fit two values per thread");

// Issue the global loads of plane z into registers; 0 outside the grid.
template <typename T, typename Loader>
__device__ inline void fetch_plane(T (&v)[2], int z, int x0, int y0, int nx,
                                   int ny, int nz, const Loader& ld) {
  const int tid = threadIdx.y * BX + threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = tid + j * NTHREADS;
    const int ty = t / TX;
    const int tx = t - ty * TX;
    const int gx = x0 + tx - 1;
    const int gy = y0 + ty - 1;
    v[j] = T(0);
    if (t < TILE && z >= 0 && z < nz && gx >= 0 && gx < nx && gy >= 0 && gy < ny)
      v[j] = ld(flat_index(gx, gy, z, nx, ny));
  }
}

template <typename T>
__device__ inline void store_plane(T* buf, const T (&v)[2]) {
  const int tid = threadIdx.y * BX + threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (tid + j * NTHREADS < TILE) buf[tid + j * NTHREADS] = v[j];
}

// 27-tap sum around tile index c over the planes below, at and above.
template <typename T>
__device__ inline T taps27(const T* lo, const T* mid, const T* hi, int c,
                           const Taps<T>& W) {
  T acc = T(0);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int o = c + (dy - 1) * TX + (dx - 1);
      acc += W.w[dy * 3 + dx] * lo[o];
      acc += W.w[9 + dy * 3 + dx] * mid[o];
      acc += W.w[18 + dy * 3 + dx] * hi[o];
    }
  }
  return acc;
}

// March this block's tile along its z chunk. For each grid point calls
// emit(flat index, x, y, z, centre value of the loaded field, 27-tap sum).
// The loads of plane z + 2 are issued into registers before the taps of
// plane z are computed, so they are in flight during the compute.
template <typename T, typename Loader, typename Emit>
__device__ inline void march(int nx, int ny, int nz, const Taps<T>& W,
                             const Loader& ld, Emit& emit) {
  __shared__ T ring[3 * TILE];
  T* lo = ring;
  T* mid = ring + TILE;
  T* hi = ring + 2 * TILE;
  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int z0 = blockIdx.z * ZCH;
  const int z1 = (z0 + ZCH < nz) ? z0 + ZCH : nz;
  const int gx = x0 + threadIdx.x;
  const int gy = y0 + threadIdx.y;
  const bool active = gx < nx && gy < ny;
  const int c = (threadIdx.y + 1) * TX + threadIdx.x + 1;
  T v[2];
  fetch_plane(v, z0 - 1, x0, y0, nx, ny, nz, ld);
  store_plane(lo, v);
  fetch_plane(v, z0, x0, y0, nx, ny, nz, ld);
  store_plane(mid, v);
  fetch_plane(v, z0 + 1, x0, y0, nx, ny, nz, ld);
  for (int z = z0; z < z1; ++z) {
    store_plane(hi, v);
    __syncthreads();
    if (z + 2 <= z1) fetch_plane(v, z + 2, x0, y0, nx, ny, nz, ld);
    if (active)
      emit(flat_index(gx, gy, z, nx, ny), gx, gy, z, mid[c],
           taps27(lo, mid, hi, c, W));
    __syncthreads();
    T* t = lo;
    lo = mid;
    mid = hi;
    hi = t;
  }
}

// Deterministic block sum of one double per thread; the total is valid in
// thread (0, 0). Launch with blockDim (BX, BY).
__device__ inline double block_sum(double v) {
  __shared__ double warp_sums[NTHREADS / 32];
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  v = 0.0;
  if (tid < 32) {
    v = tid < NTHREADS / 32 ? warp_sums[tid] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

}  // namespace dpt
