// blockstencil: the DG block stencil of a translation-invariant operator on
// a structured element lattice,
//
//   y[e] = sum_t W_t z[e + off_t] + sum_{sides s of the domain that e lies on} dD_s z[e]
//
// over the 7 face taps t = (0, -x, +x, -y, +y, -z, +z) (5 in 2D), with nb x nb
// blocks W_t and the per-side boundary corrections dD (dim, side) added on
// boundary elements (the `fold_dd` semantics of the reference's production
// lowering: the correction of side (d, 0) on elements with coordinate d = 0,
// of (d, 1) on coordinate d = n_d - 1, corners collecting every side).
// Neighbours outside the grid contribute nothing.
//
// Replaces the TPU kernels dune_pdelab_tpu/assembly/blockstencil_mm.py
// build_mm_block_apply (K5a, :151), build_mm_flat_apply (K5b, :329, the
// `mxu2` production mode) and build_mm_vreg_apply (K5c, :492), which apply
// it in the mode-major layout (nz, nb, ny, nx), and
// dune_pdelab_tpu/assembly/blockstencil_pallas.py build_block_stencil_apply
// (K6, :112), which applies it element-major (e*nb + j). One template serves
// both layouts through strides: DOF (x, y, z, mode b) sits at
// x*sx + y*sy + z*sz + b*sb. The TPU kernels' lane and sublane gates, the
// divisor-of-nz plane blocking, VMEM sizing and K6's correction for rows that
// cross a z-slab (an effect of its lane-roll layout) have no counterpart:
// each thread tests its neighbours against the grid.
//
// Bound on the H100: device-memory bytes. The function reads z and writes y
// once (8 B per DOF in fp32) against 7*nb multiply-adds per DOF (112 flop
// for Q1 3D), below the card's fp32 compute-to-bandwidth ratio. This first
// version is simple: one thread per element computes all nb outputs,
// consecutive threads on consecutive x (coalesced in the mode-major layout),
// each neighbour's nb values read once into registers, the weights read
// through the read-only cache (13*nb^2 values: 75.8 KB for Q2 3D in fp64,
// more than the 64 KB of __constant__), every warp reading the same weight
// address. Sums run in a fixed order (taps in the order above, then the dD
// sides x-, x+, y-, y+, z-, z+; the mode b innermost) with fused
// multiply-adds and no atomics, so a result repeats from run to run.
#include <cstdint>
#include <cuda_runtime.h>

namespace dpt {
namespace {

constexpr int BS_THREADS = 128;

struct Lattice {
  int nx, ny, nz, dim;
  int64_t sx, sy, sz, sb;
};

// Offset of tap t's neighbour and whether it lies in the grid.
__device__ __forceinline__ bool neighbour(const Lattice& g, int t, int x, int y, int z,
                                          int64_t* off) {
  if (t == 0) {
    *off = 0;
    return true;
  }
  const int ax = (t - 1) >> 1;
  const int sgn = (t & 1) ? -1 : 1;
  if (ax == 0) {
    *off = sgn * g.sx;
    return x + sgn >= 0 && x + sgn < g.nx;
  }
  if (ax == 1) {
    *off = sgn * g.sy;
    return y + sgn >= 0 && y + sgn < g.ny;
  }
  *off = sgn * g.sz;
  return g.dim == 3 && z + sgn >= 0 && z + sgn < g.nz;
}

// Whether the element lies on boundary side s (0 lower, 1 upper) of axis d.
__device__ __forceinline__ bool on_side(const Lattice& g, int d, int s, int x, int y,
                                        int z) {
  if (d >= g.dim) return false;
  const int c = d == 0 ? x : (d == 1 ? y : z);
  const int n = d == 0 ? g.nx : (d == 1 ? g.ny : g.nz);
  return s == 0 ? c == 0 : c == n - 1;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// NB > 0: the block size is a compile-time constant and the nb accumulators
// live in registers.
template <typename T, int NB>
__global__ void __launch_bounds__(BS_THREADS)
blockstencil_fixed(const T* __restrict__ z, const T* __restrict__ W,
                   const T* __restrict__ dD, T* __restrict__ y, Lattice g) {
  const int x = blockIdx.x * BS_THREADS + threadIdx.x;
  if (x >= g.nx) return;
  const int yy = blockIdx.y;
  const int zz = blockIdx.z;
  const int64_t base = x * g.sx + yy * g.sy + zz * g.sz;
  T acc[NB];
#pragma unroll
  for (int a = 0; a < NB; ++a) acc[a] = T(0);
#pragma unroll 1
  for (int t = 0; t < 7; ++t) {
    int64_t off;
    if (!neighbour(g, t, x, yy, zz, &off)) continue;
    const T* zn = z + base + off;
    T v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b] = __ldg(zn + b * g.sb);
    const T* Wt = W + t * NB * NB;
#pragma unroll
    for (int a = 0; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[a] = fma_rn(__ldg(Wt + a * NB + b), v[b], acc[a]);
    }
  }
#pragma unroll 1
  for (int side = 0; side < 6; ++side) {
    if (!on_side(g, side >> 1, side & 1, x, yy, zz)) continue;
    T v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b] = __ldg(z + base + b * g.sb);
    const T* Ds = dD + side * NB * NB;
#pragma unroll
    for (int a = 0; a < NB; ++a) {
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[a] = fma_rn(__ldg(Ds + a * NB + b), v[b], acc[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < NB; ++a) y[base + a * g.sb] = acc[a];
}

// Any nb: the outputs are computed one after another, each in the same
// order as blockstencil_fixed.
template <typename T>
__global__ void __launch_bounds__(BS_THREADS)
blockstencil_any(const T* __restrict__ z, const T* __restrict__ W,
                 const T* __restrict__ dD, T* __restrict__ y, Lattice g, int nb) {
  const int x = blockIdx.x * BS_THREADS + threadIdx.x;
  if (x >= g.nx) return;
  const int yy = blockIdx.y;
  const int zz = blockIdx.z;
  const int64_t base = x * g.sx + yy * g.sy + zz * g.sz;
  const int nb2 = nb * nb;
  for (int a = 0; a < nb; ++a) {
    T acc = T(0);
    for (int t = 0; t < 7; ++t) {
      int64_t off;
      if (!neighbour(g, t, x, yy, zz, &off)) continue;
      const T* zn = z + base + off;
      const T* Wa = W + t * nb2 + a * nb;
      for (int b = 0; b < nb; ++b) acc = fma_rn(__ldg(Wa + b), __ldg(zn + b * g.sb), acc);
    }
    for (int side = 0; side < 6; ++side) {
      if (!on_side(g, side >> 1, side & 1, x, yy, zz)) continue;
      const T* Da = dD + side * nb2 + a * nb;
      for (int b = 0; b < nb; ++b)
        acc = fma_rn(__ldg(Da + b), __ldg(z + base + b * g.sb), acc);
    }
    y[base + a * g.sb] = acc;
  }
}

template <typename T>
int launch(const T* z, const T* W, const T* dD, T* y, int nx, int ny, int nz, int nb,
           int dim, long long sx, long long sy, long long sz, long long sb,
           void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nb < 1 || ny > 65535 || nz > 65535 ||
      (dim != 2 && dim != 3) || (dim == 2 && nz != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Lattice g{nx, ny, nz, dim, sx, sy, sz, sb};
  const dim3 grid((nx + BS_THREADS - 1) / BS_THREADS, ny, nz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 4: blockstencil_fixed<T, 4><<<grid, BS_THREADS, 0, s>>>(z, W, dD, y, g); break;
    case 8: blockstencil_fixed<T, 8><<<grid, BS_THREADS, 0, s>>>(z, W, dD, y, g); break;
    case 9: blockstencil_fixed<T, 9><<<grid, BS_THREADS, 0, s>>>(z, W, dD, y, g); break;
    case 27: blockstencil_fixed<T, 27><<<grid, BS_THREADS, 0, s>>>(z, W, dD, y, g); break;
    default: blockstencil_any<T><<<grid, BS_THREADS, 0, s>>>(z, W, dD, y, g, nb); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dpt

// W: (7, nb, nb) taps in the order (0, -x, +x, -y, +y, -z, +z); dD: (3, 2, nb,
// nb) per-side corrections; in 2D (dim = 2, nz = 1) the z taps and z sides
// are not read.
extern "C" int dpt_blockstencil_f32(const float* z, const float* W, const float* dD,
                                    float* y, int nx, int ny, int nz, int nb, int dim,
                                    long long sx, long long sy, long long sz,
                                    long long sb, void* stream) {
  return dpt::launch<float>(z, W, dD, y, nx, ny, nz, nb, dim, sx, sy, sz, sb, stream);
}

extern "C" int dpt_blockstencil_f64(const double* z, const double* W, const double* dD,
                                    double* y, int nx, int ny, int nz, int nb, int dim,
                                    long long sx, long long sy, long long sz,
                                    long long sb, void* stream) {
  return dpt::launch<double>(z, W, dD, y, nx, ny, nz, nb, dim, sx, sy, sz, sb, stream);
}
