// ell27: the lattice-ELL SpMV of a k = 1 3D assembled matrix with per-row
// tap values, y = mask ? z : A (mask ? 0 : z), reads outside the grid = 0.
//
// Replaces the TPU kernels dune_pdelab_tpu/assembly/ell_pallas.py
// build_plane_ell_apply (K4a) and dune_pdelab_tpu/assembly/ell.py
// build_tiled_ell_apply (K4b): one kernel covers both. Unlike them it does
// not rely on zero couplings outside the domain (their lane rolls wrap
// around): every tap checks its neighbour against the grid, so the result
// is exact for ANY values, as EllMatrix._apply_impl is.
//
// Layout: values (27, nz, ny, nx) tap-major, tap t = (dz+1)*9 + (dy+1)*3 +
// (dx+1) (dim 0 fastest, the reference's offset order); z, y flat with x
// fastest; mask a uint8 (bool) vector or null for none.
//
// Bound on the H100: device-memory bytes. Per DOF the kernel must read 27
// values, z and the mask and write y (117 B in fp32, 233 B in fp64) against
// 27 multiply-adds, far below the card's compute-to-bandwidth ratio. One
// thread per DOF, consecutive threads on consecutive x, so each of the 27
// value streams is read once and coalesced, with streaming loads (`__ldcs`)
// that keep them from evicting z; the 26 neighbour reads of z and the mask
// are served mostly by L1/L2 (z is 1 of ~30 words per DOF). The taps are
// summed in the plain version's order with rounded multiplies and adds (no
// FMA contraction), so the kernel repeats ell27_reference bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace dpt {
namespace {

constexpr int ELL_THREADS = 128;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(ELL_THREADS)
ell27_kernel(const T* __restrict__ values, const T* __restrict__ z,
             const uint8_t* __restrict__ mask, T* __restrict__ y, int nx, int ny,
             int nz) {
  const int x = blockIdx.x * ELL_THREADS + threadIdx.x;
  if (x >= nx) return;
  const int yy = blockIdx.y;
  const int zz = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  const int64_t n = plane * nz;
  const int64_t i = zz * plane + static_cast<int64_t>(yy) * nx + x;
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    const int dz = t / 9 - 1;
    const int dy = (t / 3) % 3 - 1;
    const int dx = t % 3 - 1;
    T zt = T(0);
    if (x + dx >= 0 && x + dx < nx && yy + dy >= 0 && yy + dy < ny &&
        zz + dz >= 0 && zz + dz < nz) {
      const int64_t j = i + dz * plane + dy * static_cast<int64_t>(nx) + dx;
      if (mask == nullptr || !mask[j]) zt = __ldg(z + j);
    }
    const T term = mul_rn(__ldcs(values + t * n + i), zt);
    acc = (t == 0) ? term : add_rn(acc, term);
  }
  y[i] = (mask != nullptr && mask[i]) ? z[i] : acc;
}

template <typename T>
int launch(const T* values, const T* z, const uint8_t* mask, T* y, int nx, int ny,
           int nz, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || ny > 65535 || nz > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid((nx + ELL_THREADS - 1) / ELL_THREADS, ny, nz);
  ell27_kernel<T><<<grid, ELL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      values, z, mask, y, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dpt

extern "C" int dpt_ell27_f32(const float* values, const float* z, const uint8_t* mask,
                             float* y, int nx, int ny, int nz, void* stream) {
  return dpt::launch<float>(values, z, mask, y, nx, ny, nz, stream);
}

extern "C" int dpt_ell27_f64(const double* values, const double* z,
                             const uint8_t* mask, double* y, int nx, int ny, int nz,
                             void* stream) {
  return dpt::launch<double>(values, z, mask, y, nx, ny, nz, stream);
}
