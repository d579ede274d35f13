// stencil27: masked k = 1 27-tap lattice stencil, y = mask ? z : S(z * !mask).
//
// Replaces the TPU kernels dune_pdelab_tpu/assembly/stencil_pallas_tile.py
// build_tiled_stencil_apply (K2a) and stencil_pallas.py
// build_flat_stencil_apply (K2b): the same function, with the wrapper's two
// Dirichlet `where`s fused in (mask as a uint8 pointer, or null for none).
//
// Bound on the H100: device-memory bytes. Each point needs one read of z,
// one of the mask and one write of y (9 bytes per fp32 point) against 27
// FMAs, far below the card's compute-to-bandwidth ratio. The plane window
// of plane_window.cuh reads each z plane once per block chunk, so the
// traffic stays near that minimum; the halo rows and columns come mostly
// from L2.
#include "plane_window.cuh"

namespace dpt {
namespace {

template <typename T>
struct MaskedLoad {  // constrained entries read as 0
  const T* z;
  const uint8_t* mask;
  __device__ T operator()(int64_t i) const {
    return (mask != nullptr && mask[i]) ? T(0) : z[i];
  }
};

template <typename T>
struct MaskedStore {  // constrained rows are identity
  const T* z;
  const uint8_t* mask;
  T* y;
  __device__ void operator()(int64_t i, int, int, int, T, T s) {
    y[i] = (mask != nullptr && mask[i]) ? z[i] : s;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
stencil27_kernel(const T* z, const uint8_t* mask, T* y, int nx, int ny, int nz,
                 Taps<T> W) {
  MaskedLoad<T> ld{z, mask};
  MaskedStore<T> st{z, mask, y};
  march<T>(nx, ny, nz, W, ld, st);
}

template <typename T>
int launch(const T* z, const uint8_t* mask, T* y, int nx, int ny, int nz,
           const double* w, void* stream) {
  stencil27_kernel<T><<<window_grid(nx, ny, nz), dim3(BX, BY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      z, mask, y, nx, ny, nz, make_taps<T>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dpt

extern "C" int dpt_window_nblocks(int nx, int ny, int nz) {
  const dim3 g = dpt::window_grid(nx, ny, nz);
  return static_cast<int>(g.x * g.y * g.z);
}

extern "C" int dpt_stencil27_f32(const float* z, const uint8_t* mask, float* y,
                                 int nx, int ny, int nz, const double* w,
                                 void* stream) {
  return dpt::launch<float>(z, mask, y, nx, ny, nz, w, stream);
}

extern "C" int dpt_stencil27_f64(const double* z, const uint8_t* mask, double* y,
                                 int nx, int ny, int nz, const double* w,
                                 void* stream) {
  return dpt::launch<double>(z, mask, y, nx, ny, nz, w, stream);
}
