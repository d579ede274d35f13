// fused_cg_k1 / fused_cg_k2: the two passes of one CG iteration on a k = 1
// 27-tap stencil whose six grid faces are Dirichlet (q = 0 there).
//
//   K1(r, p, beta)     -> p' = r + beta p,            <p', A p'>
//   K2(x, r, p, alpha) -> x' = x + alpha p, r' = r - alpha A p, <r', r'>
//
// Replaces the TPU kernels dune_pdelab_tpu/assembly/fused_cg_pallas.py
// build_fused_cg_kernels: k1_kernel (K1a) and k2_kernel (K1b).
//
// Bound on the H100: device-memory bytes. K1 reads r, p and writes p'
// (3 vectors), K2 reads x, r, p and writes x', r' (5 vectors): 8 vector
// passes per iteration, against 27 FMAs per point per pass. K1 forms p' at
// every stencil neighbour on the fly from r and p as it loads the plane
// window (it never reads p' back), and both passes march the shared plane
// window of plane_window.cuh, so each input is streamed about once.
//
// Dots: blocks run in no order, so each block writes its partial sum
// (accumulated in double) and a second one-block pass adds the partials in
// a fixed order: deterministic, no atomics. alpha and beta are read through
// device pointers, so a CG loop issues no host sync.
#include "plane_window.cuh"

namespace dpt {
namespace {

template <typename T>
struct AxpyLoad {  // p' = r + beta p, formed at load time
  const T* r;
  const T* p;
  T beta;
  __device__ T operator()(int64_t i) const { return r[i] + beta * p[i]; }
};

template <typename T>
struct PlainLoad {
  const T* p;
  __device__ T operator()(int64_t i) const { return p[i]; }
};

template <typename T>
struct K1Emit {
  T* pn;
  int nx, ny, nz;
  double acc;
  __device__ void operator()(int64_t i, int x, int y, int z, T c, T s) {
    pn[i] = c;
    const T q = on_face(x, y, z, nx, ny, nz) ? T(0) : s;
    acc += static_cast<double>(c) * static_cast<double>(q);
  }
};

template <typename T>
struct K2Emit {
  const T* x;
  const T* r;
  T* xn;
  T* rn;
  T alpha;
  int nx, ny, nz;
  double acc;
  __device__ void operator()(int64_t i, int gx, int gy, int gz, T c, T s) {
    const T q = on_face(gx, gy, gz, nx, ny, nz) ? T(0) : s;
    xn[i] = x[i] + alpha * c;
    const T rv = r[i] - alpha * q;
    rn[i] = rv;
    acc += static_cast<double>(rv) * static_cast<double>(rv);
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
k1_kernel(const T* r, const T* p, const T* beta, T* pn, double* partials,
          int nx, int ny, int nz, Taps<T> W) {
  AxpyLoad<T> ld{r, p, *beta};
  K1Emit<T> em{pn, nx, ny, nz, 0.0};
  march<T>(nx, ny, nz, W, ld, em);
  const double v = block_sum(em.acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[block_linear()] = v;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
k2_kernel(const T* x, const T* r, const T* p, const T* alpha, T* xn, T* rn,
          double* partials, int nx, int ny, int nz, Taps<T> W) {
  PlainLoad<T> ld{p};
  K2Emit<T> em{x, r, xn, rn, *alpha, nx, ny, nz, 0.0};
  march<T>(nx, ny, nz, W, ld, em);
  const double v = block_sum(em.acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[block_linear()] = v;
}

// Second pass: one block adds the per-block partials in a fixed order.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
finalize_dot(const double* partials, int n, T* out) {
  const int tid = threadIdx.y * BX + threadIdx.x;
  double v = 0.0;
  for (int i = tid; i < n; i += NTHREADS) v += partials[i];
  v = block_sum(v);
  if (tid == 0) *out = static_cast<T>(v);
}

template <typename T>
int launch_k1(const T* r, const T* p, const T* beta, T* pn, double* partials,
              T* dot, int nx, int ny, int nz, const double* w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = window_grid(nx, ny, nz);
  k1_kernel<T><<<g, dim3(BX, BY), 0, s>>>(r, p, beta, pn, partials, nx, ny, nz,
                                          make_taps<T>(w));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  finalize_dot<T><<<1, dim3(BX, BY), 0, s>>>(
      partials, static_cast<int>(g.x * g.y * g.z), dot);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k2(const T* x, const T* r, const T* p, const T* alpha, T* xn, T* rn,
              double* partials, T* dot, int nx, int ny, int nz, const double* w,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = window_grid(nx, ny, nz);
  k2_kernel<T><<<g, dim3(BX, BY), 0, s>>>(x, r, p, alpha, xn, rn, partials, nx,
                                          ny, nz, make_taps<T>(w));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  finalize_dot<T><<<1, dim3(BX, BY), 0, s>>>(
      partials, static_cast<int>(g.x * g.y * g.z), dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dpt

extern "C" int dpt_fused_cg_k1_f32(const float* r, const float* p,
                                   const float* beta, float* pn,
                                   double* partials, float* dot, int nx, int ny,
                                   int nz, const double* w, void* stream) {
  return dpt::launch_k1<float>(r, p, beta, pn, partials, dot, nx, ny, nz, w,
                               stream);
}

extern "C" int dpt_fused_cg_k1_f64(const double* r, const double* p,
                                   const double* beta, double* pn,
                                   double* partials, double* dot, int nx, int ny,
                                   int nz, const double* w, void* stream) {
  return dpt::launch_k1<double>(r, p, beta, pn, partials, dot, nx, ny, nz, w,
                                stream);
}

extern "C" int dpt_fused_cg_k2_f32(const float* x, const float* r,
                                   const float* p, const float* alpha, float* xn,
                                   float* rn, double* partials, float* dot,
                                   int nx, int ny, int nz, const double* w,
                                   void* stream) {
  return dpt::launch_k2<float>(x, r, p, alpha, xn, rn, partials, dot, nx, ny,
                               nz, w, stream);
}

extern "C" int dpt_fused_cg_k2_f64(const double* x, const double* r,
                                   const double* p, const double* alpha,
                                   double* xn, double* rn, double* partials,
                                   double* dot, int nx, int ny, int nz,
                                   const double* w, void* stream) {
  return dpt::launch_k2<double>(x, r, p, alpha, xn, rn, partials, dot, nx, ny,
                                nz, w, stream);
}
