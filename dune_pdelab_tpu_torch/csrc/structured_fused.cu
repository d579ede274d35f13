// structured_fused: the ConvectionDiffusionFEM volume residual (with f) or
// Jacobian-apply (without f) on the 3D Q1 lattice, in one pass:
//   y = where(mask, 0, R(x))            (residual mode)
//   y = where(mask, x, R0(x * !mask))   (Jacobian-apply mode)
// with R(u) = sum_e sum_q [ (A grad u - b u) . grad phi + (c u - f) phi ] w|J|.
//
// Replaces the TPU kernel dune_pdelab_tpu/assembly/structured_fused.py
// _build_core (K3): the same function. The TPU version traced the
// coefficient closures A/b/c/f into the kernel body; here the wrapper
// evaluates them once per operator at every element quadrature point and
// passes (nqp, ncomp, nzc, nyc, nxc) arrays (kernels/structured_fused.py).
// The kernel is specialised on A's shape (constant, field, 3x3 tensor);
// b, c and f are optional pointers. The TPU's four pre-shifted inputs and
// four element-indexed partial outputs (a Mosaic alignment workaround) are
// not carried over.
//
// Design. A block owns a BX x BY tile of nodes and marches it along a chunk
// of ZCH node planes (plane_window.cuh's tiling). For each element plane it
// loads the node plane above into a two-plane shared ring, computes the
// (BX+1) x (BY+1) elements touching its nodes (one-element halo on the low
// side of x and y), keeps each element's 8 local results in shared memory,
// and every node then sums its <= 8 adjacent entries in a fixed order: four
// from the element plane below (carried in a register) and four from the
// plane above. No floating-point atomics, so results repeat bit for bit.
// The halo costs 297/256 element evaluations per node and one extra element
// plane per z chunk.
//
// Bound on the H100: arithmetic, at about 70 FMAs per quadrature point
// (8 * 70 per element for Q1's 8-point rule) against ~4 + 4 * nqp * ncomp
// bytes per element (x, y, and the coefficient values); a field A at
// nqp = 8 reads 32 B per element.
#include "plane_window.cuh"

namespace dpt {
namespace {

constexpr int EX = BX + 1;        // elements per tile row (low-side halo)
constexpr int EY = BY + 1;
constexpr int NE = EX * EY;
constexpr int TW = 33;            // tabulation row: phi[8], grad[8][3], factor

template <typename T>
struct NodeLoad {  // in Jacobian-apply mode constrained columns read as 0
  const T* x;
  const uint8_t* mask;
  __device__ T operator()(int64_t i) const {
    return (mask != nullptr && mask[i]) ? T(0) : x[i];
  }
};

// Accumulate one element's 8 local results over the quadrature points.
// Corner a = dx + 2 dy + 4 dz. Coefficient arrays are (nqp, ncomp, nel).
template <typename T, int AK>
__device__ inline void element(const T* stab, int nqp, const T (&u)[8],
                               int64_t e, int64_t nel, T a_const,
                               const T* __restrict__ A, const T* __restrict__ bv,
                               const T* __restrict__ cv, const T* __restrict__ fv,
                               T (&out)[8]) {
  for (int q = 0; q < nqp; ++q) {
    const T* tq = stab + q * TW;
    T uq = T(0), g0 = T(0), g1 = T(0), g2 = T(0);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      uq += tq[a] * u[a];
      g0 += tq[8 + 3 * a] * u[a];
      g1 += tq[9 + 3 * a] * u[a];
      g2 += tq[10 + 3 * a] * u[a];
    }
    T f0, f1, f2;
    if (AK == 0) {
      f0 = a_const * g0;
      f1 = a_const * g1;
      f2 = a_const * g2;
    } else if (AK == 1) {
      const T av = A[q * nel + e];
      f0 = av * g0;
      f1 = av * g1;
      f2 = av * g2;
    } else {
      const T* Aq = A + q * 9 * nel + e;
      f0 = Aq[0] * g0 + Aq[nel] * g1 + Aq[2 * nel] * g2;
      f1 = Aq[3 * nel] * g0 + Aq[4 * nel] * g1 + Aq[5 * nel] * g2;
      f2 = Aq[6 * nel] * g0 + Aq[7 * nel] * g1 + Aq[8 * nel] * g2;
    }
    if (bv != nullptr) {
      const T* bq = bv + q * 3 * nel + e;
      f0 -= uq * bq[0];
      f1 -= uq * bq[nel];
      f2 -= uq * bq[2 * nel];
    }
    T s = T(0);
    if (cv != nullptr) s = cv[q * nel + e] * uq;
    if (fv != nullptr) s -= fv[q * nel + e];
    const T m = tq[32];
    f0 *= m;
    f1 *= m;
    f2 *= m;
    s *= m;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      out[a] += tq[8 + 3 * a] * f0 + tq[9 + 3 * a] * f1 + tq[10 + 3 * a] * f2 + tq[a] * s;
  }
}

template <typename T, int AK>
__global__ void __launch_bounds__(NTHREADS)
structured_fused_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                        T* __restrict__ y, int nx, int ny, int nz,
                        const T* __restrict__ tab, int nqp, T a_const,
                        const T* __restrict__ A, const T* __restrict__ bv,
                        const T* __restrict__ cv, const T* __restrict__ fv,
                        int japply) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stab = reinterpret_cast<T*>(smem_raw);          // nqp * TW
  __shared__ T ring[2 * TILE];
  __shared__ T eout[8 * NE];
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int i = tid; i < nqp * TW; i += NTHREADS) stab[i] = tab[i];

  const int nxc = nx - 1, nyc = ny - 1, nzc = nz - 1;
  const int64_t nel = static_cast<int64_t>(nxc) * nyc * nzc;
  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  const int z0 = blockIdx.z * ZCH;
  const int z1 = (z0 + ZCH < nz) ? z0 + ZCH : nz;
  const int gx = x0 + threadIdx.x;
  const int gy = y0 + threadIdx.y;
  const bool active = gx < nx && gy < ny;
  const NodeLoad<T> ld{x, japply ? mask : nullptr};

  T* lo = ring;          // node plane ez
  T* hi = ring + TILE;   // node plane ez + 1
  T v[2];
  fetch_plane(v, z0 - 1, x0, y0, nx, ny, nz, ld);
  store_plane(lo, v);
  fetch_plane(v, z0, x0, y0, nx, ny, nz, ld);
  T acc = T(0);          // this node's sum from the element plane below
  for (int ez = z0 - 1; ez < z1; ++ez) {
    store_plane(hi, v);
    __syncthreads();
    if (ez + 2 <= z1) fetch_plane(v, ez + 2, x0, y0, nx, ny, nz, ld);
    for (int e = tid; e < NE; e += NTHREADS) {
      const int ley = e / EX;
      const int lex = e - ley * EX;
      const int ex = x0 - 1 + lex;
      const int ey = y0 - 1 + ley;
      T out[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) out[a] = T(0);
      if (ex >= 0 && ex < nxc && ey >= 0 && ey < nyc && ez >= 0 && ez < nzc) {
        T u[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const T* pl = (a & 4) ? hi : lo;
          u[a] = pl[(ley + ((a >> 1) & 1)) * TX + lex + (a & 1)];
        }
        const int64_t eflat = (static_cast<int64_t>(ez) * nyc + ey) * nxc + ex;
        element<T, AK>(stab, nqp, u, eflat, nel, a_const, A, bv, cv, fv, out);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) eout[a * NE + e] = out[a];
    }
    __syncthreads();
    if (active) {
      T s0 = T(0), s1 = T(0);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int e = (threadIdx.y + 1 - dy) * EX + (threadIdx.x + 1 - dx);
          s0 += eout[(dx + 2 * dy) * NE + e];        // corner dz = 0: node plane ez
          s1 += eout[(dx + 2 * dy + 4) * NE + e];    // corner dz = 1: node plane ez + 1
        }
      }
      if (ez >= z0) {
        const int64_t i = flat_index(gx, gy, ez, nx, ny);
        const bool con = mask != nullptr && mask[i];
        y[i] = con ? (japply ? x[i] : T(0)) : acc + s0;
      }
      acc = s1;
    }
    T* t = lo;
    lo = hi;
    hi = t;
  }
}

template <typename T>
int launch(const T* x, const uint8_t* mask, T* y, int nx, int ny, int nz,
           const T* tab, int nqp, int akind, double a_const, const T* A,
           const T* bv, const T* cv, const T* fv, int japply, void* stream) {
  void (*kern)(const T*, const uint8_t*, T*, int, int, int, const T*, int, T,
               const T*, const T*, const T*, const T*, int);
  switch (akind) {
    case 0: kern = structured_fused_kernel<T, 0>; break;
    case 1: kern = structured_fused_kernel<T, 1>; break;
    case 3: kern = structured_fused_kernel<T, 3>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(nqp) * TW * sizeof(T);
  if (smem > 16 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<window_grid(nx, ny, nz), dim3(BX, BY), smem,
         static_cast<cudaStream_t>(stream)>>>(x, mask, y, nx, ny, nz, tab, nqp,
                                              static_cast<T>(a_const), A, bv, cv,
                                              fv, japply);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dpt

extern "C" int dpt_structured_fused_f32(const float* x, const uint8_t* mask, float* y,
                                        int nx, int ny, int nz, const float* tab,
                                        int nqp, int akind, double a_const,
                                        const float* A, const float* b, const float* c,
                                        const float* f, int japply, void* stream) {
  return dpt::launch<float>(x, mask, y, nx, ny, nz, tab, nqp, akind, a_const, A, b,
                            c, f, japply, stream);
}

extern "C" int dpt_structured_fused_f64(const double* x, const uint8_t* mask, double* y,
                                        int nx, int ny, int nz, const double* tab,
                                        int nqp, int akind, double a_const,
                                        const double* A, const double* b, const double* c,
                                        const double* f, int japply, void* stream) {
  return dpt::launch<double>(x, mask, y, nx, ny, nz, tab, nqp, akind, a_const, A, b,
                             c, f, japply, stream);
}
