// structured_fused: the ConvectionDiffusionFEM volume residual (with f) or
// Jacobian-apply (without f) on the 3D Q1 lattice, in one pass:
//   y = where(mask, 0, R(x))            (residual mode)
//   y = where(mask, x, R0(x * !mask))   (Jacobian-apply mode)
// with R(u) = sum_e sum_q [ (A grad u - b u) . grad phi + (c u - f) phi ] w|J|.
//
// Replaces the TPU kernel dune_pdelab_tpu/assembly/structured_fused.py:256
// (_build_core, K3): the same function. The TPU version traced the
// coefficient closures A/b/c/f into the kernel body; here the operator
// evaluates them once at every element quadrature point and passes
// (nqp, ncomp, nzc, nyc, nxc) arrays (kernels/structured_fused.py). The
// kernel is specialised on A's shape (constant, field, 3x3 tensor) and on
// q = 2 Gauss points per axis (the main path's rule); other tensor rules
// (q <= 4) take a runtime-q instantiation of the same code. b, c and f are
// optional pointers.
//
// Bound on the H100: device-memory bytes, x, the mask and y per node plus
// every coefficient value once: 41 B per element for a field A at q = 2 in
// fp32 (1.645 ms at 512^3 cells and 3.35 TB/s), against 512 flop per
// element (1.03 ms at 67 TFLOP/s) for the sum-factorised evaluation.
// Measured, it reaches about 47% of the bytes bound: ~115 registers per
// thread leave 16 warps per SM, too few to hide the latency of its
// instruction stream (PERF.md).
//
// Design.
//  - Sum factorisation on the tensor rule. The wrapper factors the (nqp, 33)
//    tabulation into 1D tables (Q1 basis at the Gauss points of each axis,
//    its derivative -+1/h_d, weights w_q |J|), passed by value (constant
//    bank: FMA operands). u and grad u come from 2 + 3 + 4 one-dimensional
//    contractions (x, then y, then z) and the test-function sweep from their
//    transposes (z, y, x). A Q1 derivative contraction is a difference
//    times 1/h, the same at every point of its axis, so it is taken once
//    per line, and a test sum against a derivative is summed over its
//    axis before it is scaled.
//  - A block owns a 31 x 31 tile of nodes: 8 warps, each lane one element
//    column, each warp 4 element rows, so the 32 x 32 elements touching the
//    tile are each computed by one thread, with no ragged second pass. The
//    block marches the tile along a chunk of z planes (sized from the grid,
//    launch_shape.cuh) through a two-plane shared node ring (values as
//    loaded and their mask bytes; constrained nodes read as 0 in
//    Jacobian-apply mode), the next plane's loads in flight in registers.
//    Stores need no global load: a constrained node's output comes from
//    the ring.
//  - x contractions are shared between the two elements of a thread's column
//    that touch a node row, and both elements add into that row's
//    accumulator before its transposed x contraction. A node then sums, in
//    fixed order: its right-hand element column's share by warp shuffle, the
//    row below the warp's first by a shared exchange, the element plane
//    below from a register. No floating-point atomics: results repeat bit
//    for bit.
//  - A field A's 8 values per element are loaded two elements ahead into
//    registers. (Copying them a whole plane ahead by cp.async into shared
//    memory measured slower: PERF.md.)
// Each element is computed (32 / 31)^2 (zch + 1) / zch times.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_shape.cuh"

namespace dpt {
namespace {

constexpr int WX = 32;                  // lanes: element columns of a tile
constexpr int NW = 8;                   // warps per block
constexpr int RY = 4;                   // element rows per warp
constexpr int NT = WX * NW;
constexpr int OX = WX - 1;              // node columns a block owns
constexpr int OY = NW * RY - 1;         // node rows a block owns
constexpr int TXN = WX + 1;             // node columns of a tile plane
constexpr int TYN = NW * RY + 1;        // node rows of a tile plane
constexpr int NPL = TXN * TYN;
constexpr int NLD = (NPL + NT - 1) / NT;
constexpr int QMAX = 4;                 // Gauss points per axis, at most
constexpr int ZMIN = 4;
constexpr unsigned FULL = 0xffffffffu;

// 1D tables of the tensor rule. Axis d, point i, corner c in {0, 1}:
// phi = Q1 basis; its derivative is -+1/h_d at every point (inv_h[d]);
// w = w_q |J| at the point k = ix + q (iy + q iz), the row of the
// tabulation and of the coefficient arrays.
template <typename T>
struct Rule {
  T phi[3][QMAX][2];
  T inv_h[3];
  T w[QMAX * QMAX * QMAX];
  int q;
};

__device__ inline int64_t flat(int x, int y, int z, int nx, int ny) {
  return (static_cast<int64_t>(z) * ny + y) * nx + x;
}

// Sign of the Q1 derivative of corner c: -1 for c = 0, +1 for c = 1.
template <typename T>
__device__ __forceinline__ T sgn(int c, T v) { return c ? v : -v; }

// One element's contributions. In: its corner rows dy = 0, 1 contracted in
// x: L[dy][dz][ix] = sum_dx phi_x[ix][dx] u (values at the x points) and
// D[dy][dz] = (u1 - u0) / h_x (the x-derivative, the same at every x
// point). Out, added to the accumulators of the node rows dy = 0 and 1:
// Rr[dz][ix], the test-function sums against the x basis before the
// transposed x contraction, and Sr[dz], the sums against its derivative
// (-+1/h_x at every point, so only their total over the x points counts).
template <typename T, int AK, int QT, int QM, int NQ>
__device__ __forceinline__ void element(const Rule<T>& R, int qr, const T (&L)[2][2][QM],
                               const T (&D)[2][2], int64_t e, int64_t nel,
                               T a_const, const T (&acur)[NQ], const T* __restrict__ A,
                               const T* __restrict__ bv, const T* __restrict__ cv,
                               const T* __restrict__ fv, T (&R0)[2][QM], T (&S0)[2],
                               T (&R1)[2][QM], T (&S1)[2]) {
  const int q = QT > 0 ? QT : qr;
  const bool has_s = cv != nullptr || fv != nullptr;
  const T hy = R.inv_h[1], hz = R.inv_h[2];
  T G1[2][QM];                            // y-derivative, the same at every y point
  T Qy[2][QM];                            // sum over y points of the z-transposed f1 terms
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int ix = 0; ix < QM; ++ix) {
      G1[dz][ix] = hy * (L[1][dz][ix] - L[0][dz][ix]);
      Qy[dz][ix] = T(0);
    }
  }
#pragma unroll
  for (int iy = 0; iy < q; ++iy) {
    T U[2][QM], G0[2];                    // y-contracted values [dz][ix], x-derivative [dz]
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int ix = 0; ix < QM; ++ix)
        U[dz][ix] = R.phi[1][iy][0] * L[0][dz][ix] + R.phi[1][iy][1] * L[1][dz][ix];
      G0[dz] = R.phi[1][iy][0] * D[0][dz] + R.phi[1][iy][1] * D[1][dz];
    }
    T F2[QM], PS[2][QM], Q1[2][QM], Q0[2];   // z-transposed sums
#pragma unroll
    for (int ix = 0; ix < QM; ++ix) {
      F2[ix] = T(0);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) PS[dz][ix] = Q1[dz][ix] = T(0);
    }
    Q0[0] = Q0[1] = T(0);
#pragma unroll
    for (int iz = 0; iz < q; ++iz) {
      const T g0 = R.phi[2][iz][0] * G0[0] + R.phi[2][iz][1] * G0[1];
#pragma unroll
      for (int ix = 0; ix < QM; ++ix) {
        if (QT == 0 && ix >= q) continue;
        const T uq = R.phi[2][iz][0] * U[0][ix] + R.phi[2][iz][1] * U[1][ix];
        const T g1 = R.phi[2][iz][0] * G1[0][ix] + R.phi[2][iz][1] * G1[1][ix];
        const T g2 = hz * (U[1][ix] - U[0][ix]);
        const int k = ix + q * (iy + q * iz);
        const T wq = R.w[k];
        T f0, f1, f2;                     // w (A grad u - b u)
        if constexpr (AK == 3) {
          const T* Ak = A + k * 9 * nel + e;
          f0 = (Ak[0] * g0 + Ak[nel] * g1 + Ak[2 * nel] * g2) * wq;
          f1 = (Ak[3 * nel] * g0 + Ak[4 * nel] * g1 + Ak[5 * nel] * g2) * wq;
          f2 = (Ak[6 * nel] * g0 + Ak[7 * nel] * g1 + Ak[8 * nel] * g2) * wq;
        } else {
          T av = a_const;
          if constexpr (AK == 1) {
            if constexpr (NQ > 1) av = acur[k];
            else av = A[k * nel + e];
          }
          const T aw = av * wq;
          f0 = aw * g0;
          f1 = aw * g1;
          f2 = aw * g2;
        }
        if (bv != nullptr) {
          const T* bk = bv + k * 3 * nel + e;
          const T uw = uq * wq;
          f0 -= uw * bk[0];
          f1 -= uw * bk[nel];
          f2 -= uw * bk[2 * nel];
        }
        F2[ix] += f2;
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          Q1[dz][ix] += R.phi[2][iz][dz] * f1;
          Q0[dz] += R.phi[2][iz][dz] * f0;
        }
        if (has_s) {
          T s = T(0);
          if (cv != nullptr) s = cv[k * nel + e] * uq;
          if (fv != nullptr) s -= fv[k * nel + e];
          s *= wq;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) PS[dz][ix] += R.phi[2][iz][dz] * s;
        }
      }
    }
    // y-transposed: the basis term now, the derivative term after the loop
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int ix = 0; ix < QM; ++ix) {
        const T P = sgn(dz, hz) * F2[ix] + PS[dz][ix];
        R0[dz][ix] += R.phi[1][iy][0] * P;
        R1[dz][ix] += R.phi[1][iy][1] * P;
        Qy[dz][ix] += Q1[dz][ix];
      }
      S0[dz] += R.phi[1][iy][0] * Q0[dz];
      S1[dz] += R.phi[1][iy][1] * Q0[dz];
    }
  }
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int ix = 0; ix < QM; ++ix) {
      R0[dz][ix] -= hy * Qy[dz][ix];
      R1[dz][ix] += hy * Qy[dz][ix];
    }
  }
}

template <typename T, int AK, int QT>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
structured_fused_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                        T* __restrict__ y, int nx, int ny, int nz, int zch,
                        const __grid_constant__ Rule<T> R, T a_const,
                        const T* __restrict__ A, const T* __restrict__ bv,
                        const T* __restrict__ cv, const T* __restrict__ fv,
                        int japply) {
  constexpr int QM = QT > 0 ? QT : QMAX;            // unrolled x extent
  constexpr int NQ = (AK == 1 && QT > 0) ? QT * QT * QT : 1;   // prefetched A values
  const int q = QT > 0 ? QT : R.q;
  __shared__ T ring[2][NPL];               // node planes ez, ez + 1, as loaded
  __shared__ uint8_t mring[2][NPL];         // and their mask bytes
  __shared__ T xch[NW][2][WX];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int tid = w * WX + lane;
  const int nxc = nx - 1, nyc = ny - 1, nzc = nz - 1;
  const int64_t nel = static_cast<int64_t>(nxc) * nyc * nzc;
  const int cx0 = blockIdx.x * OX - 1;    // node and element column of tile column 0
  const int cy0 = blockIdx.y * OY - 1;
  const int z0 = blockIdx.z * zch;
  const int z1 = (z0 + zch < nz) ? z0 + zch : nz;
  const int ex = cx0 + lane;              // this lane's element column
  const bool xin = ex >= 0 && ex < nxc;
  const bool own_x = lane < WX - 1 && ex + 1 < nx;   // owns node column ex + 1

  auto elem = [&](int j, int ez) -> int64_t {   // element index or -1
    const int ey = cy0 + w * RY + j;
    return (xin && ey >= 0 && ey < nyc && ez >= 0 && ez < nzc)
               ? flat(ex, ey, ez, nxc, nyc) : int64_t(-1);
  };

  T v[NLD];
  uint32_t vm[NLD];
  auto fetch = [&](int zp) {              // node plane zp into registers
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int t = tid + j * NT;
      const int r = t / TXN;
      const int c = t - r * TXN;
      const int gx = cx0 + c, gy = cy0 + r;
      v[j] = T(0);
      vm[j] = 0;
      if (t < NPL && zp >= 0 && zp < nz && gx >= 0 && gx < nx && gy >= 0 && gy < ny) {
        const int64_t i = flat(gx, gy, zp, nx, ny);
        v[j] = x[i];
        if (mask != nullptr) vm[j] = mask[i];
      }
    }
  };
  auto put = [&](int b) {
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int t = tid + j * NT;
      if (t < NPL) {
        ring[b][t] = v[j];
        mring[b][t] = static_cast<uint8_t>(vm[j]);
      }
    }
  };
  T an1[NQ], an2[NQ];                   // A of the next two elements
  auto load_a = [&](int64_t e) {          // shift the prefetch ring, load element e
    if constexpr (NQ > 1) {
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        an1[k] = an2[k];
        an2[k] = (e >= 0) ? A[k * nel + e] : T(0);
      }
    }
  };
  // x contraction of node tile row tr in both planes (constrained nodes as
  // 0 in Jacobian-apply mode): values [dz][ix], derivative [dz]
  auto xrow = [&](int lo, int tr, T (&Lr)[2][QM], T (&Dr)[2]) {
    T u[2][2];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int i = tr * TXN + lane + dx;
        u[dz][dx] = (japply && mring[lo ^ dz][i]) ? T(0) : ring[lo ^ dz][i];
      }
    }
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int ix = 0; ix < QM; ++ix) {
        const bool on = QT > 0 || ix < q;
        Lr[dz][ix] = on ? R.phi[0][ix][0] * u[dz][0] + R.phi[0][ix][1] * u[dz][1] : T(0);
      }
      Dr[dz] = R.inv_h[0] * (u[dz][1] - u[dz][0]);
    }
  };
  // transposed x contraction of a node row's accumulators, then the node's
  // sum with its right-hand element column's share: [dz]
  auto xcomb = [&](const T (&Rr)[2][QM], const T (&Sr)[2], T (&m)[2]) {
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      T n0 = -R.inv_h[0] * Sr[dz], n1 = R.inv_h[0] * Sr[dz];
#pragma unroll
      for (int ix = 0; ix < QM; ++ix) {
        n0 += R.phi[0][ix][0] * Rr[dz][ix];
        n1 += R.phi[0][ix][1] * Rr[dz][ix];
      }
      m[dz] = n1 + __shfl_down_sync(FULL, n0, 1);
    }
  };
  T carry[RY];    // node rows 1..RY: share of the element plane below
#pragma unroll
  for (int r = 0; r < RY; ++r) carry[r] = T(0);
  // this lane's node of warp row r in node plane ez (ring[lo]): its mask
  // byte and value as loaded
  auto node = [&](int r, int lo, uint32_t& mb, T& xv) {
    const int i = (w * RY + r) * TXN + lane + 1;
    mb = mring[lo][i];
    xv = ring[lo][i];
  };
  // finish and store that node
  auto finish = [&](int r, const T (&m)[2], int ez, uint32_t mb, T xv) {
    const T val = carry[r - 1] + m[0];
    carry[r - 1] = m[1];
    const int gy = cy0 + w * RY + r;
    if (ez >= z0 && own_x && gy < ny)
      y[flat(ex + 1, gy, ez, nx, ny)] = mb ? (japply ? xv : T(0)) : val;
  };

  fetch(z0 - 1);
  put(0);
  fetch(z0);
  load_a(elem(0, z0 - 1));
  load_a(elem(1, z0 - 1));
  int lo = 0;
  for (int ez = z0 - 1; ez < z1; ++ez) {   // element plane ez: node planes ez, ez + 1
    put(lo ^ 1);
    __syncthreads();
    if (ez + 1 < z1) fetch(ez + 2);

    T L[2][2][QM], D[2][2];              // [dy][dz][ix], [dy][dz]
    xrow(lo, w * RY, L[0], D[0]);
    T R0[2][QM], S0[2];                   // node row j: elements j - 1 (dy = 1) and j (dy = 0)
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int ix = 0; ix < QM; ++ix) R0[dz][ix] = T(0);
      S0[dz] = T(0);
    }
    T m0[2];
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      xrow(lo, w * RY + j + 1, L[1], D[1]);
      T R1[2][QM], S1[2];                 // node row j + 1: element j's share
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
        for (int ix = 0; ix < QM; ++ix) R1[dz][ix] = T(0);
        S1[dz] = T(0);
      }
      const int64_t e = elem(j, ez);
      T acur[NQ];
      if constexpr (NQ > 1) {
#pragma unroll
        for (int k = 0; k < NQ; ++k) acur[k] = an1[k];
      }
      load_a(j + 2 < RY ? elem(j + 2, ez) : elem(j + 2 - RY, ez + 1));   // two elements ahead
      if (e >= 0)
        element<T, AK, QT, QM, NQ>(R, q, L, D, e, nel, a_const, acur, A, bv, cv, fv,
                                   R0, S0, R1, S1);
      T m[2];
      xcomb(R0, S0, m);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
        for (int ix = 0; ix < QM; ++ix) {
          R0[dz][ix] = R1[dz][ix];
          L[0][dz][ix] = L[1][dz][ix];
        }
        S0[dz] = S1[dz];
        D[0][dz] = D[1][dz];
      }
      if (j == 0) {
        m0[0] = m[0];
        m0[1] = m[1];
      } else {
        uint32_t mb;
        T xv;
        node(j, lo, mb, xv);
        finish(j, m, ez, mb, xv);
      }
    }
    T mt[2];
    xcomb(R0, S0, mt);                    // node row RY: the warp's last element row only
    uint32_t mb;
    T xv;
    node(RY, lo, mb, xv);                 // read before the next step may refill the ring
    xch[w][0][lane] = m0[0];
    xch[w][1][lane] = m0[1];
    __syncthreads();
    if (w + 1 < NW) {                     // add the next warp's first element row
      mt[0] += xch[w + 1][0][lane];
      mt[1] += xch[w + 1][1][lane];
      finish(RY, mt, ez, mb, xv);
    }
    lo ^= 1;
  }
}

template <typename T, int AK, int QT>
int launch_rule(const T* x, const uint8_t* mask, T* y, int nx, int ny, int nz,
                const Rule<T>& R, T a_const, const T* A, const T* bv, const T* cv,
                const T* fv, int japply, cudaStream_t stream) {
  static const int slots = resident_blocks(structured_fused_kernel<T, AK, QT>, NT);
  const int bx = cdiv(nx, OX);
  const int by = cdiv(ny, OY);
  const int zch = z_chunk(slots, bx * by, nz, ZMIN);
  structured_fused_kernel<T, AK, QT><<<dim3(bx, by, cdiv(nz, zch)), dim3(WX, NW), 0,
                                       stream>>>(x, mask, y, nx, ny, nz, zch, R, a_const,
                                                 A, bv, cv, fv, japply);
  return static_cast<int>(cudaGetLastError());
}

// rule: the wrapper's float64 tables, packed as phi[3][QMAX][2], inv_h[3],
// w[QMAX^3] (host memory).
template <typename T>
int launch(const T* x, const uint8_t* mask, T* y, int nx, int ny, int nz,
           const double* rule, int q, int akind, double a_const, const T* A,
           const T* bv, const T* cv, const T* fv, int japply, void* stream) {
  if (q < 1 || q > QMAX) return static_cast<int>(cudaErrorInvalidValue);
  Rule<T> R;
  const double* src = rule;
  for (int d = 0; d < 3; ++d)
    for (int i = 0; i < QMAX; ++i)
      for (int c = 0; c < 2; ++c) R.phi[d][i][c] = static_cast<T>(*src++);
  for (int d = 0; d < 3; ++d) R.inv_h[d] = static_cast<T>(*src++);
  for (int k = 0; k < QMAX * QMAX * QMAX; ++k) R.w[k] = static_cast<T>(*src++);
  R.q = q;
  const T ac = static_cast<T>(a_const);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q2 = q == 2;
  switch (akind) {
    case 0:
      return q2 ? launch_rule<T, 0, 2>(x, mask, y, nx, ny, nz, R, ac, A, bv, cv, fv, japply, s)
                : launch_rule<T, 0, 0>(x, mask, y, nx, ny, nz, R, ac, A, bv, cv, fv, japply, s);
    case 1:
      return q2 ? launch_rule<T, 1, 2>(x, mask, y, nx, ny, nz, R, ac, A, bv, cv, fv, japply, s)
                : launch_rule<T, 1, 0>(x, mask, y, nx, ny, nz, R, ac, A, bv, cv, fv, japply, s);
    case 3:
      return q2 ? launch_rule<T, 3, 2>(x, mask, y, nx, ny, nz, R, ac, A, bv, cv, fv, japply, s)
                : launch_rule<T, 3, 0>(x, mask, y, nx, ny, nz, R, ac, A, bv, cv, fv, japply, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dpt

extern "C" int dpt_structured_fused_f32(const float* x, const uint8_t* mask, float* y,
                                        int nx, int ny, int nz, const double* rule,
                                        int q, int akind, double a_const,
                                        const float* A, const float* b, const float* c,
                                        const float* f, int japply, void* stream) {
  return dpt::launch<float>(x, mask, y, nx, ny, nz, rule, q, akind, a_const, A, b, c,
                            f, japply, stream);
}

extern "C" int dpt_structured_fused_f64(const double* x, const uint8_t* mask, double* y,
                                        int nx, int ny, int nz, const double* rule,
                                        int q, int akind, double a_const,
                                        const double* A, const double* b, const double* c,
                                        const double* f, int japply, void* stream) {
  return dpt::launch<double>(x, mask, y, nx, ny, nz, rule, q, akind, a_const, A, b,
                             c, f, japply, stream);
}
