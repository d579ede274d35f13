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
// Neighbours outside the grid contribute nothing: they are read as 0.
//
// Replaces the TPU kernels dune_pdelab_tpu/assembly/blockstencil_mm.py
// build_mm_block_apply (K5a, :151), build_mm_flat_apply (K5b, :329, the
// `mxu2` production mode) and build_mm_vreg_apply (K5c, :492), which apply
// it in the mode-major layout (nz, nb, ny, nx), and
// dune_pdelab_tpu/assembly/blockstencil_pallas.py build_block_stencil_apply
// (K6, :112), which applies it element-major (e*nb + j). DOF (x, y, z, mode
// b) sits at x*sx + y*sy + z*sz + b*sb. The TPU kernels' lane and sublane
// gates, the divisor-of-nz plane blocking, VMEM sizing and K6's correction
// for rows that cross a z-slab (an effect of its lane-roll layout) have no
// counterpart.
//
// Bound on the H100: device-memory bytes (z read and y written once, 8 B per
// DOF in fp32) against 7*nb multiply-adds per DOF. What limits the kernels is
// instruction issue and the memory pipeline, not bytes: a first version
// loaded every weight with a uniform global load per FMA (7*nb^2 load
// instructions per element), and without FMAs the element-major data
// movement alone takes ~70% of the final kernel's time (PERF.md). Two paths,
// chosen by the wrapper from (dtype, nb):
//
//  * parameter path (nb in {4, 8, 9}, fixed at compile time): the 13 weight
//    blocks (13*nb^2 values, at most 8,424 B for nb = 9 in fp64) travel in a
//    __grid_constant__ kernel parameter, so no weight is loaded from global
//    memory: the compiler moves them into uniform registers, FMA operands
//    (parameters above 4 KB need CUDA >= 12.1 on sm_90: 32,764 B).
//    - mode-major (K5): one thread per element, consecutive threads on
//      consecutive x (every load and store coalesced), each thread marching
//      along z with the planes z-1, z, z+1 of its element in registers; the
//      next plane's values (its z+2 column, x/y neighbours at z+1) are loaded
//      before this plane's FMAs, so the loads run while the FMAs issue.
//    - element-major (K6): an element's nb values are contiguous, so direct
//      per-thread loads would be strided by nb. A block of up to 128 threads
//      takes as many consecutive elements of a row and marches along y; each
//      row of the tile plus its x halo is copied into shared memory by
//      16-byte cp.async (scalar copies at the row's unaligned ends), one row
//      ahead, in a ring of 4 rows (in 3D also the rows at z-1 and z+1,
//      double-buffered). Each thread reads its values at stride nb (odd nb
//      is free of bank conflicts, nb*sizeof(T) % 16 == 0 reads 16 B at a
//      time), and the outputs go back through shared memory as 16-byte
//      coalesced stores.
//  * shared path (any other nb; nb = 27 is Q2 in 3D): one thread per
//    element (consecutive threads on consecutive elements of a z-plane, a
//    few loads of z in flight), any strides, the outputs in chunks of CH accumulators (CH = 28
//    for nb = 27, else 8). For each chunk the block stages the weights of
//    its CH outputs from the device tensors into shared memory as rows
//    [tap][b] of CH values, so that a thread reads them 16 B at a time as
//    broadcasts; `rows` rows at a time (all 13*nb where they fit, which the
//    wrapper decides), so any nb runs in a bounded amount of shared memory.
//
// Sums run in a fixed order on every path (taps in the order above, then the
// dD sides x-, x+, y-, y+, z-, z+ on the face elements only; the mode b
// innermost) with fused multiply-adds and no atomics, so a result repeats
// bit for bit from run to run. A neighbour off the grid is read as 0 under a
// predicate rather than skipped by a branch, which changes no sum beyond the
// sign of a zero.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "launch_shape.cuh"

#if CUDART_VERSION < 12010
#error "blockstencil.cu passes up to 8,424 B of kernel parameters: CUDA >= 12.1 needed"
#endif

namespace dpt {
namespace {

constexpr int PATH_PARAM = 0;
constexpr int PATH_SHARED = 1;
constexpr int MM_WX = 32;          // mode-major block: 32 x values by 4 rows
constexpr int MM_WY = 4;
constexpr int EM_TX = 128;         // element-major block: up to 128 elements of a row
constexpr int SH_THREADS = 128;    // shared path
constexpr int SH_LOADS = 4;        // shared path: loads of z in flight per thread
constexpr int SMEM_MAX = 232448;   // shared memory one block may use on the H100

struct Lattice {
  int nx, ny, nz, dim;
  int64_t sx, sy, sz, sb;
};

// The 13 weight blocks: W_0..W_6 (taps), then dD x-, x+, y-, y+, z-, z+; each
// row-major [a][b].
template <typename T, int NB>
struct Taps {
  T w[13 * NB * NB];
};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// acc[a] += sum_b W_t[a][b] v[b], b innermost; weights from the parameter bank.
template <int t, typename T, int NB>
__device__ __forceinline__ void tap(T (&acc)[NB], const Taps<T, NB>& tp, const T (&v)[NB]) {
#pragma unroll
  for (int a = 0; a < NB; ++a) {
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a] = fma_rn(tp.w[(t * NB + a) * NB + b], v[b], acc[a]);
  }
}

// nb values at stride sb, or zeros off the grid.
template <typename T, int NB>
__device__ __forceinline__ void load_modes(T (&v)[NB], const T* p, int64_t sb, bool in) {
#pragma unroll
  for (int b = 0; b < NB; ++b) v[b] = in ? __ldg(p + b * sb) : T(0);
}

template <typename T, int NB>
__device__ __forceinline__ void copy_modes(T (&d)[NB], const T (&s)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) d[b] = s[b];
}

// ---------------------------------------------------------------- mode-major

// One thread per element, marching along z; the next plane's values are
// loaded before this plane's FMAs.
// Four blocks per SM in fp32 (118 registers for nb = 8); fp64 keeps more
// registers instead (128 spill).
template <typename T, int NB>
__global__ void __launch_bounds__(MM_WX * MM_WY, sizeof(T) == 4 ? 4 : 2)
bs_mm(const T* __restrict__ z, T* __restrict__ y, const Lattice g, const int zch,
      const __grid_constant__ Taps<T, NB> tp) {
  const int x = blockIdx.x * MM_WX + threadIdx.x;
  const int yy = blockIdx.y * MM_WY + threadIdx.y;
  const int z0 = blockIdx.z * zch;
  if (x >= g.nx || yy >= g.ny) return;
  const int z1 = min(z0 + zch, g.nz);
  const bool hx0 = x > 0, hx1 = x + 1 < g.nx, hy0 = yy > 0, hy1 = yy + 1 < g.ny;
  const T* col = z + x * g.sx + yy * g.sy;
  // own column at z-1, z, z+1 and the x/y neighbours at z, for the plane z
  T vm[NB], v0[NB], vp[NB], xm[NB], xp[NB], ym[NB], yp[NB];
  {
    const T* c = col + (int64_t)z0 * g.sz;
    load_modes(vm, c - g.sz, g.sb, z0 > 0);
    load_modes(v0, c, g.sb, true);
    load_modes(vp, c + g.sz, g.sb, z0 + 1 < g.nz);
    load_modes(xm, c - g.sx, g.sb, hx0);
    load_modes(xp, c + g.sx, g.sb, hx1);
    load_modes(ym, c - g.sy, g.sb, hy0);
    load_modes(yp, c + g.sy, g.sb, hy1);
  }
#pragma unroll 1
  for (int zz = z0; zz < z1; ++zz) {
    const T* cn = col + (int64_t)(zz + 1) * g.sz;   // the next plane
    const bool more = zz + 1 < z1;
    T vq[NB], nxm[NB], nxp[NB], nym[NB], nyp[NB];
    load_modes(vq, cn + g.sz, g.sb, more && zz + 2 < g.nz);
    load_modes(nxm, cn - g.sx, g.sb, more && hx0);
    load_modes(nxp, cn + g.sx, g.sb, more && hx1);
    load_modes(nym, cn - g.sy, g.sb, more && hy0);
    load_modes(nyp, cn + g.sy, g.sb, more && hy1);
    T acc[NB];
#pragma unroll
    for (int a = 0; a < NB; ++a) acc[a] = T(0);
    tap<0>(acc, tp, v0);
    tap<1>(acc, tp, xm);
    tap<2>(acc, tp, xp);
    tap<3>(acc, tp, ym);
    tap<4>(acc, tp, yp);
    tap<5>(acc, tp, vm);
    tap<6>(acc, tp, vp);
    if (!hx0) tap<7>(acc, tp, v0);
    if (!hx1) tap<8>(acc, tp, v0);
    if (!hy0) tap<9>(acc, tp, v0);
    if (!hy1) tap<10>(acc, tp, v0);
    if (zz == 0) tap<11>(acc, tp, v0);
    if (zz + 1 == g.nz) tap<12>(acc, tp, v0);
    T* out = y + (col - z) + (int64_t)zz * g.sz;
#pragma unroll
    for (int a = 0; a < NB; ++a) out[a * g.sb] = acc[a];
    copy_modes(vm, v0);
    copy_modes(v0, vp);
    copy_modes(vp, vq);
    copy_modes(xm, nxm);
    copy_modes(xp, nxp);
    copy_modes(ym, nym);
    copy_modes(yp, nyp);
  }
}

// ------------------------------------------------------------- element-major

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

template <typename T>
__device__ __forceinline__ void copy1(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Word w mod VW, for w >= or < 0.
template <typename T>
__device__ __forceinline__ int word_shift(int64_t w) {
  constexpr int VW = Vec<T>::n;
  return static_cast<int>(((w % VW) + VW) % VW);
}

// First word of element-row (yy, zr) (x = 0).
__device__ __forceinline__ int64_t row_word(const Lattice& g, int yy, int zr, int nb) {
  return ((int64_t)zr * g.ny + yy) * g.nx * nb;
}

// Copy elements x0-1 .. x0+TX of row (yy, zr) into buf, slot s = x - x0 + 1
// at buf[shift + s*NB], shift = (word of slot 0) mod VW so that 16-byte
// chunks of z land on 16-byte chunks of buf. Slots off the grid (and whole
// rows off the grid) are zero.
template <typename T, int NB>
__device__ __forceinline__ void stage_row(T* buf, const T* __restrict__ z, const Lattice& g,
                                          int x0, int tx, int yy, int zr, int rw) {
  constexpr int VW = Vec<T>::n;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (yy < 0 || yy >= g.ny || zr < 0 || zr >= g.nz) {
    for (int i = tid; i < rw; i += nt) buf[i] = T(0);
    return;
  }
  const int64_t ref = row_word(g, yy, zr, NB) + (int64_t)(x0 - 1) * NB;
  const int shift = word_shift<T>(ref);
  const int s_lo = max(x0 - 1, 0) - x0 + 1;         // slots [s_lo, s_hi) lie in the grid
  const int s_hi = min(x0 + tx + 1, g.nx) - x0 + 1;
  for (int i = tid; i < s_lo * NB; i += nt) buf[shift + i] = T(0);
  for (int i = s_hi * NB + tid; i < (tx + 2) * NB; i += nt) buf[shift + i] = T(0);
  // global word w of the row goes to buf[w - ref + shift]
  const int64_t w0 = ref + s_lo * NB, w1 = ref + s_hi * NB;
  for (int64_t c = w0 - word_shift<T>(w0) + (int64_t)tid * VW; c < w1; c += (int64_t)nt * VW) {
    T* dst = buf + static_cast<int>(c - ref + shift);
    if (c >= w0 && c + VW <= w1) {
      copy16(dst, z + c);
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j)
        if (c + j >= w0 && c + j < w1) copy1(dst + j, z + c + j);
    }
  }
}

template <typename T, int NB>
__device__ __forceinline__ void read_modes(T (&v)[NB], const T* p) {
  if constexpr ((NB * sizeof(T)) % 16 == 0) {
    using V = typename Vec<T>::type;
    constexpr int VW = Vec<T>::n;
#pragma unroll
    for (int i = 0; i < NB / VW; ++i) {
      const V q = reinterpret_cast<const V*>(p)[i];
      if constexpr (VW == 4) {
        v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
      } else {
        v[2 * i] = q.x; v[2 * i + 1] = q.y;
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b] = p[b];
  }
}

template <typename T, int NB>
__device__ __forceinline__ void write_modes(T* p, const T (&v)[NB]) {
  if constexpr ((NB * sizeof(T)) % 16 == 0) {
    using V = typename Vec<T>::type;
    constexpr int VW = Vec<T>::n;
#pragma unroll
    for (int i = 0; i < NB / VW; ++i) {
      V q;
      if constexpr (VW == 4) {
        q.x = v[4 * i]; q.y = v[4 * i + 1]; q.z = v[4 * i + 2]; q.w = v[4 * i + 3];
      } else {
        q.x = v[2 * i]; q.y = v[2 * i + 1];
      }
      reinterpret_cast<V*>(p)[i] = q;
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) p[b] = v[b];
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(EM_TX)
bs_em(const T* __restrict__ z, T* __restrict__ y, const Lattice g, const int ych,
      const int rw, const __grid_constant__ Taps<T, NB> tp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VW = Vec<T>::n;
  T* ring = reinterpret_cast<T*>(smem_raw);   // rows y-1, y, y+1, y+2 (by k % 4)
  const bool three = g.dim == 3;
  T* side = ring + 4 * rw;                      // 3D: (z-1, z+1) rows, two stages
  T* obuf = side + (three ? 4 * rw : 0);        // outputs of the row
  const int tx = blockDim.x, tid = threadIdx.x;
  const int x0 = blockIdx.x * tx;
  const int y0 = blockIdx.y * ych;
  const int y1 = min(y0 + ych, g.ny);
  const int zz = blockIdx.z;
  const int x = x0 + tid;
  const int s = tid + 1;                        // the element's slot in a staged row

  stage_row<T, NB>(ring, z, g, x0, tx, y0 - 1, zz, rw);
  stage_row<T, NB>(ring + rw, z, g, x0, tx, y0, zz, rw);
  stage_row<T, NB>(ring + 2 * rw, z, g, x0, tx, y0 + 1, zz, rw);
  if (three) {
    stage_row<T, NB>(side, z, g, x0, tx, y0, zz - 1, rw);
    stage_row<T, NB>(side + rw, z, g, x0, tx, y0, zz + 1, rw);
  }
  commit_copies();
#pragma unroll 1
  for (int yy = y0, k = 0; yy < y1; ++yy, ++k) {
    if (yy + 1 < y1) {
      stage_row<T, NB>(ring + ((k + 3) & 3) * rw, z, g, x0, tx, yy + 2, zz, rw);
      if (three) {
        T* sn = side + ((k + 1) & 1) * 2 * rw;
        stage_row<T, NB>(sn, z, g, x0, tx, yy + 1, zz - 1, rw);
        stage_row<T, NB>(sn + rw, z, g, x0, tx, yy + 1, zz + 1, rw);
      }
    }
    commit_copies();
    wait_all_but_newest();
    __syncthreads();
    const int64_t orow = row_word(g, yy, zz, NB) + (int64_t)x0 * NB;   // word of output slot 0
    const int osh = word_shift<T>(orow);
    if (x < g.nx) {
      const int64_t r0 = row_word(g, yy, zz, NB) + (int64_t)(x0 - 1) * NB;
      const int64_t plane = (int64_t)g.ny * g.nx * NB;
      const T* rc = ring + ((k + 1) & 3) * rw + word_shift<T>(r0) + s * NB;
      T acc[NB], v0[NB];
#pragma unroll
      for (int a = 0; a < NB; ++a) acc[a] = T(0);
      read_modes(v0, rc);
      tap<0>(acc, tp, v0);
#define DPT_TAP(t, p)        \
      {                      \
        T v[NB];             \
        read_modes(v, p);    \
        tap<t>(acc, tp, v);  \
      }
      DPT_TAP(1, rc - NB)
      DPT_TAP(2, rc + NB)
      DPT_TAP(3, ring + (k & 3) * rw + word_shift<T>(r0 - (int64_t)g.nx * NB) + s * NB)
      DPT_TAP(4, ring + ((k + 2) & 3) * rw + word_shift<T>(r0 + (int64_t)g.nx * NB) + s * NB)
      if (three) {
        const T* sc = side + (k & 1) * 2 * rw;
        DPT_TAP(5, sc + word_shift<T>(r0 - plane) + s * NB)
        DPT_TAP(6, sc + rw + word_shift<T>(r0 + plane) + s * NB)
      }
#undef DPT_TAP
      if (x == 0) tap<7>(acc, tp, v0);
      if (x + 1 == g.nx) tap<8>(acc, tp, v0);
      if (yy == 0) tap<9>(acc, tp, v0);
      if (yy + 1 == g.ny) tap<10>(acc, tp, v0);
      if (three && zz == 0) tap<11>(acc, tp, v0);
      if (three && zz + 1 == g.nz) tap<12>(acc, tp, v0);
      write_modes(obuf + osh + tid * NB, acc);
    }
    __syncthreads();
    // the row's outputs, words [orow, orow + n) of y, in 16-byte stores
    // (global word w of the row sits at obuf[w - orow + osh])
    const int64_t n = (int64_t)(min(x0 + tx, g.nx) - x0) * NB;
    for (int64_t c = orow - osh + (int64_t)tid * VW; c < orow + n; c += (int64_t)tx * VW) {
      const T* src = obuf + static_cast<int>(c - orow + osh);
      if (c >= orow && c + VW <= orow + n) {
        using V = typename Vec<T>::type;
        *reinterpret_cast<V*>(y + c) = *reinterpret_cast<const V*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j)
          if (c + j >= orow && c + j < orow + n) y[c + j] = src[j];
      }
    }
    // the next row's copies overwrite the ring slot of this row's y-1 and
    // the side rows of the previous row: every read of them is above the
    // barrier; obuf is written again only after the next barrier
  }
}

// ------------------------------------------------------------- shared path

// Tap t's neighbour offset, and whether it lies in the grid (t = 0: the
// element itself).
__device__ __forceinline__ bool neighbour(const Lattice& g, int t, int x, int yy, int zz,
                                          int64_t* off) {
  if (t == 0) {
    *off = 0;
    return true;
  }
  const int ax = (t - 1) >> 1;
  const int64_t st = ax == 0 ? g.sx : (ax == 1 ? g.sy : g.sz);
  const int c = ax == 0 ? x : (ax == 1 ? yy : zz);
  const int n = ax == 0 ? g.nx : (ax == 1 ? g.ny : g.nz);
  *off = (t & 1) ? -st : st;
  return (t & 1) ? c > 0 : c + 1 < n;
}

// Whether the element lies on boundary side `side` (x-, x+, y-, y+, z-, z+).
__device__ __forceinline__ bool on_side(const Lattice& g, int side, int x, int yy, int zz) {
  const int d = side >> 1;
  if (d >= g.dim) return false;
  const int c = d == 0 ? x : (d == 1 ? yy : zz);
  const int n = d == 0 ? g.nx : (d == 1 ? g.ny : g.nz);
  return (side & 1) ? c + 1 == n : c == 0;
}

// acc[c] += wr[c] * v for the CH outputs of a pass, 16 B of weights at a time.
template <typename T, int CH>
__device__ __forceinline__ void fma_row(T (&acc)[CH], const T* wrow, T v) {
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::n;
  const V* wr = reinterpret_cast<const V*>(wrow);
#pragma unroll
  for (int c = 0; c < CH / VW; ++c) {
    const V q = wr[c];
    if constexpr (VW == 4) {
      acc[4 * c] = fma_rn(q.x, v, acc[4 * c]);
      acc[4 * c + 1] = fma_rn(q.y, v, acc[4 * c + 1]);
      acc[4 * c + 2] = fma_rn(q.z, v, acc[4 * c + 2]);
      acc[4 * c + 3] = fma_rn(q.w, v, acc[4 * c + 3]);
    } else {
      acc[2 * c] = fma_rn(q.x, v, acc[2 * c]);
      acc[2 * c + 1] = fma_rn(q.y, v, acc[2 * c + 1]);
    }
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(SH_THREADS)
bs_shared(const T* __restrict__ z, const T* __restrict__ W, const T* __restrict__ dD,
          T* __restrict__ y, const Lattice g, const int nb, const int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(CH % Vec<T>::n == 0, "chunk of whole 16-byte vectors");
  // Weight row r = t*nb + b of the chunk a0 .. a0+CH-1 (block t: W_0..W_6,
  // then dD x-, x+, y-, y+, z-, z+) holds block t (a0 + c, b) for c < CH;
  // `rows` rows at a time sit in ws[(r - r0)*CH + c].
  T* ws = reinterpret_cast<T*>(smem_raw);
  const int64_t nb2 = (int64_t)nb * nb;
  const int nrow = 13 * nb;
  // consecutive threads on consecutive elements of a z-plane
  const int64_t exy = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = exy < (int64_t)g.nx * g.ny;   // every thread stages and syncs
  const int x = static_cast<int>(exy % g.nx), yy = static_cast<int>(exy / g.nx);
  const int zz = blockIdx.y;
  const int64_t e = (int64_t)x * g.sx + yy * g.sy + (int64_t)zz * g.sz;
  const int ntap = g.dim == 3 ? 7 : 5;
#pragma unroll 1
  for (int a0 = 0; a0 < nb; a0 += CH) {
    T acc[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = T(0);
#pragma unroll 1
    for (int r0 = 0; r0 < nrow; r0 += rows) {
      const int r1 = min(r0 + rows, nrow);
      __syncthreads();                         // the previous rows are read
      for (int i = threadIdx.x; i < (r1 - r0) * CH; i += blockDim.x) {
        const int c = i % CH, r = r0 + i / CH, t = r / nb, b = r % nb, a = a0 + c;
        const int64_t ab = (int64_t)a * nb + b;
        ws[i] = a >= nb ? T(0) : (t < 7 ? W[t * nb2 + ab] : dD[(t - 7) * nb2 + ab]);
      }
      __syncthreads();
      if (!live) continue;
#pragma unroll 1
      for (int t = r0 / nb; t * nb < r1; ++t) {
        int64_t off = 0;
        bool ok = true;
        if (t < 7) {
          if (t >= ntap) continue;                      // no z taps in 2D
          ok = neighbour(g, t, x, yy, zz, &off);
        } else if (!on_side(g, t - 7, x, yy, zz)) {
          continue;                                     // sides on face elements only
        }
        const T* p = z + e + off;
        const int b1 = min(nb, r1 - t * nb);
        int b = max(0, r0 - t * nb);
        // SH_LOADS values of z in flight, then their FMAs in the order of b
#pragma unroll 1
        for (; b + SH_LOADS <= b1; b += SH_LOADS) {
          T v[SH_LOADS];
#pragma unroll
          for (int u = 0; u < SH_LOADS; ++u) v[u] = ok ? __ldg(p + (b + u) * g.sb) : T(0);
#pragma unroll
          for (int u = 0; u < SH_LOADS; ++u)
            fma_row<T, CH>(acc, ws + (t * nb + b + u - r0) * CH, v[u]);
        }
#pragma unroll 1
        for (; b < b1; ++b)
          fma_row<T, CH>(acc, ws + (t * nb + b - r0) * CH, ok ? __ldg(p + b * g.sb) : T(0));
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (a0 + c < nb) y[e + (a0 + c) * g.sb] = acc[c];
    }
  }
}

// ------------------------------------------------------------------ launch

// Raise the dynamic shared memory limit of `kernel` to `bytes` (the static
// shared memory of the kernel comes on top).
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Chunk length along the marched axis n: about two rounds of resident
// blocks over the card, at least `least` rows per chunk where n allows.
inline int march_chunk(int slots, int64_t blocks_across, int n, int least) {
  int64_t chunks = (2 * (int64_t)slots + blocks_across - 1) / blocks_across;
  const int most = cdiv(n, least);
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  return cdiv(n, static_cast<int>(chunks));
}

template <typename T, int NB>
int launch_mm(const T* z, T* y, const Lattice& g, const Taps<T, NB>& tp, cudaStream_t s) {
  static const int slots = resident_blocks(bs_mm<T, NB>, MM_WX * MM_WY);
  const int bx = cdiv(g.nx, MM_WX), by = cdiv(g.ny, MM_WY);
  const int zch = march_chunk(slots, (int64_t)bx * by, g.nz, 2);
  const dim3 grid(bx, by, cdiv(g.nz, zch));
  bs_mm<T, NB><<<grid, dim3(MM_WX, MM_WY), 0, s>>>(z, y, g, zch, tp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB>
int launch_em(const T* z, T* y, const Lattice& g, const Taps<T, NB>& tp, cudaStream_t s) {
  constexpr int VW = Vec<T>::n;
  const int tx = g.nx >= EM_TX ? EM_TX : cdiv(g.nx, 32) * 32;
  const int rw = cdiv((tx + 2) * NB + VW - 1, VW) * VW;
  const size_t smem = sizeof(T) * ((size_t)(g.dim == 3 ? 8 : 4) * rw + (size_t)tx * NB + VW);
  const int rc = allow_smem(bs_em<T, NB>, smem);
  if (rc != 0) return rc;
  // resident blocks by block width (32, 64, 96, 128 threads) and dimension
  static int slots[EM_TX / 32][2] = {};
  int& sl = slots[tx / 32 - 1][g.dim == 3];
  if (sl == 0) sl = resident_blocks(bs_em<T, NB>, tx, smem);
  const int bx = cdiv(g.nx, tx);
  const int ych = march_chunk(sl, (int64_t)bx * g.nz, g.ny, 1);
  const dim3 grid(bx, cdiv(g.ny, ych), g.nz);
  bs_em<T, NB><<<grid, tx, smem, s>>>(z, y, g, ych, rw, tp);
  return static_cast<int>(cudaGetLastError());
}

// The parameter path takes the mode-major and the element-major layout only.
template <typename T, int NB>
int launch_param(const T* z, T* y, const Lattice& g, const void* packed, cudaStream_t s) {
  Taps<T, NB> tp;
  std::memcpy(&tp, packed, sizeof(tp));
  if (g.sx == 1 && g.sy == g.nx && g.sb == (int64_t)g.nx * g.ny &&
      g.sz == (int64_t)NB * g.nx * g.ny && g.dim == 3) {
    return launch_mm<T, NB>(z, y, g, tp, s);
  }
  if (g.sb == 1 && g.sx == NB && g.sy == (int64_t)NB * g.nx &&
      g.sz == (int64_t)NB * g.nx * g.ny) {
    return launch_em<T, NB>(z, y, g, tp, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int CH>
int launch_shared(const T* z, const T* W, const T* dD, T* y, const Lattice& g, int nb,
                  int rows, cudaStream_t s) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * CH * (size_t)rows;
  const int rc = allow_smem(bs_shared<T, CH>, smem);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>(((int64_t)g.nx * g.ny + SH_THREADS - 1) / SH_THREADS),
                  g.nz);
  bs_shared<T, CH><<<grid, SH_THREADS, smem, s>>>(z, W, dD, y, g, nb, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* z, const T* W, const T* dD, T* y, int nx, int ny, int nz, int nb,
           int dim, long long sx, long long sy, long long sz, long long sb,
           const void* packed, int path, int ch, int rows, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nb < 1 || ny > 65535 || nz > 65535 ||
      (dim != 2 && dim != 3) || (dim == 2 && nz != 1)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Lattice g{nx, ny, nz, dim, sx, sy, sz, sb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == PATH_PARAM) {
    if (packed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (nb) {
      case 4: return launch_param<T, 4>(z, y, g, packed, s);
      case 8: return launch_param<T, 8>(z, y, g, packed, s);
      case 9: return launch_param<T, 9>(z, y, g, packed, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path == PATH_SHARED) {
    if (ch == 28) return launch_shared<T, 28>(z, W, dD, y, g, nb, rows, s);
    if (ch == 8) return launch_shared<T, 8>(z, W, dD, y, g, nb, rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

static_assert(sizeof(Taps<double, 9>) <= 32764 - 256, "parameter space of sm_90");

}  // namespace
}  // namespace dpt

// z, y: the DOF arrays at strides (sx, sy, sz, sb); W: (7, nb, nb) taps in the
// order (0, -x, +x, -y, +y, -z, +z) and dD: (3, 2, nb, nb) per-side
// corrections, on the device (read by the shared path); packed: the same 13
// blocks W then dD as 13*nb*nb values in host memory (read by the parameter
// path, NULL otherwise); path: 0 parameter, 1 shared; ch, rows: the shared
// path's outputs per chunk (8, or 28 for nb = 27) and weight rows staged at a
// time (at least 1, ch*rows values within the shared memory of a block).
// In 2D (dim = 2, nz = 1) the z taps and z sides are not applied.
extern "C" int dpt_blockstencil_f32(const float* z, const float* W, const float* dD,
                                    float* y, int nx, int ny, int nz, int nb, int dim,
                                    long long sx, long long sy, long long sz,
                                    long long sb, const void* packed, int path,
                                    int ch, int rows, void* stream) {
  return dpt::launch<float>(z, W, dD, y, nx, ny, nz, nb, dim, sx, sy, sz, sb, packed,
                            path, ch, rows, stream);
}

extern "C" int dpt_blockstencil_f64(const double* z, const double* W, const double* dD,
                                    double* y, int nx, int ny, int nz, int nb, int dim,
                                    long long sx, long long sy, long long sz,
                                    long long sb, const void* packed, int path,
                                    int ch, int rows, void* stream) {
  return dpt::launch<double>(z, W, dD, y, nx, ny, nz, nb, dim, sx, sy, sz, sb, packed,
                             path, ch, rows, stream);
}
