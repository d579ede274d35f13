// stencil27: masked k = 1 27-tap lattice stencil, y = mask ? z : S(z * !mask).
//
// Replaces the TPU kernels dune_pdelab_tpu/assembly/stencil_pallas_tile.py:65
// (build_tiled_stencil_apply, K2a) and stencil_pallas.py:63
// (build_flat_stencil_apply, K2b): the same function, with the wrapper's two
// Dirichlet `where`s fused in (mask as a uint8 pointer, or null for none).
//
// Bound on the H100: device-memory bytes. A point needs one read of z and
// of the mask and one write of y (9 B in fp32: 0.361 ms at 512^3 DOFs and
// 3.35 TB/s) against 27 FMAs (0.108 ms at 67 TFLOP/s). Measured, the kernel
// reaches about 43% of that bound and is limited by the rate at which its
// warps dispatch instructions: the 27 FMAs per point are most of them, so
// every added copy, shuffle or select per point shows in its time (PERF.md).
//
// Design. A block owns a (32 XP) x 8 tile of the (x, y) plane and marches
// it along a chunk of z planes; a thread owns XP consecutive x points of a
// row. XP = 4 from 128 columns up (on nx = 128 k + 1, the multigrid
// lattices, the last tile's lane 31 takes a fifth point rather than leave a
// tile of one column); narrower grids take 2 or 1, whichever leaves fewer
// idle columns.
//  - Planes stream through a shared ring (4 stages in fp32, 3 in fp64)
//    filled by cp.async of one value per copy (4 B, 8 B in fp64, zero fill
//    off the grid), so 3 (2) planes load while one is computed, on any nx
//    (no row alignment needed). A thread copies whole halo rows (its
//    warp's and one of the two extra): a row base advanced by one plane
//    per step plus lane offsets, the x bounds fixed per thread.
//  - The mask bytes of those entries are loaded one plane ahead into
//    registers; the copying thread zeroes its constrained entries and
//    records the bytes in shared memory, where each thread finds its own
//    points' bytes as one word and loads the raw values of its constrained
//    points a plane before it stores them.
//  - Register blocking along z: once plane p has arrived, each thread reads
//    its 3 x (XP + 2) neighbourhood once (one vector load per row, the two
//    edge values by warp shuffle), forms the layer sums W[-1]*p, W[0]*p and
//    W[+1]*p of its points, completes output plane p - 1 and keeps two
//    running sums per point: at most 3 shared reads per point instead of
//    27, and one __syncthreads per plane.
//  - The z chunk is sized from the grid (launch_shape.cuh), so that small
//    multigrid levels still put several blocks on every SM.
// Each output is (W[-1]*p[z-1] + W[0]*p[z]) + W[+1]*p[z+1], every layer sum
// in fixed (dy, dx) order: no atomics, results repeat bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_shape.cuh"

namespace dpt {
namespace {

constexpr int WX = 32;                       // lanes along x
constexpr int WY = 8;                        // warps: one tile row each
constexpr int NT = WX * WY;
constexpr int HY = WY + 2;                   // tile rows with the one-point halo
constexpr int ZMIN = 4;
constexpr unsigned FULL = 0xffffffffu;

// Tile geometry for XP consecutive x points per thread: TX = 32 XP columns,
// HX = TX + 2 with the halo, shared row stride RS; halo column c sits at
// c + C0, so that the thread's XP points start XP-aligned.
template <int XP>
struct Geo {
  static constexpr int TX = WX * XP;
  static constexpr int HX = TX + 2;
  static constexpr int C0 = XP - 1;
  static constexpr int RS = TX + 8;
  static constexpr int PLANE = HY * RS;
  static constexpr int NC = XP + 1;          // copy columns per thread and row
  // a wide tile (one more column, lane 31's fifth point) still fits
  static_assert(RS % 4 == 0 && C0 + HX + 1 <= RS && HX + 1 <= NC * WX && HY <= 2 * WY,
                "tile layout");
};

template <typename T>
struct Taps {  // w[(dz+1)*9 + (dy+1)*3 + (dx+1)], in the constant bank
  T w[27];
};

template <typename T>
__device__ inline void copy_async(T* dst, const T* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(fill ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

__device__ inline void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// XP consecutive values from XP-aligned shared memory into a[1..XP].
template <int XP, typename T>
__device__ inline void load_run(const T* p, T (&a)[XP + 2]) {
  if constexpr (XP == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[1] = v.x; a[2] = v.y; a[3] = v.z; a[4] = v.w;
  } else if constexpr (XP >= 2 && sizeof(T) == 8) {
#pragma unroll
    for (int k = 0; k < XP; k += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + k);
      a[1 + k] = v.x; a[2 + k] = v.y;
    }
  } else if constexpr (XP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[1] = v.x; a[2] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < XP; ++k) a[1 + k] = p[k];
  }
}

// XP values to XP-aligned global memory.
template <int XP, typename T>
__device__ inline void store_run(T* p, const T (&v)[XP]) {
  if constexpr (XP == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (XP >= 2 && sizeof(T) == 8) {
#pragma unroll
    for (int k = 0; k < XP; k += 2)
      *reinterpret_cast<double2*>(p + k) = make_double2(v[k], v[k + 1]);
  } else if constexpr (XP == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < XP; ++k) p[k] = v[k];
  }
}

// XP mask bytes from XP-aligned shared memory, byte k at bits 8k.
template <int XP>
__device__ inline uint32_t load_bytes(const uint8_t* p) {
  if constexpr (XP == 4) return *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (XP == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *p;
}

// Each thread copies halo rows wy and wy + WY (if < HY), columns lane + 32 i:
// the addresses are a row base, advanced by one plane per step, plus lane
// offsets; the x bounds are fixed per thread.
template <typename T, int XP>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 4 : 2)
stencil27_kernel(const T* __restrict__ z, const uint8_t* __restrict__ mask,
                 T* __restrict__ y, int nx, int ny, int nz, int zch, int vec_ok,
                 int wide, Taps<T> W) {
  using G = Geo<XP>;
  constexpr int ST = sizeof(T) == 4 ? 4 : 3;  // ring depth: ST - 1 planes in flight
  __shared__ __align__(16) T ring[ST * G::PLANE];
  __shared__ __align__(16) uint8_t mbits[2 * G::PLANE];   // mask bytes of planes p, p - 1
  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int x0 = blockIdx.x * G::TX;
  const int y0 = blockIdx.y * WY;
  const int z0 = blockIdx.z * zch;
  const int z1 = (z0 + zch < nz) ? z0 + zch : nz;
  const int gy = y0 + wy;
  const int gx = x0 + lane * XP;
  const int pe = z1;                          // planes z0 - 1 .. z1 are read
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  // the last tile of a wide launch has one more column: lane 31's 5th point
  const bool fifth = XP == 4 && wide && blockIdx.x == gridDim.x - 1 && lane == WX - 1;
  const int hx = G::HX + ((XP == 4 && wide && blockIdx.x == gridDim.x - 1) ? 1 : 0);
  unsigned xin = 0;                           // copy column i lies in the grid
#pragma unroll
  for (int i = 0; i < G::NC; ++i) {
    const int c = lane + WX * i;
    if (c < hx && x0 - 1 + c >= 0 && x0 - 1 + c < nx) xin |= 1u << i;
  }
  int64_t rowoff[2];                          // flat index of column 0 of each copy row in plane 0
  bool rowin[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ry = y0 - 1 + wy + WY * k;
    rowin[k] = wy + WY * k < HY && ry >= 0 && ry < ny;
    rowoff[k] = static_cast<int64_t>(ry) * nx + x0 - 1;
  }
  auto copy_plane = [&](int p, int stage) {
    T* st = ring + stage * G::PLANE;
    const bool pin = p >= 0 && p < nz;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (wy + WY * k < HY) {
        const bool in_row = pin && rowin[k];
        const T* src = z + (in_row ? p * plane + rowoff[k] : 0);
        T* dst = st + (wy + WY * k) * G::RS + G::C0;
#pragma unroll
        for (int i = 0; i < G::NC; ++i) {
          const int c = lane + WX * i;
          if (c < hx) {
            const bool in = in_row && ((xin >> i) & 1u);
            copy_async(dst + c, in ? src + c : z, in);
          }
        }
      }
    }
  };
  uint32_t m[2][G::NC];                       // mask bytes of the next plane's copies
  auto load_mask = [&](int p) {
    const bool pin = p >= 0 && p < nz;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool in_row = pin && rowin[k];
      const uint8_t* src = mask + (in_row ? p * plane + rowoff[k] : 0);
#pragma unroll
      for (int i = 0; i < G::NC; ++i) {
        const int c = lane + WX * i;
        m[k][i] = (in_row && c < hx && ((xin >> i) & 1u)) ? src[c] : 0u;
      }
    }
  };

#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    if (z0 - 1 + k <= pe) copy_plane(z0 - 1 + k, k);
    commit_copies();
  }
  if (mask != nullptr) load_mask(z0 - 1);

  T s0[XP], s1[XP];   // running sums of output planes p + 1 and p
  T craw[XP];         // plane p - 1 at this thread's constrained points, as loaded
  uint32_t cmask = 0; // mask bytes of this thread's points in plane p - 1
#pragma unroll
  for (int k = 0; k < XP; ++k) s0[k] = s1[k] = craw[k] = T(0);
  T f0 = T(0), f1 = T(0), fraw = T(0);        // the same for a fifth point
  uint32_t fmask = 0;

  int stage = 0;
  for (int p = z0 - 1; p <= pe; ++p) {
    T* st = ring + stage * G::PLANE;
    uint8_t* mb = mbits + (p & 1) * G::PLANE;
    wait_copies<ST - 2>();                    // this thread's copies of plane p
    if (mask != nullptr) {                    // zero its constrained entries
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (wy + WY * k < HY) {
          const int r0 = (wy + WY * k) * G::RS + G::C0;
#pragma unroll
          for (int i = 0; i < G::NC; ++i) {
            const int c = lane + WX * i;
            if (c < hx) {
              mb[r0 + c] = static_cast<uint8_t>(m[k][i]);
              if (m[k][i]) st[r0 + c] = T(0);
            }
          }
        }
      }
    }
    __syncthreads();                          // plane p visible; plane p - 1 done
    const int refill = (stage + ST - 1) % ST;
    if (p + ST - 1 <= pe) copy_plane(p + ST - 1, refill);
    commit_copies();
    const int own = (wy + 1) * G::RS + G::C0 + 1 + lane * XP;   // this thread's first point
    uint32_t pmask = 0, pfifth = 0;           // this thread's points in plane p
    T praw[XP] = {}, prawf = T(0);
    if (mask != nullptr) {
      if (p + 1 <= pe) load_mask(p + 1);
      pmask = load_bytes<XP>(mb + own);
      if (fifth) pfifth = mb[own + XP];
      if (pmask != 0u || pfifth != 0u) {      // their raw values, a plane early
        const T* zr = z + p * plane + static_cast<int64_t>(gy) * nx + gx;
#pragma unroll
        for (int k = 0; k < XP; ++k)
          if ((pmask >> (8 * k)) & 0xffu) praw[k] = zr[k];
        if (pfifth) prawf = zr[XP];
      }
    }

    // layer sums t[L] = W[L - 1] * plane p at this thread's XP points (tf:
    // the fifth point)
    T t[3][XP], tf[3] = {};
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const T* row = st + own + (dr - 1) * G::RS;
      T a[XP + 2];
      load_run<XP>(row, a);
      T left = __shfl_up_sync(FULL, a[XP], 1);
      T right = __shfl_down_sync(FULL, a[1], 1);
      if (lane == 0) left = row[-1];
      if (lane == WX - 1) right = row[XP];
      a[0] = left;
      a[XP + 1] = right;
#pragma unroll
      for (int L = 0; L < 3; ++L) {
#pragma unroll
        for (int k = 0; k < XP; ++k) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const T wt = W.w[L * 9 + dr * 3 + dx];
            t[L][k] = (dr == 0 && dx == 0) ? wt * a[k] : t[L][k] + wt * a[k + dx];
          }
        }
      }
      if (fifth) {
        const T a6 = row[XP + 1];
#pragma unroll
        for (int L = 0; L < 3; ++L)
          tf[L] = (dr == 0 ? T(0) : tf[L]) + W.w[L * 9 + dr * 3] * a[XP] +
                  W.w[L * 9 + dr * 3 + 1] * a[XP + 1] + W.w[L * 9 + dr * 3 + 2] * a6;
      }
    }

    if (p > z0 && gy < ny) {                  // output plane p - 1 is complete
      T v[XP];
#pragma unroll
      for (int k = 0; k < XP; ++k)
        v[k] = ((cmask >> (8 * k)) & 0xffu) ? craw[k] : s1[k] + t[2][k];
      const int64_t i0 = (p - 1) * plane + static_cast<int64_t>(gy) * nx + gx;
      if (vec_ok && gx + XP <= nx && (i0 % XP) == 0) {
        store_run<XP>(y + i0, v);
      } else {
#pragma unroll
        for (int k = 0; k < XP; ++k)
          if (gx + k < nx) y[i0 + k] = v[k];
      }
      if (fifth) y[i0 + XP] = fmask ? fraw : f1 + tf[2];
    }
    if (fifth) {
      f1 = f0 + tf[1];
      f0 = tf[0];
      fraw = prawf;
      fmask = pfifth;
    }
#pragma unroll
    for (int k = 0; k < XP; ++k) {
      s1[k] = s0[k] + t[1][k];
      s0[k] = t[0][k];
      craw[k] = praw[k];
    }
    cmask = pmask;
    stage = (stage + 1) % ST;
  }
  wait_copies<0>();
}

template <typename T, int XP>
int launch_xp(const T* z, const uint8_t* mask, T* y, int nx, int ny, int nz, int wide,
              const Taps<T>& W, cudaStream_t stream) {
  static const int slots = resident_blocks(stencil27_kernel<T, XP>, NT);
  const int bx = cdiv(nx - wide, Geo<XP>::TX);
  const int by = cdiv(ny, WY);
  const int zch = z_chunk(slots, bx * by, nz, ZMIN);
  // vector stores need y aligned to a run of XP values
  const int vec_ok = reinterpret_cast<uintptr_t>(y) % (XP * sizeof(T)) == 0;
  stencil27_kernel<T, XP><<<dim3(bx, by, cdiv(nz, zch)), dim3(WX, WY), 0, stream>>>(
      z, mask, y, nx, ny, nz, zch, vec_ok, wide, W);
  return static_cast<int>(cudaGetLastError());
}

// Points per thread. Runs of 4 cost the least per point on large grids
// (fewest halo copies, shared reads and steps per point), so every grid of
// 128 columns and more takes them, and nx = 128 k + 1 (the multigrid
// lattices) lets its last tile's lane 31 take a fifth point instead of a
// tile of one column. Narrower grids take the run whose tiles leave the
// fewest idle columns (a run of 1 counted at 1.2 times: more reads per
// point).
inline int points_per_thread(int nx) {
  if (nx >= 128) return 4;
  const int c4 = 5 * cdiv(nx, 128) * 128, c2 = 5 * cdiv(nx, 64) * 64,
            c1 = 6 * cdiv(nx, 32) * 32;
  if (c4 <= c2 && c4 <= c1) return 4;
  return c2 <= c1 ? 2 : 1;
}

template <typename T>
int launch(const T* z, const uint8_t* mask, T* y, int nx, int ny, int nz,
           const double* w, void* stream) {
  Taps<T> W;
  for (int i = 0; i < 27; ++i) W.w[i] = static_cast<T>(w[i]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (points_per_thread(nx)) {
    case 4: return launch_xp<T, 4>(z, mask, y, nx, ny, nz, nx > 128 && nx % 128 == 1, W, s);
    case 2: return launch_xp<T, 2>(z, mask, y, nx, ny, nz, 0, W, s);
    default: return launch_xp<T, 1>(z, mask, y, nx, ny, nz, 0, W, s);
  }
}

}  // namespace
}  // namespace dpt

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
