// Fused nonlinear Richtmyer shallow-water step for Hopper (sm_90a).
//
// Replaces the Pallas kernels of climatemodel_tpu/ops/pallas_stencils.py:
//   mode none (interior only)  <- _kernel / _kernel_flat via _kernel_body
//                                 (richtmyer_step_interior, K5)
//   modes bx x by (all ghosts) <- _kernel_frame / _kernel_frame_flat via
//                                 _kernel_frame_body, _store_ghost_row and
//                                 _write_ghost_lanes (richtmyer_step_frame, K6)
// One kernel, templated on the float type, on flat orography and on f and r
// given as one row; the boundary mode is a runtime argument (it only decides
// the edge writes).
//
// What it computes per interior cell, in the op order of _fused_update
// (pallas_stencils.py:57-136) and of the plain version
// (ops/stencils.richtmyer_step_interior_plain): the conservative form, both
// Richtmyer stages (half-step states at the four faces, reciprocals 1 / h
// then products for the half-step fluxes), the update, the source at
// half-time h with the exact Coriolis cancellation f * vh (h_mid only with
// orography), Rayleigh damping against the pre-step u and v, the ok freeze,
// and u^2 + v^2 for the next step's CFL statistic max2.
//
// What bounds it on this card: bytes, then instruction issue.  A step
// reads h, u, v and writes the new h, u, v (f and r are one broadcast row on
// the bench world; the flat variant reads no orography gradients): 6 field
// passes, ~50.5 MB at 2050 x 1026 f32, ~15 us at 3.35 TB/s.  The arithmetic
// is ~110 f32 operations a cell (one rounding each, no contraction: -fmad=
// false for bit-equality with the plain version), and with the shuffles,
// the division checks, the copies, the stores and the loop a warp issues
// ~230 instructions for a row of its 30 cells (SASS): ~18 us of issue on
// 132 SMs at one instruction a clock a scheduler.  So the loads must stay in
// flight while the cells are computed, and nothing may be computed twice.
//
// The design: row strips with a rolling window.
//  - A warp owns a band of 32 columns along y (the contiguous axis), lane l
//    on column 30 b + l of band b, and walks a strip of R rows along x.  The
//    edge lanes are the band's halo: lanes 1..30 output, so the loaded bytes
//    are 32/30 of the fields along y and (R+2)/R along x.
//  - Rows arrive through a per-warp ring of kRing rows in shared memory,
//    filled by cp.async: each lane copies its own column's h, u, v and reads
//    them back itself (no barrier), and the rows i+2 .. i+kRing are in
//    flight while row i is computed, without holding registers.  (Loads into
//    registers, one row ahead, held a third of those bytes in flight and ran
//    ~10% slower.)
//  - Each lane keeps the conservative form and fluxes of rows i and i+1 of
//    its column in registers (cell(), evaluated once per cell).  The x-face
//    flux at i+1/2 is computed once and becomes row i+1's flux at i-1/2.
//  - The y-neighbour's cell comes from __shfl_down_sync, the y-face flux at
//    j-1/2 from the lane below by __shfl_up_sync: every face flux once.
//  - f and r given as one row (row stride 0) are read once per strip (a
//    template case); full f, r and the orography gradients once per row.
//  - The three f32 divisions (1 / h at the x-faces, the y-faces and the new
//    cell) take div_rn_in_range (div_rn.cuh) wherever a warp vote puts every
//    lane's denominator in [2^-20, 2^40] (depths of 1e2-1e4 m always are),
//    `/` otherwise; f64 divides with `/`.
//  - 4-byte copies, one column a lane: rows of an odd ny are only 4-byte
//    aligned, and a warp's 32 lanes already move 128 contiguous bytes.  (Two
//    columns a lane, with 8-byte copies where aligned, needs 116-128
//    registers: half the warps an SM, and slower.)
//  - 32-bit offsets (nx ny < 2^31) and per-lane base pointers keep the
//    address arithmetic off the 64-bit path.
//  - max2 in the same launch: each block reduces its cells' u^2 + v^2 with
//    NaN-propagating selects (jnp.max propagates NaN; fmaxf drops it, and a
//    NaN max2 is what freezes the next step), then takes an atomicMax on the
//    bit pattern of that non-negative value (NaN as the canonical positive
//    NaN, above +inf) into an accumulator that the wrapper keeps per device
//    and stream.  A ticket (atomicInc, which wraps to 0 at the last block)
//    finds the last block; it swaps the accumulator with 0 and writes max2.
//    The accumulator and the ticket are 0 again when the launch ends, so the
//    step is one launch, with no memset, and stays valid in a CUDA graph.
//    Exact: a max of bit patterns in any order.
// R = kRows = 12 rows and kWarps = 4 warps a block, chosen by measurement
// at 2050 x 1026 (chip_compare.py on copies of the package with the two
// constants edited; PERF.md): the fastest there, though it loads 32/30 x
// 14/12 = 1.24 x the fields' bytes (taller strips load less and ran
// slower).  64 registers (the launch bound) keep 32 warps an SM in f32.
//
// Scalars without a host sync: dt, g, dx, dy are 0-d device tensors read by
// pointer, ok a 0-d bool; sx = dt / dx and sy = dt / dy are one division
// each in the working type, as the JAX wrapper computes them.
//
// Ghost cells (K6 modes): every ghost value of apply_boundary_conditions
// (x block then y block, corners included) is one fixed interior cell of
// the new step, or zero.  The lane that computes an interior cell writes
// every ghost that copies it, so there is no dependency between blocks
// (periodic-x ghost rows copy the opposite edge's new rows from the lanes
// that computed them).  With f = (h, u, v), zx = u at x walls, zy = v at y
// walls, and s0 / s1 the source rows of ghost rows 0 / nx-1 (walls: 1 /
// nx-2; periodic: nx-2 / 1):
//   interior row i, by walls:    (i,0) <- zy ? 0 : (i,1); (i,ny-1) <- zy ? 0 : (i,ny-2)
//   interior row i, by periodic: (i,0) <- (i,ny-2);       (i,ny-1) <- (i,1)
//   ghost rows, interior col j:  (0,j) <- zx ? 0 : (s0,j); (nx-1,j) <- zx ? 0 : (s1,j)
//   corners, by walls:           (0,0) <- zx|zy ? 0 : (s0,1), (0,ny-1) from (s0,ny-2),
//                                (nx-1,0) from (s1,1), (nx-1,ny-1) from (s1,ny-2)
//   corners, by periodic:        (0,0) <- (1,ny-2); (0,ny-1) <- (1,1);
//                                (nx-1,0) <- (nx-2,ny-2); (nx-1,ny-1) <- (nx-2,1)
// bx = given writes no x ghost row and no corner (the caller's halo fills
// them), as the Pallas kernel.  Only the edge bands and the rows 1 and nx-2
// go through those rules; every other cell is one store a field.
//
// Rounding: the build passes -fmad=false (no multiply-add contraction) and
// no fast math, so every product, sum and division (div.rn, or its in-range
// form) is one IEEE rounding in the plain version's order: the kernel is
// bit-equal to it.
//
// C interface (ctypes): pointers and the stream as void*, strides as
// long long, sizes and modes as int.  The entry points return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "div_rn.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRing = 4;                 // rows a warp's cp.async ring holds (>= 2)
constexpr int kOut = kWarp - 2;          // interior columns a warp outputs
constexpr int kRows = 12;                // R: the rows of a warp's strip
constexpr int kWarps = 4;                // warps a block
constexpr unsigned kFull = 0xffffffffu;

enum BxMode { kBxNone = 0, kBxWalls = 1, kBxPeriodic = 2, kBxGiven = 3 };
enum ByMode { kByNone = 0, kByWalls = 1, kByPeriodic = 2 };

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (isnan(a) || a > b) ? a : b; }

// One element from device memory into shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(s), "l"(gmem), "n"(sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = nan_max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The max2 accumulator: the bit pattern of a value in [+0, +inf] or NaN,
// ordered as the values, with every NaN mapped to the positive quiet NaN.
template <typename T> struct Bits;
template <> struct Bits<float> {
  using type = unsigned int;
  static __device__ __forceinline__ type of(float x) {
    return isnan(x) ? 0x7fc00000u : __float_as_uint(x);
  }
  static __device__ __forceinline__ float value(type b) { return __uint_as_float(b); }
};
template <> struct Bits<double> {
  using type = unsigned long long;
  static __device__ __forceinline__ type of(double x) {
    return isnan(x) ? 0x7ff8000000000000ull
                    : static_cast<type>(__double_as_longlong(x));
  }
  static __device__ __forceinline__ double value(type b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
};

// 1 / x, with the branch-free division where the warp voted `fast`.
template <typename T>
__device__ __forceinline__ T recip(T x, bool fast) {
  if constexpr (sizeof(T) == 4) {
    if (fast) return div_rn_in_range(1.0f, x);
  }
  return static_cast<T>(1) / x;
}

// Whether every lane's denominator allows the branch-free division (f32).
template <typename T>
__device__ __forceinline__ bool vote_fast(T x) {
  if constexpr (sizeof(T) == 4)
    return __all_sync(kFull, in_fast_range(x));
  else
    return false;
}

// Per-cell conservative form and fluxes: F = (uh, uh u + gh2, uh v),
// G = (vh, uh v, vh v + gh2), gh2 = ((g / 2) h) h.
template <typename T>
struct Cell {
  T h, uh, vh, F1, F2, G2;
};

template <typename T>
__device__ __forceinline__ Cell<T> cell(T h, T u, T v, T half_g) {
  Cell<T> c;
  c.h = h;
  c.uh = h * u;
  c.vh = h * v;
  const T gh2 = half_g * h * h;
  c.F1 = c.uh * u + gh2;
  c.F2 = c.uh * v;
  c.G2 = c.vh * v + gh2;
  return c;
}

// Half-step fluxes at one face.
template <typename T>
struct Face {
  T f0, f1, f2;
};

// The x-face between rows lo (i) and hi (i+1) of one column.
template <typename T>
__device__ __forceinline__ Face<T> x_face(const Cell<T>& lo, const Cell<T>& hi,
                                          T half, T half_sx, T half_g) {
  const T hx0 = half * (hi.h + lo.h) - half_sx * (hi.uh - lo.uh);
  const T hx1 = half * (hi.uh + lo.uh) - half_sx * (hi.F1 - lo.F1);
  const T hx2 = half * (hi.vh + lo.vh) - half_sx * (hi.F2 - lo.F2);
  const T inv = recip(hx0, vote_fast(hx0));
  return {hx1, hx1 * hx1 * inv + half_g * hx0 * hx0, hx1 * hx2 * inv};
}

// The y-face between this lane's column (lo) and the next lane's (hi).
template <typename T>
__device__ __forceinline__ Face<T> y_face(const Cell<T>& lo, T half, T half_sy,
                                          T half_g) {
  const T h = __shfl_down_sync(kFull, lo.h, 1);
  const T uh = __shfl_down_sync(kFull, lo.uh, 1);
  const T vh = __shfl_down_sync(kFull, lo.vh, 1);
  const T F2 = __shfl_down_sync(kFull, lo.F2, 1);
  const T G2 = __shfl_down_sync(kFull, lo.G2, 1);
  const T hy0 = half * (h + lo.h) - half_sy * (vh - lo.vh);
  const T hy1 = half * (uh + lo.uh) - half_sy * (F2 - lo.F2);
  const T hy2 = half * (vh + lo.vh) - half_sy * (G2 - lo.G2);
  const T inv = recip(hy0, vote_fast(hy0));
  return {hy2, hy1 * hy2 * inv, hy2 * hy2 * inv + half_g * hy0 * hy0};
}

template <typename T>
struct Fields {
  T* h;
  T* u;
  T* v;
  int ny;
  __device__ __forceinline__ void put(int i, int j, T hv, T uv, T vv) const {
    const size_t k = (size_t)i * ny + j;
    h[k] = hv;
    u[k] = uv;
    v[k] = vv;
  }
};

// Interior cell (i, j) of the new step and every ghost cell that copies it.
template <typename T>
__device__ __forceinline__ void write_with_ghosts(const Fields<T>& o, int nx,
                                                  int ny, int bx, int by,
                                                  int i, int j, T hv, T uv,
                                                  T vv) {
  const T zero = static_cast<T>(0);
  o.put(i, j, hv, uv, vv);
  // y block on the interior rows
  if (by == kByWalls) {
    if (j == 1) o.put(i, 0, hv, uv, zero);
    if (j == ny - 2) o.put(i, ny - 1, hv, uv, zero);
  } else {
    if (j == ny - 2) o.put(i, 0, hv, uv, vv);
    if (j == 1) o.put(i, ny - 1, hv, uv, vv);
  }
  if (bx == kBxGiven) return;
  // x ghost rows (and, at y walls, their corners)
  const int s0 = bx == kBxPeriodic ? nx - 2 : 1;
  const int s1 = bx == kBxPeriodic ? 1 : nx - 2;
  const T ug = bx == kBxWalls ? zero : uv;
  const int rows[2] = {0, nx - 1};
  const int srcs[2] = {s0, s1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (i != srcs[k]) continue;
    o.put(rows[k], j, hv, ug, vv);
    if (by == kByWalls) {
      if (j == 1) o.put(rows[k], 0, hv, ug, zero);
      if (j == ny - 2) o.put(rows[k], ny - 1, hv, ug, zero);
    }
  }
  // corners at periodic y read the interior after the x block
  if (by == kByPeriodic) {
    if (i == 1 && j == ny - 2) o.put(0, 0, hv, uv, vv);
    if (i == 1 && j == 1) o.put(0, ny - 1, hv, uv, vv);
    if (i == nx - 2 && j == ny - 2) o.put(nx - 1, 0, hv, uv, vv);
    if (i == nx - 2 && j == 1) o.put(nx - 1, ny - 1, hv, uv, vv);
  }
}

template <typename T>
struct StepArgs {
  const T* h;
  const T* u;
  const T* v;
  const T* f;                 // interior Coriolis, row stride f_stride (0: one row)
  const T* r;                 // interior damping, row stride r_stride
  const T* dhbx;              // orography gradients (unused when flat)
  const T* dhby;
  long long f_stride, r_stride, dhbx_stride, dhby_stride;
  const T* dt;
  const T* g;
  const T* dx;
  const T* dy;
  const unsigned char* ok;
  Fields<T> out;              // [nx-2, ny-2] (mode none) or [nx, ny]
  T* max2;                    // 0-d output
  typename Bits<T>::type* acc;  // per-stream max2 accumulator, 0 between launches
  unsigned int* ticket;       // per-stream block counter, 0 between launches
  int nx, ny, bx, by;
};

// 64 registers in f32 (32 warps an SM), 128 in f64
template <typename T, bool kFlat, bool kRowFR>
__global__ void __launch_bounds__(kWarp * kWarps,
                                  (sizeof(T) == 4 ? 32 : 16) / kWarps)
richtmyer_kernel(const StepArgs<T> a) {
  __shared__ T red[kWarps];
  __shared__ T ring[kWarps][kRing][3][kWarp];
  const int nx = a.nx, ny = a.ny;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int band = blockIdx.x * kWarps + warp;
  const int c = band * kOut + lane;                 // this lane's column
  const int i0 = 1 + blockIdx.y * kRows;            // the strip's first row
  const int i1 = min(i0 + kRows, nx - 1);           // one past its last
  T m2 = static_cast<T>(0);                         // max2 of this lane's cells

  if (band * kOut < ny - 2) {                       // the band has outputs
    const T dt = *a.dt;
    const T g = *a.g;
    const bool ok = *a.ok != 0;
    const T sx = dt / *a.dx;
    const T sy = dt / *a.dy;
    const T half = static_cast<T>(0.5);
    const T half_g = half * g;
    const T half_sx = half * sx;
    const T half_sy = half * sy;
    const bool outputs = lane >= 1 && lane <= kOut && c <= ny - 2;
    // lanes past the grid read its last column: only faces nobody uses
    const int col = min(c, ny - 1);
    const int jj = min(max(c - 1, 0), ny - 3);      // interior column
    const T* hp = a.h + col;
    const T* up = a.u + col;
    const T* vp = a.v + col;
    // f and r: one row read once, or a value a row from row i0 - 1 of the
    // interior on, as the orography gradients
    const T* fp = a.f + (i0 - 1) * a.f_stride + jj;
    const T* rp = a.r + (i0 - 1) * a.r_stride + jj;
    T fc = *fp, rc = *rp;
    const T* gxp = kFlat ? nullptr : a.dhbx + (i0 - 1) * a.dhbx_stride + jj;
    const T* gyp = kFlat ? nullptr : a.dhby + (i0 - 1) * a.dhby_stride + jj;
    // the outputs of this lane's column: interior [nx-2, ny-2] (mode none)
    // or full [nx, ny] from row i0; ghosts through write_with_ghosts at
    // the edge bands and rows 1 and nx-2
    const bool interior = a.bx == kBxNone;
    const int ostride = a.out.ny;
    int o_off = (interior ? i0 - 1 : i0) * ostride + (interior ? jj : col);
    T* ohp = a.out.h;
    T* oup = a.out.u;
    T* ovp = a.out.v;
    const bool edge_band = !interior &&
                           (band == 0 || band * kOut + kOut >= ny - 2);

    // a warp's ring: row r of the strip (r0 = i0 - 1) in slot (r - r0) %
    // kRing, each lane's element copied by that lane (so read by it alone)
    T (*rg)[3][kWarp] = ring[warp];
    auto issue = [&](int r, int slot) {
      if (r <= i1) {
        const int k = r * ny;
        cp_async(&rg[slot][0][lane], hp + k);
        cp_async(&rg[slot][1][lane], up + k);
        cp_async(&rg[slot][2][lane], vp + k);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int q = 0; q < kRing; ++q) issue(i0 - 1 + q, q);

    // the window: row i's cell (and raw u, v) and the x-face flux at i-1/2
    cp_async_wait<kRing - 2>();
    Cell<T> cur = cell(rg[1][0][lane], rg[1][1][lane], rg[1][2][lane], half_g);
    T u_c = rg[1][1][lane];
    T v_c = rg[1][2][lane];
    Face<T> fxm = x_face(
        cell(rg[0][0][lane], rg[0][1][lane], rg[0][2][lane], half_g), cur,
        half, half_sx, half_g);
    issue(i0 - 1 + kRing, 0);
    int s_read = 2 % kRing, s_free = 1;

    for (int i = i0; i < i1; ++i) {
      // row i+1 from the ring; rows up to i+kRing in flight
      cp_async_wait<kRing - 2>();
      const T h_n = rg[s_read][0][lane];
      const T u_n = rg[s_read][1][lane];
      const T v_n = rg[s_read][2][lane];
      issue(i + kRing, s_free);
      s_read = s_read + 1 == kRing ? 0 : s_read + 1;
      s_free = s_free + 1 == kRing ? 0 : s_free + 1;
      if (!kRowFR) {
        fc = *fp;
        rc = *rp;
        fp += a.f_stride;
        rp += a.r_stride;
      }
      T dgx = static_cast<T>(0), dgy = static_cast<T>(0);
      if (!kFlat) {
        dgx = *gxp;
        dgy = *gyp;
        gxp += a.dhbx_stride;
        gyp += a.dhby_stride;
      }

      const Cell<T> nxt = cell(h_n, u_n, v_n, half_g);
      const Face<T> fxp = x_face(cur, nxt, half, half_sx, half_g);
      const Face<T> fyp = y_face(cur, half, half_sy, half_g);
      const T fym0 = __shfl_up_sync(kFull, fyp.f0, 1);
      const T fym1 = __shfl_up_sync(kFull, fyp.f1, 1);
      const T fym2 = __shfl_up_sync(kFull, fyp.f2, 1);

      // stage 2: update, source, damping, freeze
      const T hw = cur.h;
      T h_new = hw - sx * (fxp.f0 - fxm.f0) - sy * (fyp.f0 - fym0);
      T uh_new = cur.uh - sx * (fxp.f1 - fxm.f1) - sy * (fyp.f1 - fym1);
      T vh_new = cur.vh - sx * (fxp.f2 - fxm.f2) - sy * (fyp.f2 - fym2);
      T Q1, Q2;
      if (kFlat) {
        Q1 = fc * cur.vh;
        Q2 = -fc * cur.uh;
      } else {
        const T gh_mid = g * (half * (h_new + hw));
        Q1 = fc * cur.vh - gh_mid * dgx;
        Q2 = -fc * cur.uh - gh_mid * dgy;
      }
      uh_new = uh_new + Q1 * dt;
      vh_new = vh_new + Q2 * dt;
      const T inv_new = recip(h_new, vote_fast(h_new));
      const T r_dt = rc * dt;
      T u_new = uh_new * inv_new - r_dt * u_c;
      T v_new = vh_new * inv_new - r_dt * v_c;
      if (!ok) {
        h_new = hw;
        u_new = u_c;
        v_new = v_c;
      }
      if (outputs) {
        m2 = nan_max(m2, u_new * u_new + v_new * v_new);
        if (edge_band || (!interior && (i == 1 || i == nx - 2))) {
          write_with_ghosts(a.out, nx, ny, a.bx, a.by, i, c, h_new, u_new,
                            v_new);
        } else {
          ohp[o_off] = h_new;
          oup[o_off] = u_new;
          ovp[o_off] = v_new;
        }
      }
      o_off += ostride;

      cur = nxt;
      u_c = u_n;
      v_c = v_n;
      fxm = fxp;
    }
    cp_async_wait<0>();
  }

  // max2: the block's max, then the per-stream accumulator; the last block
  // to finish takes the result and leaves the accumulator and ticket at 0
  m2 = warp_max(m2);
  if (lane == 0) red[warp] = m2;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m2 = nan_max(m2, red[w]);
    atomicMax(a.acc, Bits<T>::of(m2));
    __threadfence();
    const unsigned int last = gridDim.x * gridDim.y - 1;
    if (atomicInc(a.ticket, last) == last) {
      __threadfence();
      *a.max2 = Bits<T>::value(atomicExch(a.acc, 0));
    }
  }
}

bool modes_valid(int bx, int by) {
  if (bx == kBxNone) return by == kByNone;
  return (bx == kBxWalls || bx == kBxPeriodic || bx == kBxGiven) &&
         (by == kByWalls || by == kByPeriodic);
}

template <typename T>
int launch(const void* h, const void* u, const void* v, const void* f,
           long long f_stride, const void* r, long long r_stride,
           const void* dhbx, long long dhbx_stride, const void* dhby,
           long long dhby_stride, const void* dt, const void* g,
           const void* dx, const void* dy, const void* ok, void* h_out,
           void* u_out, void* v_out, void* max2, void* acc, void* ticket,
           int nx, int ny, int bx, int by, void* stream) {
  if (nx < 3 || ny < 3 || !modes_valid(bx, by) ||
      (dhbx == nullptr) != (dhby == nullptr) ||
      (long long)nx * ny > INT_MAX)             // 32-bit offsets in the kernel
    return (int)cudaErrorInvalidValue;
  StepArgs<T> a;
  a.h = (const T*)h;
  a.u = (const T*)u;
  a.v = (const T*)v;
  a.f = (const T*)f;
  a.r = (const T*)r;
  a.dhbx = (const T*)dhbx;
  a.dhby = (const T*)dhby;
  a.f_stride = f_stride;
  a.r_stride = r_stride;
  a.dhbx_stride = dhbx_stride;
  a.dhby_stride = dhby_stride;
  a.dt = (const T*)dt;
  a.g = (const T*)g;
  a.dx = (const T*)dx;
  a.dy = (const T*)dy;
  a.ok = (const unsigned char*)ok;
  a.out.h = (T*)h_out;
  a.out.u = (T*)u_out;
  a.out.v = (T*)v_out;
  a.out.ny = bx == kBxNone ? ny - 2 : ny;
  a.max2 = (T*)max2;
  a.acc = (typename Bits<T>::type*)acc;
  a.ticket = (unsigned int*)ticket;
  a.nx = nx;
  a.ny = ny;
  a.bx = bx;
  a.by = by;
  const int bands = (ny - 2 + kOut - 1) / kOut;
  const dim3 grid((bands + kWarps - 1) / kWarps, (nx - 2 + kRows - 1) / kRows);
  cudaStream_t s = (cudaStream_t)stream;
  const bool flat = dhbx == nullptr, row_fr = f_stride == 0 && r_stride == 0;
  if (flat && row_fr)
    richtmyer_kernel<T, true, true><<<grid, kWarps * kWarp, 0, s>>>(a);
  else if (flat)
    richtmyer_kernel<T, true, false><<<grid, kWarps * kWarp, 0, s>>>(a);
  else if (row_fr)
    richtmyer_kernel<T, false, true><<<grid, kWarps * kWarp, 0, s>>>(a);
  else
    richtmyer_kernel<T, false, false><<<grid, kWarps * kWarp, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int richtmyer_step_f32(const void* h, const void* u, const void* v,
                       const void* f, long long f_stride, const void* r,
                       long long r_stride, const void* dhbx,
                       long long dhbx_stride, const void* dhby,
                       long long dhby_stride, const void* dt, const void* g,
                       const void* dx, const void* dy, const void* ok,
                       void* h_out, void* u_out, void* v_out, void* max2,
                       void* acc, void* ticket, int nx, int ny, int bx, int by,
                       void* stream) {
  return launch<float>(h, u, v, f, f_stride, r, r_stride, dhbx, dhbx_stride,
                       dhby, dhby_stride, dt, g, dx, dy, ok, h_out, u_out,
                       v_out, max2, acc, ticket, nx, ny, bx, by, stream);
}

int richtmyer_step_f64(const void* h, const void* u, const void* v,
                       const void* f, long long f_stride, const void* r,
                       long long r_stride, const void* dhbx,
                       long long dhbx_stride, const void* dhby,
                       long long dhby_stride, const void* dt, const void* g,
                       const void* dx, const void* dy, const void* ok,
                       void* h_out, void* u_out, void* v_out, void* max2,
                       void* acc, void* ticket, int nx, int ny, int bx, int by,
                       void* stream) {
  return launch<double>(h, u, v, f, f_stride, r, r_stride, dhbx, dhbx_stride,
                        dhby, dhby_stride, dt, g, dx, dy, ok, h_out, u_out,
                        v_out, max2, acc, ticket, nx, ny, bx, by, stream);
}

}  // extern "C"
