// Fused nonlinear Richtmyer shallow-water step for Hopper (sm_90a).
//
// Replaces the Pallas kernels of climatemodel_tpu/ops/pallas_stencils.py:
//   mode none (interior only)  <- _kernel / _kernel_flat via _kernel_body
//                                 (richtmyer_step_interior, K5)
//   modes bx x by (all ghosts) <- _kernel_frame / _kernel_frame_flat via
//                                 _kernel_frame_body, _store_ghost_row and
//                                 _write_ghost_lanes (richtmyer_step_frame, K6)
// One kernel, templated on the float type and on flat orography; the
// boundary mode is a runtime argument (it only decides the edge writes).
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
// What bounds it on this card: bytes.  A step reads h, u, v and writes the
// new h, u, v (f and r are one broadcast row on the bench world; the flat
// variant reads no orography gradients): 6 field passes, ~50.5 MB at
// 2050 x 1026 f32, ~15 us at 3.35 TB/s.  The arithmetic is ~70 operations a
// cell (~2 us at 67 TFLOP/s).  The 25 MB of inputs and 25 MB of outputs fit
// in the 50 MB L2, so a time below the HBM bound is possible when a step
// follows a step.
//
// The design: a block of 32 x 8 threads owns a 8-row x 32-column tile of
// outputs; threadIdx.x runs along y, the contiguous axis, so loads and
// stores coalesce.  It stages the (8+2) x (32+2) window of h, u, v in shared
// memory, forms the half-step fluxes of the 9 x 32 x-faces and 8 x 33
// y-faces once each into shared memory, and updates its cells from them.
// Edges are masked, so any nx, ny >= 3 works.  max2 is reduced per block
// with NaN-propagating selects (jnp.max propagates NaN; fmaxf drops it, and a
// NaN max2 is what freezes the next step), the block partials are reduced by
// a one-block second launch; no float atomics.
//
// Scalars without a host sync: dt, g, dx, dy are 0-d device tensors read by
// pointer, ok a 0-d bool; sx = dt / dx and sy = dt / dy are one division
// each in the working type, as the JAX wrapper computes them.
//
// Ghost cells (K6 modes): every ghost value of apply_boundary_conditions
// (x block then y block, corners included) is one fixed interior cell of
// the new step, or zero.  The thread that computes an interior cell writes
// every ghost that copies it, so there is no dependency between blocks
// (periodic-x ghost rows copy the opposite edge's new rows from the threads
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
// them), as the Pallas kernel.
//
// Rounding: the build passes -fmad=false (no multiply-add contraction) and
// no fast math, so every product, sum and division (div.rn) is one IEEE
// rounding in the plain version's order: the kernel is expected to be
// bit-equal to it.
//
// C interface (ctypes): pointers and the stream as void*, strides as
// long long, sizes and modes as int.  Entry points return
// cudaGetLastError() after their launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTY = 32;                  // outputs along y per block (x threads)
constexpr int kTX = 8;                   // outputs along x per block (y threads)
constexpr int kThreads = kTX * kTY;
constexpr int kReduceThreads = 1024;

enum BxMode { kBxNone = 0, kBxWalls = 1, kBxPeriodic = 2, kBxGiven = 3 };
enum ByMode { kByNone = 0, kByWalls = 1, kByPeriodic = 2 };

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (isnan(a) || a > b) ? a : b; }

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
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
  T* partial;                 // one max2 partial per block
  int nx, ny, bx, by;
};

template <typename T, bool kFlat>
__global__ void __launch_bounds__(kThreads)
richtmyer_kernel(const StepArgs<T> a) {
  __shared__ T sh[kTX + 2][kTY + 2];
  __shared__ T su[kTX + 2][kTY + 2];
  __shared__ T sv[kTX + 2][kTY + 2];
  __shared__ T fx[3][kTX + 1][kTY];       // half-step fluxes on x-faces
  __shared__ T fy[3][kTX][kTY + 1];       // half-step fluxes on y-faces
  __shared__ T red[kThreads / 32];

  const int nx = a.nx, ny = a.ny;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTY + tx;
  const int i0 = blockIdx.y * kTX;        // full row of window row 0
  const int j0 = blockIdx.x * kTY;        // full column of window column 0

  for (int k = tid; k < (kTX + 2) * (kTY + 2); k += kThreads) {
    const int wr = k / (kTY + 2), wc = k % (kTY + 2);
    const int gi = i0 + wr, gj = j0 + wc;
    T hv = static_cast<T>(1), uv = static_cast<T>(0), vv = static_cast<T>(0);
    if (gi < nx && gj < ny) {
      const size_t idx = (size_t)gi * ny + gj;
      hv = a.h[idx];
      uv = a.u[idx];
      vv = a.v[idx];
    }
    sh[wr][wc] = hv;
    su[wr][wc] = uv;
    sv[wr][wc] = vv;
  }
  const T dt = *a.dt;
  const T g = *a.g;
  const bool ok = *a.ok != 0;
  const T sx = dt / *a.dx;
  const T sy = dt / *a.dy;
  const T half = static_cast<T>(0.5);
  const T one = static_cast<T>(1);
  const T half_g = half * g;
  const T half_sx = half * sx;
  const T half_sy = half * sy;
  __syncthreads();

  // stage 1 + half-step fluxes, x-faces between window rows r and r+1
  for (int k = tid; k < (kTX + 1) * kTY; k += kThreads) {
    const int r = k / kTY, c = k % kTY + 1;
    const Cell<T> lo = cell(sh[r][c], su[r][c], sv[r][c], half_g);
    const Cell<T> hi = cell(sh[r + 1][c], su[r + 1][c], sv[r + 1][c], half_g);
    const T hx0 = half * (hi.h + lo.h) - half_sx * (hi.uh - lo.uh);
    const T hx1 = half * (hi.uh + lo.uh) - half_sx * (hi.F1 - lo.F1);
    const T hx2 = half * (hi.vh + lo.vh) - half_sx * (hi.F2 - lo.F2);
    const T inv = one / hx0;
    fx[0][r][c - 1] = hx1;
    fx[1][r][c - 1] = hx1 * hx1 * inv + half_g * hx0 * hx0;
    fx[2][r][c - 1] = hx1 * hx2 * inv;
  }
  // y-faces between window columns c and c+1
  for (int k = tid; k < kTX * (kTY + 1); k += kThreads) {
    const int r = k / (kTY + 1) + 1, c = k % (kTY + 1);
    const Cell<T> lo = cell(sh[r][c], su[r][c], sv[r][c], half_g);
    const Cell<T> hi = cell(sh[r][c + 1], su[r][c + 1], sv[r][c + 1], half_g);
    const T hy0 = half * (hi.h + lo.h) - half_sy * (hi.vh - lo.vh);
    const T hy1 = half * (hi.uh + lo.uh) - half_sy * (hi.F2 - lo.F2);
    const T hy2 = half * (hi.vh + lo.vh) - half_sy * (hi.G2 - lo.G2);
    const T inv = one / hy0;
    fy[0][r - 1][c] = hy2;
    fy[1][r - 1][c] = hy1 * hy2 * inv;
    fy[2][r - 1][c] = hy2 * hy2 * inv + half_g * hy0 * hy0;
  }
  __syncthreads();

  // stage 2: update, source, damping, freeze
  const int gi = i0 + 1 + ty, gj = j0 + 1 + tx;
  T s2 = static_cast<T>(-INFINITY);
  if (gi <= nx - 2 && gj <= ny - 2) {
    const T hw = sh[ty + 1][tx + 1];
    const T uw = su[ty + 1][tx + 1];
    const T vw = sv[ty + 1][tx + 1];
    const T uhw = hw * uw;
    const T vhw = hw * vw;
    T h_new = hw - sx * (fx[0][ty + 1][tx] - fx[0][ty][tx])
              - sy * (fy[0][ty][tx + 1] - fy[0][ty][tx]);
    T uh_new = uhw - sx * (fx[1][ty + 1][tx] - fx[1][ty][tx])
               - sy * (fy[1][ty][tx + 1] - fy[1][ty][tx]);
    T vh_new = vhw - sx * (fx[2][ty + 1][tx] - fx[2][ty][tx])
               - sy * (fy[2][ty][tx + 1] - fy[2][ty][tx]);
    const int ii = gi - 1, jj = gj - 1;   // interior indices
    const T fc = a.f[ii * a.f_stride + jj];
    T Q1, Q2;
    if (kFlat) {
      Q1 = fc * vhw;
      Q2 = -fc * uhw;
    } else {
      const T gh_mid = g * (half * (h_new + hw));
      Q1 = fc * vhw - gh_mid * a.dhbx[ii * a.dhbx_stride + jj];
      Q2 = -fc * uhw - gh_mid * a.dhby[ii * a.dhby_stride + jj];
    }
    uh_new = uh_new + Q1 * dt;
    vh_new = vh_new + Q2 * dt;
    const T inv_new = one / h_new;
    const T r_dt = a.r[ii * a.r_stride + jj] * dt;
    T u_new = uh_new * inv_new - r_dt * uw;
    T v_new = vh_new * inv_new - r_dt * vw;
    if (!ok) {
      h_new = hw;
      u_new = uw;
      v_new = vw;
    }
    s2 = u_new * u_new + v_new * v_new;
    if (a.bx == kBxNone) {
      Fields<T> o = a.out;
      o.put(ii, jj, h_new, u_new, v_new);
    } else {
      write_with_ghosts(a.out, nx, ny, a.bx, a.by, gi, gj, h_new, u_new, v_new);
    }
  }

  s2 = warp_max(s2);
  if (tid % 32 == 0) red[tid / 32] = s2;
  __syncthreads();
  if (tid < 32) {
    T m = tid < kThreads / 32 ? red[tid] : static_cast<T>(-INFINITY);
    m = warp_max(m);
    if (tid == 0) a.partial[blockIdx.y * gridDim.x + blockIdx.x] = m;
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
max_reduce_kernel(const T* __restrict__ partial, int n, T* __restrict__ out) {
  __shared__ T red[kReduceThreads / 32];
  T m = static_cast<T>(-INFINITY);
  for (int k = threadIdx.x; k < n; k += kReduceThreads) m = nan_max(m, partial[k]);
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = red[threadIdx.x];
    m = warp_max(m);
    if (threadIdx.x == 0) *out = m;
  }
}

inline dim3 grid_for(int nx, int ny) {
  return dim3((ny - 2 + kTY - 1) / kTY, (nx - 2 + kTX - 1) / kTX);
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
           void* u_out, void* v_out, void* partial, void* max2, int nx,
           int ny, int bx, int by, void* stream) {
  if (nx < 3 || ny < 3 || !modes_valid(bx, by) ||
      (dhbx == nullptr) != (dhby == nullptr))
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
  a.partial = (T*)partial;
  a.nx = nx;
  a.ny = ny;
  a.bx = bx;
  a.by = by;
  const dim3 grid = grid_for(nx, ny);
  const dim3 block(kTY, kTX);
  cudaStream_t s = (cudaStream_t)stream;
  if (dhbx == nullptr)
    richtmyer_kernel<T, true><<<grid, block, 0, s>>>(a);
  else
    richtmyer_kernel<T, false><<<grid, block, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  max_reduce_kernel<T><<<1, kReduceThreads, 0, s>>>(
      (const T*)partial, (int)(grid.x * grid.y), (T*)max2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block max2 partials the step writes for an [nx, ny] grid.
int richtmyer_num_partials(int nx, int ny) {
  if (nx < 3 || ny < 3) return 0;
  const dim3 grid = grid_for(nx, ny);
  return (int)(grid.x * grid.y);
}

int richtmyer_step_f32(const void* h, const void* u, const void* v,
                       const void* f, long long f_stride, const void* r,
                       long long r_stride, const void* dhbx,
                       long long dhbx_stride, const void* dhby,
                       long long dhby_stride, const void* dt, const void* g,
                       const void* dx, const void* dy, const void* ok,
                       void* h_out, void* u_out, void* v_out, void* partial,
                       void* max2, int nx, int ny, int bx, int by,
                       void* stream) {
  return launch<float>(h, u, v, f, f_stride, r, r_stride, dhbx, dhbx_stride,
                       dhby, dhby_stride, dt, g, dx, dy, ok, h_out, u_out,
                       v_out, partial, max2, nx, ny, bx, by, stream);
}

int richtmyer_step_f64(const void* h, const void* u, const void* v,
                       const void* f, long long f_stride, const void* r,
                       long long r_stride, const void* dhbx,
                       long long dhbx_stride, const void* dhby,
                       long long dhby_stride, const void* dt, const void* g,
                       const void* dx, const void* dy, const void* ok,
                       void* h_out, void* u_out, void* v_out, void* partial,
                       void* max2, int nx, int ny, int bx, int by,
                       void* stream) {
  return launch<double>(h, u, v, f, f_stride, r, r_stride, dhbx, dhbx_stride,
                        dhby, dhby_stride, dt, g, dx, dy, ok, h_out, u_out,
                        v_out, partial, max2, nx, ny, bx, by, stream);
}

}  // extern "C"
