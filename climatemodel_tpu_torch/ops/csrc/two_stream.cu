// Grey two-stream flux kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of climatemodel_tpu/ops/pallas_two_stream.py:
//   lw_walk         <- _lw_kernel (lw_flux_lanes / _lw_lanes_rows, K1) and
//                      _lw_kernel_packed (_lw_lanes_packed, K2)
//   net_stats_walk  <- _net_stats_kernel (grey_net_stats_lanes, K3)
//
// What bounds them on this card: each member column is a sequential
// recurrence over its n cells, x = x * e + s for the up and the down
// stream, so a member is a dependency chain of n (mul, add) pairs; the
// bytes (2-5 words per level in, 1-2 out) are a few MB per call at the
// headline size (4096 members x 59 cells), far below what the memory
// system moves in the time the chain takes.
//
// lw_walk, on the [n, b] layout (member index contiguous; the TPU kernel's
// (8,128) sublane packing has no meaning here, so K1 and K2 are one
// kernel).  A block takes m = min(b, kLwMembers) members and walks their
// levels from the top down in chunks of K levels, K as many as 48 KB
// of shared memory hold (all of them for the march's grids: n = 59, 99 and
// 'auto' grids of ~600 at m = 1), three phases a chunk:
//  1. stage: every thread of the block over the flattened K x m tile, which
//     is coalesced at b = 1 (lanes over levels) and at b = 4096 (lanes over
//     members); T*T, sigma*(T^2*T^2), exp(+-dtau) and src*(1-e) of each
//     level into shared memory, the phase-1 helper of net_stats_walk;
//  2. the chains: one thread per member and stream walks x = x * e + s from
//     shared memory in the plain order, carrying x from chunk to chunk;
//  3. write: every thread stores the chunk's up and down, coalesced.
// The earlier kernel walked a member per thread straight from device
// memory: at the single world's batch of one, one thread on one SM waited
// on two loads and two exps each level.
//
// net_stats_walk: one warp per member, on the march's own [b, r] rows (a
// member's column contiguous), in three phases over a per-warp slice of
// shared memory:
//  1. lanes over levels (coalesced): T*T, sigma*(T^2*T^2), exp(+-dtau) and
//     src*(1-e) of every level, everything that is off the chain; the sw
//     fluxes and prev_net are staged beside them, so every device load is
//     in flight at once, before the chain starts;
//  2. the two affine chains, lane 0 up and lane 1 down, each a (mul, add)
//     per level from shared memory in the plain version's order (handing a
//     carry from lane to lane would add a shuffle per hop and save nothing:
//     the chain is sequential either way);
//  3. lanes over interfaces: net, |net - prev| and |net| in parallel,
//     max|net| by a warp reduction, and the top-L of |net - prev| by rounds
//     of a warp max: each round takes the largest value left, counts its
//     copies (__reduce_add_sync) and removes them, so L rounds at most give
//     the exact order statistics with their multiplicity.
// The earlier kernel walked a member per thread on [r, b] copies made by
// the caller: 4 of 132 SMs busy at 512 members, a device load latency per
// level.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn etc.,
// and the build passes -fmad=false) and exp is the accurate expf/exp, so
// the kernels round in the op order of the plain PyTorch twins in
// ops/two_stream.py: x * e + s * (1 - e), s = sigma * (T^2 * T^2),
// net = ((up - down) + up_sw) - down_sw.
//
// NaN: the Pallas kernel's sorted insertion from NaN-propagating max/min
// turns every one of its L slots into NaN once a NaN is inserted, and the
// march's NaN sentinel (a NaN top_1) depends on it.  net_stats_walk gives
// exactly that: a NaN anywhere in a member's |net - prev| makes top_1,
// top_{L-1} and top_L NaN; max|net| is a NaN-propagating max of its own.
// lw_walk has no selection.
//
// Shared memory of net_stats_walk: 7 (n + 1) values a member (8.4 KB at
// n = 149 in f64); above 48 KB (n > ~875 in f64) the launch opts in to the
// larger dynamic size.  lw_walk: 4 K m values, at most 48 KB.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
// lw_walk's members a block and threads a block at most, chosen by
// measurement at 59 x 4096 (chip_compare.py on copies of the package with
// the two constants edited; PERF.md)
constexpr int kLwMembers = 16;
constexpr int kLwThreads = 256;
static_assert(2 * kLwMembers <= kLwThreads, "a thread for each chain");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinL = 2;
constexpr int kMaxL = 32;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;          // what a block may opt in to
constexpr double kSigma = 5.670367e-8;   // constants.sigma

template <typename T> struct PairOf;
template <> struct PairOf<float> { using type = float2; };
template <> struct PairOf<double> { using type = double2; };

__device__ __forceinline__ float2 make_pair(float a, float b) { return make_float2(a, b); }
__device__ __forceinline__ double2 make_pair(double a, double b) { return make_double2(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float exp_acc(float x) { return expf(x); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double exp_acc(double x) { return exp(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (isnan(a) || a > b) ? a : b; }

// One level of both streams, everything that is off the chain: the
// (e, s) pairs, x -> x * e + s, of the up (e = exp(dtau)) and the down
// (e = exp(-dtau)) stream, s = sigma (T^2 T^2) (1 - e).
template <typename T, typename P>
__device__ __forceinline__ void stage_level(T temp, T dt, P& up, P& dn) {
  const T one = static_cast<T>(1);
  const T sq = mul_rn(temp, temp);
  const T src = mul_rn(static_cast<T>(kSigma), mul_rn(sq, sq));
  const T ep = exp_acc(dt);
  const T em = exp_acc(-dt);
  up = make_pair(ep, mul_rn(src, sub_rn(one, ep)));
  dn = make_pair(em, mul_rn(src, sub_rn(one, em)));
}

// x = x * e + s down the levels k = n-1 .. 0 of one stream, c[k * stride] =
// (e, s) on entry and c[k * stride].x = x on exit; returns the last x.
// Eight pairs are loaded ahead of their steps; the chain is the (mul, add)
// alone.
template <typename P, typename T>
__device__ __forceinline__ T affine_walk(P* c, T x, int n, int stride) {
  int k = n - 1;
  for (; k >= 7; k -= 8) {
    P es[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) es[q] = c[(k - q) * stride];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      x = add_rn(mul_rn(x, es[q].x), es[q].y);
      c[(k - q) * stride].x = x;
    }
  }
  for (; k >= 0; --k) {
    const P es = c[k * stride];
    x = add_rn(mul_rn(x, es.x), es.y);
    c[k * stride].x = x;
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kLwThreads)
lw_walk_kernel(const T* __restrict__ temp, const T* __restrict__ dtau,
               const T* __restrict__ toa, T* __restrict__ up_out,
               T* __restrict__ down_out, int n, int b, int m, int chunk) {
  using P = typename PairOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = blockIdx.x * m;
  const int mb = min(m, b - j0);                  // this block's members
  P* su = reinterpret_cast<P*>(smem);             // [chunk][mb], up stream
  P* sd = su + (size_t)chunk * mb;                // the same, down
  const int tid = threadIdx.x;
  const bool walker = tid < 2 * mb;               // threads mb.. walk down
  const bool is_up = tid < mb;
  const int jw = is_up ? tid : tid - mb;
  T x = static_cast<T>(0);
  if (walker) {
    if (is_up) x = toa[j0 + jw];
    (is_up ? up_out : down_out)[(size_t)n * b + j0 + jw] = x;
  }
  for (int hi = n; hi > 0; hi -= chunk) {
    const int lo = max(hi - chunk, 0);
    const int cells = (hi - lo) * mb;
    // 1. stage levels lo .. hi-1
    for (int k = tid; k < cells; k += blockDim.x) {
      const int li = k / mb, j = k - li * mb;
      const size_t g = (size_t)(lo + li) * b + j0 + j;
      stage_level(temp[g], dtau[g], su[k], sd[k]);
    }
    __syncthreads();
    // 2. the chains
    if (walker) x = affine_walk((is_up ? su : sd) + jw, x, hi - lo, mb);
    __syncthreads();
    // 3. the fluxes of levels lo .. hi-1
    for (int k = tid; k < cells; k += blockDim.x) {
      const int li = k / mb, j = k - li * mb;
      const size_t g = (size_t)(lo + li) * b + j0 + j;
      up_out[g] = su[k].x;
      down_out[g] = sd[k].x;
    }
    if (lo > 0) __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {          // no NaN in x
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const T o = __shfl_xor_sync(kFull, x, off);
    x = o > x ? o : x;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_nan_max(T x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    x = nan_max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The 1st, (L-1)-th and L-th largest of x[0..r-1] (no NaN), counted with
// multiplicity, -inf where fewer than L values are left: rounds of a warp
// max, each removing every copy of the value it found.  Lane i holds the
// entries i, i + 32, ...; x is overwritten.
template <typename T>
__device__ void top_l(T* x, int r, int L, int lane, T& top1, T& hi, T& lo) {
  const T ninf = static_cast<T>(-INFINITY);
  int rank = 0;
  while (rank < L) {                          // rank, mx, c: uniform
    T mx = ninf;
    for (int i = lane; i < r; i += kWarp) mx = x[i] > mx ? x[i] : mx;
    mx = warp_max(mx);
    if (!(mx > ninf)) return;                 // the remaining slots stay -inf
    int c = 0;
    for (int i = lane; i < r; i += kWarp)
      if (x[i] == mx) {
        ++c;
        x[i] = ninf;
      }
    c = __reduce_add_sync(kFull, c);
    if (rank == 0) top1 = mx;
    if (rank <= L - 2 && L - 2 < rank + c) hi = mx;
    if (rank <= L - 1 && L - 1 < rank + c) lo = mx;
    rank += c;
  }
}

// Shared memory of one member (one warp, one block): the (e, s) pairs of
// both streams and the sw fluxes and prev_net of its r = n + 1 interfaces.
template <typename T>
size_t net_stats_smem(int n) {
  return (size_t)(n + 1) * (2 * sizeof(typename PairOf<T>::type) + 3 * sizeof(T));
}

// 32 one-warp blocks an SM (the most it schedules): at most 64 registers a
// thread, so 4096 members are one wave on 132 SMs.
template <typename T>
__global__ void __launch_bounds__(kWarp, 32)
net_stats_walk_kernel(const T* __restrict__ temp, const T* __restrict__ dtau,
                      const T* __restrict__ usw, const T* __restrict__ dsw,
                      const T* __restrict__ toa, const T* __restrict__ prev,
                      T* __restrict__ net_out, T* __restrict__ stats, int n,
                      int b, int L) {
  using P = typename PairOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = n + 1;
  P* up = reinterpret_cast<P*>(smem);     // (e, s) per level, then up
  P* dn = up + r;                         // the same for the down stream
  T* sw_up = reinterpret_cast<T*>(dn + r);
  T* sw_dn = sw_up + r;
  T* delta = sw_dn + r;                   // prev_net, then |net - prev|
  const int m = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t cells = (size_t)m * n;
  const size_t faces = (size_t)m * r;

  // 1. off the chain, lanes over levels
  for (int i = lane; i < n; i += kWarp)
    stage_level(temp[cells + i], dtau[cells + i], up[i], dn[i]);
  for (int i = lane; i < r; i += kWarp) {
    sw_up[i] = usw[faces + i];
    sw_dn[i] = dsw[faces + i];
    delta[i] = prev[faces + i];
  }
  __syncwarp();

  // 2. the chains: lane 0 walks up from the TOA flux, lane 1 down from 0
  if (lane < 2) {
    P* c = lane == 0 ? up : dn;
    const T top = lane == 0 ? toa[m] : static_cast<T>(0);
    c[n].x = top;
    affine_walk(c, top, n, 1);
  }
  __syncwarp();

  // 3. net and the statistics, lanes over interfaces
  T amax = static_cast<T>(-INFINITY);
  bool has_nan = false;
  for (int i = lane; i < r; i += kWarp) {
    const T net = sub_rn(add_rn(sub_rn(up[i].x, dn[i].x), sw_up[i]), sw_dn[i]);
    net_out[faces + i] = net;
    const T d = abs_(sub_rn(net, delta[i]));
    delta[i] = d;
    has_nan |= isnan(d);
    amax = nan_max(amax, abs_(net));
  }
  amax = warp_nan_max(amax);
  T top1 = static_cast<T>(-INFINITY), hi = top1, lo = top1;
  if (__any_sync(kFull, has_nan))
    top1 = hi = lo = static_cast<T>(NAN);
  else
    top_l(delta, r, L, lane, top1, hi, lo);
  if (lane == 0) {
    stats[m] = top1;                      // top_1: NaN sentinel / max
    stats[(size_t)b + m] = hi;            // top_{L-1}
    stats[(size_t)2 * b + m] = lo;        // top_L
    stats[(size_t)3 * b + m] = amax;      // max |net|
  }
}

template <typename T>
int launch_lw_walk(const void* temp, const void* dtau, const void* toa,
                   void* up, void* down, int n, int b, void* stream) {
  if (n < 0 || b < 1) return (int)cudaErrorInvalidValue;
  const int m = min(kLwMembers, b);
  // a thread for each of the tile's cells and each chain (2 m), up to
  // kLwThreads, in whole warps
  const long long cells = (long long)max(n, 2) * m;
  const int threads = cells >= kLwThreads
                          ? kLwThreads
                          : (int)(cells + kWarp - 1) / kWarp * kWarp;
  const size_t level = 2 * sizeof(typename PairOf<T>::type) * m;
  const int chunk = max(min(n, (int)(kStaticSmem / level)), 1);
  if ((size_t)chunk * level > (size_t)kStaticSmem)
    return (int)cudaErrorInvalidValue;
  lw_walk_kernel<T><<<(b + m - 1) / m, threads, chunk * level,
                      (cudaStream_t)stream>>>(
      (const T*)temp, (const T*)dtau, (const T*)toa, (T*)up, (T*)down, n, b,
      m, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_net_stats_walk(const void* temp, const void* dtau, const void* usw,
                          const void* dsw, const void* toa, const void* prev,
                          void* net, void* stats, int n, int b, int l,
                          void* stream) {
  if (n < 0 || b < 1 || l < kMinL || l > kMaxL || l > n + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = net_stats_smem<T>(n);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        net_stats_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  net_stats_walk_kernel<T><<<b, kWarp, smem, (cudaStream_t)stream>>>(
      (const T*)temp, (const T*)dtau, (const T*)usw, (const T*)dsw,
      (const T*)toa, (const T*)prev, (T*)net, (T*)stats, n, b, l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int two_stream_max_topk() { return kMaxL; }

int lw_walk_f32(const void* temp, const void* dtau, const void* toa, void* up,
                void* down, int n, int b, void* stream) {
  return launch_lw_walk<float>(temp, dtau, toa, up, down, n, b, stream);
}

int lw_walk_f64(const void* temp, const void* dtau, const void* toa, void* up,
                void* down, int n, int b, void* stream) {
  return launch_lw_walk<double>(temp, dtau, toa, up, down, n, b, stream);
}

int net_stats_walk_f32(const void* temp, const void* dtau, const void* usw,
                       const void* dsw, const void* toa, const void* prev,
                       void* net, void* stats, int n, int b, int l,
                       void* stream) {
  return launch_net_stats_walk<float>(temp, dtau, usw, dsw, toa, prev, net,
                                      stats, n, b, l, stream);
}

int net_stats_walk_f64(const void* temp, const void* dtau, const void* usw,
                       const void* dsw, const void* toa, const void* prev,
                       void* net, void* stats, int n, int b, int l,
                       void* stream) {
  return launch_net_stats_walk<double>(temp, dtau, usw, dsw, toa, prev, net,
                                       stats, n, b, l, stream);
}

}  // extern "C"
