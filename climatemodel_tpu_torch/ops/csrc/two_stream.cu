// Grey two-stream flux kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of climatemodel_tpu/ops/pallas_two_stream.py:
//   lw_walk         <- _lw_kernel (lw_flux_lanes / _lw_lanes_rows, K1) and
//                      _lw_kernel_packed (_lw_lanes_packed, K2)
//   net_stats_walk  <- _net_stats_kernel (grey_net_stats_lanes, K3)
//
// What bounds them on this card: each member column is a sequential
// recurrence over nz-1 levels, so the walk is a dependency chain of
// ~nz * (2 exp + 6 flops) per member, with 2-4 loads and 2 stores of one
// word per level.  At the headline size (4096 members x 59 cells) that is a
// few MB per call: far below what the memory system moves in the time the
// chain takes, so the kernel is latency-bound on the chain and on how few
// members there are to hide it (4096 threads = 32 blocks of 128 on 132 SMs).
//
// What the design does about it: one thread per member column keeps the
// whole walk (and K3's L-deep sorted top-k) in registers; the level loop
// runs inside the thread.  Arrays are [n, b] with the member index
// contiguous, so every row's loads and stores coalesce across a warp.  The
// TPU kernel's (8,128) sublane packing has no meaning here, so K1 and K2
// are one kernel.  Filling the card (more members per SM, or splitting the
// walk) is left to later work.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn etc.,
// and the build passes -fmad=false) and exp is the accurate expf/exp, so
// the kernels round in the op order of the plain PyTorch twins in
// ops/two_stream.py: x * e + s * (1 - e), s = sigma * (T^2 * T^2),
// net = ((up - down) + up_sw) - down_sw.
//
// NaN: jnp.maximum/jnp.minimum propagate NaN and the march's NaN sentinel
// (a NaN top_1) depends on it; fmaxf/fminf drop NaN, so the top-k insertion
// network uses the NaN-propagating nan_max/nan_min below.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinL = 2;
constexpr int kMaxL = 32;
constexpr double kSigma = 5.670367e-8;   // constants.sigma

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
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (isnan(a) || a < b) ? a : b; }

// One level of the walk from interface i+1 to interface i.
template <typename T>
__device__ __forceinline__ void walk_level(T& up, T& down, T temp, T dt) {
  const T sq = mul_rn(temp, temp);
  const T src = mul_rn(static_cast<T>(kSigma), mul_rn(sq, sq));
  const T ep = exp_acc(dt);
  const T em = exp_acc(-dt);
  up = add_rn(mul_rn(up, ep), mul_rn(src, sub_rn(static_cast<T>(1), ep)));
  down = add_rn(mul_rn(down, em), mul_rn(src, sub_rn(static_cast<T>(1), em)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lw_walk_kernel(const T* __restrict__ temp, const T* __restrict__ dtau,
               const T* __restrict__ toa, T* __restrict__ up_out,
               T* __restrict__ down_out, int n, int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  T up = toa[j];
  T down = static_cast<T>(0);
  up_out[(size_t)n * b + j] = up;
  down_out[(size_t)n * b + j] = down;
  for (int i = n - 1; i >= 0; --i) {
    const size_t k = (size_t)i * b + j;
    walk_level(up, down, temp[k], dtau[k]);
    up_out[k] = up;
    down_out[k] = down;
  }
}

template <typename T, int L>
struct TopL {
  T regs[L];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < L; ++r) regs[r] = -INFINITY;
  }
  // sorted-descending insertion from min/max only (pallas_two_stream.py:92-95)
  __device__ __forceinline__ void insert(T x) {
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const T hi = nan_max(regs[r], x);
      x = nan_min(regs[r], x);
      regs[r] = hi;
    }
  }
};

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
net_stats_walk_kernel(const T* __restrict__ temp, const T* __restrict__ dtau,
                      const T* __restrict__ usw, const T* __restrict__ dsw,
                      const T* __restrict__ toa, const T* __restrict__ prev,
                      T* __restrict__ net_out, T* __restrict__ stats, int n,
                      int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  T up = toa[j];
  T down = static_cast<T>(0);
  T amax = -INFINITY;
  TopL<T, L> top;
  top.init();
  for (int i = n; i >= 0; --i) {
    const size_t k = (size_t)i * b + j;
    if (i < n) walk_level(up, down, temp[k], dtau[k]);
    const T net = sub_rn(add_rn(sub_rn(up, down), usw[k]), dsw[k]);
    net_out[k] = net;
    top.insert(abs_(sub_rn(net, prev[k])));
    amax = nan_max(amax, abs_(net));
  }
  stats[j] = top.regs[0];                        // top_1: NaN sentinel / max
  stats[(size_t)b + j] = top.regs[L - 2];        // top_{L-1}
  stats[(size_t)2 * b + j] = top.regs[L - 1];    // top_L
  stats[(size_t)3 * b + j] = amax;               // max |net|
}

inline int blocks_for(int b) { return (b + kThreads - 1) / kThreads; }

template <typename T>
int launch_lw_walk(const void* temp, const void* dtau, const void* toa,
                   void* up, void* down, int n, int b, void* stream) {
  lw_walk_kernel<T><<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)temp, (const T*)dtau, (const T*)toa, (T*)up, (T*)down, n, b);
  return (int)cudaGetLastError();
}

// Dispatch the runtime top-k depth onto the template instances kMinL..kMaxL.
template <typename T, int L>
struct NetStatsLauncher {
  static int launch(int l, const void* temp, const void* dtau, const void* usw,
                    const void* dsw, const void* toa, const void* prev,
                    void* net, void* stats, int n, int b, void* stream) {
    if (l != L)
      return NetStatsLauncher<T, L + 1>::launch(l, temp, dtau, usw, dsw, toa,
                                                prev, net, stats, n, b, stream);
    net_stats_walk_kernel<T, L>
        <<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
            (const T*)temp, (const T*)dtau, (const T*)usw, (const T*)dsw,
            (const T*)toa, (const T*)prev, (T*)net, (T*)stats, n, b);
    return (int)cudaGetLastError();
  }
};

template <typename T>
struct NetStatsLauncher<T, kMaxL + 1> {
  static int launch(int, const void*, const void*, const void*, const void*,
                    const void*, const void*, void*, void*, int, int, void*) {
    return (int)cudaErrorInvalidValue;
  }
};

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
  if (l < kMinL) return (int)cudaErrorInvalidValue;
  return NetStatsLauncher<float, kMinL>::launch(l, temp, dtau, usw, dsw, toa,
                                                prev, net, stats, n, b, stream);
}

int net_stats_walk_f64(const void* temp, const void* dtau, const void* usw,
                       const void* dsw, const void* toa, const void* prev,
                       void* net, void* stats, int n, int b, int l,
                       void* stream) {
  if (l < kMinL) return (int)cudaErrorInvalidValue;
  return NetStatsLauncher<double, kMinL>::launch(l, temp, dtau, usw, dsw, toa,
                                                 prev, net, stats, n, b, stream);
}

}  // extern "C"
