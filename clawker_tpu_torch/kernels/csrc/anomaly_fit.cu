// K3: the whole fit of the anomaly autoencoder -- `steps` denoising SGD
// steps -- as one persistent cooperative launch.
//
// Replaces: clawker_tpu/analytics/runtime.py:128-144, the jitted lax.scan
// of denoise_step_with_noise (clawker_tpu/analytics/anomaly.py:96) over the
// [steps, n, F] noise, with the params as the donated carry: one device
// program for the whole fit, no host round-trip between steps.
//
// What bounds it on the H100: steps x K2's bound, ~1.6 us per step at
// n = 4224, F = 32 (the backward products at the fp32 rate), 0.19 ms for
// 120 steps.  What sets the time instead is latency: each step's phase A
// (one block's walk over its row tiles), phase B (the slots' reduce) and
// two grid-wide barriers of ~1 us each.  A loop of K2 launches pays the
// host's enqueue of two launches per step; this kernel pays one launch
// per fit.
//
// Design: gb blocks of 256 threads, all co-resident (one per SM, at least
// `ga`), run the loop; for each step s
//   * phase A: blocks b < ga = min(ceil(n / 32), 132) run the step's phase
//     A on noise + s n F with tile stride ga, exactly K2's launch A, and
//     write slot b; blocks >= ga skip it;
//   * grid.sync();
//   * phase B: the gb blocks walk the 64-parameter slices grid-stride, 8
//     groups of 32 threads per slice, each thread 2 parameters: one round
//     at F = 32 on an H100, where one parameter per thread takes two.  The
//     order of additions is K2's (runs of <= 17 slots, then the fixed
//     tree), so the params and losses are bit-identical to `steps` K2
//     launches.  It updates the params in place and writes loss[s];
//   * grid.sync().
// Phase B shares the block's dynamic shared memory with phase A.  The
// params are read through L2 (anomaly_fit_phases.cuh): phase A of step
// s + 1 reads what phase B of step s wrote.  If `ga` blocks cannot be
// co-resident, the launch returns an error; there is no fallback.  On
// request the kernel traces each block's %globaltimer at the phase
// boundaries (`stamps`), which is how chip_smoke.py splits a step.

#include <algorithm>

#include <cooperative_groups.h>

#include "anomaly_fit_phases.cuh"

namespace anomaly {

namespace cg = cooperative_groups;

constexpr int kFitWidth = kFitThreads / kReduceGroups;   // 32 threads
constexpr int kFitCols = 2;                              // columns each
constexpr int kFitSlice = kFitWidth * kFitCols;          // parameters

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
fit_kernel(const float* __restrict__ x, const float* __restrict__ noises,
           float sigma, float* w_enc, float* b_enc, float* w_dec,
           float* b_dec, float* partials, float* losses, float lr,
           float count, float inv_count, int n, int f, int steps, int ga,
           long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int block = blockIdx.x;
  const int slices = (param_floats(f) + kFitSlice - 1) / kFitSlice;
  const size_t per_step = static_cast<size_t>(n) * f;
  // stamps [steps][4][gridDim.x]: the block's clock at the step's start,
  // after phase A, after the first barrier, after phase B
  auto stamp = [&](int s, int k) {
    if (stamps != nullptr && threadIdx.x == 0) {
      stamps[(s * 4 + k) * gridDim.x + block] = global_ns();
    }
  };
  for (int s = 0; s < steps; ++s) {
    stamp(s, 0);
    if (block < ga) {
      fit_partials<FP>(block, ga, x, noises + s * per_step, sigma, w_enc,
                       b_enc, w_dec, b_dec, partials, inv_count, n, f, smem);
    }
    stamp(s, 1);
    grid.sync();
    stamp(s, 2);
    for (int sl = block; sl < slices; sl += gridDim.x) {
      fit_reduce<kFitWidth, kFitCols>(
          sl, threadIdx.x, reinterpret_cast<float*>(smem), partials, ga, f,
          w_enc, b_enc, w_dec, b_dec, losses + s, lr, count);
    }
    stamp(s, 3);
    grid.sync();
  }
}

template <int FP>
int fit(const float* x, const float* noises, float sigma, float* w_enc,
        float* b_enc, float* w_dec, float* b_dec, float* partials,
        long long partials_floats, float* losses, float lr, int n, int f,
        int steps, long long* stamps, long long stamps_len, cudaStream_t s) {
  int ga = fit_slots(n);
  if (steps < 1 ||
      partials_floats < static_cast<long long>(ga) * param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = fit_smem_bytes(FP);
  static_assert(smem >= sizeof(float) * kReduceGroups * kFitSlice,
                "phase B's groups fit in phase A's shared memory");
  // above 48 KB only after opting in: once for each FP
  static bool opted = smem <= 48 * 1024;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fit_kernel<FP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fit_kernel<FP>, kFitThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = per_sm * sms;
  if (ga > resident) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  // one block per SM, and never fewer than phase A's ga
  const int gb = std::min(resident, std::max(ga, sms));
  if (stamps != nullptr && stamps_len < 4LL * steps * gb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float count = static_cast<float>(n) * static_cast<float>(f);
  float inv_count = 1.0f / count;
  void* args[] = {&x,     &noises,   &sigma,  &w_enc, &b_enc, &w_dec,
                  &b_dec, &partials, &losses, &lr,    &count, &inv_count,
                  &n,     &f,        &steps,  &ga,    &stamps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fit_kernel<FP>),
                                    dim3(gb), dim3(kFitThreads), args, smem,
                                    s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
}

}  // namespace anomaly

// Scratch: `partials` holds min(ceil(n / R), 132) * (2 f 128 + 128 + f + 1)
// floats, as K2's (`partials_floats` says how many the caller allocated).
// `noises` is [steps, n, f]; `losses` gets one float per step, the loss
// before that step's update.  `stamps` is null, or `stamps_len` int64s
// for a trace of the phases: 4 x steps x (the launch's blocks, one per SM
// on an H100), nanoseconds of %globaltimer.
extern "C" int anomaly_fit(const float* x, const float* noises, float sigma,
                           float* w_enc, float* b_enc, float* w_dec,
                           float* b_dec, float* partials,
                           long long partials_floats, float* losses, float lr,
                           int n, int f, int steps, long long* stamps,
                           long long stamps_len, void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 ? 0 : (f + 15) / 16) {
    case 1:
      return fit<16>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, partials,
                     partials_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    case 2:
      return fit<32>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, partials,
                     partials_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    case 3:
      return fit<48>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, partials,
                     partials_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    case 4:
      return fit<64>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, partials,
                     partials_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
