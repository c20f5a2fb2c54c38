// K2: fused (denoising) SGD step of the anomaly autoencoder, as two launches.
//
// Replaces: clawker_tpu/analytics/anomaly.py:96 denoise_step_with_noise
// (and :72 train_step, the same step with no noise).  The runtime's fit
// runs the same step body inside K3 (anomaly_fit.cu); this kernel serves
// single steps.
//
// What bounds it on the H100: the 4 nFH flops of the forward products and
// the 18 nFH of the backward ones (each of the three multiplies the fp32
// cotangent as three exact bf16 products) at 989 TFLOP/s take about
// 0.39 us at n = 4224, F = 32 (at the fp32 rate the backward alone would
// take 1.6 us); the bytes (x and noise in, the params in and out, ~1.2 MB)
// about 0.34 us.  Below that, what sets the time is latency: how long one
// block takes over its tile, and two launches per step.
//
// Design (the step's arithmetic and its phases: anomaly_fit_phases.cuh):
// * Launch A (fit_partials_kernel): min(ceil(n / kFitRows), 132) blocks of
//   256 threads, one per SM, each runs phase A and writes one slot.
// * Launch B (fit_reduce_kernel): one block of 64 x 8 threads per slice
//   of 64 parameters runs phase B on it.

#include "anomaly_fit_phases.cuh"

namespace anomaly {

constexpr int kReduceSlice = 64;     // parameters per launch-B block

template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
fit_partials_kernel(const float* __restrict__ x,
                    const float* __restrict__ noise, float sigma,
                    const float* w_enc, const float* b_enc,
                    const float* w_dec, const float* b_dec, float* partials,
                    float inv_count, int n, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  fit_partials<FP>(blockIdx.x, gridDim.x, x, noise, sigma, w_enc, b_enc,
                   w_dec, b_dec, partials, inv_count, n, f, smem);
}

__global__ void __launch_bounds__(kReduceSlice * kReduceGroups)
fit_reduce_kernel(const float* partials, int slots, int f, float* w_enc,
                  float* b_enc, float* w_dec, float* b_dec, float* loss_out,
                  float lr, float count) {
  __shared__ float red[kReduceGroups * kReduceSlice];
  fit_reduce<kReduceSlice, 1>(blockIdx.x, threadIdx.x, red, partials, slots,
                              f, w_enc, b_enc, w_dec, b_dec, loss_out, lr,
                              count, nullptr, 0);
}

template <int FP>
int fit_step(const float* x, const float* noise, float sigma, float* w_enc,
             float* b_enc, float* w_dec, float* b_dec, float* partials,
             long long partials_floats, float* loss_out, float lr, int n,
             int f, cudaStream_t s) {
  const int slots = fit_slots(n);
  if (partials_floats < static_cast<long long>(slots) * param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = work_bytes(FP) + tile_bytes(FP);
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(fit_partials_kernel<FP>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float count = static_cast<float>(n) * static_cast<float>(f);
  const float inv_count = 1.0f / count;
  fit_partials_kernel<FP><<<slots, kFitThreads, smem, s>>>(
      x, noise, sigma, w_enc, b_enc, w_dec, b_dec, partials, inv_count, n, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (param_floats(f) + kReduceSlice - 1) / kReduceSlice;
  fit_reduce_kernel<<<blocks, kReduceSlice * kReduceGroups, 0, s>>>(
      partials, slots, f, w_enc, b_enc, w_dec, b_dec, loss_out, lr, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anomaly

// Scratch: `partials` holds min(ceil(n / R), 132) * (2 f 128 + 128 + f + 1)
// floats (`partials_floats` says how many the caller allocated).  `noise`
// may be null: the plain autoencoder step.  `loss_out` points at one float.
extern "C" int anomaly_fit_step(const float* x, const float* noise,
                                float sigma, float* w_enc, float* b_enc,
                                float* w_dec, float* b_dec, float* partials,
                                long long partials_floats, float* loss_out,
                                float lr, int n, int f, void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 ? 0 : (f + 15) / 16) {
    case 1:
      return fit_step<16>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                          partials, partials_floats, loss_out, lr, n, f, s);
    case 2:
      return fit_step<32>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                          partials, partials_floats, loss_out, lr, n, f, s);
    case 3:
      return fit_step<48>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                          partials, partials_floats, loss_out, lr, n, f, s);
    case 4:
      return fit_step<64>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                          partials, partials_floats, loss_out, lr, n, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
