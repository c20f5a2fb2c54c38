// K5: one (denoising) SGD step of the anomaly autoencoder over a fleet
// whose rows are split into shards, as S + 1 launches: phase A once per
// shard, then phase B once over all the shards' slots.
//
// Replaces: clawker_tpu/analytics/anomaly.py:117-156 (fleet_mesh,
// shard_params, shard_batch, shard_noise) with the mesh-rounded row pad at
// clawker_tpu/analytics/runtime.py:170-172 and the placement at :187-194:
// the reference's ONE jitted fit run as an SPMD program over a data x model
// mesh, rows and noise rows over `data`, the gradient psum over `data`
// inserted by XLA.  Here the rows are split over all data x model shards
// (kernels/anomaly.py fit_shard_ holds the host loop); the hidden split
// over `model` is not done (queued as K5b): the function is the same, only
// the layout differs.
//
// What bounds it on the H100: per step, K2's work (the 22 nFH bf16 flops of
// the products over all N rows, x and noise read once, the params in and
// out) plus the slots written by phase A and read by phase B, sum over the
// shards of min(ceil(n_s / 32), 132) x (2 F H + H + F + 1) floats each
// way.  What sets the time instead is latency: S + 1 launches a step, each
// a few us of one block's walk over its tiles or of the slots' reduce.
//
// Design:
// * anomaly_fit_shard_partials (launch A of one shard): K2's phase A
//   (fit_partials) over the shard's n_s rows, min(ceil(n_s / 32), 132)
//   blocks of 256 threads, each writing one slot into the region of the
//   slot buffer the caller points it at.  It takes the GLOBAL row count
//   N = sum of n_s and forms dr with inv_count = 1 / (N F), computed here
//   as K2 and K3 compute theirs from their own n, so that every shard's
//   partial sums are terms of the one mean over the whole batch.  The
//   slots are stored one float at a time (write_slot), so a region needs
//   only float alignment: the regions lie back to back, shard after shard,
//   in shard order, and the buffer as a whole starts at 16 bytes.
// * anomaly_fit_shard_reduce (launch B): K2's phase B (fit_reduce) over
//   the concatenation of all the shards' slots, in shard order then block
//   order, with count = N F, run in the same fixed groups and tree.  The
//   shards' slots together may outnumber the 8 x 17 that K2's and K3's
//   fixed runs hold (4 shards of 8192 / 4 rows give 256), so it sums runs
//   of any length (fit_reduce's kLongRuns), in the same order.  No float
//   atomics and a fixed order: the sharded fit is deterministic, and over
//   ONE shard it adds the same slots in the same order as K3, so it is
//   bit-identical to K3 (and to K2's loop).
// * Several cards (the wrapper's choice, written here because the kernel's
//   results depend on it): each card runs phase A of its shards into its
//   own copy of the slot buffer, the wrapper copies each shard's region to
//   the FIRST shard's card, phase B runs once there, and the updated
//   params are copied back to every other card: every card's params end
//   bit-identical, since they are copies of one result.  On one card all
//   shards write into one buffer and nothing is copied.
// * The step's loss goes to loss_out, as K2 writes it; K3's staged image is
//   not used (fit_reduce with staged = null writes only the params).
//
// A simple kernel that is right: the host issues S + 1 launches a step
// (1080 a fit at S = 8, 120 steps).  Folding the loop into one launch, CUDA
// graphs, and a cross-card reduce in distributed shared memory are later
// work.

#include "anomaly_fit_phases.cuh"

namespace anomaly {

constexpr int kShardSlice = 64;     // parameters per launch-B block

template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
shard_partials_kernel(const float* __restrict__ x,
                      const float* __restrict__ noise, float sigma,
                      const float* w_enc, const float* b_enc,
                      const float* w_dec, const float* b_dec, float* slots,
                      float inv_count, int n, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  fit_partials<FP>(blockIdx.x, gridDim.x, x, noise, sigma, w_enc, b_enc,
                   w_dec, b_dec, slots, inv_count, n, f, smem);
}

__global__ void __launch_bounds__(kShardSlice * kReduceGroups)
shard_reduce_kernel(const float* slots, int total_slots, int f,
                    float* w_enc, float* b_enc, float* w_dec, float* b_dec,
                    float* loss_out, float lr, float count) {
  __shared__ float red[kReduceGroups * kShardSlice];
  fit_reduce<kShardSlice, 1, true>(blockIdx.x, threadIdx.x, red, slots,
                                   total_slots, f, w_enc, b_enc, w_dec,
                                   b_dec, loss_out, lr, count, nullptr, 0);
}

// count = N F and inv_count = 1 / count in fp32, as K2 and K3 form theirs
inline float global_count(int n_total, int f) {
  return static_cast<float>(n_total) * static_cast<float>(f);
}

template <int FP>
int shard_partials(const float* x, const float* noise, float sigma,
                   const float* w_enc, const float* b_enc, const float* w_dec,
                   const float* b_dec, float* slots, long long slots_floats,
                   int n, int n_total, int f, cudaStream_t s) {
  const int ga = fit_slots(n);
  if (n_total < n ||
      slots_floats < static_cast<long long>(ga) * param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = work_bytes(FP) + tile_bytes(FP);
  cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(shard_partials_kernel<FP>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_count = 1.0f / global_count(n_total, f);
  shard_partials_kernel<FP><<<ga, kFitThreads, smem, s>>>(
      x, noise, sigma, w_enc, b_enc, w_dec, b_dec, slots, inv_count, n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anomaly

// Phase A of one shard: x and noise are the shard's [n, f] rows (noise may
// be null: the plain autoencoder step); its min(ceil(n / 32), 132) slots of
// (2 f 128 + 128 + f + 1) floats go to `slots`, which holds `slots_floats`
// floats from there on.  n_total is the row count of all the shards.
extern "C" int anomaly_fit_shard_partials(
    const float* x, const float* noise, float sigma, const float* w_enc,
    const float* b_enc, const float* w_dec, const float* b_dec, float* slots,
    long long slots_floats, int n, int n_total, int f, void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 ? 0 : (f + 15) / 16) {
    case 1:
      return shard_partials<16>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                slots, slots_floats, n, n_total, f, s);
    case 2:
      return shard_partials<32>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                slots, slots_floats, n, n_total, f, s);
    case 3:
      return shard_partials<48>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                slots, slots_floats, n, n_total, f, s);
    case 4:
      return shard_partials<64>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                slots, slots_floats, n, n_total, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Phase B over all the shards: `slots` holds total_slots slots back to back
// (shard order, then block order), at least total_slots x (2 f 128 + 128 +
// f + 1) floats of `slots_floats`; the params are updated in place and the
// step's loss written to `loss_out` (one float).  n_total is the row count
// of all the shards.
extern "C" int anomaly_fit_shard_reduce(const float* slots,
                                        long long slots_floats,
                                        int total_slots, float* w_enc,
                                        float* b_enc, float* w_dec,
                                        float* b_dec, float* loss_out,
                                        float lr, int n_total, int f,
                                        void* stream) {
  using namespace anomaly;
  if (total_slots < 1 || n_total < 1 || f < 1 || f > 64 ||
      (reinterpret_cast<uintptr_t>(slots) & 15) != 0 ||
      slots_floats <
          static_cast<long long>(total_slots) * param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (param_floats(f) + kShardSlice - 1) / kShardSlice;
  shard_reduce_kernel<<<blocks, kShardSlice * kReduceGroups, 0, s>>>(
      slots, total_slots, f, w_enc, b_enc, w_dec, b_dec, loss_out, lr,
      global_count(n_total, f));
  return static_cast<int>(cudaGetLastError());
}
