// K3: the whole fit of the anomaly autoencoder -- `steps` denoising SGD
// steps -- as one persistent cooperative launch.
//
// Replaces: clawker_tpu/analytics/runtime.py:128-144, the jitted lax.scan
// of denoise_step_with_noise (clawker_tpu/analytics/anomaly.py:96) over the
// [steps, n, F] noise, with the params as the donated carry: one device
// program for the whole fit, no host round-trip between steps.
//
// What bounds it on the H100 (chip_smoke.py, fit_bound): the bytes -- x
// read once, each step's noise once, the params in and out once, one loss
// per step -- or steps x 22 nFH flops at the bf16 tensor rate (the two
// forward products, 4 nFH; the three backward ones, 18 nFH, each taking
// the fp32 cotangent as three bf16 terms), whichever takes longer: the
// flops, 0.046 ms for 120 steps at n = 4224, F = 32, where the bytes
// take 0.020 ms.  What sets the time instead is latency: each step's phase A
// (one block's walk over its row tiles), phase B (the slots' reduce) and
// two grid-wide barriers of ~1 us each.  So the design keeps off phase A's
// critical path every round trip whose data is known before the step.
//
// Design: gb blocks of 256 threads, all co-resident (one per SM, at least
// `ga` = min(ceil(n / 32), 132)).
//   * Prologue: block 0 builds the STAGED IMAGE in global scratch from
//     the fp32 params, as K2 stages them (stage_params): bf16 W_enc^T
//     [H][FP+8], bf16 W_dec^T [FP][H+8], fp32 b_enc [H], b_dec [FP], zeros
//     past f -- byte for byte the layout phase A wants in shared memory
//     (`Staged`, anomaly_common.cuh).
//     Each phase-A block loads its own clean x tiles (t = block,
//     block + ga, ...) into shared memory, where they stay RESIDENT for the
//     whole fit, and starts the copy of its first noise tile; grid.sync().
//   * For each step s, phase A on blocks b < ga:
//       - one cp.async group copies the staged image into shared memory:
//         16-byte copies through L2, no conversion, no transpose;
//       - per tile: wait for the tile's noise (already on chip: it was
//         prefetched), noisy = __fadd_rn(x, __fmul_rn(sigma, noise)) from
//         the resident x, then start the cp.async of the NEXT tile's noise
//         (the same block's next tile, or step s + 1's first) into the
//         other half of a double buffer, wait for the weights, and run K2's
//         tile body (fit_tile: forward, dh/da, weight sums);
//       - write slot b (write_slot).
//     Blocks >= ga skip it.
//   * grid.sync();
//   * phase B: the gb blocks walk the 64-parameter slices grid-stride, 8
//     groups of 32 threads per slice, each thread 2 parameters: one round
//     at F = 32 on an H100, where one parameter per thread takes two.  The
//     order of additions is K2's (runs of <= 17 slots, then the fixed
//     tree), so the params and losses are bit-identical to `steps` K2
//     launches.  It updates the params in place, writes each new value
//     into the staged image too (bf16 for the weights), and writes loss[s];
//   * grid.sync().
// Which reads still go through L2: the staged image (phase B of the step
// before wrote it, in other blocks: cp.async.cg, never L1), the slots in
// phase B (phase A of the same step wrote them: __ldcg) and the params'
// old values in phase B.  The noise is read once, ahead of its step.
//
// Shared memory: work_bytes(FP) (phase A's working set, the slot's and
// phase B's room) + T x tile_bytes(FP) of resident x, T = the tiles a block
// owns, ceil(ceil(n / 32) / ga), + 2 x tile_bytes(FP) of noise.  The x
// tiles are resident while that fits in the 227 KB a block may have: up
// to T = 76 / 33 / 19 / 12 tiles at F padded to 16 / 32 / 48 / 64, that is
// n <= 321024 / 139392 / 80256 / 50688 rows.  Beyond, one x tile is
// reloaded from global memory at each tile, as K2 does.
//
// If `ga` blocks cannot be co-resident the launch returns an error; there
// is no fallback.  The launch's size (device, SM count, occupancy) is
// queried on every launch.
// On request the kernel traces each block's %globaltimer at kStamps points
// of every step (`stamps`), which is how chip_smoke.py splits a step.

#include "anomaly_fit_persistent.cuh"

namespace anomaly {

// resident_tiles > 0: a block keeps all its x tiles in shared memory
// (room for resident_tiles of them); 0: one, reloaded at each tile.
template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
fit_kernel(const float* __restrict__ x, const float* __restrict__ noises,
           float sigma, float* w_enc, float* b_enc, float* w_dec,
           float* b_dec, unsigned char* image, float* partials,
           float* losses, float lr, float count, float inv_count, int n,
           int f, int steps, int ga, int resident_tiles, long long* stamps) {
  constexpr int R = kFitRows;
  constexpr int kTile = R * FP;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int block = blockIdx.x;
  const int tid = threadIdx.x;
  const PhaseA<FP> m(smem);
  const Staged img(image, FP);
  // x tiles [max(resident_tiles, 1)][R][FP], then noise [2][R][FP]
  float* xs = reinterpret_cast<float*>(smem + work_bytes(FP));
  float* nz = xs + kTile * max(resident_tiles, 1);
  const int tiles = (n + R - 1) / R;
  const int own = block < ga ? (tiles - block + ga - 1) / ga : 0;
  const int slices = (param_floats(f) + kFitSlice - 1) / kFitSlice;
  const size_t per_step = static_cast<size_t>(n) * f;
  // stamps [steps][kStamps][gridDim.x]: the block's clock (thread 0's) at
  // each point of the step; a block >= ga leaves phase A's points 1-5
  auto stamp = [&](int s, int k) {
    if (stamps != nullptr && tid == 0) {
      stamps[(s * kStamps + k) * gridDim.x + block] = global_ns();
    }
  };
  auto noise_of = [&](int s, int t) {
    return noises + s * per_step + static_cast<size_t>(t) * R * f;
  };
  auto rows_of = [&](int t) { return min(R, n - t * R); };

  if (block == 0) {
    stage_params<FP>(img, w_enc, b_enc, w_dec, b_dec, f, tid, kFitThreads);
  }
  if (own > 0) {
    for (int k = 0; resident_tiles > 0 && k < own; ++k) {
      const int t = block + k * ga;
      load_x<FP>(xs + k * kTile, x, t * R, rows_of(t), f, tid);
    }
    copy_async(nz, noise_of(0, block), rows_of(block) * f, tid);
    cp_async_commit();
  }
  grid.sync();

  int q = 0;   // tiles this block has taken: the noise buffer's parity
  for (int s = 0; s < steps; ++s) {
    stamp(s, 0);
    if (own > 0) {
      {
        const float* src = reinterpret_cast<const float*>(image);
        float* dst = reinterpret_cast<float*>(m.w.weT);
        copy_async(dst, src, static_cast<int>(staged_bytes(FP) / 4), tid);
        cp_async_commit();
      }
      Grads<FP> g = {};
      auto mark = [&](int k) { stamp(s, k); };
      for (int k = 0; k < own; ++k, ++q) {
        const int t = block + k * ga;
        const int rows = rows_of(t);
        // in flight: this tile's noise, and at k == 0 the weights after it
        if (k == 0) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();   // the copies landed; the last tile's readers done
        mark(1);
        float* xc = resident_tiles > 0 ? xs + k * kTile : xs;
        if (resident_tiles == 0) {   // each thread reads back only its own
          load_x<FP>(xc, x, t * R, rows, f, tid);
        }
        const float* nc = nz + (q & 1) * kTile;
        for (int idx = tid; idx < kTile; idx += kFitThreads) {
          const int i = idx / FP;
          const int j = idx - i * FP;
          const float nv =
              i < rows && j < f
                  ? __fadd_rn(xc[idx], __fmul_rn(sigma, nc[i * f + j]))
                  : 0.0f;
          m.xb[i * PhaseA<FP>::kLdk + j] = __float2bfloat16_rn(nv);
        }
        // the next tile's noise into the other buffer (an empty group
        // after the last step keeps the count of groups)
        const bool last = k + 1 == own;
        if (!last || s + 1 < steps) {
          const int t2 = last ? block : t + ga;
          copy_async(nz + ((q + 1) & 1) * kTile, noise_of(last ? s + 1 : s, t2),
                     rows_of(t2) * f, tid);
        }
        cp_async_commit();
        if (k == 0) cp_async_wait<1>();   // the weights
        __syncthreads();
        mark(2);
        fit_tile<FP>(m, xc, rows, f, inv_count, g, mark);
      }
      write_slot<FP>(m, g, partials, block, f, mark);
    }
    stamp(s, 6);
    grid.sync();
    stamp(s, 7);
    for (int sl = block; sl < slices; sl += gridDim.x) {
      fit_reduce<kFitWidth, kFitCols>(
          sl, tid, reinterpret_cast<float*>(smem), partials, ga, f, w_enc,
          b_enc, w_dec, b_dec, losses + s, lr, count, image, FP);
    }
    stamp(s, 8);
    grid.sync();
  }
}

template <int FP>
int fit(const float* x, const float* noises, float sigma, float* w_enc,
        float* b_enc, float* w_dec, float* b_dec, float* scratch,
        long long scratch_floats, float* losses, float lr, int n, int f,
        int steps, long long* stamps, long long stamps_len, cudaStream_t s) {
  static_assert(work_bytes(FP) >= sizeof(float) * kReduceGroups * kFitSlice,
                "phase B's groups fit in phase A's working set");
  static_assert(staged_bytes(FP) % 16 == 0, "the image copies in 16 bytes");
  int ga = fit_slots(n);
  const long long image_floats = staged_bytes(FP) / sizeof(float);
  if (steps < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      scratch_floats <
          image_floats + static_cast<long long>(ga) * param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kFitRows - 1) / kFitRows;
  int resident_tiles = 0;
  size_t smem = 0;
  shared_plan<FP>((tiles + ga - 1) / ga, &resident_tiles, &smem);
  int gb = 0;
  cudaError_t err = grid_blocks(reinterpret_cast<const void*>(fit_kernel<FP>),
                                ga, smem, &gb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stamps != nullptr && stamps_len < 1LL * kStamps * steps * gb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* image = reinterpret_cast<unsigned char*>(scratch);
  float* partials = scratch + image_floats;
  float count = static_cast<float>(n) * static_cast<float>(f);
  float inv_count = 1.0f / count;
  void* args[] = {&x,        &noises, &sigma,     &w_enc, &b_enc,
                  &w_dec,    &b_dec,  &image,     &partials,
                  &losses,   &lr,     &count,     &inv_count,
                  &n,        &f,      &steps,     &ga,
                  &resident_tiles,    &stamps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fit_kernel<FP>),
                                    dim3(gb), dim3(kFitThreads), args, smem,
                                    s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
}

}  // namespace anomaly

// Scratch: `scratch_floats` floats at a 16-byte aligned `scratch`: the
// staged image, staged_bytes(FP) (a whole number of floats), then the
// partial slots, min(ceil(n / R), 132) x (2 f 128 + 128 + f + 1) floats.
// `noises` is [steps, n, f]; `losses` gets one float per step, the loss
// before that step's update.  `stamps` is null, or `stamps_len` int64s
// for a trace of the phases: [steps][kStamps][the launch's blocks, the
// larger of the SM count and min(ceil(n / R), 132)], nanoseconds of
// %globaltimer.
extern "C" int anomaly_fit(const float* x, const float* noises, float sigma,
                           float* w_enc, float* b_enc, float* w_dec,
                           float* b_dec, float* scratch,
                           long long scratch_floats, float* losses, float lr,
                           int n, int f, int steps, long long* stamps,
                           long long stamps_len, void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 ? 0 : (f + 15) / 16) {
    case 1:
      return fit<16>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                     scratch_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    case 2:
      return fit<32>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                     scratch_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    case 3:
      return fit<48>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                     scratch_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    case 4:
      return fit<64>(x, noises, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                     scratch_floats, losses, lr, n, f, steps, stamps,
                     stamps_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
