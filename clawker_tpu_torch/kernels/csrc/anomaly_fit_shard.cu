// K5: the (denoising) SGD fit of the anomaly autoencoder over a fleet
// whose rows are split into shards.  Three C entry points, two routes,
// chosen by the wrapper (kernels/anomaly.py) by layout, never by failure:
// * all the shards on one card: the whole fit as ONE persistent
//   cooperative launch (anomaly_fit_shard_fit), K3's design over the
//   shards' work items (below);
// * shards on several cards, and the single step of mesh.train_step /
//   denoise_step / graft_entry.dryrun_multichip on any layout: per step,
//   phase A once per shard (anomaly_fit_shard_partials), then phase B
//   once over all the shards' slots (anomaly_fit_shard_reduce): S + 1
//   launches a step, "the per-step route".
// The two give the same bits at every shape and shard count: the same
// slots, each the sum of the same tiles in the same order, reduced in the
// same fixed order.
//
// Replaces: clawker_tpu/analytics/anomaly.py:117-156 (fleet_mesh,
// shard_params, shard_batch, shard_noise) with the mesh-rounded row pad at
// clawker_tpu/analytics/runtime.py:170-172 and the placement at :187-194:
// the reference's ONE jitted fit run as an SPMD program over a data x model
// mesh, rows and noise rows over `data`, the gradient psum over `data`
// inserted by XLA.  Here, on a mesh with model = 1 (an odd count, or a
// data-only mesh), the rows are split over the shards and the params
// replicated.  The reference's split of the hidden dimension over `model`
// = 2 is K5b, anomaly_fit_model.cu.
//
// What bounds it on the H100: the fit's own work, whatever implements it
// (chip_smoke.py, fit_bound over N = sum of n_s rows): x read once, each
// step's noise once, the params in and out once, one loss per step, and
// steps x 22 N F H flops at the bf16 tensor rate.  What sets the time
// instead is latency, as in K3: each step's walk of a block over its row
// tiles, the slots' reduce and two grid-wide barriers.
//
// The one-launch fit (anomaly_fit_shard_fit):
// * The shard table is passed by value (__grid_constant__ ShardTable, at
//   most kMaxShards shards): each shard's x and noise pointers, the
//   noise's step stride, n_s and its first slot.  No copy to the device,
//   so the launch can be captured in a graph.  N = sum of n_s and
//   inv_count = 1 / (N F) are formed here as the per-step route forms
//   them (global_count).
// * Work items in the per-step route's slot order: slot i is shard s's
//   block b = i - slot0[s] of its ga_s = min(ceil(n_s / 32), 132), and
//   walks tiles b, b + ga_s, ... of shard s only, summing them into one
//   Grads in registers and writing slot i.  The grid is one block per SM
//   (K3's sizing, queried on every launch); block k takes slots k,
//   k + gb, ... in order, so where there are more slots than SMs (8 shards
//   of 528 rows: 136) a few blocks take two items one after the other.
// * Each step is K3's (anomaly_fit.cu): block 0 stages the bf16 image of
//   the weights in the prologue; a block keeps the x tiles of ALL its
//   items resident in shared memory while they fit (shared_plan over the
//   most tiles any block walks), else reloads one tile at a time; it
//   copies the staged image in with cp.async at each item (write_slot
//   assembles the slot over it); the next tile's noise is prefetched,
//   across items and into the next step; fit_tile, write_slot;
//   grid.sync(); phase B over the 64-parameter slices of all the slots
//   (fit_reduce, its long-runs form past 8 x 17 slots), which writes the
//   params, the staged image and loss[s]; grid.sync().  The same reads
//   go through L2 as in K3 (__ldcg, cp.async.cg).
// * If the grid cannot be one co-resident block per SM, or there are more
//   than kMaxShards shards, it returns an error; there is no fallback.
// * On request it traces K3's kStamps points of every step (`stamps`);
//   points 1-5 are those of each block's last item of the step.
//
// The per-step route:
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
//   bit-identical, since they are copies of one result.
// * The step's loss goes to loss_out, as K2 writes it; K3's staged image is
//   not used (fit_reduce with staged = null writes only the params).

#include <vector>

#include "anomaly_fit_persistent.cuh"

namespace anomaly {

constexpr int kShardSlice = 64;     // parameters per launch-B block
constexpr int kMaxShards = 64;      // the one-launch fit's shard table

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

// The shards of one fit, by value in the kernel's parameter space
struct ShardTable {
  const float* x[kMaxShards];       // shard s's [n_s, f] rows
  const float* noise[kMaxShards];   // its [steps, n_s, f] noise
  long long stride[kMaxShards];     // floats from one step's noise to the next
  int rows[kMaxShards];             // n_s
  int slot0[kMaxShards];            // its first slot: sum of ga_r, r < s
  int shards;
};

// One work item, slot `slot`: the per-step route's launch A of shard
// `shard`, block b of its ga, which walks `count` tiles b, b + ga, ...
struct Item {
  int shard;
  int b;
  int ga;
  int count;
};

__host__ __device__ inline Item item_of(const ShardTable& t, int slot) {
  int s = 0;
  while (s + 1 < t.shards && t.slot0[s + 1] <= slot) ++s;
  const int tiles = (t.rows[s] + kFitRows - 1) / kFitRows;
  const int ga = fit_slots(t.rows[s]);
  const int b = slot - t.slot0[s];
  return {s, b, ga, (tiles - b + ga - 1) / ga};
}

// resident_tiles > 0: a block keeps the x tiles of all its items in
// shared memory (room for resident_tiles of them); 0: one, reloaded at
// each tile.
template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
shard_fit_kernel(const __grid_constant__ ShardTable table, float sigma,
                 float* w_enc, float* b_enc, float* w_dec, float* b_dec,
                 unsigned char* image, float* partials, float* losses,
                 float lr, float count, float inv_count, int f, int steps,
                 int total_slots, int resident_tiles, long long* stamps) {
  constexpr int R = kFitRows;
  constexpr int kTile = R * FP;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int block = blockIdx.x;
  const int gb = gridDim.x;
  const int tid = threadIdx.x;
  const PhaseA<FP> m(smem);
  const Staged img(image, FP);
  // x tiles [max(resident_tiles, 1)][R][FP], then noise [2][R][FP]
  float* xs = reinterpret_cast<float*>(smem + work_bytes(FP));
  float* nz = xs + kTile * max(resident_tiles, 1);
  // this block's items: slots block, block + gb, ...
  const int items =
      block < total_slots ? (total_slots - block + gb - 1) / gb : 0;
  const int slices = (param_floats(f) + kFitSlice - 1) / kFitSlice;
  const bool long_runs = total_slots > kReduceGroups * kReduceRun;
  // stamps [steps][kStamps][gb], as K3's
  auto stamp = [&](int s, int k) {
    if (stamps != nullptr && tid == 0) {
      stamps[(s * kStamps + k) * gb + block] = global_ns();
    }
  };
  auto rows_of = [&](int sh, int t) { return min(R, table.rows[sh] - t * R); };
  auto noise_of = [&](int s, int sh, int t) {
    return table.noise[sh] + s * table.stride[sh] +
           static_cast<size_t>(t) * R * f;
  };

  if (block == 0) {
    stage_params<FP>(img, w_enc, b_enc, w_dec, b_dec, f, tid, kFitThreads);
  }
  if (items > 0) {
    for (int j = 0, r = 0; resident_tiles > 0 && j < items; ++j) {
      const Item it = item_of(table, block + j * gb);
      for (int k = 0; k < it.count; ++k, ++r) {
        const int t = it.b + k * it.ga;
        load_x<FP>(xs + r * kTile, table.x[it.shard], t * R,
                   rows_of(it.shard, t), f, tid);
      }
    }
    const Item first = item_of(table, block);
    copy_async(nz, noise_of(0, first.shard, first.b),
               rows_of(first.shard, first.b) * f, tid);
    cp_async_commit();
  }
  grid.sync();

  int q = 0;   // tiles this block has taken: the noise buffer's parity
  for (int s = 0; s < steps; ++s) {
    stamp(s, 0);
    auto mark = [&](int k) { stamp(s, k); };
    for (int j = 0, r = 0; j < items; ++j) {
      const int slot = block + j * gb;
      const Item it = item_of(table, slot);
      // the last item's slot stores have read the working set, over which
      // the weights land
      if (j > 0) __syncthreads();
      {
        const float* src = reinterpret_cast<const float*>(image);
        float* dst = reinterpret_cast<float*>(m.w.weT);
        copy_async(dst, src, static_cast<int>(staged_bytes(FP) / 4), tid);
        cp_async_commit();
      }
      Grads<FP> g = {};
      for (int k = 0; k < it.count; ++k, ++q, ++r) {
        const int t = it.b + k * it.ga;
        const int rows = rows_of(it.shard, t);
        // in flight: this tile's noise, and at k == 0 the weights after it
        if (k == 0) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();   // the copies landed; the last tile's readers done
        mark(1);
        float* xc = resident_tiles > 0 ? xs + r * kTile : xs;
        if (resident_tiles == 0) {   // each thread reads back only its own
          load_x<FP>(xc, table.x[it.shard], t * R, rows, f, tid);
        }
        const float* nc = nz + (q & 1) * kTile;
        for (int idx = tid; idx < kTile; idx += kFitThreads) {
          const int i = idx / FP;
          const int c = idx - i * FP;
          const float nv =
              i < rows && c < f
                  ? __fadd_rn(xc[idx], __fmul_rn(sigma, nc[i * f + c]))
                  : 0.0f;
          m.xb[i * PhaseA<FP>::kLdk + c] = __float2bfloat16_rn(nv);
        }
        // the next tile's noise into the other buffer: this item's next
        // tile, the next item's first, or step s + 1's first (an empty
        // group after the last step keeps the count of groups)
        int s2 = s;
        int sh2 = it.shard;
        int t2 = t + it.ga;
        bool next = true;
        if (k + 1 == it.count) {
          const bool more = j + 1 < items;
          next = more || s + 1 < steps;
          const Item nx = item_of(table, more ? slot + gb : block);
          s2 = more ? s : s + 1;
          sh2 = nx.shard;
          t2 = nx.b;
        }
        if (next) {
          copy_async(nz + ((q + 1) & 1) * kTile, noise_of(s2, sh2, t2),
                     rows_of(sh2, t2) * f, tid);
        }
        cp_async_commit();
        if (k == 0) cp_async_wait<1>();   // the weights
        __syncthreads();
        mark(2);
        fit_tile<FP>(m, xc, rows, f, inv_count, g, mark);
      }
      write_slot<FP>(m, g, partials, slot, f, mark);
    }
    stamp(s, 6);
    grid.sync();
    stamp(s, 7);
    for (int sl = block; sl < slices; sl += gb) {
      float* red = reinterpret_cast<float*>(smem);
      if (long_runs) {
        fit_reduce<kFitWidth, kFitCols, true>(
            sl, tid, red, partials, total_slots, f, w_enc, b_enc, w_dec,
            b_dec, losses + s, lr, count, image, FP);
      } else {
        fit_reduce<kFitWidth, kFitCols>(
            sl, tid, red, partials, total_slots, f, w_enc, b_enc, w_dec,
            b_dec, losses + s, lr, count, image, FP);
      }
    }
    stamp(s, 8);
    grid.sync();
  }
}

// The most x tiles one block walks in a step when `gb` blocks take the
// slots k, k + gb, ... (kernels/anomaly.py shard_fit_plan is its twin)
inline int most_block_tiles(const ShardTable& t, int total_slots, int gb) {
  std::vector<int> tiles(gb, 0);
  for (int slot = 0; slot < total_slots; ++slot) {
    tiles[slot % gb] += item_of(t, slot).count;
  }
  return *std::max_element(tiles.begin(), tiles.end());
}

template <int FP>
int shard_fit(const ShardTable& table, int n_total, float sigma,
              float* w_enc, float* b_enc, float* w_dec, float* b_dec,
              float* scratch, long long scratch_floats, float* losses,
              float lr, int f, int steps, long long* stamps,
              long long stamps_len, cudaStream_t s) {
  static_assert(work_bytes(FP) >= sizeof(float) * kReduceGroups * kFitSlice,
                "phase B's groups fit in phase A's working set");
  static_assert(staged_bytes(FP) % 16 == 0, "the image copies in 16 bytes");
  const int last = table.shards - 1;
  int total_slots = table.slot0[last] + fit_slots(table.rows[last]);
  const long long image_floats = staged_bytes(FP) / sizeof(float);
  if (steps < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      scratch_floats < image_floats + static_cast<long long>(total_slots) *
                                          param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one block per SM, planned before the launch's occupancy is known
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident_tiles = 0;
  size_t smem = 0;
  shared_plan<FP>(most_block_tiles(table, total_slots, sms), &resident_tiles,
                  &smem);
  int gb = 0;
  err = grid_blocks(reinterpret_cast<const void*>(shard_fit_kernel<FP>),
                    std::min(total_slots, sms), smem, &gb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gb != sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (stamps != nullptr && stamps_len < 1LL * kStamps * steps * gb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* image = reinterpret_cast<unsigned char*>(scratch);
  float* partials = scratch + image_floats;
  float count = global_count(n_total, f);
  float inv_count = 1.0f / count;
  void* args[] = {const_cast<ShardTable*>(&table), &sigma, &w_enc, &b_enc,
                  &w_dec, &b_dec, &image, &partials, &losses, &lr, &count,
                  &inv_count, &f, &steps, &total_slots, &resident_tiles,
                  &stamps};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(shard_fit_kernel<FP>), dim3(gb),
      dim3(kFitThreads), args, smem, s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
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

// The whole fit over `shards` shards of one card in one launch: `table`
// holds shards x 4 int64, for each shard in shard order its x pointer
// ([n_s, f] floats), its noise pointer ([steps, n_s, f], each step's rows
// contiguous), the floats from one step's noise to the next, and n_s.
// Scratch: `scratch_floats` floats at a 16-byte aligned `scratch`: the
// staged image, staged_bytes(FP), then every shard's slots back to back,
// sum of min(ceil(n_s / 32), 132) x (2 f 128 + 128 + f + 1) floats.
// `losses` gets one float per step, the loss before that step's update.
// `stamps` is null, or `stamps_len` int64s for a trace of the phases:
// [steps][kStamps][the SM count], nanoseconds of %globaltimer.
extern "C" int anomaly_fit_shard_fit(const long long* table, int shards,
                                     float sigma, float* w_enc, float* b_enc,
                                     float* w_dec, float* b_dec,
                                     float* scratch, long long scratch_floats,
                                     float* losses, float lr, int f,
                                     int steps, long long* stamps,
                                     long long stamps_len, void* stream) {
  using namespace anomaly;
  if (table == nullptr || shards < 1 || shards > kMaxShards || f < 1 ||
      f > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ShardTable t = {};
  t.shards = shards;
  long long n_total = 0;
  int slot = 0;
  for (int sh = 0; sh < shards; ++sh) {
    const long long* e = table + 4 * sh;
    t.x[sh] = reinterpret_cast<const float*>(static_cast<uintptr_t>(e[0]));
    t.noise[sh] =
        reinterpret_cast<const float*>(static_cast<uintptr_t>(e[1]));
    t.stride[sh] = e[2];
    if (t.x[sh] == nullptr || t.noise[sh] == nullptr || e[3] < 1 ||
        e[3] > (1 << 30) || e[2] < e[3] * f) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.rows[sh] = static_cast<int>(e[3]);
    t.slot0[sh] = slot;
    slot += fit_slots(t.rows[sh]);
    n_total += e[3];
  }
  if (n_total > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(n_total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((f + 15) / 16) {
    case 1:
      return shard_fit<16>(t, n, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                           scratch_floats, losses, lr, f, steps, stamps,
                           stamps_len, s);
    case 2:
      return shard_fit<32>(t, n, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                           scratch_floats, losses, lr, f, steps, stamps,
                           stamps_len, s);
    case 3:
      return shard_fit<48>(t, n, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                           scratch_floats, losses, lr, f, steps, stamps,
                           stamps_len, s);
    default:
      return shard_fit<64>(t, n, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
                           scratch_floats, losses, lr, f, steps, stamps,
                           stamps_len, s);
  }
}
