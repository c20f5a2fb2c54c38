// The parts of the persistent fit launches that K3 (anomaly_fit.cu, one
// fit of one batch) and K5's one-launch fit (anomaly_fit_shard.cu, one fit
// over rows split into shards) share: the trace's clock, the cp.async
// copies, the x tile's load, the shared-memory plan and the grid's size.
// K5b's (anomaly_fit_model.cu, the hidden split over `model`) takes all
// of it but grid_blocks: its fold sizes its grid once per device.
// Both run `steps` x (phase A, grid.sync(), phase B, grid.sync()) in one
// cooperative launch of one 256-thread block per SM; see anomaly_fit.cu
// for the design.
#pragma once

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>

#include "anomaly_fit_phases.cuh"

namespace anomaly {

namespace cg = cooperative_groups;

constexpr int kFitWidth = kFitThreads / kReduceGroups;   // 32 threads
constexpr int kFitCols = 2;                              // columns each
constexpr int kFitSlice = kFitWidth * kFitCols;          // parameters
constexpr size_t kMaxSmem = 232448;   // 227 KB, a block's most on an H100
// The trace's points per step: the step's start; in phase A, the tile's
// noise on chip, noisy x and the weights on chip, the forward, dh/da and
// the weight sums; phase A's end (slot written); after the first barrier;
// after phase B
constexpr int kStamps = 9;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `count` floats from global `src` to shared `dst` (16-byte
// aligned), asynchronously: 16 bytes a copy where `src` and `count`
// allow, else 4.  Every thread of the block calls it.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int count, int tid) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (count & 3) == 0) {
    for (int c = tid; c < count / 4; c += kFitThreads) {
      cp_async16(dst + 4 * c, src + 4 * c);
    }
  } else {
    for (int c = tid; c < count; c += kFitThreads) {
      cp_async4(dst + c, src + c);
    }
  }
}

// The clean x tile at row0 (rows of them) into xc [R][FP], zeros past rows
// and f
template <int FP>
__device__ __forceinline__ void load_x(float* xc, const float* x, int row0,
                                       int rows, int f, int tid) {
  for (int idx = tid; idx < kFitRows * FP; idx += kFitThreads) {
    const int i = idx / FP;
    const int j = idx - i * FP;
    xc[idx] = i < rows && j < f
                  ? x[static_cast<size_t>(row0 + i) * f + j]
                  : 0.0f;
  }
}

// The x tiles a block keeps resident when the most any block walks in a
// step is `per_block` (0: one, reloaded at each tile) and the launch's
// shared memory: the working set (`work`: K3's and K5's, or K5b's fold's),
// the resident x tiles (or the one reloaded), two noise tiles.
template <int FP>
void shared_plan(int per_block, int* resident_tiles, size_t* smem,
                 size_t work = work_bytes(FP)) {
  const size_t base = work + 2 * tile_bytes(FP);
  if (base + per_block * tile_bytes(FP) <= kMaxSmem) {
    *resident_tiles = per_block;
    *smem = base + per_block * tile_bytes(FP);
  } else {
    *resident_tiles = 0;
    *smem = base + tile_bytes(FP);
  }
}

// The launch's blocks for ga phase-A blocks and `smem` bytes: one per SM,
// never fewer than ga; an error if ga blocks cannot be co-resident.  The
// device, its SM count and the occupancy are queried on every launch.
inline cudaError_t grid_blocks(const void* kernel, int ga, size_t smem,
                               int* gb) {
  // opted in once per device, to the most any n asks for
  cudaError_t err = opt_in_smem(kernel, kMaxSmem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kFitThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int resident = per_sm * sms;
  if (ga > resident) return cudaErrorCooperativeLaunchTooLarge;
  *gb = std::min(resident, std::max(ga, sms));
  return cudaSuccess;
}

}  // namespace anomaly
