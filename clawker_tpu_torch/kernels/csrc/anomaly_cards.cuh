// What lets one persistent launch per card run as one program over the
// cards of a host: peer access, enabled once per (device, peer) pair, and a
// barrier across cards inside the kernels.  K5b's route across cards
// (anomaly_fit_model.cu, anomaly_fit_model_cards) takes it; K5's route
// across cards can take the same.
//
// * Peer access (enable_peers): cudaDeviceEnablePeerAccess from the
//   current device to each peer, once per pair; the result is kept in a
//   table under a mutex, as opt_in_smem keeps its opt-in, so later calls
//   return it, a failure too.  A pair already enabled (by PyTorch's own
//   peer copies, say) counts as a success.  Peer access covers memory from
//   cudaMalloc, which PyTorch's caching allocator uses by default; the
//   wrapper (kernels/anomaly.py, cards_allocator_ok) takes the route only
//   then: not under expandable_segments, whose segments would need
//   cuMemSetAccess, nor under the cudaMallocAsync backend.
// * The barrier across cards (cards_sync): every thread that stored into
//   a peer's memory since the last barrier fences at system scope
//   (fence.acq_rel.sys: its stores are released before it arrives); a
//   grid.sync() on the card; then threads c < cards of block 0 each store
//   the barrier's number with release semantics at system scope into this
//   card's flag on card c (flags[c][me]) and spin with acquire loads at
//   system scope on card c's flag on this card (flags[me][c]) until it
//   holds that number; a grid.sync() ends it.  The spins read this card's
//   own memory; the stores are the only traffic across cards.  A flag is a
//   running count, never reset: a barrier's number is the count of
//   barriers that earlier launches over the same flags passed (`epoch`,
//   which the wrapper keeps and passes with each launch) plus this
//   barrier's own, so a store from an earlier launch never satisfies a
//   later barrier, whatever the order in which the stores land.  Data a
//   peer wrote before the barrier is read after it through L2 (__ldcg,
//   cp.async.cg), never through a stale L1 line.
// * A spin past kCardsDeadlineNs of %globaltimer traps: a card that never
//   arrives (lost, or its launch refused) becomes a CUDA error that the
//   next synchronize raises, never a hang and never a silent result.
#pragma once

#include <cstdint>
#include <mutex>
#include <vector>

#include "anomaly_fit_persistent.cuh"

namespace anomaly {

constexpr int kMaxCards = 8;   // cards of one launch set: an HGX node's
constexpr long long kCardsDeadlineNs = 10LL * 1000 * 1000 * 1000;   // 10 s

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The barrier across cards numbered `target` (see above): `flags[c]` is
// card c's array of kMaxCards flags, one per sender; `stored`: this thread
// stored into a peer's memory since the last barrier.  at_barrier() runs
// in every thread once this card's blocks have all arrived, before the
// wait across cards (a trace point).  Every thread of every block calls
// it.
template <class AtBarrier>
__device__ __forceinline__ void cards_sync(cg::grid_group& grid,
                                           unsigned long long* const* flags,
                                           int cards, int me,
                                           unsigned long long target,
                                           bool stored,
                                           AtBarrier at_barrier) {
  if (stored) asm volatile("fence.acq_rel.sys;" ::: "memory");
  grid.sync();
  at_barrier();
  if (blockIdx.x == 0 && threadIdx.x < cards) {
    const int c = threadIdx.x;
    st_release_sys(flags[c] + me, target);
    const unsigned long long* theirs = flags[me] + c;
    const long long deadline = global_ns() + kCardsDeadlineNs;
    while (ld_acquire_sys(theirs) < target) {
      if (global_ns() > deadline) __trap();
    }
  }
  grid.sync();
}

// Peer access from the current device to each of devices[0 .. count) but
// itself, once per pair (see above).  -> the first failure, or success.
inline cudaError_t enable_peers(const int* devices, int count) {
  struct Pair {
    int device;
    int peer;
    cudaError_t err;
  };
  static std::mutex mu;
  static std::vector<Pair> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < count; ++i) {
    const int peer = devices[i];
    if (peer == device) continue;
    const Pair* known = nullptr;
    for (const Pair& p : done) {
      if (p.device == device && p.peer == peer) known = &p;
    }
    if (known == nullptr) {
      int can = 0;
      err = cudaDeviceCanAccessPeer(&can, device, peer);
      if (err == cudaSuccess && !can) err = cudaErrorPeerAccessUnsupported;
      if (err == cudaSuccess) {
        err = cudaDeviceEnablePeerAccess(peer, 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
          cudaGetLastError();   // clear what we forgive
          err = cudaSuccess;
        }
      }
      if (err != cudaSuccess) cudaGetLastError();   // clear what we report
      done.push_back({device, peer, err});
      known = &done.back();
    }
    if (known->err != cudaSuccess) return known->err;
  }
  return cudaSuccess;
}

}  // namespace anomaly
