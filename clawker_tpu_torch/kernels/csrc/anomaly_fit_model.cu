// K5b: the (denoising) SGD fit of the anomaly autoencoder with the rows
// split over `data` and the hidden dimension split over `model` = 2, the
// reference's mesh layout.  Five C entry points, three routes, chosen by
// the wrapper (kernels/anomaly.py, model_route) from the layout and the
// host before any launch, never by failure:
// * all the shards on one card: the whole fit as ONE persistent
//   cooperative launch (anomaly_fit_model_fit), "the fold" (below);
// * shards on several cards, every pair of which has peer access: the
//   whole fit as one persistent cooperative launch PER CARD, all running
//   at once (anomaly_fit_model_cards), "the cards route" (below);
// * shards on several cards without peer access between some pair, and
//   the single step of mesh.train_step / denoise_step /
//   graft_entry.dryrun_multichip: per step, the forward once per shard
//   (anomaly_fit_model_forward), the partials once per shard
//   (anomaly_fit_model_partials), then phase B once per half
//   (anomaly_fit_model_reduce): 2 S + 2 launches a step, with the host
//   copying y, the slots and the params between cards, "the per-step
//   route".
//
// Replaces: clawker_tpu/analytics/anomaly.py:132-145 (shard_params on
// fleet_mesh with model = 2: w_enc P(None, "model"), b_enc P("model"),
// w_dec P("model", None), b_dec replicated) with shard_batch/shard_noise
// (:148-156, rows over `data` only) and the jitted fit over that mesh
// (clawker_tpu/analytics/runtime.py:170-194).  Shard (d, m) holds half m
// of the hidden units, H/2 = 64, and the rows of data block d; both model
// shards of a data block see the same rows.  Per step, following
// anomaly.py:43-55 and :96-113 with the hidden split:
//   1. shard (d, m): a_m = bf(noisy) . bf(W_enc_m) + b_enc_m (fp32 sums),
//      h_m = gelu(a_m), the partial y_m = bf(h_m) . bf(W_dec_m);
//   2. the reduce over `model`: r = (y_0 + y_1) + b_dec;
//   3. e = r - x, dr = 2 e / (N F) over the whole batch's N, the loss;
//   4. each half's backward on its own columns: dW_dec_m = bf(h_m)^T dr,
//      dh_m = bf(dr . bf(W_dec_m)^T), da_m = dh_m gelu'(a_m),
//      dW_enc_m = bf(noisy)^T da_m, db_enc_m and db_dec as sums;
//   5. phase B: each half's slots summed over `data` in a fixed order, that
//      half's params updated.  Both halves form the same dr (the same y_0 +
//      y_1, the same b_dec), so their db_dec sums, and their b_dec after the
//      update, are the same bits; the loss is half 0's.
//
// The per-step route and the fold run different work items (the cards
// route runs the fold's).  A slot of a half is [dW_enc_m
// [F][64] | db_enc_m [64] | dW_dec_m^T [F][64] | db_dec [F] | loss]; slot
// i of a half is data block d's block b = i - slot0[d] of its ga_d =
// min(ceil(n_d / 32), 132), which walks the row tiles b, b + ga_d, ... of
// block d; half m's slots lie at m x half_slots (data order, then block
// order), as the reduce reads them.
// * The per-step route's work item is one half of one slot: the forward
//   launch writes y_m [N][F] to global memory, and the partials launch runs
//   the half's forward again, reads the peer's y through L2 and goes on with
//   dr and the half's backward.  It is the reference for the bits and the
//   route across cards without peer access.
// * The fold's work item is one slot with BOTH halves: per row tile the
//   block runs half 0's forward (its epilogue keeps y_0 in shared memory),
//   half 1's forward (its epilogue forms r = y_1 + y_0 + b_dec, e, the
//   squared error and dr), then half 0's backward into its sums and half
//   1's into its own, and at the item's end writes the two slots.  No y
//   goes to global memory, no forward runs twice, and a step has two grid
//   barriers (phase A | phase B |), K5's, where the per-step route's
//   three phases would need three.
// They give the same bits: each slot is the sum of the same tiles in the
// same order, each tile's terms from the same device functions
// (forward_tile at a width of 64, backward_tile, write_half_slot) on the
// same inputs; r is formed from the same two 64-wide passes (y_1 + y_0 is
// y_0 + y_1 in fp32: one rounded add), where one 128-wide pass would sum
// y in another order; the squared error of both slots is that one sum,
// and phase B is the same fit_reduce over the same slots.  The fold reads
// b_dec from half 0 alone: the halves hold the same bits (shard_params
// gives each the whole b_dec, and every update keeps them equal).
//
// What bounds it on the H100: the fit's own work, as K5 (chip_smoke.py,
// fit_bound over N rows): 0.046 ms for 120 steps at [4224, 32], by the
// bf16 tensor products.  What sets the time instead is latency, as in K3
// and K5: a block's walk over its tiles, the slots' reduce and the grid
// barriers.  The per-step route's items were half a row tile each, two a
// block a phase at the timed meshes (2x2 and 4x2: 264 of them), each
// paying a tile's whole fixed cost for half its math, behind a third
// barrier.  The fold has 132 items there, one a block, each with the math
// of a K5 item, so a step is K5's: phase A, a barrier, phase B, a
// barrier.
//
// The fold (anomaly_fit_model_fit):
// * The data blocks' table and the halves' pointers are passed by value
//   (__grid_constant__ ModelTable, Halves; at most kMaxData blocks): no
//   copy to the device.  One block per SM (queried once per device and FP,
//   persistent_grid); block k takes slots k, k + gb, ... in order.
// * Shared memory (fold_work_bytes): both halves' staged weights, each
//   half's gelu'(a), gelu and da, one dr and its three bf16 terms, one
//   bf(noisy); then K5's plan (shared_plan): the x tiles of all the
//   block's items resident while they fit, else one reloaded a tile, and
//   two noise tiles, the next one prefetched with cp.async across items
//   and steps.
// * The weights come from K3's STAGED IMAGE, one a half (StagedAt<64>, in
//   the scratch): blocks 0 and 1 build them from the fp32 params in the
//   prologue; at each step's start a block copies both with cp.async
//   (16-byte copies through L2, no conversion), behind its first tile's
//   noise; phase B writes each updated param into its half's image.
//   Staging both halves from fp32 in every block took 2.6-3.0 us a step
//   on an H100 at F = 32.
// * Phase B is fit_reduce at a width of 64 over each half's slots, in
//   K5's short runs while a half has at most 8 x 17 slots (the same sums
//   as its long runs, which the per-step reduce takes: phase B took 9.6
//   us a step in them against 2.4 at 132 slots of F = 32 on an H100),
//   then its long runs.
// * On request it traces kStamps points of every step (`stamps`, K3's and
//   K5's format): 0 the step's start; of the block's last tile 1 its noise
//   on chip, 2 noisy x and the weights on chip, 3 both forwards, 4 half
//   0's backward, 5 half 1's; 6 the slots written; 7 after the first
//   barrier; 8 after phase B.
// * If one block of the most shared memory cannot sit on an SM, or there
//   are more than kMaxData data blocks, it returns an error; there is no
//   fallback.
//
// The cards route (anomaly_fit_model_cards): the reference runs the
// sharded fit as ONE SPMD program whose psums XLA places inside it, with no
// host in the loop (clawker_tpu/analytics/runtime.py:170-194); this is its
// counterpart, one persistent launch per card, each on that card's current
// stream, that work as one program through peer access and a barrier
// across cards (anomaly_cards.cuh).  It replaces the per-step route across
// cards, whose host ordered some twenty copies between cards a step.
// * Work: the fold's items.  Data block d's ga_d slots are split evenly,
//   a contiguous run each, over the distinct cards that hold its shards
//   (card_items; on the fleet mesh cards (d, 0) and (d, 1)).  A card's
//   blocks take its items j, j + gb, ... and run the fold's phase A on them
//   (fold_phase_a: x tiles resident or reloaded, the noise prefetched, both
//   halves' forwards, r, dr, both backwards).
// * Params: a card needs both halves.  It updates the params sets it holds
//   in place; of a half it holds none of, it copies the fp32 params from a
//   peer's set into its scratch at the fit's start (peer loads, once a
//   fit) and keeps that copy updated, so that at the fit's end every card
//   holds both halves, the copy for as long as its scratch lives.  Its
//   images of both halves are its own.
// * Phase B by a replicated reduce: each item assembles its two slots once
//   and stores them into EVERY card's slots (peer stores over NVLink);
//   then one barrier across cards; then every card runs the fold's phase B
//   (fold_phase_b) over all the slots in its own memory into its own
//   params and images.  Each slot is the sum of the same tiles in the same
//   order as the fold's, and every card sums the same slots in slot order,
//   so every card ends with the fold's bits and the per-step route's.  The
//   slots alternate between two parities by step: a card that has passed
//   step s's barrier may store step s + 1's slots while a slower card
//   still reduces step s's.  One barrier across cards a step; the other
//   design, a reduce-scatter (card c reduces slices c, c + C, ... reading
//   its peers' slots, then stores the params into every card's copy), needs
//   a second one and puts peer loads on phase B's latency.
// * Barriers across cards: one at the start (every card's launch has
//   begun, so no card stores into scratch a peer's stream still uses, or
//   reads params a peer's stream still writes), one a step, one at the end
//   (no card's kernel exits, and its stream frees its scratch, while a peer
//   may still touch it): steps + 2 a launch.  The loss is written by the
//   card that holds `losses`, the others' to their scratch's last float.
// * Trace (`stamps`, [steps][kCardStamps][the SM count] on each card): the
//   fold's points 0-6, then 7 this card's blocks all at the barrier across
//   cards, 8 past it, 9 after phase B: 8 - 7 is the wait for the peers.
// * At most kMaxCards cards and kMaxData data blocks; a refused peer
//   enable, grid or launch returns its error, and a barrier past its
//   deadline traps: no fallback.

#include "anomaly_cards.cuh"

namespace anomaly {

constexpr int kModel = 2;                 // model shards
constexpr int kHalf = kHidden / kModel;   // hidden units a model shard holds
constexpr int kLdq = kHalf + 8;           // row stride of the [.][kHalf]
                                          // arrays: (kLdq / 2) % 8 == 4
constexpr int kMaxData = 32;              // data blocks in the fold's
                                          // table: 64 shards
constexpr int kHalfSlice = 64;            // parameters per reduce block

__host__ __device__ constexpr int half_floats(int f) {
  // dW_enc_m [f][kHalf], db_enc_m [kHalf], dW_dec_m^T [f][kHalf], db_dec [f],
  // loss sum
  return 2 * f * kHalf + kHalf + f + 1;
}

// A half's staged weights, one layout in shared memory:
//   weT bf16 [kHalf][FP+8]  row h = bf(W_enc_m[:, h]), zeros past f
//   wdT bf16 [FP][kLdq]     row j = bf(W_dec_m[:, j]), zero rows past f
//   be  fp32 [kHalf], bd fp32 [FP] (zeros past f)
__host__ __device__ constexpr size_t half_staged_bytes(int fp) {
  return sizeof(__nv_bfloat16) * (kHalf * (fp + 8) + fp * kLdq) +
         sizeof(float) * (kHalf + fp);
}

// The per-step route's working set (K5's PhaseA at half width), then the
// clean x tile [R][FP]:
//   as [R][kLdq] gelu'(a), then da | dr [R][FP+1] | red [8] | staged |
//   xb [R][FP+8] | gs [R][kLdq] | drs [3][R][FP+8] | das [3][R][kLdq]
__host__ __device__ constexpr size_t model_work_bytes(int fp) {
  return sizeof(float) * (kFitRows * kLdq + kFitRows * (fp + 1) +
                          kFitThreads / 32) +
         half_staged_bytes(fp) +
         sizeof(__nv_bfloat16) * (4 * kFitRows * (fp + 8) +
                                  4 * kFitRows * kLdq);
}

__host__ __device__ constexpr size_t model_smem_bytes(int fp) {
  return model_work_bytes(fp) + tile_bytes(fp);
}

// Where the tile's arrays (xb on) begin: after the fp32 arrays and the
// staged weights
__host__ __device__ constexpr size_t model_tile_offset(int fp) {
  return sizeof(float) * (kFitRows * kLdq + kFitRows * (fp + 1) +
                          kFitThreads / 32) +
         half_staged_bytes(fp);
}

template <int FP>
struct PhaseM {
  static constexpr int kLdk = FP + 8;
  static constexpr int kDs = FP + 1;
  // the bytes from xb on, over which write_half_slot assembles a slot
  static constexpr size_t kSlotRoom =
      model_smem_bytes(FP) - model_tile_offset(FP);
  float* as;
  float* dr;
  float* red;
  __nv_bfloat16* weT;
  __nv_bfloat16* wdT;
  float* be;
  float* bd;
  __nv_bfloat16* xb;
  __nv_bfloat16* gs;
  __nv_bfloat16* drs;
  __nv_bfloat16* das;
  float* xc;
  __device__ explicit PhaseM(unsigned char* smem)
      : as(reinterpret_cast<float*>(smem)),
        dr(as + kFitRows * kLdq),
        red(dr + kFitRows * kDs),
        weT(reinterpret_cast<__nv_bfloat16*>(red + kFitThreads / 32)),
        wdT(weT + kHalf * kLdk),
        be(reinterpret_cast<float*>(wdT + FP * kLdq)),
        bd(be + kHalf),
        xb(reinterpret_cast<__nv_bfloat16*>(bd + FP)),
        gs(xb + kFitRows * kLdk),
        drs(gs + kFitRows * kLdq),
        das(drs + 3 * kFitRows * kLdk),
        xc(reinterpret_cast<float*>(smem + model_work_bytes(FP))) {}
};

// A block's unrounded gradient sums of one half, in registers.  Warp w
// owns hidden columns 16 (w % 4) .. + 15 and feature tiles mt = w / 4 + 2 q
// of both weight sums (we[q][nt], wd[q][nt]: mma.sync C fragments); thread
// tid < kHalf sums db_enc_m[tid], thread kHalf + j < kHalf + FP db_dec[j].
template <int FP>
struct HalfGrads {
  static constexpr int kMt = FP / 16;
  static constexpr int kQ = (kMt + 1) / 2;
  float we[kQ][2][4];
  float wd[kQ][2][4];
  float bias;
  float sq;
};

// stage_transposed's dst[n][k] = bf(src[k][n]) (k < K, n < N, zeros up to
// KP x NP) with the same pairs to the same lanes, but a thread's loads all
// issued before its stores: the params are read through L2 at every step,
// and one round trip a thread costs less than one a pair.
template <int KP, int NP>
__device__ __forceinline__ void stage_pairs(__nv_bfloat16* dst, int ld,
                                            const float* src, int lds, int K,
                                            int N, int tid) {
  constexpr int kPairs = NP * KP / 2;
  constexpr int kPer = (kPairs + kFitThreads - 1) / kFitThreads;
  constexpr int kBlocks = NP / 8;
  float v[kPer][2];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int w = tid + q * kFitThreads;
    const int lane = w & 31;
    const int n = ((w >> 5) % kBlocks) * 8 + (lane >> 2);
    const int k = ((w >> 5) / kBlocks) * 8 + 2 * (lane & 3);
    const bool in = w < kPairs && n < N;
    v[q][0] = in && k < K ? __ldcg(src + k * lds + n) : 0.0f;
    v[q][1] = in && k + 1 < K ? __ldcg(src + (k + 1) * lds + n) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int w = tid + q * kFitThreads;
    const int lane = w & 31;
    const int n = ((w >> 5) % kBlocks) * 8 + (lane >> 2);
    const int k = ((w >> 5) / kBlocks) * 8 + 2 * (lane & 3);
    if (w < kPairs) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * ld + k) =
          __floats2bfloat162_rn(v[q][0], v[q][1]);
    }
  }
}

// Half m's weights staged from its fp32 params (read through L2: phase B of
// the step before wrote them, in other blocks) into `m`'s weT, wdT, be and
// bd: a PhaseM's (the per-step route), or the fold's image of the half
// (StagedAt<kHalf>).  Every thread of the block calls it.
template <int FP, class Staging>
__device__ __forceinline__ void stage_half(const Staging& m,
                                           const float* w_enc,
                                           const float* b_enc,
                                           const float* w_dec,
                                           const float* b_dec, int f,
                                           int tid) {
  stage_pairs<FP + 8, kHalf>(m.weT, FP + 8, w_enc, kHalf, f, kHalf, tid);
  stage_pairs<kLdq, FP>(m.wdT, kLdq, w_dec, f, kHalf, f, tid);
  for (int i = tid; i < kHalf + FP; i += kFitThreads) {
    if (i < kHalf) {
      m.be[i] = __ldcg(b_enc + i);
    } else {
      m.bd[i - kHalf] = i - kHalf < f ? __ldcg(b_dec + i - kHalf) : 0.0f;
    }
  }
}

// Tile rows row0.. (rows of them): the clean x into xc, bf(noisy) into xb,
// zeros past rows and f; noise null is the plain autoencoder step.  With
// y_peer (the other half's partial output of the same rows, read through
// L2), its [i][j] goes to dr[i][j], where the forward's epilogue reads it
// before it writes dr there.  A thread's loads are all issued before its
// stores.
template <int FP>
__device__ __forceinline__ void load_tile(const PhaseM<FP>& m,
                                          const float* x, const float* noise,
                                          const float* y_peer, float sigma,
                                          int row0, int rows, int f,
                                          int tid) {
  constexpr int kPer = kFitRows * FP / kFitThreads;
  static_assert(kPer * kFitThreads == kFitRows * FP, "whole passes");
  float xv[kPer];
  float nv[kPer];
  float yv[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = tid + q * kFitThreads;
    const int i = idx / FP;
    const int j = idx - i * FP;
    const bool in = i < rows && j < f;
    const size_t gi = static_cast<size_t>(row0 + i) * f + j;
    xv[q] = in ? x[gi] : 0.0f;
    nv[q] = in && noise ? noise[gi] : 0.0f;
    yv[q] = in && y_peer ? __ldcg(y_peer + gi) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = tid + q * kFitThreads;
    const int i = idx / FP;
    const int j = idx - i * FP;
    const bool in = i < rows && j < f;
    float v = xv[q];
    if (in && noise) v = __fadd_rn(xv[q], __fmul_rn(sigma, nv[q]));
    m.xc[idx] = xv[q];
    m.xb[i * PhaseM<FP>::kLdk + j] = __float2bfloat16_rn(v);
    if (in && y_peer) m.dr[i * PhaseM<FP>::kDs + j] = yv[q];
  }
}

// The per-step route's forward of shard (d, m), block b of ga over data
// block d's n rows (x, noise at its first row), half m's params: writes y_m
// of its tiles' rows to y (the half's [n][f] rows of block d).
template <int FP>
__device__ void forward_item(const PhaseM<FP>& m, const float* x,
                             const float* noise, float sigma,
                             const float* w_enc, const float* b_enc,
                             const float* w_dec, const float* b_dec, float* y,
                             int n, int b, int ga, int f) {
  constexpr int R = kFitRows;
  const int tid = threadIdx.x;
  stage_half<FP>(m, w_enc, b_enc, w_dec, b_dec, f, tid);
  const int tiles = (n + R - 1) / R;
  for (int t = b; t < tiles; t += ga) {
    const int row0 = t * R;
    const int rows = min(R, n - row0);
    __syncthreads();   // the last tile's readers are done
    load_tile<FP>(m, x, noise, nullptr, sigma, row0, rows, f, tid);
    __syncthreads();
    forward_tile<R, kFitThreads / 32, kHalf>(
        m.xb, PhaseM<FP>::kLdk, FP, m.weT, PhaseM<FP>::kLdk, m.be, nullptr,
        kLdq, m.gs, kLdq, m.wdT, kLdq, FP, tid >> 5, tid & 31,
        [&](int i, int j, float acc) {
          if (i < rows && j < f) {
            y[static_cast<size_t>(row0 + i) * f + j] = acc;
          }
        });
  }
}

// dh/da, the bias sums and the weight sums of one tile of half m, after
// the forward's epilogue wrote dr, drs, as (gelu'(a)), gs and xb (synced).
// `m` is the half's view of shared memory: a PhaseM (the per-step route) or
// a FoldHalf (the fold).  One barrier inside, none at the end.
template <int FP, class Phase>
__device__ __forceinline__ void backward_tile(const Phase& m, int rows,
                                              HalfGrads<FP>& g) {
  constexpr int R = kFitRows;
  constexpr int kLdk = FP + 8;
  constexpr int kDs = FP + 1;
  constexpr int kMt = HalfGrads<FP>::kMt;
  constexpr int kQ = HalfGrads<FP>::kQ;
  static_assert(R == 32 && kFitThreads / 32 == 8 && kHalf == 64,
                "8 warps: 4 column blocks of 16 x 2 row or feature groups");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int h0 = 16 * (warp & 3);
  const int rg = warp >> 2;

  // dh = dr . bf(W_dec_m)^T (B[j][h] = wdT[j][h]) over the tile's row tile
  // rg, the row's full sum over F rounded to bf16; da = dh * gelu'(a)
  // overwrites gelu'(a), and goes to das
  {
    float acc[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < FP; k0 += 16) {
      uint32_t b[4];
      load_b2_trans(b, m.wdT, kLdq, h0, k0, lane);
#pragma unroll
      for (int u = 2; u >= 0; --u) {   // lo, mid, hi
        uint32_t a[4];
        load_a(a, m.drs + u * R * kLdk, kLdk, 16 * rg, k0, lane);
        mma_bf16_16816(acc[0], a, b);
        mma_bf16_16816(acc[1], a, b + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * rg + gq + 8 * half;
        const int h = h0 + 8 * nt + t2;
        float2* ap = reinterpret_cast<float2*>(m.as + i * kLdq + h);
        float2 a = *ap;
        a.x = __fmul_rn(bf(acc[nt][2 * half]), a.x);
        a.y = __fmul_rn(bf(acc[nt][2 * half + 1]), a.y);
        *ap = a;
        const Split3 s0(a.x);
        const Split3 s1(a.y);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          __nv_bfloat162 v;
          v.x = s0.t[u];
          v.y = s1.t[u];
          *reinterpret_cast<__nv_bfloat162*>(m.das + (u * R + i) * kLdq + h) =
              v;
        }
      }
    }
  }
  __syncthreads();

  // the bias sums, fp32 over the rows in order
  if (tid < kHalf) {
    for (int i = 0; i < rows; ++i) g.bias = __fadd_rn(g.bias, m.as[i * kLdq + tid]);
  } else if (tid < kHalf + FP) {
    for (int i = 0; i < rows; ++i) {
      g.bias = __fadd_rn(g.bias, m.dr[i * kDs + tid - kHalf]);
    }
  }
  // the weight sums over the tile's rows (k = i), feature tiles mt of rg:
  //   dW_enc_m[j][h]   += sum_i xb[i][j] da[i][h]
  //   dW_dec_m^T[j][h] += sum_i dr[i][j] gs[i][h]
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += 16) {
    uint32_t bda[3][4];
    uint32_t bg[4];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      load_b2_trans(bda[u], m.das + u * R * kLdq, kLdq, h0, k0, lane);
    }
    load_b2_trans(bg, m.gs, kLdq, h0, k0, lane);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int mt = rg + 2 * q;
      if (mt < kMt) {
        uint32_t a[4];
        load_a_trans(a, m.xb, kLdk, 16 * mt, k0, lane);
#pragma unroll
        for (int u = 2; u >= 0; --u) {
          mma_bf16_16816(g.we[q][0], a, bda[u]);
          mma_bf16_16816(g.we[q][1], a, bda[u] + 2);
        }
#pragma unroll
        for (int u = 2; u >= 0; --u) {
          load_a_trans(a, m.drs + u * R * kLdk, kLdk, 16 * mt, k0, lane);
          mma_bf16_16816(g.wd[q][0], a, bg);
          mma_bf16_16816(g.wd[q][1], a, bg + 2);
        }
      }
    }
  }
}

// This block's slot sums g of one half, assembled over the tile's arrays
// from xb on (the staged weights before them stay for the block's next
// item) for store_half_slot.  Every thread calls it: it begins and ends
// with a barrier.
template <int FP, class Phase>
__device__ __forceinline__ void assemble_half_slot(const Phase& m,
                                                   HalfGrads<FP>& g, int f) {
  constexpr int kMt = HalfGrads<FP>::kMt;
  constexpr int kQ = HalfGrads<FP>::kQ;
  static_assert(Phase::kSlotRoom >=
                    sizeof(float) * (2 * FP * kLdq + kHalf + FP + 1),
                "the slot is assembled over the tile's arrays");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int h0 = 16 * (warp & 3);
  const int rg = warp >> 2;
  float sq = g.sq;
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) m.red[warp] = sq;
  __syncthreads();
  float loss = 0.0f;
  if (tid == 0) {
    for (int w = 0; w < kFitThreads / 32; ++w) loss = __fadd_rn(loss, m.red[w]);
  }
  __syncthreads();   // the tiles' arrays are free: assemble the slot there

  float* s_we = reinterpret_cast<float*>(m.xb);   // dW_enc_m [FP][kLdq]
  float* s_wd = s_we + FP * kLdq;   // dW_dec_m^T [FP][kLdq]
  float* s_b = s_wd + FP * kLdq;    // db_enc_m [kHalf], db_dec [f], loss
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int mt = rg + 2 * q;
    if (mt < kMt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (16 * mt + gq + 8 * half) * kLdq + h0 + 8 * nt + t2;
          *reinterpret_cast<float2*>(s_we + o) =
              make_float2(g.we[q][nt][2 * half], g.we[q][nt][2 * half + 1]);
          *reinterpret_cast<float2*>(s_wd + o) =
              make_float2(g.wd[q][nt][2 * half], g.wd[q][nt][2 * half + 1]);
        }
      }
    }
  }
  if (tid < kHalf + f) s_b[tid] = g.bias;
  if (tid == 0) s_b[kHalf + f] = loss;
  __syncthreads();
}

// The slot that assemble_half_slot left in shared memory, stored coalesced
// at `part` (half_floats(f) floats): this card's memory or a peer's.
template <int FP, class Phase>
__device__ __forceinline__ void store_half_slot(const Phase& m, float* part,
                                                int f) {
  const int tid = threadIdx.x;
  const float* s_we = reinterpret_cast<const float*>(m.xb);
  const float* s_wd = s_we + FP * kLdq;
  const float* s_b = s_wd + FP * kLdq;
  const int o_be = f * kHalf;
  const int o_wd = o_be + kHalf;
  const int o_bd = o_wd + kHalf * f;
  const int c = tid % kHalf;   // four rows of kHalf per pass
  for (int j = tid / kHalf; j < f; j += kFitThreads / kHalf) {
    part[j * kHalf + c] = s_we[j * kLdq + c];
    part[o_wd + j * kHalf + c] = s_wd[j * kLdq + c];
  }
  if (tid < kHalf) {
    part[o_be + tid] = s_b[tid];
  } else if (tid <= kHalf + f) {   // db_dec, then the loss
    part[o_bd + tid - kHalf] = s_b[tid];
  }
}

// This block's slot `slot` of `slots` (half_floats(f) each), from g; every
// thread calls it (it begins with a barrier).
template <int FP, class Phase>
__device__ __forceinline__ void write_half_slot(const Phase& m,
                                                HalfGrads<FP>& g,
                                                float* slots, int slot,
                                                int f) {
  assemble_half_slot<FP>(m, g, f);
  store_half_slot<FP>(m, slots + static_cast<size_t>(slot) * half_floats(f),
                      f);
}

// The per-step route's partials of shard (d, m), block b: as forward_item,
// then with the peer half's y (y_peer: its [n][f] rows of block d, loaded
// with each tile) r = (y_0 + y_1) + b_dec, e, dr and the backward; writes
// slot `slot` of `slots`.
template <int FP>
__device__ void partials_item(const PhaseM<FP>& m, const float* x,
                              const float* noise, float sigma,
                              const float* w_enc, const float* b_enc,
                              const float* w_dec, const float* b_dec,
                              const float* y_peer, float* slots, int slot,
                              float inv_count, int n, int b, int ga, int f) {
  constexpr int R = kFitRows;
  constexpr int kLdk = PhaseM<FP>::kLdk;
  constexpr int kDs = PhaseM<FP>::kDs;
  const int tid = threadIdx.x;
  stage_half<FP>(m, w_enc, b_enc, w_dec, b_dec, f, tid);
  HalfGrads<FP> g = {};
  const int tiles = (n + R - 1) / R;
  for (int t = b; t < tiles; t += ga) {
    const int row0 = t * R;
    const int rows = min(R, n - row0);
    __syncthreads();   // the last tile's readers are done
    load_tile<FP>(m, x, noise, y_peer, sigma, row0, rows, f, tid);
    __syncthreads();
    // the forward again, its epilogue forming r from both halves' y (the
    // peer's staged in dr), then e, dr (fp32 and split) and the squared
    // error (dr = 0 past rows and f)
    forward_tile<R, kFitThreads / 32, kHalf>(
        m.xb, kLdk, FP, m.weT, kLdk, m.be, m.as, kLdq, m.gs, kLdq, m.wdT, kLdq,
        FP, tid >> 5, tid & 31, [&](int i, int j, float acc) {
          float d = 0.0f;
          if (i < rows && j < f) {
            const float r = __fadd_rn(acc, m.dr[i * kDs + j]);
            const float e = __fsub_rn(__fadd_rn(r, m.bd[j]), m.xc[i * FP + j]);
            g.sq = __fadd_rn(g.sq, __fmul_rn(e, e));
            d = __fmul_rn(__fmul_rn(2.0f, e), inv_count);
          }
          m.dr[i * kDs + j] = d;
          const Split3 sd(d);
#pragma unroll
          for (int u = 0; u < 3; ++u) m.drs[(u * R + i) * kLdk + j] = sd.t[u];
        });
    __syncthreads();
    backward_tile<FP>(m, rows, g);
  }
  write_half_slot<FP>(m, g, slots, slot, f);
}

// ------------------------------------------------------ the per-step route

template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
model_forward_kernel(const float* x, const float* noise, float sigma,
                     const float* w_enc, const float* b_enc,
                     const float* w_dec, const float* b_dec, float* y, int n,
                     int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_item<FP>(PhaseM<FP>(smem), x, noise, sigma, w_enc, b_enc, w_dec,
                   b_dec, y, n, blockIdx.x, gridDim.x, f);
}

template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
model_partials_kernel(const float* x, const float* noise, float sigma,
                      const float* w_enc, const float* b_enc,
                      const float* w_dec, const float* b_dec,
                      const float* y_peer, float* slots, float inv_count,
                      int n, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  partials_item<FP>(PhaseM<FP>(smem), x, noise, sigma, w_enc, b_enc, w_dec,
                    b_dec, y_peer, slots, blockIdx.x, inv_count, n, blockIdx.x,
                    gridDim.x, f);
}

__global__ void __launch_bounds__(kHalfSlice * kReduceGroups)
model_reduce_kernel(const float* slots, int half_slots, int f, float* w_enc,
                    float* b_enc, float* w_dec, float* b_dec, float* loss_out,
                    float lr, float count) {
  __shared__ float red[kReduceGroups * kHalfSlice];
  fit_reduce<kHalfSlice, 1, true, kHalf>(blockIdx.x, threadIdx.x, red, slots,
                                         half_slots, f, w_enc, b_enc, w_dec,
                                         b_dec, loss_out, lr, count, nullptr,
                                         0);
}

inline float model_count(int n_total, int f) {
  return static_cast<float>(n_total) * static_cast<float>(f);
}

template <class Kernel>
int launch_a(Kernel kernel, size_t smem, int n, const void* const* args,
             cudaStream_t s) {
  cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                         dim3(fit_slots(n)), dim3(kFitThreads),
                         const_cast<void**>(args), smem, s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
}

template <int FP>
int model_forward(const float* x, const float* noise, float sigma,
                  const float* w_enc, const float* b_enc, const float* w_dec,
                  const float* b_dec, float* y, int n, int f,
                  cudaStream_t s) {
  const void* args[] = {&x, &noise, &sigma, &w_enc, &b_enc, &w_dec, &b_dec,
                        &y, &n, &f};
  return launch_a(model_forward_kernel<FP>, model_smem_bytes(FP), n, args, s);
}

template <int FP>
int model_partials(const float* x, const float* noise, float sigma,
                   const float* w_enc, const float* b_enc, const float* w_dec,
                   const float* b_dec, const float* y_peer, float* slots,
                   long long slots_floats, int n, int n_total, int f,
                   cudaStream_t s) {
  if (n_total < n ||
      slots_floats < static_cast<long long>(fit_slots(n)) * half_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float inv_count = 1.0f / model_count(n_total, f);
  const void* args[] = {&x,      &noise, &sigma,     &w_enc, &b_enc, &w_dec,
                        &b_dec,  &y_peer, &slots,    &inv_count, &n, &f};
  return launch_a(model_partials_kernel<FP>, model_smem_bytes(FP), n, args,
                  s);
}

// ----------------------------------------------------------------- the fold

// The data blocks of one fit, by value in the kernel's parameter space
struct ModelTable {
  const float* x[kMaxData];       // block d's [n_d, f] rows
  const float* noise[kMaxData];   // its [steps, n_d, f] noise
  long long stride[kMaxData];     // floats from one step's noise to the next
  int rows[kMaxData];             // n_d
  int slot0[kMaxData];            // its first slot of a half: sum of ga_r
  int blocks;                     // D
};

// The two halves' params, by value
struct Halves {
  float* w_enc[kModel];
  float* b_enc[kModel];
  float* w_dec[kModel];
  float* b_dec[kModel];
};

// The fold's working set in shared memory, from offset 0 (each array a
// multiple of 16 bytes):
//   staged half 0, staged half 1  half_staged_bytes(FP) each: a copy of
//                                 the image
//   red [8]                       per-warp loss sums
//   as [2][R][kLdq]               each half's gelu'(a), then its da
//   dr [R][FP+1]                  y_0, then dr (fp32)
//   xb [R][FP+8]                  bf(noisy)                 <- the slots are
//   gs [2][R][kLdq]               each half's bf(gelu(a))      assembled
//   drs [3][R][FP+8]              dr as three bf16 terms       from here
//   das [2][3][R][kLdq]           each half's da as three bf16 terms
// Phase B's sums reuse its start.  The x and noise tiles follow it.
__host__ __device__ constexpr size_t fold_slot_room(int fp) {
  return sizeof(__nv_bfloat16) *
         (4 * kFitRows * (fp + 8) + kModel * 4 * kFitRows * kLdq);
}

__host__ __device__ constexpr size_t fold_work_bytes(int fp) {
  return kModel * half_staged_bytes(fp) +
         sizeof(float) * (kFitThreads / 32 + kModel * kFitRows * kLdq +
                          kFitRows * (fp + 1)) +
         fold_slot_room(fp);
}

// Half m's view of the fold's working set, under PhaseM's names (what
// backward_tile and write_half_slot read): its own staged weights, as, gs
// and das; red, dr, xb and drs shared by both halves.  The fold reads half
// 0's bd.
template <int FP>
struct FoldHalf {
  static constexpr size_t kSlotRoom = fold_slot_room(FP);
  __nv_bfloat16* weT;
  __nv_bfloat16* wdT;
  float* be;
  float* bd;
  float* red;
  float* as;
  float* dr;
  __nv_bfloat16* xb;
  __nv_bfloat16* gs;
  __nv_bfloat16* drs;
  __nv_bfloat16* das;
  __device__ FoldHalf(unsigned char* smem, int m)
      : weT(reinterpret_cast<__nv_bfloat16*>(smem + m * half_staged_bytes(FP))),
        wdT(weT + kHalf * (FP + 8)),
        be(reinterpret_cast<float*>(wdT + FP * kLdq)),
        bd(be + kHalf),
        red(reinterpret_cast<float*>(smem + kModel * half_staged_bytes(FP))),
        as(red + kFitThreads / 32 + m * kFitRows * kLdq),
        dr(red + kFitThreads / 32 + kModel * kFitRows * kLdq),
        xb(reinterpret_cast<__nv_bfloat16*>(dr + kFitRows * (FP + 1))),
        gs(xb + kFitRows * (FP + 8) + m * kFitRows * kLdq),
        drs(xb + kFitRows * (FP + 8) + kModel * kFitRows * kLdq),
        das(drs + 3 * kFitRows * (FP + 8) + m * 3 * kFitRows * kLdq) {}
};

// One work item of the fold, slot `slot` of each half: data block d's block
// b of its ga, which walks `count` tiles b, b + ga, ... of block d (the
// per-step route's launches of shards (d, 0) and (d, 1), block b)
struct FoldItem {
  int d;
  int b;
  int ga;
  int count;
};

__host__ __device__ inline FoldItem fold_item(const ModelTable& t, int slot) {
  int d = 0;
  while (d + 1 < t.blocks && t.slot0[d + 1] <= slot) ++d;
  const int tiles = (t.rows[d] + kFitRows - 1) / kFitRows;
  const int ga = fit_slots(t.rows[d]);
  const int b = slot - t.slot0[d];
  return {d, b, ga, (tiles - b + ga - 1) / ga};
}

__device__ __forceinline__ int tile_rows(const ModelTable& t, int d,
                                         int tile) {
  return min(kFitRows, t.rows[d] - tile * kFitRows);
}

__device__ __forceinline__ const float* tile_noise(const ModelTable& t,
                                                   int s, int d, int tile,
                                                   int f) {
  return t.noise[d] + s * t.stride[d] +
         static_cast<size_t>(tile) * kFitRows * f;
}

// Before the first step, for a block with `items` items (item j: slot
// slot_of(j) of each half): the x tiles of all of them into xs while
// resident_tiles > 0 (0: one, reloaded at each tile), and the first tile's
// noise into nz, in flight.
template <int FP, class SlotOf>
__device__ __forceinline__ void fold_load(const ModelTable& table, float* xs,
                                          float* nz, int items,
                                          int resident_tiles, int f,
                                          SlotOf slot_of) {
  constexpr int kTile = kFitRows * FP;
  const int tid = threadIdx.x;
  if (items == 0) return;
  for (int j = 0, r = 0; resident_tiles > 0 && j < items; ++j) {
    const FoldItem it = fold_item(table, slot_of(j));
    for (int k = 0; k < it.count; ++k, ++r) {
      const int t = it.b + k * it.ga;
      load_x<FP>(xs + r * kTile, table.x[it.d], t * kFitRows,
                 tile_rows(table, it.d, t), f, tid);
    }
  }
  const FoldItem it0 = fold_item(table, slot_of(0));
  copy_async(nz, tile_noise(table, 0, it0.d, it0.b, f),
             tile_rows(table, it0.d, it0.b) * f, tid);
  cp_async_commit();
}

// Phase A of step s for a block with `items` items (item j: slot
// slot_of(j) of each half): at the step's first tile both halves' images
// come in behind the noise; each tile runs half 0's forward, half 1's
// (forming r, e, dr and the squared error) and each half's backward; at
// the item's end put(g0, g1, slot) writes its two slots.  The noise tiles
// double-buffer in nz across items and steps (q: the tiles the block has
// taken, the buffer's parity).  stamp(k) marks trace point k.
template <int FP, class SlotOf, class Put, class Stamp>
__device__ __forceinline__ void fold_phase_a(
    const ModelTable& table, const FoldHalf<FP>& h0, const FoldHalf<FP>& h1,
    float* xs, float* nz, const unsigned char* image, int items, int s,
    int steps, int& q, float sigma, float inv_count, int f,
    int resident_tiles, SlotOf slot_of, Put put, Stamp stamp) {
  constexpr int R = kFitRows;
  constexpr int kTile = R * FP;
  constexpr int kLdk = FP + 8;
  constexpr int kDs = FP + 1;
  const int tid = threadIdx.x;
  if (items > 0) {   // both halves' images, once a step, behind the noise
    copy_async(reinterpret_cast<float*>(h0.weT),
               reinterpret_cast<const float*>(image),
               static_cast<int>(kModel * half_staged_bytes(FP) / 4), tid);
    cp_async_commit();
  }
  for (int j = 0, r = 0; j < items; ++j) {
    const int slot = slot_of(j);
    const FoldItem it = fold_item(table, slot);
    HalfGrads<FP> g0 = {};
    HalfGrads<FP> g1 = {};
    for (int k = 0; k < it.count; ++k, ++q, ++r) {
      const int t = it.b + k * it.ga;
      const int rows = tile_rows(table, it.d, t);
      // in flight: this tile's noise, and at the step's first tile the
      // weights after it
      const bool first = j == 0 && k == 0;
      if (first) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // the noise landed; the last tile's and the last
                         // slot's readers are done
      stamp(1);
      float* xc = resident_tiles > 0 ? xs + r * kTile : xs;
      if (resident_tiles == 0) {   // each thread reads back only its own
        load_x<FP>(xc, table.x[it.d], t * R, rows, f, tid);
      }
      const float* nc = nz + (q & 1) * kTile;
      for (int idx = tid; idx < kTile; idx += kFitThreads) {
        const int i = idx / FP;
        const int c = idx - i * FP;
        const float nv =
            i < rows && c < f
                ? __fadd_rn(xc[idx], __fmul_rn(sigma, nc[i * f + c]))
                : 0.0f;
        h0.xb[i * kLdk + c] = __float2bfloat16_rn(nv);
      }
      // the next tile's noise into the other buffer: this item's next
      // tile, the next item's first, or step s + 1's first
      int s2 = s;
      int d2 = it.d;
      int t2 = t + it.ga;
      bool next = true;
      if (k + 1 == it.count) {
        const bool more = j + 1 < items;
        next = more || s + 1 < steps;
        const FoldItem nx = fold_item(table, slot_of(more ? j + 1 : 0));
        s2 = more ? s : s + 1;
        d2 = nx.d;
        t2 = nx.b;
      }
      if (next) {
        copy_async(nz + ((q + 1) & 1) * kTile, tile_noise(table, s2, d2, t2, f),
                   tile_rows(table, d2, t2) * f, tid);
      }
      cp_async_commit();
      if (first) cp_async_wait<1>();   // the weights
      __syncthreads();
      stamp(2);
      // half 0's forward: y_0 kept in dr for half 1's epilogue (each
      // (i, j) is the same thread's in both)
      forward_tile<R, kFitThreads / 32, kHalf>(
          h0.xb, kLdk, FP, h0.weT, kLdk, h0.be, h0.as, kLdq, h0.gs, kLdq,
          h0.wdT, kLdq, FP, tid >> 5, tid & 31,
          [&](int i, int j, float acc) { h0.dr[i * kDs + j] = acc; });
      // half 1's: r = y_1 + y_0, then e, dr (fp32 and split) and the
      // squared error (dr = 0 past rows and f), as partials_item forms
      // them
      forward_tile<R, kFitThreads / 32, kHalf>(
          h1.xb, kLdk, FP, h1.weT, kLdk, h1.be, h1.as, kLdq, h1.gs, kLdq,
          h1.wdT, kLdq, FP, tid >> 5, tid & 31,
          [&](int i, int j, float acc) {
            float d = 0.0f;
            if (i < rows && j < f) {
              const float y = __fadd_rn(acc, h0.dr[i * kDs + j]);
              const float e =
                  __fsub_rn(__fadd_rn(y, h0.bd[j]), xc[i * FP + j]);
              g0.sq = __fadd_rn(g0.sq, __fmul_rn(e, e));
              d = __fmul_rn(__fmul_rn(2.0f, e), inv_count);
            }
            h0.dr[i * kDs + j] = d;
            const Split3 sd(d);
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              h0.drs[(u * R + i) * kLdk + j] = sd.t[u];
            }
          });
      __syncthreads();
      stamp(3);
      backward_tile<FP>(h0, rows, g0);
      stamp(4);
      backward_tile<FP>(h1, rows, g1);
      stamp(5);
    }
    g1.sq = g0.sq;   // both slots carry the one squared error
    put(g0, g1, slot);
  }
}

// Phase B of a step: each half's params updated from its half_slots slots
// at `slots` (half 0's, then half 1's) by fit_reduce at a width of 64, in
// K5's short runs while a half has at most 8 x 17 slots, else its long
// runs; each updated param also goes to the half's image; the loss to
// `loss` (half 1's copy of it to `discard`).  Block k takes the slices k,
// k + gb, ... of both halves' parameters.
template <int FP>
__device__ __forceinline__ void fold_phase_b(const Halves& hv,
                                             unsigned char* smem,
                                             const float* slots,
                                             unsigned char* image,
                                             float* loss, float* discard,
                                             int half_slots, int f, float lr,
                                             float count) {
  const int block = blockIdx.x;
  const int gb = gridDim.x;
  const int tid = threadIdx.x;
  const int pf = half_floats(f);
  const int slices = (pf + kFitSlice - 1) / kFitSlice;
  const bool long_runs = half_slots > kReduceGroups * kReduceRun;
  for (int k = block; k < kModel * slices; k += gb) {
    if (k != block) __syncthreads();   // the last slice's reads of red
    const int h = k / slices;
    float* red = reinterpret_cast<float*>(smem);
    const float* part = slots + static_cast<size_t>(h) * half_slots * pf;
    float* out = h == 0 ? loss : discard;
    unsigned char* img = image + h * half_staged_bytes(FP);
    if (long_runs) {
      fit_reduce<kFitWidth, kFitCols, true, kHalf>(
          k - h * slices, tid, red, part, half_slots, f, hv.w_enc[h],
          hv.b_enc[h], hv.w_dec[h], hv.b_dec[h], out, lr, count, img, FP);
    } else {
      fit_reduce<kFitWidth, kFitCols, false, kHalf>(
          k - h * slices, tid, red, part, half_slots, f, hv.w_enc[h],
          hv.b_enc[h], hv.w_dec[h], hv.b_dec[h], out, lr, count, img, FP);
    }
  }
}

// resident_tiles > 0: a block keeps the x tiles of all its items in
// shared memory (room for resident_tiles of them); 0: one, reloaded at
// each tile.
template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
model_fit_kernel(const __grid_constant__ ModelTable table,
                 const __grid_constant__ Halves hv, float sigma,
                 unsigned char* image, float* slots, float* discard,
                 float* losses, float lr, float count, float inv_count,
                 int f, int steps, int half_slots, int resident_tiles,
                 long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int block = blockIdx.x;
  const int gb = gridDim.x;
  const int tid = threadIdx.x;
  const FoldHalf<FP> h0(smem, 0);
  const FoldHalf<FP> h1(smem, 1);
  // x tiles [max(resident_tiles, 1)][R][FP], then noise [2][R][FP]
  float* xs = reinterpret_cast<float*>(smem + fold_work_bytes(FP));
  float* nz = xs + kFitRows * FP * max(resident_tiles, 1);
  // this block's items: slots block, block + gb, ...
  const int items =
      block < half_slots ? (half_slots - block + gb - 1) / gb : 0;
  const auto slot_of = [&](int j) { return block + j * gb; };
  const int pf = half_floats(f);
  // stamps [steps][kStamps][gb], as K3's and K5's
  auto stamp = [&](int s, int k) {
    if (stamps != nullptr && tid == 0) {
      stamps[(s * kStamps + k) * gb + block] = global_ns();
    }
  };

  if (block < kModel) {   // half `block`'s image, from its fp32 params
    stage_half<FP>(StagedAt<kHalf>(image + block * half_staged_bytes(FP), FP),
                   hv.w_enc[block], hv.b_enc[block], hv.w_dec[block],
                   hv.b_dec[block], f, tid);
  }
  fold_load<FP>(table, xs, nz, items, resident_tiles, f, slot_of);
  grid.sync();

  int q = 0;   // tiles this block has taken: the noise buffer's parity
  for (int s = 0; s < steps; ++s) {
    stamp(s, 0);
    fold_phase_a<FP>(
        table, h0, h1, xs, nz, image, items, s, steps, q, sigma, inv_count,
        f, resident_tiles, slot_of,
        [&](HalfGrads<FP>& g0, HalfGrads<FP>& g1, int slot) {
          write_half_slot<FP>(h0, g0, slots, slot, f);
          write_half_slot<FP>(h1, g1,
                              slots + static_cast<size_t>(half_slots) * pf,
                              slot, f);
        },
        [&](int k) { stamp(s, k); });
    stamp(s, 6);
    grid.sync();
    stamp(s, 7);
    fold_phase_b<FP>(hv, smem, slots, image, losses + s, discard, half_slots,
                     f, lr, count);
    stamp(s, 8);
    grid.sync();
  }
}

// The most x tiles one block walks in a step when `gb` blocks take the
// slots k, k + gb, ... (kernels/anomaly.py model_fit_plan is its twin)
inline int fold_block_tiles(const ModelTable& t, int half_slots, int gb) {
  std::vector<int> tiles(gb, 0);
  for (int slot = 0; slot < half_slots; ++slot) {
    tiles[slot % gb] += fold_item(t, slot).count;
  }
  return *std::max_element(tiles.begin(), tiles.end());
}

// The grid of a persistent launch of `kernel` on the current device: one
// block per SM, once the kernel is known to opt in to, and hold on an SM,
// one block of the most shared memory any plan asks for.  Queried once per
// (kernel, device), as opt_in_smem keeps its opt-in, a failure too; later
// calls return it.
inline cudaError_t persistent_grid(const void* kernel, int* sms) {
  struct Grid {
    const void* kernel;
    int device;
    int sms;
    cudaError_t err;
  };
  static std::mutex mu;
  static std::vector<Grid> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Grid& g : done) {
    if (g.kernel == kernel && g.device == device) {
      *sms = g.sms;
      return g.err;
    }
  }
  int count = 0;
  int per_sm = 0;
  err = opt_in_smem(kernel, kMaxSmem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kFitThreads,
                                                        kMaxSmem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear what we report
  } else if (per_sm < 1) {
    err = cudaErrorCooperativeLaunchTooLarge;
  }
  done.push_back({kernel, device, count, err});
  *sms = count;
  return err;
}

template <int FP>
int model_fit(const ModelTable& table, const Halves& hv, int n_total,
              float sigma, float* scratch, long long scratch_floats,
              float* losses, float lr, int f, int steps, long long* stamps,
              long long stamps_len, cudaStream_t s) {
  static_assert(fold_work_bytes(FP) >=
                    sizeof(float) * kReduceGroups * kFitSlice,
                "phase B's groups fit in phase A's working set");
  const int last = table.blocks - 1;
  int half_slots = table.slot0[last] + fit_slots(table.rows[last]);
  const long long image_floats = kModel * half_staged_bytes(FP) / 4;
  const long long slot_floats =
      static_cast<long long>(kModel) * half_slots * half_floats(f);
  if (steps < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      scratch_floats < image_floats + slot_floats + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int gb = 0;
  cudaError_t err = persistent_grid(
      reinterpret_cast<const void*>(model_fit_kernel<FP>), &gb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stamps != nullptr && stamps_len < 1LL * kStamps * steps * gb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident_tiles = 0;
  size_t smem = 0;
  shared_plan<FP>(fold_block_tiles(table, half_slots, gb), &resident_tiles,
                  &smem, fold_work_bytes(FP));
  unsigned char* image = reinterpret_cast<unsigned char*>(scratch);
  float* slots = scratch + image_floats;
  float* discard = slots + slot_floats;
  float count = model_count(n_total, f);
  float inv_count = 1.0f / count;
  void* args[] = {const_cast<ModelTable*>(&table), const_cast<Halves*>(&hv),
                  &sigma, &image, &slots, &discard, &losses, &lr, &count,
                  &inv_count, &f, &steps, &half_slots, &resident_tiles,
                  &stamps};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(model_fit_kernel<FP>), dim3(gb),
      dim3(kFitThreads), args, smem, s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
}

// ------------------------------------------------------- the cards route

// The trace's points per step of the cards route: the fold's 0-6, then 7
// this card's blocks all at the barrier across cards, 8 past it, 9 after
// phase B
constexpr int kCardStamps = 10;

// The cards of one launch set and this card's part, by value: each card's
// slots (both parities) and flags, where this card copies a half it holds
// no params of from at the fit's start, and which run [lo, hi) of each
// data block's slots it takes.
struct Cards {
  float* slots[kMaxCards];
  unsigned long long* flags[kMaxCards];
  const float* src[kModel][4];   // a peer's half m; null: held here
  int lo[kMaxData];
  int hi[kMaxData];
  int items;                     // the sum of hi - lo
  int cards;
  int me;
  unsigned long long epoch;      // the barriers passed before this launch
};

// The j-th of this card's slots, data block by data block
__host__ __device__ inline int card_slot(const ModelTable& t, const Cards& c,
                                         int j) {
  for (int d = 0; d < t.blocks; ++d) {
    const int n = c.hi[d] - c.lo[d];
    if (j < n) return t.slot0[d] + c.lo[d] + j;
    j -= n;
  }
  return -1;
}

// The fit over the cards of a host, one launch per card: the fold's work
// items split over the cards, every slot stored into every card's slots,
// one barrier across cards a step, and the same phase B on every card.
template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
model_cards_kernel(const __grid_constant__ ModelTable table,
                   const __grid_constant__ Halves hv,
                   const __grid_constant__ Cards cards, float sigma,
                   unsigned char* image, float* losses, float* discard,
                   float lr, float count, float inv_count, int f, int steps,
                   int half_slots, int resident_tiles, long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int block = blockIdx.x;
  const int gb = gridDim.x;
  const int tid = threadIdx.x;
  const FoldHalf<FP> h0(smem, 0);
  const FoldHalf<FP> h1(smem, 1);
  float* xs = reinterpret_cast<float*>(smem + fold_work_bytes(FP));
  float* nz = xs + kFitRows * FP * max(resident_tiles, 1);
  // this block's items: the card's items block, block + gb, ...
  const int items =
      block < cards.items ? (cards.items - block + gb - 1) / gb : 0;
  const auto slot_of = [&](int j) {
    return card_slot(table, cards, block + j * gb);
  };
  const int pf = half_floats(f);
  // one step's slots of both halves; step s uses parity s & 1
  const size_t parity = static_cast<size_t>(kModel) * half_slots * pf;
  // stamps [steps][kCardStamps][gb]
  auto stamp = [&](int s, int k) {
    if (stamps != nullptr && tid == 0) {
      stamps[(s * kCardStamps + k) * gb + block] = global_ns();
    }
  };
  unsigned long long barrier = cards.epoch;

  fold_load<FP>(table, xs, nz, items, resident_tiles, f, slot_of);
  // every card's launch has begun: the peers' scratch is this fit's, and
  // the peers' params are no longer written by what came before
  cards_sync(grid, cards.flags, cards.cards, cards.me, ++barrier, false,
             [] {});
  if (block < kModel) {   // half `block`: its params where a peer holds
    const int m = block;  // them, then its image
    if (cards.src[m][0] != nullptr) {
      float* dst[4] = {hv.w_enc[m], hv.b_enc[m], hv.w_dec[m], hv.b_dec[m]};
      const int len[4] = {f * kHalf, kHalf, kHalf * f, f};
      for (int i = 0; i < 4; ++i) {
        for (int e = tid; e < len[i]; e += kFitThreads) {
          dst[i][e] = __ldcg(cards.src[m][i] + e);
        }
      }
      __syncthreads();
    }
    stage_half<FP>(StagedAt<kHalf>(image + m * half_staged_bytes(FP), FP),
                   hv.w_enc[m], hv.b_enc[m], hv.w_dec[m], hv.b_dec[m], f,
                   tid);
  }
  grid.sync();

  int q = 0;   // tiles this block has taken: the noise buffer's parity
  for (int s = 0; s < steps; ++s) {
    const size_t at = (s & 1) * parity;
    stamp(s, 0);
    fold_phase_a<FP>(
        table, h0, h1, xs, nz, image, items, s, steps, q, sigma, inv_count,
        f, resident_tiles, slot_of,
        [&](HalfGrads<FP>& g0, HalfGrads<FP>& g1, int slot) {
          // the same two slots into every card's slots
          assemble_half_slot<FP>(h0, g0, f);
          for (int c = 0; c < cards.cards; ++c) {
            store_half_slot<FP>(
                h0, cards.slots[c] + at + static_cast<size_t>(slot) * pf, f);
          }
          assemble_half_slot<FP>(h1, g1, f);
          for (int c = 0; c < cards.cards; ++c) {
            store_half_slot<FP>(
                h1,
                cards.slots[c] + at +
                    static_cast<size_t>(half_slots + slot) * pf,
                f);
          }
        },
        [&](int k) { stamp(s, k); });
    stamp(s, 6);
    cards_sync(grid, cards.flags, cards.cards, cards.me, ++barrier,
               items > 0 && cards.cards > 1, [&] { stamp(s, 7); });
    stamp(s, 8);
    fold_phase_b<FP>(hv, smem, cards.slots[cards.me] + at, image,
                     losses != nullptr ? losses + s : discard, discard,
                     half_slots, f, lr, count);
    stamp(s, 9);
    if (s + 1 < steps) grid.sync();   // phase A reads phase B's images
  }
  // no card's kernel exits while a peer may still touch its memory
  cards_sync(grid, cards.flags, cards.cards, cards.me, ++barrier, false,
             [] {});
}

// Which of each data block's ga_d slots this card takes: the ga_d split
// evenly, a contiguous run each, over the distinct cards that hold the
// block's shards (d, 0) and (d, 1), in that order; none where it holds
// neither (kernels/anomaly.py cards_fit_plan is its twin).
inline void card_items(const ModelTable& t, const int* card_of_shard, int me,
                       Cards* c) {
  c->items = 0;
  for (int d = 0; d < t.blocks; ++d) {
    int holders = 0;
    int pos = -1;
    for (int m = 0; m < kModel; ++m) {
      const int card = card_of_shard[kModel * d + m];
      bool seen = false;
      for (int k = 0; k < m; ++k) seen |= card_of_shard[kModel * d + k] == card;
      if (seen) continue;
      if (card == me) pos = holders;
      ++holders;
    }
    const int ga = fit_slots(t.rows[d]);
    c->lo[d] = pos < 0 ? 0 : pos * ga / holders;
    c->hi[d] = pos < 0 ? 0 : (pos + 1) * ga / holders;
    c->items += c->hi[d] - c->lo[d];
  }
}

// The most x tiles one block of this card walks in a step
inline int card_block_tiles(const ModelTable& t, const Cards& c, int gb) {
  std::vector<int> tiles(gb, 0);
  for (int j = 0; j < c.items; ++j) {
    tiles[j % gb] += fold_item(t, card_slot(t, c, j)).count;
  }
  return *std::max_element(tiles.begin(), tiles.end());
}

// The floats at the start of a card's scratch that hold its copy of the
// halves it holds no params of: half m's w_enc [f][kHalf], b_enc [kHalf],
// w_dec [kHalf][f], b_dec [f] from m (half_floats(f) - 1) on, rounded up
// to 16 bytes
__host__ __device__ constexpr long long cards_copy_floats(int f) {
  return (kModel * (half_floats(f) - 1) + 3) / 4 * 4;
}

template <int FP>
int model_cards(const ModelTable& table, const Halves& hv,
                const Cards& cards, const int* devices, int n_total,
                float sigma, float* scratch, long long scratch_floats,
                float* losses, float lr, int f, int steps, long long* stamps,
                long long stamps_len, bool launch, cudaStream_t s) {
  const int last = table.blocks - 1;
  int half_slots = table.slot0[last] + fit_slots(table.rows[last]);
  const long long copy_floats = cards_copy_floats(f);
  const long long image_floats = kModel * half_staged_bytes(FP) / 4;
  const long long slot_floats = 2LL * kModel * half_slots * half_floats(f);
  unsigned char* image =
      reinterpret_cast<unsigned char*>(scratch + copy_floats);
  float* slots = scratch + copy_floats + image_floats;
  float* discard = slots + slot_floats;
  if (steps < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      scratch_floats < copy_floats + image_floats + slot_floats + 1 ||
      cards.slots[cards.me] != slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = enable_peers(devices, cards.cards);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gb = 0;
  err = persistent_grid(reinterpret_cast<const void*>(model_cards_kernel<FP>),
                        &gb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stamps != nullptr && stamps_len < 1LL * kCardStamps * steps * gb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!launch) return static_cast<int>(cudaSuccess);
  int resident_tiles = 0;
  size_t smem = 0;
  shared_plan<FP>(card_block_tiles(table, cards, gb), &resident_tiles, &smem,
                  fold_work_bytes(FP));
  float count = model_count(n_total, f);
  float inv_count = 1.0f / count;
  void* args[] = {const_cast<ModelTable*>(&table), const_cast<Halves*>(&hv),
                  const_cast<Cards*>(&cards), &sigma, &image, &losses,
                  &discard, &lr, &count, &inv_count, &f, &steps,
                  &half_slots, &resident_tiles, &stamps};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(model_cards_kernel<FP>), dim3(gb),
      dim3(kFitThreads), args, smem, s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
}

// The data blocks' table (blocks x 4 int64: x, noise, the noise's step
// stride, n_d) -> t and the batch's rows; x and noise are needed only of
// the blocks `held` marks (all, where it is null).  -> false if invalid.
inline bool parse_table(const long long* table, int blocks, int f,
                        const bool* held, ModelTable* t, int* n) {
  *t = {};
  t->blocks = blocks;
  long long n_total = 0;
  int slot = 0;
  for (int d = 0; d < blocks; ++d) {
    const long long* e = table + 4 * d;
    t->x[d] = reinterpret_cast<const float*>(static_cast<uintptr_t>(e[0]));
    t->noise[d] = reinterpret_cast<const float*>(static_cast<uintptr_t>(e[1]));
    t->stride[d] = e[2];
    if (e[3] < 1 || e[3] > (1 << 30)) return false;
    if ((held == nullptr || held[d]) &&
        (t->x[d] == nullptr || t->noise[d] == nullptr || e[2] < e[3] * f)) {
      return false;
    }
    t->rows[d] = static_cast<int>(e[3]);
    t->slot0[d] = slot;
    slot += fit_slots(t->rows[d]);
    n_total += e[3];
    if (n_total > (1 << 30)) return false;
  }
  *n = static_cast<int>(n_total);
  return true;
}

inline float* as_floats(long long p) {
  return reinterpret_cast<float*>(static_cast<uintptr_t>(p));
}

}  // namespace anomaly

// Phase A1 of shard (d, m): x and noise are data block d's [n, f] rows
// (noise may be null: the plain autoencoder step), the params half m's
// (w_enc [f, 64], b_enc [64], w_dec [64, f], b_dec [f]); its partial
// decoder output y_m goes to `y`, [n, f] floats.
extern "C" int anomaly_fit_model_forward(const float* x, const float* noise,
                                         float sigma, const float* w_enc,
                                         const float* b_enc,
                                         const float* w_dec,
                                         const float* b_dec, float* y, int n,
                                         int f, void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 || f > 64 ? 0 : (f + 15) / 16) {
    case 1:
      return model_forward<16>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec, y,
                               n, f, s);
    case 2:
      return model_forward<32>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec, y,
                               n, f, s);
    case 3:
      return model_forward<48>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec, y,
                               n, f, s);
    case 4:
      return model_forward<64>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec, y,
                               n, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Phase A2 of shard (d, m): as the forward, with y_peer the other half's
// [n, f] partial output of the same rows; its min(ceil(n / 32), 132) slots
// of (2 f 64 + 64 + f + 1) floats go to `slots`, which holds
// `slots_floats` floats from there on.  n_total is the batch's row count.
extern "C" int anomaly_fit_model_partials(
    const float* x, const float* noise, float sigma, const float* w_enc,
    const float* b_enc, const float* w_dec, const float* b_dec,
    const float* y_peer, float* slots, long long slots_floats, int n,
    int n_total, int f, void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 || f > 64 ? 0 : (f + 15) / 16) {
    case 1:
      return model_partials<16>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                y_peer, slots, slots_floats, n, n_total, f,
                                s);
    case 2:
      return model_partials<32>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                y_peer, slots, slots_floats, n, n_total, f,
                                s);
    case 3:
      return model_partials<48>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                y_peer, slots, slots_floats, n, n_total, f,
                                s);
    case 4:
      return model_partials<64>(x, noise, sigma, w_enc, b_enc, w_dec, b_dec,
                                y_peer, slots, slots_floats, n, n_total, f,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Phase B of one half: `slots` holds its half_slots slots back to back (data
// order, then block order); that half's params are updated in place and the
// step's loss written to `loss_out` (one float).
extern "C" int anomaly_fit_model_reduce(const float* slots,
                                        long long slots_floats,
                                        int half_slots, float* w_enc,
                                        float* b_enc, float* w_dec,
                                        float* b_dec, float* loss_out,
                                        float lr, int n_total, int f,
                                        void* stream) {
  using namespace anomaly;
  if (half_slots < 1 || n_total < 1 || f < 1 || f > 64 ||
      slots_floats < static_cast<long long>(half_slots) * half_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (half_floats(f) + kHalfSlice - 1) / kHalfSlice;
  model_reduce_kernel<<<blocks, kHalfSlice * kReduceGroups, 0, s>>>(
      slots, half_slots, f, w_enc, b_enc, w_dec, b_dec, loss_out, lr,
      model_count(n_total, f));
  return static_cast<int>(cudaGetLastError());
}

// The whole fit over `blocks` data blocks of one card in one launch (the
// fold): `table` holds blocks x 4 int64, for each block in data order its
// x pointer ([n_d, f] floats), its noise pointer ([steps, n_d, f], each
// step's rows contiguous), the floats from one step's noise to the next,
// and n_d; `halves` holds 8 int64, half 0's w_enc, b_enc, w_dec, b_dec
// pointers, then half 1's (both b_dec the same bits).  Scratch:
// `scratch_floats` floats at a 16-byte aligned `scratch`: both halves'
// staged images (half_staged_bytes(FP) each), their slots (half 0's, then
// half 1's), then one float.  `losses` gets one
// float per step, the loss before that step's update.  `stamps` is null,
// or `stamps_len` int64s for a trace of the phases: [steps][kStamps][the
// SM count], nanoseconds of %globaltimer.
extern "C" int anomaly_fit_model_fit(const long long* table, int blocks,
                                     const long long* halves, float sigma,
                                     float* scratch, long long scratch_floats,
                                     float* losses, float lr, int f,
                                     int steps, long long* stamps,
                                     long long stamps_len, void* stream) {
  using namespace anomaly;
  if (table == nullptr || halves == nullptr || blocks < 1 ||
      blocks > kMaxData || f < 1 || f > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ModelTable t;
  int n = 0;
  if (!parse_table(table, blocks, f, nullptr, &t, &n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Halves hv = {};
  for (int h = 0; h < kModel; ++h) {
    float* p[4];
    for (int i = 0; i < 4; ++i) {
      p[i] = as_floats(halves[4 * h + i]);
      if (p[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
    hv.w_enc[h] = p[0];
    hv.b_enc[h] = p[1];
    hv.w_dec[h] = p[2];
    hv.b_dec[h] = p[3];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((f + 15) / 16) {
    case 1:
      return model_fit<16>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, stamps, stamps_len, s);
    case 2:
      return model_fit<32>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, stamps, stamps_len, s);
    case 3:
      return model_fit<48>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, stamps, stamps_len, s);
    default:
      return model_fit<64>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, stamps, stamps_len, s);
  }
}

// The fit over the cards of a host (the cards route), called once per card
// with the current device that card, first with `launch` 0 for each card
// (every check, the peer access and the grid, no launch), then with 1:
// `blocks` data blocks in `table` as the fold takes them (x and noise
// pointers on this card, 0 for a block whose shards it holds none of);
// `shard_cards` 2 x blocks int64, the card (0 .. cards - 1) of each shard
// in shard order; `halves` 8 int64, this card's params of half 0, then
// half 1 (w_enc, b_enc, w_dec, b_dec), all 0 for a half it holds none of,
// whose params `sources` (8 int64, 0 for a half held here) names on a peer;
// `peers` cards x 3 int64, each card's device ordinal, slots (its
// scratch's, below) and flags (kMaxCards uint64, zero before the first
// launch); `me` this card; `epoch` the barriers that earlier launches over
// these flags passed (steps + 2 a launch).  Scratch: `scratch_floats`
// floats at a 16-byte aligned `scratch`: the copy of the halves held on
// peers (cards_copy_floats(f)), both halves' images, two parities of both
// halves' slots, one float.  `losses` (steps floats, on one card; null on
// the others) gets each step's loss.  `stamps` is null, or `stamps_len`
// int64s for a trace: [steps][kCardStamps][the SM count].
extern "C" int anomaly_fit_model_cards(
    const long long* table, int blocks, const long long* shard_cards,
    const long long* halves, const long long* sources,
    const long long* peers, int cards, int me, long long epoch, float sigma,
    float* scratch, long long scratch_floats, float* losses, float lr,
    int f, int steps, long long* stamps, long long stamps_len, int launch,
    void* stream) {
  using namespace anomaly;
  if (table == nullptr || shard_cards == nullptr || halves == nullptr ||
      sources == nullptr || peers == nullptr || blocks < 1 ||
      blocks > kMaxData || cards < 1 || cards > kMaxCards || me < 0 ||
      me >= cards || epoch < 0 || f < 1 || f > 64 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int card_of[kModel * kMaxData];
  bool held[kMaxData] = {};
  for (int i = 0; i < kModel * blocks; ++i) {
    if (shard_cards[i] < 0 || shard_cards[i] >= cards) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    card_of[i] = static_cast<int>(shard_cards[i]);
    if (card_of[i] == me) held[i / kModel] = true;
  }
  ModelTable t;
  int n = 0;
  if (!parse_table(table, blocks, f, held, &t, &n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Cards c = {};
  c.cards = cards;
  c.me = me;
  c.epoch = static_cast<unsigned long long>(epoch);
  int devices[kMaxCards];
  for (int k = 0; k < cards; ++k) {
    devices[k] = static_cast<int>(peers[3 * k]);
    c.slots[k] = as_floats(peers[3 * k + 1]);
    c.flags[k] = reinterpret_cast<unsigned long long*>(
        static_cast<uintptr_t>(peers[3 * k + 2]));
    if (c.slots[k] == nullptr || c.flags[k] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (devices[me] != device) return static_cast<int>(cudaErrorInvalidValue);
  card_items(t, card_of, me, &c);
  Halves hv = {};
  for (int h = 0; h < kModel; ++h) {
    int own = 0;
    int peer = 0;
    for (int i = 0; i < 4; ++i) {
      own += halves[4 * h + i] != 0;
      peer += sources[4 * h + i] != 0;
    }
    float* p[4];
    if (own == 4 && peer == 0) {
      for (int i = 0; i < 4; ++i) p[i] = as_floats(halves[4 * h + i]);
    } else if (own == 0 && peer == 4) {   // this card's copy, in scratch
      p[0] = scratch + h * (half_floats(f) - 1);
      p[1] = p[0] + f * kHalf;
      p[2] = p[1] + kHalf;
      p[3] = p[2] + kHalf * f;
      for (int i = 0; i < 4; ++i) c.src[h][i] = as_floats(sources[4 * h + i]);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    hv.w_enc[h] = p[0];
    hv.b_enc[h] = p[1];
    hv.w_dec[h] = p[2];
    hv.b_dec[h] = p[3];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((f + 15) / 16) {
    case 1:
      return model_cards<16>(t, hv, c, devices, n, sigma, scratch,
                             scratch_floats, losses, lr, f, steps, stamps,
                             stamps_len, launch != 0, s);
    case 2:
      return model_cards<32>(t, hv, c, devices, n, sigma, scratch,
                             scratch_floats, losses, lr, f, steps, stamps,
                             stamps_len, launch != 0, s);
    case 3:
      return model_cards<48>(t, hv, c, devices, n, sigma, scratch,
                             scratch_floats, losses, lr, f, steps, stamps,
                             stamps_len, launch != 0, s);
    default:
      return model_cards<64>(t, hv, c, devices, n, sigma, scratch,
                             scratch_floats, losses, lr, f, steps, stamps,
                             stamps_len, launch != 0, s);
  }
}
