// K5b: the (denoising) SGD fit of the anomaly autoencoder with the rows
// split over `data` and the hidden dimension split over `model` = 2, the
// reference's mesh layout.  Four C entry points, two routes, chosen by the
// wrapper (kernels/anomaly.py) by layout, never by failure:
// * all the shards on one card: the whole fit as ONE persistent
//   cooperative launch (anomaly_fit_model_fit), K3's and K5's design;
// * shards on several cards, and the single step of mesh.train_step /
//   denoise_step / graft_entry.dryrun_multichip: per step, the forward
//   once per shard (anomaly_fit_model_forward), the partials once per
//   shard (anomaly_fit_model_partials), then phase B once per half
//   (anomaly_fit_model_reduce): 2 S + 2 launches a step, "the per-step
//   route".
// Both routes run the same device functions over the same work items with
// the same fixed sums, so they give the same bits.
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
// How the halves of a row tile meet for step 2: through global memory,
// behind a third grid-wide barrier a step.  Phase A1 writes each half's y_m
// [N][F] (fp32) to the scratch; grid.sync(); phase A2 recomputes the
// half's encoder (the same code on the same inputs: the same bits), its own
// y_m, reads the peer's y through L2 (__ldcg) and goes on with dr and the
// backward.  A 2-CTA cluster reading the peer's y from distributed shared
// memory would save the barrier (~1 us a step), but needs the cooperative
// and cluster launch attributes together and ties a half to a co-scheduled
// peer; the barrier needs neither, and the per-step route is the same three
// phases as three kinds of launches, so the two routes share every sum.
//
// Each work item is one shard's block b of ga_d = min(ceil(n_d / 32), 132)
// and walks the tiles b, b + ga_d, ... of data block d, as K5's items do;
// the halves' items alternate, so a block's items are of one half.  A
// block stages its half's weights from the fp32 params (K2's way, no
// global image: bf16 W_enc_m^T [64][FP+8], W_dec_m^T [FP][72], b_enc_m,
// b_dec) once a step, in A1, and keeps them through A2: the params change
// only in phase B, and the slot is assembled over the tile's arrays.  The backward runs on the tensor cores with K3's exact products
// (dr and da as three bf16 terms each): warp w takes hidden columns
// 16 (w % 4) .. + 15 and row tile (dh) or feature tiles (the weight sums)
// w / 4, w / 4 + 2, ..., so each warp holds half of K5's weight sums in
// registers.  A slot of a half is [dW_enc_m [F][64] | db_enc_m [64] |
// dW_dec_m^T [F][64] | db_dec [F] | loss]; phase B is fit_reduce at kH = 64
// over one half's slots (its long-runs form: any number of them).
//
// Scratch (floats): the slots, 2 x sum_d ga_d of half_floats(f) (half 0's,
// then half 1's, each data block's back to back in data order), then y,
// [2][N][F] (half 0's rows then half 1's, in data order), then one float
// for half 1's copy of the loss.
//
// What bounds it on the H100: the fit's own work, as K5 (chip_smoke.py,
// fit_bound over N rows); the per-step launches by their bytes.

#include "anomaly_fit_persistent.cuh"

namespace anomaly {

constexpr int kModel = 2;                 // model shards
constexpr int kHalf = kHidden / kModel;   // hidden units a model shard holds
constexpr int kLdq = kHalf + 8;           // row stride of the [.][kHalf]
                                          // arrays: (kLdq / 2) % 8 == 4
constexpr int kMaxData = 32;              // data blocks in the one-launch
                                          // fit's table: 64 shards
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

// Phase A's working set (K5's PhaseA at half width), then the clean x tile
// [R][FP]:
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
// the step before wrote them, in other blocks).  Every thread calls it.
template <int FP>
__device__ __forceinline__ void stage_half(const PhaseM<FP>& m,
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

// Phase A1 of one item: block b of ga over data block d's n rows (x, noise
// at its first row), half m's params; writes y_m of its tiles' rows to y
// (the half's [n][f] rows of block d).  `stage`: stage half m's weights
// (false: they are already in shared memory, staged this step).  Begins
// with a barrier.
template <int FP>
__device__ void forward_item(const PhaseM<FP>& m, const float* x,
                             const float* noise, float sigma,
                             const float* w_enc, const float* b_enc,
                             const float* w_dec, const float* b_dec, float* y,
                             int n, int b, int ga, int f, bool stage) {
  constexpr int R = kFitRows;
  const int tid = threadIdx.x;
  __syncthreads();   // the last item's readers of the working set are done
  if (stage) stage_half<FP>(m, w_enc, b_enc, w_dec, b_dec, f, tid);
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
template <int FP>
__device__ __forceinline__ void backward_tile(const PhaseM<FP>& m, int rows,
                                              HalfGrads<FP>& g) {
  constexpr int R = kFitRows;
  constexpr int kLdk = PhaseM<FP>::kLdk;
  constexpr int kDs = PhaseM<FP>::kDs;
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

// This block's slot `slot` of `slots` (half_floats(f) each), from g; every
// thread calls it (it begins with a barrier).  Assembled over the tile's
// arrays from xb on (the staged weights before them stay for the block's
// next item of the half), then stored coalesced.
template <int FP>
__device__ __forceinline__ void write_half_slot(const PhaseM<FP>& m,
                                                HalfGrads<FP>& g,
                                                float* slots, int slot,
                                                int f) {
  constexpr int kMt = HalfGrads<FP>::kMt;
  constexpr int kQ = HalfGrads<FP>::kQ;
  static_assert(model_smem_bytes(FP) - model_tile_offset(FP) >=
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
  const int pf = half_floats(f);
  const int o_be = f * kHalf;
  const int o_wd = o_be + kHalf;
  const int o_bd = o_wd + kHalf * f;
  float* part = slots + static_cast<size_t>(slot) * pf;
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

// Phase A2 of one item: as forward_item, then with the peer half's y
// (y_peer: its [n][f] rows of block d, loaded with each tile) r = (y_0 +
// y_1) + b_dec, e, dr and the backward; writes slot `slot` of `slots`.
template <int FP>
__device__ void partials_item(const PhaseM<FP>& m, const float* x,
                              const float* noise, float sigma,
                              const float* w_enc, const float* b_enc,
                              const float* w_dec, const float* b_dec,
                              const float* y_peer, float* slots, int slot,
                              float inv_count, int n, int b, int ga, int f,
                              bool stage) {
  constexpr int R = kFitRows;
  constexpr int kLdk = PhaseM<FP>::kLdk;
  constexpr int kDs = PhaseM<FP>::kDs;
  const int tid = threadIdx.x;
  __syncthreads();   // the last item's readers of the working set are done
  if (stage) stage_half<FP>(m, w_enc, b_enc, w_dec, b_dec, f, tid);
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
                   b_dec, y, n, blockIdx.x, gridDim.x, f, true);
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
                    gridDim.x, f, true);
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

// ------------------------------------------------------ the one-launch fit

// The data blocks of one fit, by value in the kernel's parameter space
struct ModelTable {
  const float* x[kMaxData];       // block d's [n_d, f] rows
  const float* noise[kMaxData];   // its [steps, n_d, f] noise
  long long stride[kMaxData];     // floats from one step's noise to the next
  int rows[kMaxData];             // n_d
  int row0[kMaxData];             // its first row in the batch: sum of n_r
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

// Work item k of 2 x half_slots: half m = k % 2, slot i = k / 2 of that
// half's = data block d's block b = i - slot0[d] of its ga.  The halves
// alternate, so over an even grid (one block per SM: 132 on an H100) the
// items k, k + gb, ... of a block are all of one half, and it stages that
// half's weights once a step.
struct ModelItem {
  int m;
  int d;
  int slot;
  int b;
  int ga;
};

__host__ __device__ inline ModelItem model_item(const ModelTable& t, int k) {
  const int m = k % kModel;
  const int slot = k / kModel;
  int d = 0;
  while (d + 1 < t.blocks && t.slot0[d + 1] <= slot) ++d;
  return {m, d, slot, slot - t.slot0[d], fit_slots(t.rows[d])};
}

template <int FP>
__global__ void __launch_bounds__(kFitThreads, 1)
model_fit_kernel(const __grid_constant__ ModelTable table,
                 const __grid_constant__ Halves hv, float sigma,
                 float* slots, float* y, float* discard, float* losses,
                 float lr, float count, float inv_count, int n_total, int f,
                 int steps, int half_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const PhaseM<FP> m(smem);
  const int items = kModel * half_slots;
  const size_t per_half = static_cast<size_t>(n_total) * f;
  const int pf = half_floats(f);
  const int slices = (pf + kFitSlice - 1) / kFitSlice;
  for (int s = 0; s < steps; ++s) {
    int staged = -1;   // the half whose weights are in shared memory
    for (int k = blockIdx.x; k < items; k += gridDim.x) {   // A1
      const ModelItem it = model_item(table, k);
      forward_item<FP>(m, table.x[it.d],
                       table.noise[it.d] + s * table.stride[it.d], sigma,
                       hv.w_enc[it.m], hv.b_enc[it.m], hv.w_dec[it.m],
                       hv.b_dec[it.m],
                       y + it.m * per_half +
                           static_cast<size_t>(table.row0[it.d]) * f,
                       table.rows[it.d], it.b, it.ga, f, it.m != staged);
      staged = it.m;
    }
    grid.sync();
    for (int k = blockIdx.x; k < items; k += gridDim.x) {   // A2
      const ModelItem it = model_item(table, k);
      partials_item<FP>(m, table.x[it.d],
                        table.noise[it.d] + s * table.stride[it.d], sigma,
                        hv.w_enc[it.m], hv.b_enc[it.m], hv.w_dec[it.m],
                        hv.b_dec[it.m],
                        y + (kModel - 1 - it.m) * per_half +
                            static_cast<size_t>(table.row0[it.d]) * f,
                        slots + static_cast<size_t>(it.m) * half_slots * pf,
                        it.slot, inv_count, table.rows[it.d], it.b, it.ga, f,
                        it.m != staged);
      staged = it.m;
    }
    grid.sync();
    for (int q = blockIdx.x; q < kModel * slices; q += gridDim.x) {   // B
      const int h = q / slices;
      fit_reduce<kFitWidth, kFitCols, true, kHalf>(
          q - h * slices, threadIdx.x, reinterpret_cast<float*>(smem),
          slots + static_cast<size_t>(h) * half_slots * pf, half_slots, f,
          hv.w_enc[h], hv.b_enc[h], hv.w_dec[h], hv.b_dec[h],
          h == 0 ? losses + s : discard, lr, count, nullptr, FP);
    }
    grid.sync();
  }
}

template <int FP>
int model_fit(const ModelTable& table, const Halves& hv, int n_total,
              float sigma, float* scratch, long long scratch_floats,
              float* losses, float lr, int f, int steps, cudaStream_t s) {
  static_assert(model_work_bytes(FP) >=
                    sizeof(float) * kReduceGroups * kFitSlice,
                "phase B's groups fit in phase A's working set");
  const int last = table.blocks - 1;
  int half_slots = table.slot0[last] + fit_slots(table.rows[last]);
  const long long slot_floats =
      static_cast<long long>(kModel) * half_slots * half_floats(f);
  const long long y_floats = static_cast<long long>(kModel) * n_total * f;
  if (steps < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      scratch_floats < slot_floats + y_floats + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = model_smem_bytes(FP);
  int gb = 0;
  err = grid_blocks(reinterpret_cast<const void*>(model_fit_kernel<FP>),
                    std::min(kModel * half_slots, sms), smem, &gb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gb != sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  float* slots = scratch;
  float* y = scratch + slot_floats;
  float* discard = y + y_floats;
  float count = model_count(n_total, f);
  float inv_count = 1.0f / count;
  void* args[] = {const_cast<ModelTable*>(&table), const_cast<Halves*>(&hv),
                  &sigma, &slots, &y, &discard, &losses, &lr, &count,
                  &inv_count, &n_total, &f, &steps, &half_slots};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(model_fit_kernel<FP>), dim3(gb),
      dim3(kFitThreads), args, smem, s);
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  return static_cast<int>(err);
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

// The whole fit over `blocks` data blocks of one card in one launch: `table`
// holds blocks x 4 int64, for each block in data order its x pointer
// ([n_d, f] floats), its noise pointer ([steps, n_d, f], each step's rows
// contiguous), the floats from one step's noise to the next, and n_d;
// `halves` holds 8 int64, half 0's w_enc, b_enc, w_dec, b_dec pointers, then
// half 1's.  Scratch: `scratch_floats` floats at a 16-byte aligned
// `scratch`: both halves' slots, then y [2][N][f], then one float.
// `losses` gets one float per step, the loss before that step's update.
extern "C" int anomaly_fit_model_fit(const long long* table, int blocks,
                                     const long long* halves, float sigma,
                                     float* scratch, long long scratch_floats,
                                     float* losses, float lr, int f,
                                     int steps, void* stream) {
  using namespace anomaly;
  if (table == nullptr || halves == nullptr || blocks < 1 ||
      blocks > kMaxData || f < 1 || f > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ModelTable t = {};
  t.blocks = blocks;
  long long n_total = 0;
  int slot = 0;
  for (int d = 0; d < blocks; ++d) {
    const long long* e = table + 4 * d;
    t.x[d] = reinterpret_cast<const float*>(static_cast<uintptr_t>(e[0]));
    t.noise[d] = reinterpret_cast<const float*>(static_cast<uintptr_t>(e[1]));
    t.stride[d] = e[2];
    if (t.x[d] == nullptr || t.noise[d] == nullptr || e[3] < 1 ||
        e[3] > (1 << 30) || e[2] < e[3] * f) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.rows[d] = static_cast<int>(e[3]);
    t.row0[d] = static_cast<int>(n_total);
    t.slot0[d] = slot;
    slot += fit_slots(t.rows[d]);
    n_total += e[3];
    if (n_total > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  }
  Halves hv = {};
  for (int h = 0; h < kModel; ++h) {
    float* p[4];
    for (int i = 0; i < 4; ++i) {
      p[i] = reinterpret_cast<float*>(static_cast<uintptr_t>(halves[4 * h + i]));
      if (p[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
    hv.w_enc[h] = p[0];
    hv.b_enc[h] = p[1];
    hv.w_dec[h] = p[2];
    hv.b_dec[h] = p[3];
  }
  const int n = static_cast<int>(n_total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((f + 15) / 16) {
    case 1:
      return model_fit<16>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, s);
    case 2:
      return model_fit<32>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, s);
    case 3:
      return model_fit<48>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, s);
    default:
      return model_fit<64>(t, hv, n, sigma, scratch, scratch_floats, losses,
                           lr, f, steps, s);
  }
}
