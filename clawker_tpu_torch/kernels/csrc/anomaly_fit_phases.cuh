// The two phases of one (denoising) SGD step of the anomaly autoencoder,
// as __device__ functions.  K2 (anomaly_fit_step.cu) runs them as two
// launches per step; K3 (anomaly_fit.cu) runs both for every step inside
// one persistent launch; K5 (anomaly_fit_shard.cu) runs phase A once per
// shard of the rows and phase B once over all the shards' slots.  The
// step's arithmetic exists only here, so K2 and K3 give bit-identical
// params and losses, and so does K5 over one shard.
//
//   noisy = x + sigma * noise
//   forward of K1 on noisy; e = r - x (clean, unrounded)
//   loss  = mean(e^2) over all n*F
//   dr    = (2 e) / (n F)
//   dh    = bf(dr . bf(W_dec)^T)      (the row's full sum, then bf16)
//   da    = dh * gelu'(a)
//   dW_dec = bf(sum_i bf(g)^T dr)     dW_enc = bf(sum_i bf(noisy)^T da)
//   db_dec = sum_i dr                 db_enc = sum_i da      (fp32)
//   p -= lr * grad                    (all four params, in place)
//
// These are the rounding points of jax.grad of the reference loss: the
// backward dots multiply the fp32 cotangent by a bf16 operand and round the
// RESULT to bf16.  So the weight gradients may be rounded only after the sum
// over ALL rows -- rounding each tile's partial would not match.
//
// * Phase A: `ga` = min(ceil(n / kFitRows), 132) blocks of 256 threads.
//   Each block needs the STAGED WEIGHTS in shared memory (`Staged`: bf16
//   W_enc^T [H][FP+8] and W_dec^T [FP][H+8], transposed with padded row
//   strides so that the fragment loads meet no bank conflict, then fp32
//   b_enc [H] and b_dec [FP]; zeros past f).  K2 builds them from the fp32
//   params (stage_params); K3 copies a ready-made image of them that its
//   phase B keeps in global memory.  The block then walks its row tiles
//   t = block, block + ga, ... (fit_tile) and keeps its unrounded fp32
//   gradient sums in registers (Grads).  It writes one slot of scratch
//   (write_slot): ga x (2 F H + H + F + 1) floats, <= 4.4 MB at F = 32,
//   laid out
//   [dW_enc [F][H] | db_enc [H] | dW_dec^T [F][H] | db_dec [F] | loss]
//   and assembled in shared memory first, so that the block writes it with
//   coalesced stores.
// * The two forward products have bf16 operands on both sides: they run on
//   the tensor cores (mma.sync m16n8k16 bf16 -> fp32, forward_tile in
//   anomaly_common.cuh).  The products are exact; the fp32 accumulation
//   behaves like rounding toward zero after each 16-deep step, so now and
//   then a bf16(g) lands one ulp off the plain version's.
// * The three backward products (dr . bf(W_dec)^T, bf(noisy)^T . da,
//   bf(g)^T . dr) multiply the UNROUNDED fp32 cotangent: one bf16 MMA would
//   round it, and TF32 would drop 13 of its bits.  So dr and da are split
//   into three bf16 terms each, hi + mid + lo == the fp32 value exactly
//   (Split3), and each product is three bf16 MMAs into one fp32
//   accumulator: every product is exact, only the order and rounding of
//   the sums are the tensor cores'.  The two weight sums reduce over the
//   tile's rows, which run down the rows of xb, gs, drs and das in shared
//   memory: ldmatrix .trans loads those operands transposed, so nothing is
//   stored twice.  Warp w owns hidden columns 16 w .. 16 w + 15 of dh and
//   of both weight sums; the weight sums stay in registers (Grads) across
//   the block's tiles.  The bias sums stay fp32 adds over the rows in
//   order.
// * Phase B (fit_reduce): a block of 8 groups of threads takes the slice
//   of parameters it is given (K2: 64 threads a group, one parameter each;
//   K3: 32 threads, two each); each group sums fixed contiguous runs of
//   <= 17 slots, read coalesced (all of a run's loads in flight at once,
//   then added in order), and the groups are combined in a fixed tree,
//   ((g0+g4)+(g2+g6)) + ((g1+g5)+(g3+g7)).  The order of additions does
//   not depend on the slice's shape.  No float atomics: two runs on the
//   same inputs give bit-identical params.  Then it rounds the full weight
//   sums to bf16, updates the params in place and writes the step's loss;
//   given a staged image (K3), it also writes each updated param there,
//   bf16 for the weights, at the place phase A's shared memory wants it.
//   bf16 of one fp32 value is the same bits wherever it is rounded, so the
//   image equals what stage_params would build from the new params.
//
// The params, the slots and the staged image are read through L2 (__ldcg,
// cp.async.cg), never through the read-only path (ld.global.nc) or L1,
// which are not coherent within a kernel: in K3, phase A reads the image
// that phase B of the step before wrote, and phase B reads the slots that
// phase A of the same step wrote.
//
// Every elementwise step uses the _rn intrinsics (no FMA contraction where
// the plain version rounds twice); no --use_fast_math.
#pragma once

#include <cstdint>

#include "anomaly_common.cuh"

namespace anomaly {

// The tiling; kernels/anomaly.py names the same numbers (FIT_ROWS,
// FIT_MAX_BLOCKS, REDUCE_GROUPS) to size the scratch, and the CPU tests
// group their sums by them.
constexpr int kFitRows = 32;         // R, rows per tile: faster than 64 on
                                     // an H100 at every main-path shape
constexpr int kFitThreads = 256;     // 8 warps
constexpr int kFitMaxBlocks = 132;   // ga <= one block per H100 SM
constexpr int kReduceGroups = 8;     // slot groups per phase-B block
constexpr int kReduceRun =           // the longest run of slots a group sums
    (kFitMaxBlocks + kReduceGroups - 1) / kReduceGroups;

__host__ __device__ constexpr int param_floats(int f) {
  // dW_enc [f][H], db_enc [H], dW_dec^T [f][H], db_dec [f], loss sum
  return 2 * f * kHidden + kHidden + f + 1;
}

// Slots of phase A (its blocks) for n rows.
__host__ __device__ constexpr int fit_slots(int n) {
  return (n + kFitRows - 1) / kFitRows < kFitMaxBlocks
             ? (n + kFitRows - 1) / kFitRows
             : kFitMaxBlocks;
}

// Phase A's working set in shared memory, at offset 0 (fp32 arrays first,
// 16-byte aligned rows, then the staged weights, then bf16):
//   as [R][kLdh]      gelu'(a), then da in place
//   dr [R][FP+1]      dr (fp32, for db_dec)
//   red [8]           per-warp loss sums
//   staged            staged_bytes(FP)
//   xb [R][FP+8]      bf(noisy)
//   gs [R][kLdh]      bf(gelu(a))
//   drs [3][R][FP+8]  dr as three bf16 terms, hi + mid + lo == dr exactly
//   das [3][R][kLdh]  da as three bf16 terms
// The slot is assembled over it, and phase B's sums reuse its start.  The
// kernels put their fp32 x tiles (tile_bytes each) after it.
__host__ __device__ constexpr size_t work_bytes(int fp) {
  return sizeof(float) * (kFitRows * kLdh + kFitRows * (fp + 1) +
                          kFitThreads / 32) +
         staged_bytes(fp) +
         sizeof(__nv_bfloat16) * (4 * kFitRows * (fp + 8) +
                                  4 * kFitRows * kLdh);
}

__host__ __device__ constexpr size_t tile_bytes(int fp) {
  return sizeof(float) * kFitRows * fp;
}

template <int FP>
struct PhaseA {
  static constexpr int kLdk = FP + 8;
  static constexpr int kDs = FP + 1;
  float* as;
  float* dr;
  float* red;
  Staged w;
  __nv_bfloat16* xb;
  __nv_bfloat16* gs;
  __nv_bfloat16* drs;
  __nv_bfloat16* das;
  __device__ explicit PhaseA(unsigned char* smem)
      : as(reinterpret_cast<float*>(smem)),
        dr(as + kFitRows * kLdh),
        red(dr + kFitRows * kDs),
        w(reinterpret_cast<unsigned char*>(red + kFitThreads / 32), FP),
        xb(reinterpret_cast<__nv_bfloat16*>(
            reinterpret_cast<unsigned char*>(w.weT) + staged_bytes(FP))),
        gs(xb + kFitRows * kLdk),
        drs(gs + kFitRows * kLdh),
        das(drs + 3 * kFitRows * kLdk) {}
};

// A block's unrounded gradient sums, in registers.  Warp w owns the hidden
// columns h = 16 w .. 16 w + 15 of both weight sums, as mma.sync tiles:
// we[mt][nt] is the C fragment of dW_enc rows j = 16 mt.., columns
// h = 16 w + 8 nt..; wd the same of dW_dec^T.  Thread tid < H sums
// db_enc[tid], thread H + j < H + FP sums db_dec[j].
template <int FP>
struct Grads {
  static constexpr int kMt = FP / 16;
  float we[kMt][2][4];
  float wd[kMt][2][4];
  float bias;
  float sq;          // squared error
};

// No trace: K2's phase A
struct NoMarks {
  __device__ void operator()(int) const {}
};

// v as three bf16 terms, hi + mid + lo == v exactly: each step takes the
// top 8 bits of what is left, and an fp32 value has 24
struct Split3 {
  __nv_bfloat16 t[3];
  __device__ explicit Split3(float v) {
    t[0] = __float2bfloat16_rn(v);
    const float r = __fsub_rn(v, __bfloat162float(t[0]));
    t[1] = __float2bfloat16_rn(r);
    t[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(t[1])));
  }
};

// One tile of rows row0.. (rows of them) on a block whose shared memory
// holds the staged weights, xb = bf(noisy) and xc = the clean x tile
// [R][FP] (zeros past rows and f), synced: the forward, dr, dh/da and the
// tile's rows added into g.  Ends without a barrier; the caller syncs
// before it overwrites xb, xc or the staged weights.  mark(3) after the
// forward, mark(4) after dh/da.
//
// The three backward products run on the tensor cores too, without
// rounding the fp32 cotangent: dr and da are split into three bf16 terms
// each (Split3), and each product is the sum of three bf16 products, each
// exact in the fp32 accumulator.  The sums differ from an fp32 FMA chain
// only in their order and rounding (the tensor cores' accumulation), as
// the forward's do.  Rows past `rows` and features past f are zeros in xb,
// dr and da, so they add exact zeros.  The bias sums stay fp32 adds over
// the rows in order.
template <int FP, class Mark>
__device__ __forceinline__ void fit_tile(const PhaseA<FP>& m,
                                         const float* xc, int rows, int f,
                                         float inv_count, Grads<FP>& g,
                                         Mark& mark) {
  constexpr int R = kFitRows;
  constexpr int kLdk = PhaseA<FP>::kLdk;
  constexpr int kDs = PhaseA<FP>::kDs;
  constexpr int kMt = Grads<FP>::kMt;
  static_assert(R == 32 && kFitThreads / 32 * 16 == kHidden,
                "8 warps of 16 hidden columns; two row tiles of 16");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int h0 = 16 * warp;
  float* as = m.as;
  float* dr = m.dr;
  const float* bd = m.w.bd;
  __nv_bfloat16* drs = m.drs;
  __nv_bfloat16* das = m.das;

  // forward on the tensor cores; the decoder's epilogue forms e, dr (fp32
  // and split) and the squared error (rows past n and features past f
  // give dr = 0)
  forward_tile<R, kFitThreads / 32>(
      m.xb, kLdk, FP, m.w.weT, kLdk, m.w.be, as, kLdh, m.gs, kLdh, m.w.wdT,
      kLdh, FP, warp, lane, [&](int i, int j, float acc) {
        float d = 0.0f;
        if (i < rows && j < f) {
          const float e = __fsub_rn(__fadd_rn(acc, bd[j]), xc[i * FP + j]);
          g.sq = __fadd_rn(g.sq, __fmul_rn(e, e));
          d = __fmul_rn(__fmul_rn(2.0f, e), inv_count);
        }
        dr[i * kDs + j] = d;
        const Split3 sd(d);
#pragma unroll
        for (int u = 0; u < 3; ++u) drs[(u * R + i) * kLdk + j] = sd.t[u];
      });
  __syncthreads();
  mark(3);

  // dh = dr . bf(W_dec)^T (B[j][h] = wdT[j][h]), the row's full sum over F
  // rounded to bf16; da = dh * gelu'(a) overwrites gelu'(a), and goes to
  // das
  {
    float acc[2][2][4] = {};   // [row tile][column tile]
#pragma unroll
    for (int k0 = 0; k0 < FP; k0 += 16) {
      uint32_t b[4];
      load_b2_trans(b, m.w.wdT, kLdh, h0, k0, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int u = 2; u >= 0; --u) {   // lo, mid, hi
          uint32_t a[4];
          load_a(a, drs + u * R * kLdk, kLdk, 16 * mt, k0, lane);
          mma_bf16_16816(acc[mt][0], a, b);
          mma_bf16_16816(acc[mt][1], a, b + 2);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * mt + gq + 8 * half;
          const int h = h0 + 8 * nt + t2;
          float2* ap = reinterpret_cast<float2*>(as + i * kLdh + h);
          float2 a = *ap;
          a.x = __fmul_rn(bf(acc[mt][nt][2 * half]), a.x);
          a.y = __fmul_rn(bf(acc[mt][nt][2 * half + 1]), a.y);
          *ap = a;
          const Split3 s0(a.x);
          const Split3 s1(a.y);
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            __nv_bfloat162 v;
            v.x = s0.t[u];
            v.y = s1.t[u];
            *reinterpret_cast<__nv_bfloat162*>(das + (u * R + i) * kLdh + h) =
                v;
          }
        }
      }
    }
  }
  __syncthreads();
  mark(4);

  // the bias sums, fp32 over the rows in order
  if (tid < kHidden) {
    for (int i = 0; i < rows; ++i) {
      g.bias = __fadd_rn(g.bias, as[i * kLdh + tid]);
    }
  } else if (tid < kHidden + FP) {
    for (int i = 0; i < rows; ++i) {
      g.bias = __fadd_rn(g.bias, dr[i * kDs + tid - kHidden]);
    }
  }
  // the weight sums over the tile's rows (k = i):
  //   dW_enc[j][h]   += sum_i xb[i][j] da[i][h]
  //   dW_dec^T[j][h] += sum_i dr[i][j] gs[i][h]
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += 16) {
    uint32_t bda[3][4];
    uint32_t bg[4];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      load_b2_trans(bda[u], das + u * R * kLdh, kLdh, h0, k0, lane);
    }
    load_b2_trans(bg, m.gs, kLdh, h0, k0, lane);
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      uint32_t a[4];
      load_a_trans(a, m.xb, kLdk, 16 * mt, k0, lane);
#pragma unroll
      for (int u = 2; u >= 0; --u) {
        mma_bf16_16816(g.we[mt][0], a, bda[u]);
        mma_bf16_16816(g.we[mt][1], a, bda[u] + 2);
      }
#pragma unroll
      for (int u = 2; u >= 0; --u) {
        load_a_trans(a, drs + u * R * kLdk, kLdk, 16 * mt, k0, lane);
        mma_bf16_16816(g.wd[mt][0], a, bg);
        mma_bf16_16816(g.wd[mt][1], a, bg + 2);
      }
    }
  }
}

// This block's slot `block` of `partials`, from g (every thread calls it;
// it begins with a barrier).  mark(5) once the tiles' sums are all in.
// The slot is assembled over the working set first, its weight rows
// padded to kLdh floats so that no two rows of a fragment store meet in a
// bank, and then stored coalesced.
template <int FP, class Mark>
__device__ __forceinline__ void write_slot(const PhaseA<FP>& m,
                                           Grads<FP>& g, float* partials,
                                           int block, int f, Mark& mark) {
  constexpr int kMt = Grads<FP>::kMt;
  static_assert(work_bytes(FP) >=
                    sizeof(float) * (2 * FP * kLdh + kHidden + FP + 1),
                "phase A assembles its slot over its working set");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t2 = 2 * (lane & 3);
  float sq = g.sq;
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) m.red[warp] = sq;
  __syncthreads();
  mark(5);
  float loss = 0.0f;
  if (tid == 0) {
    for (int w = 0; w < kFitThreads / 32; ++w) loss = __fadd_rn(loss, m.red[w]);
  }
  __syncthreads();   // the tiles' arrays are free: assemble the slot there

  float* s_we = m.as;                 // dW_enc [FP][kLdh]
  float* s_wd = s_we + FP * kLdh;     // dW_dec^T [FP][kLdh]
  float* s_b = s_wd + FP * kLdh;      // db_enc [H], db_dec [f], loss
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q =
            (16 * mt + gq + 8 * half) * kLdh + 16 * warp + 8 * nt + t2;
        *reinterpret_cast<float2*>(s_we + q) =
            make_float2(g.we[mt][nt][2 * half], g.we[mt][nt][2 * half + 1]);
        *reinterpret_cast<float2*>(s_wd + q) =
            make_float2(g.wd[mt][nt][2 * half], g.wd[mt][nt][2 * half + 1]);
      }
    }
  }
  if (tid < kHidden + f) s_b[tid] = g.bias;
  if (tid == 0) s_b[kHidden + f] = loss;
  __syncthreads();
  const int pf = param_floats(f);
  const int o_be = f * kHidden;
  const int o_wd = o_be + kHidden;
  const int o_bd = o_wd + kHidden * f;
  float* part = partials + static_cast<size_t>(block) * pf;
  // two rows of H per pass, each warp a 128-byte run
  const int c = tid % kHidden;
#pragma unroll 4
  for (int j = tid / kHidden; j < f; j += kFitThreads / kHidden) {
    part[j * kHidden + c] = s_we[j * kLdh + c];
    part[o_wd + j * kHidden + c] = s_wd[j * kLdh + c];
  }
  if (tid < kHidden) {
    part[o_be + tid] = s_b[tid];
  } else if (tid <= kHidden + f) {   // db_dec, then the loss
    part[o_bd + tid - kHidden] = s_b[tid];
  }
}

// K2's phase A for block `block` of `ga` (kFitThreads threads): the
// weights staged from the fp32 params, each tile loaded from x and noise
// (global memory), slot `block` of `partials`.  `smem` holds
// work_bytes(FP) + tile_bytes(FP).
template <int FP>
__device__ __forceinline__ void fit_partials(
    int block, int ga, const float* __restrict__ x,
    const float* __restrict__ noise, float sigma, const float* w_enc,
    const float* b_enc, const float* w_dec, const float* b_dec,
    float* partials, float inv_count, int n, int f, unsigned char* smem) {
  constexpr int R = kFitRows;
  const PhaseA<FP> m(smem);
  float* xc = reinterpret_cast<float*>(smem + work_bytes(FP));
  const int tid = threadIdx.x;
  NoMarks mark;

  stage_params<FP>(m.w, w_enc, b_enc, w_dec, b_dec, f, tid, kFitThreads);
  Grads<FP> g = {};
  const int tiles = (n + R - 1) / R;
  for (int t = block; t < tiles; t += ga) {
    const int row0 = t * R;
    const int rows = min(R, n - row0);
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < R * FP; idx += kFitThreads) {
      const int i = idx / FP;
      const int j = idx - i * FP;
      float xv = 0.0f;
      float nv = 0.0f;
      if (i < rows && j < f) {
        const size_t gi = static_cast<size_t>(row0 + i) * f + j;
        xv = x[gi];
        nv = noise ? __fadd_rn(xv, __fmul_rn(sigma, noise[gi])) : xv;
      }
      xc[idx] = xv;
      m.xb[i * PhaseA<FP>::kLdk + j] = __float2bfloat16_rn(nv);
    }
    __syncthreads();
    fit_tile<FP>(m, xc, rows, f, inv_count, g, mark);
  }
  write_slot<FP>(m, g, partials, block, f, mark);
}

// Phase B for parameter slice `slice` of kSlice = kWidth x kCols
// parameters, by the block's threads tid < kWidth * kReduceGroups: thread
// tid sums, in group tid / kWidth, the columns tid % kWidth + kWidth c
// (c < kCols).  `red` holds kReduceGroups * kSlice floats of shared
// memory.  `staged` is null (K2) or K3's image of the staged weights for
// FP = fp, which gets each updated param.  Every thread must call it (it
// holds __syncthreads).  kLongRuns (K5): more than kReduceGroups x
// kReduceRun slots may come in, so a group's run is read in chunks of
// kReduceRun and added, in the same order, into one sum; for runs of
// <= kReduceRun that is the same sum as K2's and K3's.
template <int kWidth, int kCols, bool kLongRuns = false>
__device__ __forceinline__ void fit_reduce(
    int slice, int tid, float* red, const float* partials, int slots, int f,
    float* w_enc, float* b_enc, float* w_dec, float* b_dec, float* loss_out,
    float lr, float count, unsigned char* staged, int fp) {
  constexpr int kSlice = kWidth * kCols;
  const int stride = param_floats(f);
  const int grp = tid / kWidth;
  const int per = (slots + kReduceGroups - 1) / kReduceGroups;
  const int s0 = min(grp * per, slots);
  const int len = min(s0 + per, slots) - s0;
  if constexpr (kLongRuns) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int p = slice * kSlice + tid % kWidth + kWidth * c;
      float s = 0.0f;
      for (int k0 = 0; p < stride && k0 < len; k0 += kReduceRun) {
        float v[kReduceRun];
#pragma unroll
        for (int k = 0; k < kReduceRun; ++k) {
          v[k] = k0 + k < len
                     ? __ldcg(partials +
                              static_cast<size_t>(s0 + k0 + k) * stride + p)
                     : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kReduceRun; ++k) {
          if (k0 + k < len) s = __fadd_rn(s, v[k]);
        }
      }
      red[grp * kSlice + tid % kWidth + kWidth * c] = s;
    }
  } else {
    float v[kCols][kReduceRun];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int p = slice * kSlice + tid % kWidth + kWidth * c;
      const int run = p < stride ? len : 0;
#pragma unroll
      for (int k = 0; k < kReduceRun; ++k) {
        v[c][k] = k < run ? __ldcg(partials +
                                   static_cast<size_t>(s0 + k) * stride + p)
                          : 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kReduceRun; ++k) {
        if (k < len) s = __fadd_rn(s, v[c][k]);
      }
      red[grp * kSlice + tid % kWidth + kWidth * c] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int half = kReduceGroups / 2; half > 0; half >>= 1) {
    for (int q = tid; q < half * kSlice; q += kWidth * kReduceGroups) {
      red[q] = __fadd_rn(red[q], red[q + half * kSlice]);
    }
    __syncthreads();
  }
  const int o_be = f * kHidden;
  const int o_wd = o_be + kHidden;
  const int o_bd = o_wd + kHidden * f;
  const int o_loss = o_bd + f;
  for (int q = tid; q < kSlice; q += kWidth * kReduceGroups) {
    const int p = slice * kSlice + q;
    if (p >= stride) break;
    const float s = red[q];
    if (p < o_be) {
      const float u = __fsub_rn(__ldcg(w_enc + p), __fmul_rn(lr, bf(s)));
      w_enc[p] = u;
      if (staged != nullptr) {   // W_enc[j][h] -> weT[h][j]
        const int j = p / kHidden;
        Staged(staged, fp).weT[(p - j * kHidden) * (fp + 8) + j] =
            __float2bfloat16_rn(u);
      }
    } else if (p < o_wd) {
      const int i = p - o_be;
      const float u = __fsub_rn(__ldcg(b_enc + i), __fmul_rn(lr, s));
      b_enc[i] = u;
      if (staged != nullptr) Staged(staged, fp).be[i] = u;
    } else if (p < o_bd) {   // the slot holds dW_dec transposed
      const int j = (p - o_wd) / kHidden;
      const int h = p - o_wd - j * kHidden;
      const int i = h * f + j;
      const float u = __fsub_rn(__ldcg(w_dec + i), __fmul_rn(lr, bf(s)));
      w_dec[i] = u;
      if (staged != nullptr) {   // W_dec[h][j] -> wdT[j][h]
        Staged(staged, fp).wdT[j * kLdh + h] = __float2bfloat16_rn(u);
      }
    } else if (p < o_loss) {
      const int i = p - o_bd;
      const float u = __fsub_rn(__ldcg(b_dec + i), __fmul_rn(lr, s));
      b_dec[i] = u;
      if (staged != nullptr) Staged(staged, fp).bd[i] = u;
    } else {
      *loss_out = __fdiv_rn(s, count);
    }
  }
}

}  // namespace anomaly
