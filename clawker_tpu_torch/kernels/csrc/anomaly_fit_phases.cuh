// The two phases of one (denoising) SGD step of the anomaly autoencoder,
// as __device__ functions.  K2 (anomaly_fit_step.cu) runs them as two
// launches per step; K3 (anomaly_fit.cu) runs both for every step inside
// one persistent launch.  The step's arithmetic exists only here, so the
// two kernels give bit-identical params and losses.
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
// * Phase A (fit_partials): `ga` = min(ceil(n / kFitRows), 132) blocks of
//   256 threads.  Each block rounds the weights to bf16 into shared memory
//   (transposed, with padded row strides so that neither the staging nor
//   the fragment loads meet a bank conflict), then walks its row tiles
//   t = block, block + ga, ... and keeps its unrounded fp32 gradient sums
//   in registers.  It writes one slot of scratch: ga x (2 F H + H + F + 1)
//   floats, <= 4.4 MB at F = 32, laid out
//   [dW_enc [F][H] | db_enc [H] | dW_dec^T [F][H] | db_dec [F] | loss]
//   and assembled in shared memory first, so that the block writes it with
//   coalesced stores.
// * The two forward products have bf16 operands on both sides: they run on
//   the tensor cores (mma.sync m16n8k16 bf16 -> fp32, forward_tile in
//   anomaly_common.cuh).  The products are exact; the fp32 accumulation
//   behaves like rounding toward zero after each 16-deep step, so now and
//   then a bf16(g) lands one ulp off the plain version's.
// * The three backward products (dr . bf(W_dec)^T, bf(noisy)^T . da,
//   bf(g)^T . dr) multiply the UNROUNDED fp32 cotangent: a bf16 MMA would
//   round it, and TF32 would drop 13 of its bits, so they stay fp32 FMAs on
//   the CUDA cores.  They are register-tiled: a thread owns a 2 x 8 tile of
//   dh, and a (F/16) x 8 tile of each weight gradient, all independent
//   accumulators fed from shared memory; no chain is longer than one
//   product's depth (F for dh, the block's rows for the weight sums).
// * Phase B (fit_reduce): a block of 8 groups of threads takes the slice
//   of parameters it is given (K2: 64 threads a group, one parameter each;
//   K3: 32 threads, two each); each group sums fixed contiguous runs of
//   <= 17 slots, read coalesced (all of a run's loads in flight at once,
//   then added in order), and the groups are combined in a fixed tree,
//   ((g0+g4)+(g2+g6)) + ((g1+g5)+(g3+g7)).  The order of additions does
//   not depend on the slice's shape.  No float atomics: two runs on the
//   same inputs give bit-identical params.  Then it rounds the full weight
//   sums to bf16, updates the params in place and writes the step's loss.
//
// The params and the slots are read through L2 (__ldcg), never through the
// read-only path (ld.global.nc), which is not coherent within a kernel: in
// K3, phase A reads the params that phase B of the step before wrote, and
// phase B reads the slots that phase A of the same step wrote.
//
// Every elementwise step uses the _rn intrinsics (no FMA contraction where
// the plain version rounds twice); no --use_fast_math.
#pragma once

#include "anomaly_common.cuh"

namespace anomaly {

// The tiling; kernels/anomaly.py names the same numbers (FIT_ROWS,
// FIT_MAX_BLOCKS, REDUCE_GROUPS) to size the scratch, and the CPU tests
// group their sums by them.  K1 keeps kTileRows.
constexpr int kFitRows = 32;         // R, rows per tile: faster than 64 on
                                     // an H100 at every main-path shape
constexpr int kFitThreads = 256;     // 8 warps
constexpr int kFitMaxBlocks = 132;   // ga <= one block per H100 SM
constexpr int kReduceGroups = 8;     // slot groups per phase-B block
constexpr int kReduceRun =           // the longest run of slots a group sums
    (kFitMaxBlocks + kReduceGroups - 1) / kReduceGroups;

constexpr int kLdh = kHidden + 8;    // row stride of the [.][H] arrays

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

// Shared memory of phase A for FP = f rounded up to 16.  fp32 arrays
// first (16-byte aligned rows), then bf16:
//   as [R][kLdh]  a, then da in place      xc [R][FP]  clean x
//   dr [R][FP+1]  dr (odd stride: the dh loop reads 4 rows of one column)
//   red [8]       per-warp loss sums
//   weT [H][FP+8], wdT [FP][kLdh], xb [R][FP+8], gs [R][kLdh]  (bf16)
__host__ __device__ constexpr size_t fit_smem_bytes(int fp) {
  return sizeof(float) * (kFitRows * kLdh + kFitRows * fp +
                          kFitRows * (fp + 1) + kFitThreads / 32) +
         sizeof(__nv_bfloat16) * (kHidden * (fp + 8) + fp * kLdh +
                                  kFitRows * (fp + 8) + kFitRows * kLdh);
}

__device__ __forceinline__ void bf16x4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Phase A for block `block` of `ga` (kFitThreads threads): slot `block`
// of `partials`.  `smem` holds fit_smem_bytes(FP).
template <int FP>
__device__ __forceinline__ void fit_partials(
    int block, int ga, const float* __restrict__ x,
    const float* __restrict__ noise, float sigma, const float* w_enc,
    const float* b_enc, const float* w_dec, const float* b_dec,
    float* partials, float inv_count, int n, int f, unsigned char* smem) {
  constexpr int R = kFitRows;
  constexpr int kLdk = FP + 8;
  constexpr int kDs = FP + 1;
  constexpr int kRt = R / 16;        // dh rows per thread
  constexpr int kQ = FP / 16;        // weight-gradient rows per thread
  static_assert(fit_smem_bytes(FP) >= sizeof(float) * param_floats(FP),
                "phase A assembles its slot in shared memory");
  float* as = reinterpret_cast<float*>(smem);
  float* xc = as + R * kLdh;
  float* dr = xc + R * FP;
  float* red = dr + R * kDs;
  __nv_bfloat16* weT = reinterpret_cast<__nv_bfloat16*>(red + kFitThreads / 32);
  __nv_bfloat16* wdT = weT + kHidden * kLdk;
  __nv_bfloat16* xb = wdT + FP * kLdh;
  __nv_bfloat16* gs = xb + R * kLdk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // backward ownership: columns h = 4 tx + e + 64 c (e < 4, c < 2), and
  // rows ty * kRt + r of dh or rows j = ty + 16 q of the weight gradients
  const int tx = tid & 15;
  const int ty = tid >> 4;

  stage_transposed(weT, kLdk, w_enc, kHidden, f, kHidden, FP, kHidden, tid,
                   kFitThreads);
  stage_transposed(wdT, kLdh, w_dec, f, kHidden, f, kHidden, FP, tid,
                   kFitThreads);

  float gwe[kQ][8] = {};   // dW_enc[j][h]
  float gwd[kQ][8] = {};   // dW_dec[h][j]
  float gbe[8] = {};       // db_enc[h], rows ty == 0
  float gbd[kQ] = {};      // db_dec[j], columns tx == 0
  float sq = 0.0f;

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
        const size_t g = static_cast<size_t>(row0 + i) * f + j;
        xv = x[g];
        nv = noise ? __fadd_rn(xv, __fmul_rn(sigma, noise[g])) : xv;
      }
      xc[idx] = xv;
      xb[i * kLdk + j] = __float2bfloat16_rn(nv);
    }
    __syncthreads();

    // forward on the tensor cores; the decoder's epilogue forms e, dr and
    // the squared error (rows past n and features past f give dr = 0, so
    // they add nothing to any gradient below)
    forward_tile<R, kFitThreads / 32>(
        xb, kLdk, FP, weT, kLdk, b_enc, as, kLdh, gs, kLdh, wdT, kLdh, FP,
        warp, lane, [&](int i, int j, float acc) {
          float d = 0.0f;
          if (i < rows && j < f) {
            const float e =
                __fsub_rn(__fadd_rn(acc, __ldcg(b_dec + j)), xc[i * FP + j]);
            sq = __fadd_rn(sq, __fmul_rn(e, e));
            d = __fmul_rn(__fmul_rn(2.0f, e), inv_count);
          }
          dr[i * kDs + j] = d;
        });
    __syncthreads();

    // dh = dr . bf(W_dec)^T, the row's full sum over F rounded to bf16;
    // da = dh * gelu'(a) overwrites a (each thread its own elements)
    {
      float acc[kRt][8] = {};
#pragma unroll
      for (int j = 0; j < FP; ++j) {
        float w[8];
        bf16x4(wdT + j * kLdh + 4 * tx, w);
        bf16x4(wdT + j * kLdh + 64 + 4 * tx, w + 4);
#pragma unroll
        for (int r = 0; r < kRt; ++r) {
          const float d = dr[(ty * kRt + r) * kDs + j];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(d, w[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRt; ++r) {
        float* ap = as + (ty * kRt + r) * kLdh + 4 * tx;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float4 a = *reinterpret_cast<float4*>(ap + 64 * c);
          a.x = __fmul_rn(bf(acc[r][4 * c]), gelu_tanh_grad(a.x));
          a.y = __fmul_rn(bf(acc[r][4 * c + 1]), gelu_tanh_grad(a.y));
          a.z = __fmul_rn(bf(acc[r][4 * c + 2]), gelu_tanh_grad(a.z));
          a.w = __fmul_rn(bf(acc[r][4 * c + 3]), gelu_tanh_grad(a.w));
          *reinterpret_cast<float4*>(ap + 64 * c) = a;
        }
      }
    }
    __syncthreads();

    // the weight gradients: rank-1 updates row by row, unrounded fp32
    for (int i = 0; i < rows; ++i) {
      float da[8];
      float g[8];
      const float4 d0 = *reinterpret_cast<const float4*>(as + i * kLdh + 4 * tx);
      const float4 d1 =
          *reinterpret_cast<const float4*>(as + i * kLdh + 64 + 4 * tx);
      da[0] = d0.x; da[1] = d0.y; da[2] = d0.z; da[3] = d0.w;
      da[4] = d1.x; da[5] = d1.y; da[6] = d1.z; da[7] = d1.w;
      bf16x4(gs + i * kLdh + 4 * tx, g);
      bf16x4(gs + i * kLdh + 64 + 4 * tx, g + 4);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float xv = __bfloat162float(xb[i * kLdk + ty + 16 * q]);
        const float dv = dr[i * kDs + ty + 16 * q];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          gwe[q][c] = fmaf(xv, da[c], gwe[q][c]);
          gwd[q][c] = fmaf(g[c], dv, gwd[q][c]);
        }
        if (tx == 0) gbd[q] = __fadd_rn(gbd[q], dv);
      }
      if (ty == 0) {
#pragma unroll
        for (int c = 0; c < 8; ++c) gbe[c] = __fadd_rn(gbe[c], da[c]);
      }
    }
  }

  // this block's slot
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  float loss = 0.0f;
  if (tid == 0) {
    for (int w = 0; w < kFitThreads / 32; ++w) loss = __fadd_rn(loss, red[w]);
  }
  __syncthreads();   // the tiles' arrays are free: assemble the slot there

  float* slot = reinterpret_cast<float*>(smem);
  const int pf = param_floats(f);
  const int o_be = f * kHidden;
  const int o_wd = o_be + kHidden;
  const int o_bd = o_wd + kHidden * f;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = ty + 16 * q;
    if (j >= f) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int h = 4 * tx + 64 * c;
      *reinterpret_cast<float4*>(slot + j * kHidden + h) = make_float4(
          gwe[q][4 * c], gwe[q][4 * c + 1], gwe[q][4 * c + 2], gwe[q][4 * c + 3]);
      *reinterpret_cast<float4*>(slot + o_wd + j * kHidden + h) = make_float4(
          gwd[q][4 * c], gwd[q][4 * c + 1], gwd[q][4 * c + 2], gwd[q][4 * c + 3]);
    }
    if (tx == 0) slot[o_bd + j] = gbd[q];
  }
  if (ty == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      slot[o_be + 4 * tx + (c & 3) + 64 * (c >> 2)] = gbe[c];
    }
  }
  if (tid == 0) slot[pf - 1] = loss;
  __syncthreads();
  float* part = partials + static_cast<size_t>(block) * pf;
  for (int p = tid; p < pf; p += kFitThreads) part[p] = slot[p];
}

// Phase B for parameter slice `slice` of kSlice = kWidth x kCols
// parameters, by the block's threads tid < kWidth * kReduceGroups: thread
// tid sums, in group tid / kWidth, the columns tid % kWidth + kWidth c
// (c < kCols).  `red` holds kReduceGroups * kSlice floats of shared
// memory.  Every thread must call it (it holds __syncthreads).
template <int kWidth, int kCols>
__device__ __forceinline__ void fit_reduce(
    int slice, int tid, float* red, const float* partials, int slots, int f,
    float* w_enc, float* b_enc, float* w_dec, float* b_dec, float* loss_out,
    float lr, float count) {
  constexpr int kSlice = kWidth * kCols;
  const int stride = param_floats(f);
  const int grp = tid / kWidth;
  const int per = (slots + kReduceGroups - 1) / kReduceGroups;
  const int s0 = min(grp * per, slots);
  const int len = min(s0 + per, slots) - s0;
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
      w_enc[p] = __fsub_rn(__ldcg(w_enc + p), __fmul_rn(lr, bf(s)));
    } else if (p < o_wd) {
      const int i = p - o_be;
      b_enc[i] = __fsub_rn(__ldcg(b_enc + i), __fmul_rn(lr, s));
    } else if (p < o_bd) {   // the slot holds dW_dec transposed
      const int j = (p - o_wd) / kHidden;
      const int i = (p - o_wd - j * kHidden) * f + j;
      w_dec[i] = __fsub_rn(__ldcg(w_dec + i), __fmul_rn(lr, bf(s)));
    } else if (p < o_loss) {
      const int i = p - o_bd;
      b_dec[i] = __fsub_rn(__ldcg(b_dec + i), __fmul_rn(lr, s));
    } else {
      *loss_out = __fdiv_rn(s, count);
    }
  }
}

}  // namespace anomaly
