// K1: fused anomaly score -- per-row mean squared reconstruction error of
// the two-layer autoencoder, one launch for the whole batch.
//
// Replaces: clawker_tpu/analytics/anomaly.py:59 score (with _reconstruct,
// :43), jitted at clawker_tpu/analytics/runtime.py:145.
//
//   a = bf(x) . bf(W_enc) + b_enc        (bf16 operands, fp32 accumulate)
//   g = gelu_tanh(a)                      (fp32)
//   r = bf(g) . bf(W_dec) + b_dec
//   score[i] = mean_j (r[i,j] - x[i,j])^2 (x unrounded fp32)
//
// What bounds it on the H100: at the main-path shapes ([n <= 4224, F <=
// 40], H = 128) the bytes (x in, one float out per row, ~50 KB of weights)
// take well under a microsecond at 3.35 TB/s, and the 4 nFH flops of the
// two products less at the bf16 tensor rate.  What sets the time is the
// latency of one block and of the launch itself.
//
// Design: one block of 256 threads (8 warps) per tile of kScoreRows = 32
// rows, ceil(n / 32) blocks: one wave of the 132 SMs at n = 4224.  Each
// block
//   * issues its x tile's loads first (coalesced; rows >= n and columns
//     >= f read as zero), then stages the weights as K2 does
//     (stage_params: bf16 W_enc^T [H][FP+8], W_dec^T [FP][H+8], the fp32
//     biases), then stores the tile twice: fp32 x [32][FP+8] for the
//     error and bf(x) [32][FP+8] as the A operand;
//   * runs the forward on the tensor cores with forward_tile, the fit's
//     own instruction sequence (mma.sync bf16 -> fp32): a row's
//     reconstruction has the bits of K2's noise-free forward on the same
//     params;
//   * in the decoder's epilogue forms e = (r + b_dec) - x for j < f (0
//     past f) and writes e^2 over the x it was taken from (each element
//     has one reader and writer);
//   * reduces each row in a fixed order, no atomics: kRowThreads = 8
//     threads a row, thread q summing columns q, q + 8, ... in turn, then
//     the 8 partial sums as ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 +
//     s7)) by warp shuffles; score = sum / f (__fdiv_rn).  Two runs give
//     the same bits.
// Shared memory: 35,968 / 47,552 / 59,136 bytes at F padded to 32 / 48 /
// 64; above 48 KB after an opt-in per device (opt_in_smem).

#include "anomaly_common.cuh"

namespace anomaly {

constexpr int kScoreRows = 32;      // rows per block
constexpr int kScoreThreads = 256;  // 8 warps
constexpr int kRowThreads = kScoreThreads / kScoreRows;   // 8 a row

// staged weights, then bf(x) [R][FP+8], bf(g) [R][kLdh], fp32 x [R][FP+8]
__host__ __device__ constexpr size_t score_bytes(int fp) {
  return staged_bytes(fp) +
         sizeof(__nv_bfloat16) * kScoreRows * (fp + 8 + kLdh) +
         sizeof(float) * kScoreRows * (fp + 8);
}

template <int FP>
__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const float* __restrict__ x, const float* __restrict__ w_enc,
             const float* __restrict__ b_enc, const float* __restrict__ w_dec,
             const float* __restrict__ b_dec, float* __restrict__ out, int n,
             int f) {
  constexpr int R = kScoreRows;
  constexpr int kLdk = FP + 8;   // row stride of xb and xs
  constexpr int kPer = R * FP / kScoreThreads;
  static_assert(R * FP % kScoreThreads == 0 && FP % kRowThreads == 0,
                "whole loads and reduce runs per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const Staged w(smem, FP);
  __nv_bfloat16* xb =
      reinterpret_cast<__nv_bfloat16*>(smem + staged_bytes(FP));
  __nv_bfloat16* gs = xb + R * kLdk;
  float* xs = reinterpret_cast<float*>(gs + R * kLdh);   // x, then e^2
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n - row0);

  // the tile's loads in flight while the weights are staged
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int idx = tid + k * kScoreThreads;
    const int i = idx / FP;
    const int j = idx - i * FP;
    v[k] = i < rows && j < f ? x[static_cast<size_t>(row0 + i) * f + j]
                             : 0.0f;
  }
  stage_params<FP>(w, w_enc, b_enc, w_dec, b_dec, f, tid, kScoreThreads);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int idx = tid + k * kScoreThreads;
    const int i = idx / FP;
    const int j = idx - i * FP;
    xs[i * kLdk + j] = v[k];
    xb[i * kLdk + j] = __float2bfloat16_rn(v[k]);
  }
  __syncthreads();

  forward_tile<R, kScoreThreads / 32>(
      xb, kLdk, FP, w.weT, kLdk, w.be, nullptr, 0, gs, kLdh, w.wdT, kLdh,
      FP, tid >> 5, tid & 31, [&](int i, int j, float acc) {
        float e = 0.0f;
        if (j < f) e = __fsub_rn(__fadd_rn(acc, w.bd[j]), xs[i * kLdk + j]);
        xs[i * kLdk + j] = __fmul_rn(e, e);
      });
  __syncthreads();

  // row i's sum: thread q of its 8 takes columns q, q + 8, ... in turn
  // (exact zeros past f), then the fixed tree over the 8 (lanes q ^ 4,
  // q ^ 2, q ^ 1: all 8 end with the same bits)
  const int i = tid / kRowThreads;
  const int q = tid % kRowThreads;
  float s = 0.0f;
#pragma unroll
  for (int j = q; j < FP; j += kRowThreads) {
    s = __fadd_rn(s, xs[i * kLdk + j]);
  }
#pragma unroll
  for (int off = kRowThreads / 2; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  }
  if (q == 0 && i < rows) {
    out[row0 + i] = __fdiv_rn(s, static_cast<float>(f));
  }
}

template <int FP>
int score(const float* x, const float* w_enc, const float* b_enc,
          const float* w_dec, const float* b_dec, float* out, int n, int f,
          cudaStream_t s) {
  constexpr size_t smem = score_bytes(FP);
  const cudaError_t err =
      opt_in_smem(reinterpret_cast<const void*>(score_kernel<FP>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kScoreRows - 1) / kScoreRows;
  score_kernel<FP><<<blocks, kScoreThreads, smem, s>>>(
      x, w_enc, b_enc, w_dec, b_dec, out, n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anomaly

extern "C" int anomaly_score(const float* x, const float* w_enc,
                             const float* b_enc, const float* w_dec,
                             const float* b_dec, float* out, int n, int f,
                             void* stream) {
  using namespace anomaly;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n <= 0 ? 0 : (f + 15) / 16) {
    case 1:
      return score<16>(x, w_enc, b_enc, w_dec, b_dec, out, n, f, s);
    case 2:
      return score<32>(x, w_enc, b_enc, w_dec, b_dec, out, n, f, s);
    case 3:
      return score<48>(x, w_enc, b_enc, w_dec, b_dec, out, n, f, s);
    case 4:
      return score<64>(x, w_enc, b_enc, w_dec, b_dec, out, n, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
