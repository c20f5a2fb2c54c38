// K2: fused (denoising) SGD step of the anomaly autoencoder, as two launches.
//
// Replaces: clawker_tpu/analytics/anomaly.py:96 denoise_step_with_noise
// (and :72 train_step, the same step with no noise), scanned 40-120 times
// per call at clawker_tpu/analytics/runtime.py:128-136.
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
// over ALL rows -- rounding each tile's partial would not match -- and the
// products stay fp32 FMAs on the CUDA cores: a bf16 tensor-core MMA would
// round the fp32 cotangent and is not a drop-in.
//
// Launch A (one block of 128 threads per 32-row tile): forward, error, dr,
// dh, da, and the tile's UNROUNDED fp32 partial sums of the four gradients
// and of the squared error, written to scratch [tiles][P].
// Launch B (one thread per parameter): sums the partials over tiles in a
// fixed order (deterministic, no atomics), rounds only the full weight
// sums to bf16, updates the params in place and writes the step's loss.
//
// What bounds it on the H100: the 10 nFH operations of forward and
// backward (6 nFH of them fp32 products, at 67 TFLOP/s outside the tensor
// cores) take about 1.5 us at n = 4096, F = 32; the bytes (x and noise in,
// the params in and out, ~1.2 MB) about 0.4 us.  This first-correct design
// is latency- and launch-bound well above that: serial per-thread loops,
// two launches per step, and one step per launch (K3, the loop, is a
// Python loop of these launches; a CUDA graph or persistent kernel is later
// work).

#include "anomaly_common.cuh"

namespace anomaly {

__host__ __device__ inline int param_floats(int f) {
  // dW_enc [f][H], db_enc [H], dW_dec [H][f], db_dec [f], loss sum
  return 2 * f * kHidden + kHidden + f + 1;
}

__global__ void __launch_bounds__(kHidden)
fit_partials_kernel(const float* __restrict__ x,
                    const float* __restrict__ noise, float sigma,
                    const float* __restrict__ w_enc,
                    const float* __restrict__ b_enc,
                    const float* __restrict__ w_dec,
                    const float* __restrict__ b_dec,
                    float* __restrict__ partials, float inv_count, int n,
                    int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* we = reinterpret_cast<__nv_bfloat16*>(smem);  // [f][H]
  __nv_bfloat16* wd = we + f * kHidden;                         // [H][f]
  __nv_bfloat16* wdt = wd + f * kHidden;                        // [f][H]
  __nv_bfloat16* gs = wdt + f * kHidden;                        // [T][H]
  float* xn = reinterpret_cast<float*>(gs + kTileRows * kHidden);  // [T][f]
  float* xc = xn + kTileRows * f;                               // [T][f]
  float* dr = xc + kTileRows * f;                               // [T][f]
  float* as = dr + kTileRows * f;           // [T][H]: a, then da in place
  float* red = as + kTileRows * kHidden;    // [H/32] per-warp loss sums

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, n - row0);

  for (int i = tid; i < f * kHidden; i += kHidden) {
    we[i] = __float2bfloat16_rn(w_enc[i]);
    const __nv_bfloat16 v = __float2bfloat16_rn(w_dec[i]);
    wd[i] = v;
    const int k = i / f;
    wdt[(i - k * f) * kHidden + k] = v;
  }
  for (int i = tid; i < kTileRows * f; i += kHidden) {
    float xv = 0.0f;
    float nv = 0.0f;
    if (i / f < rows) {
      const size_t g = static_cast<size_t>(row0) * f + i;
      xv = x[g];
      nv = noise ? __fadd_rn(xv, __fmul_rn(sigma, noise[g])) : xv;
    }
    xc[i] = xv;
    xn[i] = nv;
  }
  __syncthreads();

  // forward encoder: thread tid owns hidden unit tid
  const float bk = b_enc[tid];
  for (int i = 0; i < rows; ++i) {
    float acc = 0.0f;
    for (int j = 0; j < f; ++j) {
      acc = fmaf(bf(xn[i * f + j]), __bfloat162float(we[j * kHidden + tid]), acc);
    }
    const float a = __fadd_rn(acc, bk);
    as[i * kHidden + tid] = a;
    gs[i * kHidden + tid] = __float2bfloat16_rn(gelu_tanh(a));
  }
  __syncthreads();

  // forward decoder, error against the clean x, dr, loss
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float sq = 0.0f;
  for (int i = warp; i < rows; i += kHidden / 32) {
    for (int j = lane; j < f; j += 32) {
      float acc = 0.0f;
      for (int k = 0; k < kHidden; ++k) {
        acc = fmaf(__bfloat162float(gs[i * kHidden + k]),
                   __bfloat162float(wd[k * f + j]), acc);
      }
      const float e = __fsub_rn(__fadd_rn(acc, b_dec[j]), xc[i * f + j]);
      sq = __fadd_rn(sq, __fmul_rn(e, e));
      dr[i * f + j] = __fmul_rn(__fmul_rn(2.0f, e), inv_count);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) red[warp] = sq;
  __syncthreads();

  // backward into the hidden layer: dh is the row's complete sum, so it is
  // rounded to bf16 here; da overwrites a in place (thread-owned column)
  for (int i = 0; i < rows; ++i) {
    float s = 0.0f;
    for (int j = 0; j < f; ++j) {
      s = fmaf(dr[i * f + j], __bfloat162float(wdt[j * kHidden + tid]), s);
    }
    const float a = as[i * kHidden + tid];
    as[i * kHidden + tid] = __fmul_rn(bf(s), gelu_tanh_grad(a));
  }
  __syncthreads();

  // the tile's unrounded partial sums over its rows
  float* part = partials + static_cast<size_t>(blockIdx.x) * param_floats(f);
  const int o_be = f * kHidden;
  const int o_wd = o_be + kHidden;
  const int o_bd = o_wd + kHidden * f;
  const int o_loss = o_bd + f;
  for (int e = tid; e < f * kHidden; e += kHidden) {   // dW_enc[j][tid]
    const int j = e / kHidden;
    float s = 0.0f;
    for (int i = 0; i < rows; ++i) {
      s = fmaf(bf(xn[i * f + j]), as[i * kHidden + tid], s);
    }
    part[e] = s;
  }
  {                                                     // db_enc[tid]
    float s = 0.0f;
    for (int i = 0; i < rows; ++i) s = __fadd_rn(s, as[i * kHidden + tid]);
    part[o_be + tid] = s;
  }
  for (int e = tid; e < kHidden * f; e += kHidden) {   // dW_dec[k][j]
    const int k = e / f;
    const int j = e - k * f;
    float s = 0.0f;
    for (int i = 0; i < rows; ++i) {
      s = fmaf(__bfloat162float(gs[i * kHidden + k]), dr[i * f + j], s);
    }
    part[o_wd + e] = s;
  }
  if (tid < f) {                                        // db_dec[tid]
    float s = 0.0f;
    for (int i = 0; i < rows; ++i) s = __fadd_rn(s, dr[i * f + tid]);
    part[o_bd + tid] = s;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < kHidden / 32; ++w) s = __fadd_rn(s, red[w]);
    part[o_loss] = s;
  }
}

__global__ void fit_apply_kernel(const float* __restrict__ partials,
                                 int tiles, int f, float* __restrict__ w_enc,
                                 float* __restrict__ b_enc,
                                 float* __restrict__ w_dec,
                                 float* __restrict__ b_dec,
                                 float* __restrict__ loss_out, float lr,
                                 float count) {
  const int stride = param_floats(f);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= stride) return;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    s = __fadd_rn(s, partials[static_cast<size_t>(t) * stride + p]);
  }
  const int o_be = f * kHidden;
  const int o_wd = o_be + kHidden;
  const int o_bd = o_wd + kHidden * f;
  const int o_loss = o_bd + f;
  if (p < o_be) {
    w_enc[p] = __fsub_rn(w_enc[p], __fmul_rn(lr, bf(s)));
  } else if (p < o_wd) {
    b_enc[p - o_be] = __fsub_rn(b_enc[p - o_be], __fmul_rn(lr, s));
  } else if (p < o_bd) {
    w_dec[p - o_wd] = __fsub_rn(w_dec[p - o_wd], __fmul_rn(lr, bf(s)));
  } else if (p < o_loss) {
    b_dec[p - o_bd] = __fsub_rn(b_dec[p - o_bd], __fmul_rn(lr, s));
  } else {
    *loss_out = __fdiv_rn(s, count);
  }
}

}  // namespace anomaly

// Scratch: `partials` holds ceil(n / 32) * (2 f 128 + 128 + f + 1) floats
// (`partials_floats` says how many the caller allocated).  `noise` may be
// null: the plain autoencoder step.  `loss_out` points at one float.
extern "C" int anomaly_fit_step(const float* x, const float* noise,
                                float sigma, float* w_enc, float* b_enc,
                                float* w_dec, float* b_dec, float* partials,
                                long long partials_floats, float* loss_out,
                                float lr, int n, int f, void* stream) {
  using namespace anomaly;
  if (n <= 0 || f <= 0 || f > kMaxFeatures) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kTileRows - 1) / kTileRows;
  if (partials_floats < static_cast<long long>(tiles) * param_floats(f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(__nv_bfloat16) * (3 * f * kHidden +
                                               kTileRows * kHidden) +
                      sizeof(float) * (3 * kTileRows * f +
                                       kTileRows * kHidden + kHidden / 32);
  // above 48 KB only after opting in; once, for the widest f taken
  static size_t smem_opted = 48 * 1024;
  if (smem > smem_opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fit_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted = smem;
  }
  const float count = static_cast<float>(n) * static_cast<float>(f);
  const float inv_count = 1.0f / count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fit_partials_kernel<<<tiles, kHidden, smem, s>>>(
      x, noise, sigma, w_enc, b_enc, w_dec, b_dec, partials, inv_count, n, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (param_floats(f) + threads - 1) / threads;
  fit_apply_kernel<<<blocks, threads, 0, s>>>(partials, tiles, f, w_enc,
                                              b_enc, w_dec, b_dec, loss_out,
                                              lr, count);
  return static_cast<int>(cudaGetLastError());
}
