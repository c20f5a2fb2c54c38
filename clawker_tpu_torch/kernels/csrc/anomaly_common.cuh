// Shared device helpers of the anomaly kernels (score, fit step, fit).
//
// The rounding points follow the JAX reference (clawker_tpu/analytics/
// anomaly.py): bf16 dot operands with fp32 accumulation, the tanh form of
// GELU in fp32.  Elementwise steps use the _rn intrinsics so that nvcc does
// not contract a multiply and an add into one FMA where the plain PyTorch
// version (kernels/reference.py) rounds twice.
#pragma once

#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace anomaly {

constexpr int kHidden = 128;     // hidden width
constexpr int kLdh = kHidden + 8;    // row stride of the [.][H] arrays

constexpr float kGeluC = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float kGeluK = 0.044715f;
constexpr float kGelu3K = 0.134145f;            // 3 * kGeluK

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float gelu_tanh_u(float a) {
  const float a3 = __fmul_rn(__fmul_rn(a, a), a);
  return __fmul_rn(kGeluC, __fadd_rn(a, __fmul_rn(kGeluK, a3)));
}

// a * (0.5 * (1 + t)), t = tanh(c * (a + k a^3))
//   -- jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh_t(float a, float t) {
  return __fmul_rn(a, __fmul_rn(0.5f, __fadd_rn(1.0f, t)));
}

// d/da of gelu_tanh for the same t, in the operation order of
// reference.gelu_tanh_grad
__device__ __forceinline__ float gelu_tanh_grad_t(float a, float t) {
  const float left = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
  float right = __fmul_rn(__fmul_rn(a, 0.5f), __fsub_rn(1.0f, __fmul_rn(t, t)));
  right = __fmul_rn(right, kGeluC);
  right = __fmul_rn(right, __fadd_rn(1.0f, __fmul_rn(__fmul_rn(kGelu3K, a), a)));
  return __fadd_rn(left, right);
}

// ---------------------------------------------------------------------------
// The forward of one row tile on the tensor cores (mma.sync, bf16 operands,
// fp32 accumulation: the products are exact; the sum's order differs from
// the plain version's, and it behaves like rounding toward zero after each
// 16-deep step rather than to nearest).
//
// Operands in shared memory, all bf16, k contiguous:
//   xb  [R][ldx]   the tile's rows, bf(x), k = feature (kp of them, zeros
//                  past f)
//   weT [kHidden][ldw]  bf(W_enc) transposed: row h holds W_enc[:, h]
//   gs  [R][ldg]   written here: bf(gelu(a)), k = hidden unit
//   wdT [np][ldd]  bf(W_dec) transposed: row j holds W_dec[:, j]
// A row stride s with (s / 2) % 8 == 4 (in bf16: kp + 8, kHidden + 8)
// makes the fragment loads below free of bank conflicts.

// D += A . B for one m16n8k16 tile: a[4] the row-major A fragment, b[2] the
// column-major B fragment, d[4] the fp32 accumulator
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows m0..m0+15, columns k0..k0+15 of a row-major [.][ld]
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int ld, int m0, int k0, int lane) {
  const __nv_bfloat16* p = s + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B fragment of columns n0..n0+7, depth k0..k0+15, stored n-major [n][ld]
__device__ __forceinline__ void load_b(uint32_t b[2], const __nv_bfloat16* s,
                                       int ld, int n0, int k0, int lane) {
  const __nv_bfloat16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// The fragments of an operand whose reduction index runs down the rows of
// its store (`s` holds S[k][.] with row stride ld, 8 bf16 = 16 bytes
// contiguous from each row address): ldmatrix .trans hands each lane the
// pairs (S[k + 2t][c], S[k + 2t + 1][c]) that mma.sync wants.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A fragment of A[m][k] = S[k][m], rows m0..m0+15 and depth k0..k0+15
__device__ __forceinline__ void load_a_trans(uint32_t a[4],
                                             const __nv_bfloat16* s, int ld,
                                             int m0, int k0, int lane) {
  const int q = lane >> 3;
  ldmatrix_x4_trans(
      a, s + (k0 + (lane & 7) + 8 * (q >> 1)) * ld + m0 + 8 * (q & 1));
}

// The B fragments of B[k][n] = S[k][n] for the two n-tiles n0 and n0 + 8,
// depth k0..k0+15: b[0..1] for n0, b[2..3] for n0 + 8
__device__ __forceinline__ void load_b2_trans(uint32_t b[4],
                                              const __nv_bfloat16* s, int ld,
                                              int n0, int k0, int lane) {
  const int q = lane >> 3;
  ldmatrix_x4_trans(
      b, s + (k0 + (lane & 7) + 8 * (q & 1)) * ld + n0 + 8 * (q >> 1));
}

// dst[n][k] = bf(src[k][n]) for k < K, n < N, zero up to kp, np (multiples
// of 8): a transpose into the n-major layout of a B operand.  A warp writes
// an 8 n x 8 k block, lane (g, t) the pair (n0 + g, k0 + 2t): the same
// pattern as a fragment load, so with the stride rule above no two lanes
// hit one bank.  `src` is read through L2 (__ldcg): the fit kernel stages
// params that it wrote itself, which the read-only path may not see.
__device__ __forceinline__ void stage_transposed(__nv_bfloat16* dst, int ld,
                                                 const float* src, int lds,
                                                 int K, int N, int kp, int np,
                                                 int tid, int threads) {
  const int nblocks = np / 8;
  for (int w = tid; w < np * kp / 2; w += threads) {
    const int chunk = w >> 5;
    const int lane = w & 31;
    const int n = (chunk % nblocks) * 8 + (lane >> 2);
    const int k = (chunk / nblocks) * 8 + 2 * (lane & 3);
    const float v0 = (n < N && k < K) ? __ldcg(src + k * lds + n) : 0.0f;
    const float v1 =
        (n < N && k + 1 < K) ? __ldcg(src + (k + 1) * lds + n) : 0.0f;
    *reinterpret_cast<__nv_bfloat162*>(dst + n * ld + k) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// The staged weights for FP = f rounded up to 16: the operands of
// forward_tile, one layout in shared memory (K1, K2) and in K3's global
// image (kernels/reference.py `staged` is its plain version):
//   weT bf16 [H][FP+8]   row h = bf(W_enc[:, h]), zeros past f
//   wdT bf16 [FP][kLdh]  row j = bf(W_dec[:, j]), zero rows past f
//   be  fp32 [H]         b_enc
//   bd  fp32 [FP]        b_dec, zeros past f
// A multiple of 16 bytes (cp.async's unit) at every FP.
__host__ __device__ constexpr size_t staged_bytes(int fp) {
  return sizeof(__nv_bfloat16) * (kHidden * (fp + 8) + fp * kLdh) +
         sizeof(float) * (kHidden + fp);
}

struct Staged {
  __nv_bfloat16* weT;
  __nv_bfloat16* wdT;
  float* be;
  float* bd;
  __device__ Staged(unsigned char* base, int fp)
      : weT(reinterpret_cast<__nv_bfloat16*>(base)),
        wdT(weT + kHidden * (fp + 8)),
        be(reinterpret_cast<float*>(wdT + fp * kLdh)),
        bd(be + kHidden) {}
};

// The same layout at kH hidden units, rows of kH + 8 (K5b's half: kH = 64,
// in shared memory and in its fold's global image)
template <int kH>
struct StagedAt {
  __nv_bfloat16* weT;
  __nv_bfloat16* wdT;
  float* be;
  float* bd;
  __device__ StagedAt(unsigned char* base, int fp)
      : weT(reinterpret_cast<__nv_bfloat16*>(base)),
        wdT(weT + kH * (fp + 8)),
        be(reinterpret_cast<float*>(wdT + fp * (kH + 8))),
        bd(be + kH) {}
};

// The staged weights built from the fp32 params by one block's `threads`
// threads, whole rows, padding included: into shared memory (K1, K2), or
// into K3's global image (its prologue), which phase A copies whole
template <int FP>
__device__ __forceinline__ void stage_params(const Staged& w,
                                             const float* w_enc,
                                             const float* b_enc,
                                             const float* w_dec,
                                             const float* b_dec, int f,
                                             int tid, int threads) {
  stage_transposed(w.weT, FP + 8, w_enc, kHidden, f, kHidden, FP + 8,
                   kHidden, tid, threads);
  stage_transposed(w.wdT, kLdh, w_dec, f, kHidden, f, kLdh, FP, tid,
                   threads);
  for (int i = tid; i < kHidden + FP; i += threads) {
    if (i < kHidden) {
      w.be[i] = __ldcg(b_enc + i);
    } else {
      w.bd[i - kHidden] = i - kHidden < f ? __ldcg(b_dec + i - kHidden) : 0.0f;
    }
  }
}

// The forward of an R-row tile by kWarps warps (R a multiple of 16, kWarps
// a multiple of R / 16) over kH hidden units (K5b's model shard: half of
// them):
//   a = bf(x) . bf(W_enc) + b_enc
//   as[i][h] = gelu'(a)              (fp32, from gelu's own tanh; skipped
//                                     if as is null)
//   gs[i][h] = bf(gelu(a))
//   r = gs . bf(W_dec)               -> epi(i, j, r_ij) for i < R, j < np
// b_dec is left to `epi`; b_enc is read from shared memory, beside the
// staged weights.  The caller syncs before (xb, weT, wdT staged) and after
// (epi's writes); one __syncthreads sits between the layers.
template <int R, int kWarps, int kH = kHidden, class Epi>
__device__ __forceinline__ void forward_tile(
    const __nv_bfloat16* xb, int ldx, int kp, const __nv_bfloat16* weT,
    int ldw, const float* b_enc, float* as, int lda,
    __nv_bfloat16* gs, int ldg, const __nv_bfloat16* wdT, int ldd, int np,
    int warp, int lane, Epi epi) {
  constexpr int kMt = R / 16;
  static_assert(R % 16 == 0 && kWarps % kMt == 0, "tile shape");
  // encoder: warp w takes m-tile w % kMt and every kStep-th n-tile
  constexpr int kStep = kWarps / kMt;
  constexpr int kPer = (kH / 8) / kStep;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  {
    const int m0 = (warp % kMt) * 16;
    const int nt0 = warp / kMt;
    float acc[kPer][4];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    }
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t a[4];
      load_a(a, xb, ldx, m0, k0, lane);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        uint32_t b[2];
        load_b(b, weT, ldw, (nt0 + q * kStep) * 8, k0, lane);
        mma_bf16_16816(acc[q], a, b);
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int h = (nt0 + q * kStep) * 8 + t2;
      const float b0 = b_enc[h];
      const float b1 = b_enc[h + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = m0 + g + 8 * half;
        const float a0 = __fadd_rn(acc[q][2 * half], b0);
        const float a1 = __fadd_rn(acc[q][2 * half + 1], b1);
        const float t0 = tanhf(gelu_tanh_u(a0));
        const float t1 = tanhf(gelu_tanh_u(a1));
        if (as != nullptr) {
          *reinterpret_cast<float2*>(as + i * lda + h) = make_float2(
              gelu_tanh_grad_t(a0, t0), gelu_tanh_grad_t(a1, t1));
        }
        *reinterpret_cast<__nv_bfloat162*>(gs + i * ldg + h) =
            __floats2bfloat162_rn(gelu_tanh_t(a0, t0), gelu_tanh_t(a1, t1));
      }
    }
  }
  __syncthreads();

  // decoder: the kMt x (np / 8) output tiles dealt to the warps in turn
  for (int tile = warp; tile < kMt * (np / 8); tile += kWarps) {
    const int m0 = (tile % kMt) * 16;
    const int n0 = (tile / kMt) * 8;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k0 = 0; k0 < kH; k0 += 16) {
      uint32_t a[4];
      uint32_t b[2];
      load_a(a, gs, ldg, m0, k0, lane);
      load_b(b, wdT, ldd, n0, k0, lane);
      mma_bf16_16816(acc, a, b);
    }
    epi(m0 + g, n0 + t2, acc[0]);
    epi(m0 + g, n0 + t2 + 1, acc[1]);
    epi(m0 + g + 8, n0 + t2, acc[2]);
    epi(m0 + g + 8, n0 + t2 + 1, acc[3]);
  }
}

// Lets `kernel` launch with `bytes` of dynamic shared memory on the
// current device: above 48 KB that takes cudaFuncSetAttribute, which acts
// on one device only.  The first call for a (kernel, device) pair sets
// the attribute; its result is kept in a table under a mutex (launches
// come from several host threads), so later calls return it, a failure
// too.  A kernel asks for the same `bytes` every time.
inline cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  struct OptIn {
    const void* kernel;
    int device;
    cudaError_t err;
  };
  static std::mutex mu;
  static std::vector<OptIn> done;
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const OptIn& o : done) {
    if (o.kernel == kernel && o.device == device) return o.err;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();   // clear what we report
  done.push_back({kernel, device, err});
  return err;
}

}  // namespace anomaly
