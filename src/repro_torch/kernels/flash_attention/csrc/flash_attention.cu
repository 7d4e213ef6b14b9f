// Flash attention forward for Hopper (sm_90a), float32.
//
// Hand-written CUDA replacement of the Pallas kernel flash_attention_padded
// (_flash_kernel) of src/repro/kernels/flash_attention/flash_attention.py:
// online-softmax GQA attention, forward only,
//
//   q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> o (B, Sq, H, hd),
//
// query head h reads kv head h / (H / KV).  It computes what _flash_kernel
// computes, in float32 throughout (no TF32: the reference takes a full
// precision dot): per kv tile s = (q . k) * scale; masked entries are
// NEG = -1e30; m_new = max(m, rowmax s); p = exp(s - m_new) where unmasked,
// else 0; l = exp(m - m_new) * l + rowsum p; acc = acc * exp(m - m_new) +
// p . v; at the end o = acc / max(l, 1e-30).  Masks: query < Sq, key < Skv,
// causal (q >= k), window (q - k < window), positions counted from 0 for
// both q and k, as in the reference.
//
// Bound: operations.  At the serving path's shape (B 4, S 2048, H 32/KV 8,
// hd 64, causal) the two products take 4*B*H*hd*S(S+1)/2 = 68.7 GFLOP:
// 1.03 ms at the H100's 67 TFLOP/s of float32 outside the tensor cores,
// against 0.05 ms for the 168 MB of q/k/v/o.  So the design spends its
// effort on keeping the FMA pipes fed, not on bytes:
//
//   * One block per (b*h, query tile of BQ = 128 rows), ONE THREAD PER
//     QUERY ROW.  The thread keeps its q row, its output accumulator (64
//     floats each) and its running max m and denominator l in registers.
//   * A loop inside the block over kv tiles takes the place of the TPU's
//     sequential kv grid axis.  Each tile (BK = 32 keys) of K and V is
//     staged in shared memory (2 x 8 KB) by all threads with coalesced
//     16-byte loads; every thread then reads the same K/V row at the same
//     time, a broadcast with no bank conflicts, so each shared-memory load
//     feeds 4 FMAs per thread.  The scores of a tile are 32 independent
//     FMA chains, the output update 64.
//   * GQA in the index: the block reads kv head h / (H/KV) directly; K/V
//     are never repeated in memory.
//   * Tiles that are masked for every query of the block (past the
//     diagonal under causal, before the window) are skipped; the TPU kernel
//     still runs them.  Skipping is exact: such a tile gives p = 0 for every
//     entry and alpha = exp(m - max(m, NEG)) = exp(0) = 1, so l and acc
//     would come out of it unchanged, bit for bit.
//   * Rows past Sq and keys past Skv are masked in the kernel: no padding,
//     any S.  The heaviest query tiles (last under causal) are launched
//     first.
//
// No backward: the reference's kernel has none either.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head_dim the kernel is built for
constexpr int HD4 = HD / 4;
constexpr int BQ = 128;         // query rows per block = threads per block
constexpr int BK = 32;          // keys per shared-memory tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool visible(int64_t qi, int64_t kp, int64_t Skv,
                                        int causal, int64_t window) {
  return kp < Skv && (!causal || qi >= kp)
         && (window <= 0 || qi - kp < window);
}

__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                 const float4* __restrict__ v, float4* __restrict__ o,
                 int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
                 float scale, int causal, int64_t window) {
  __shared__ float4 ks[BK][HD4];
  __shared__ float4 vs[BK][HD4];

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H;
  const int64_t g = h / (H / KV);
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t qi = q0 + threadIdx.x;
  const bool qvalid = qi < Sq;

  float qr[HD], acc[HD];
  if (qvalid) {
    const float4* src = q + ((b * Sq + qi) * H + h) * HD4;
#pragma unroll
    for (int c = 0; c < HD4; ++c) {
      const float4 t = src[c];
      qr[4 * c] = t.x; qr[4 * c + 1] = t.y;
      qr[4 * c + 2] = t.z; qr[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = NEG, l = 0.f;

  // the keys any valid query of this block can see
  const int64_t q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int64_t k_end = Skv;
  if (causal && q_last + 1 < k_end) k_end = q_last + 1;
  int64_t k_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) k_begin = q0 - window + 1;
  const int64_t t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t k0 = t * BK;
    for (int i = threadIdx.x; i < BK * HD4; i += BQ) {
      const int r = i / HD4, c = i % HD4;
      const int64_t kp = k0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kp < Skv) {
        const int64_t idx = ((b * Skv + kp) * KV + g) * HD4 + c;
        kk = k[idx];
        vv = v[idx];
      }
      ks[r][c] = kk;
      vs[r][c] = vv;
    }
    __syncthreads();
    if (qvalid) {
      float s[BK];
#pragma unroll
      for (int j = 0; j < BK; ++j) s[j] = 0.f;
#pragma unroll
      for (int c = 0; c < HD4; ++c) {
#pragma unroll
        for (int j = 0; j < BK; ++j) {
          const float4 kk = ks[j][c];
          s[j] = fmaf(qr[4 * c], kk.x, s[j]);
          s[j] = fmaf(qr[4 * c + 1], kk.y, s[j]);
          s[j] = fmaf(qr[4 * c + 2], kk.z, s[j]);
          s[j] = fmaf(qr[4 * c + 3], kk.w, s[j]);
        }
      }
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = visible(qi, k0 + j, Skv, causal, window) ? s[j] * scale : NEG;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = visible(qi, k0 + j, Skv, causal, window) ? expf(s[j] - m_new)
                                                         : 0.f;
        psum += s[j];
      }
      l = alpha * l + psum;
      m = m_new;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
#pragma unroll
        for (int c = 0; c < HD4; ++c) {
          const float4 vv = vs[j][c];
          acc[4 * c] = fmaf(s[j], vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(s[j], vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(s[j], vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(s[j], vv.w, acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (qvalid) {
    const float den = fmaxf(l, 1e-30f);
    float4* dst = o + ((b * Sq + qi) * H + h) * HD4;
#pragma unroll
    for (int c = 0; c < HD4; ++c)
      dst[c] = make_float4(acc[4 * c] / den, acc[4 * c + 1] / den,
                           acc[4 * c + 2] / den, acc[4 * c + 3] / den);
  }
}

}  // namespace

extern "C" {

// q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); float32, contiguous,
// 16-byte aligned.  window <= 0: no window.  Only hd == 64 is built.
int lag_flash_attention_f32(const void* q, const void* k, const void* v,
                            void* o, int64_t B, int64_t Sq, int64_t Skv,
                            int64_t H, int64_t KV, int64_t hd, float scale,
                            int causal, int64_t window, void* stream) {
  if (hd != HD || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return 0;
  const int64_t nq = (Sq + BQ - 1) / BQ;
  if (B * H > 0x7fffffffLL || nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)nq);
  flash_fwd_kernel<<<grid, BQ, 0, (cudaStream_t)stream>>>(
      (const float4*)q, (const float4*)k, (const float4*)v, (float4*)o, Sq,
      Skv, H, KV, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // extern "C"
