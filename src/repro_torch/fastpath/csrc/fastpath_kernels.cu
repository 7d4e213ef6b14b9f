// Batched flat-buffer comm-plane kernels for Hopper (sm_90a).
//
// Hand-written CUDA replacements of the five Pallas kernels of
// src/repro/fastpath/kernels.py:
//
//   lag_delta_sq_blocks   <- delta_sqnorm_blocks (_delta_sq_kernel)
//   lag_sq_blocks         <- sqnorm_blocks       (_sq_kernel)
//   lag_absmax_blocks     <- absmax_blocks       (_absmax_kernel)
//   lag_laq_encode_blocks <- laq_encode_blocks   (_laq_kernel)
//   lag_masked_combine    <- masked_combine      (_masked_kernel)
//
// Operands are the (W, R, 128) float32 flat buffers of
// repro_torch/fastpath/layout.py; a "sub-block" is 8 x 128 = 1024
// contiguous floats and never straddles two leaves.  Every kernel is one
// streaming sweep over device memory with a few flops per element, so all
// five are bound by HBM bytes, not by arithmetic: the design is coalesced
// 16-byte (float4) loads and stores, no shared memory, no atomics.
//
//   * Per-sub-block reductions: ONE WARP PER SUB-BLOCK.  Lane l reads the
//     float4s l, l+32, ..., l+224 of its sub-block (each step of the warp
//     reads 512 contiguous bytes), folds them in a fixed sequential order,
//     and a fixed xor-butterfly of shuffles finishes the sub-block.  No
//     partial crosses a sub-block and nothing crosses a block, so the same
//     inputs give the same bits on every launch (the fixed-order contract
//     of the reference plan) and no cross-block pass or atomic is needed.
//   * Elementwise folds: one float4 per thread, grid-stride.
//   * Offsets are int64 throughout: at full width a (2, 9.66M, 128) operand
//     holds 2.47e9 elements, above 2^31.
//   * A worker stride of 0 broadcasts an unstacked (R, 128) operand (the
//     shared iterate theta) to every worker without a W-fold copy.
//   * Exact arithmetic: built with --fmad=false and written with the _rn
//     intrinsics, so v - codes*step is never contracted into an FMA and the
//     LAQ payload/residual equal the plain PyTorch version bit for bit;
//     1/step is an IEEE division and rounding is half-to-even (rintf), as
//     jnp.round.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB_VEC = 1024 / 4;            // float4s per sub-block
constexpr int WARP = 32;
constexpr int VEC_PER_LANE = SUB_VEC / WARP; // 8
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARP * WARPS_PER_BLOCK;
constexpr int64_t MAX_GRID = 132 * 64;       // grid-stride cap (132 SMs)

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating max (jnp.max / torch.amax semantics; fmaxf drops NaN)
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sq_diff_acc(float acc, float x, float y) {
  const float d = __fsub_rn(x, y);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// per-(worker, sub-block) sum (a - b)^2; b may be broadcast (b_ws == 0)
__global__ void delta_sq_kernel(const float4* a, const float4* b, float* out,
                                int64_t total_subs, int64_t nsubs,
                                int64_t a_ws, int64_t b_ws) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;             // the whole warp leaves
  const int lane = threadIdx.x % WARP;
  const int64_t w = sub / nsubs;
  const int64_t s = sub - w * nsubs;
  const float4* pa = a + w * a_ws + s * SUB_VEC;
  const float4* pb = b + w * b_ws + s * SUB_VEC;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const float4 x = pa[lane + j * WARP];
    const float4 y = pb[lane + j * WARP];
    acc = sq_diff_acc(acc, x.x, y.x);
    acc = sq_diff_acc(acc, x.y, y.y);
    acc = sq_diff_acc(acc, x.z, y.z);
    acc = sq_diff_acc(acc, x.w, y.w);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[sub] = acc;
}

// per-(worker, sub-block) sum a^2: delta_sq_kernel with one operand
__global__ void sq_kernel(const float4* a, float* out, int64_t total_subs) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;
  const int lane = threadIdx.x % WARP;
  const float4* pa = a + sub * SUB_VEC;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const float4 x = pa[lane + j * WARP];
    acc = __fadd_rn(acc, __fmul_rn(x.x, x.x));
    acc = __fadd_rn(acc, __fmul_rn(x.y, x.y));
    acc = __fadd_rn(acc, __fmul_rn(x.z, x.z));
    acc = __fadd_rn(acc, __fmul_rn(x.w, x.w));
  }
  acc = warp_sum(acc);
  if (lane == 0) out[sub] = acc;
}

__device__ __forceinline__ float innovation(float g, float q, float e) {
  return __fadd_rn(__fsub_rn(g, q), e);      // (g - q) + e, in that order
}

// per-(worker, sub-block) max |(g - q) + e|; all operands stacked
__global__ void absmax_kernel(const float4* g, const float4* q,
                              const float4* e, float* out,
                              int64_t total_subs) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;
  const int lane = threadIdx.x % WARP;
  const int64_t base = sub * SUB_VEC;
  float m = 0.f;                             // |v| >= 0: 0 is the identity
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const int64_t k = base + lane + j * WARP;
    const float4 a = g[k], b = q[k], c = e[k];
    m = max_nan(m, fabsf(innovation(a.x, b.x, c.x)));
    m = max_nan(m, fabsf(innovation(a.y, b.y, c.y)));
    m = max_nan(m, fabsf(innovation(a.z, b.z, c.z)));
    m = max_nan(m, fabsf(innovation(a.w, b.w, c.w)));
  }
  m = warp_max(m);
  if (lane == 0) out[sub] = m;
}

struct LaqOut { float p, r; };

__device__ __forceinline__ LaqOut laq_one(float g, float q, float e,
                                          float step, float inv,
                                          float qmax) {
  const float v = innovation(g, q, e);
  float c = rintf(__fmul_rn(v, inv));        // half-to-even
  if (c == c) c = fminf(fmaxf(c, -qmax), qmax);
  const float p = __fmul_rn(c, step);
  return {p, __fsub_rn(v, p)};
}

// fused LAQ encode: payload, residual and per-sub-block sum payload^2.
// ``p`` may alias ``g`` (the payload overwrites the consumed gradient):
// every element is read and written by the same thread.
__global__ void laq_encode_kernel(const float4* g, const float4* q,
                                  const float4* e, const float* steps,
                                  float4* p, float4* r, float* sq,
                                  int64_t total_subs, float qmax) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;
  const int lane = threadIdx.x % WARP;
  const float step = steps[sub];
  const float inv = step > 0.f ? __fdiv_rn(1.0f, step) : 0.f;
  const int64_t base = sub * SUB_VEC;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const int64_t k = base + lane + j * WARP;
    const float4 a = g[k], b = q[k], c = e[k];
    const LaqOut ox = laq_one(a.x, b.x, c.x, step, inv, qmax);
    const LaqOut oy = laq_one(a.y, b.y, c.y, step, inv, qmax);
    const LaqOut oz = laq_one(a.z, b.z, c.z, step, inv, qmax);
    const LaqOut ow = laq_one(a.w, b.w, c.w, step, inv, qmax);
    acc = __fadd_rn(acc, __fmul_rn(ox.p, ox.p));
    acc = __fadd_rn(acc, __fmul_rn(oy.p, oy.p));
    acc = __fadd_rn(acc, __fmul_rn(oz.p, oz.p));
    acc = __fadd_rn(acc, __fmul_rn(ow.p, ow.p));
    p[k] = make_float4(ox.p, oy.p, oz.p, ow.p);
    r[k] = make_float4(ox.r, oy.r, oz.r, ow.r);
  }
  acc = warp_sum(acc);
  if (lane == 0) sq[sub] = acc;
}

// masked folds of candidate a into state b under a per-worker mask m:
//   MODE 0 add: b + m*a   MODE 1 update: b + m*(a - b)
//   MODE 2 select: m != 0 ? a : b (copies bits, no arithmetic)
// ``out`` may alias ``b`` (in-place state update).
template <int MODE>
__device__ __forceinline__ float fold(float x, float y, float m) {
  if (MODE == 0) return __fadd_rn(y, __fmul_rn(m, x));
  if (MODE == 1) return __fadd_rn(y, __fmul_rn(m, __fsub_rn(x, y)));
  return m != 0.f ? x : y;
}

template <int MODE>
__global__ void masked_kernel(const float4* a, const float4* b,
                              const float* mask, float4* out,
                              int64_t total_vec, int64_t vec_per_w,
                              int64_t a_ws) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total_vec; i += stride) {
    const int64_t w = i / vec_per_w;
    const float m = mask[w];
    const float4 x = a[w * a_ws + (i - w * vec_per_w)];
    const float4 y = b[i];
    out[i] = make_float4(fold<MODE>(x.x, y.x, m), fold<MODE>(x.y, y.y, m),
                         fold<MODE>(x.z, y.z, m), fold<MODE>(x.w, y.w, m));
  }
}

inline unsigned sub_grid(int64_t total_subs) {
  return (unsigned)((total_subs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

}  // namespace

extern "C" {

// a, b: (W, R, 128) float32 (b may be (R, 128): b_ws = 0); strides are in
// float4 units; out: (W, R/8) float32.
int lag_delta_sq_blocks(const void* a, const void* b, void* out, int64_t W,
                        int64_t nsubs, int64_t a_ws, int64_t b_ws,
                        void* stream) {
  const int64_t total = W * nsubs;
  if (total == 0) return 0;
  delta_sq_kernel<<<sub_grid(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)a, (const float4*)b, (float*)out, total, nsubs, a_ws,
      b_ws);
  return (int)cudaGetLastError();
}

// a: (W, R, 128) float32; out: (W, R/8) float32
int lag_sq_blocks(const void* a, void* out, int64_t total_subs,
                  void* stream) {
  if (total_subs == 0) return 0;
  sq_kernel<<<sub_grid(total_subs), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)a, (float*)out, total_subs);
  return (int)cudaGetLastError();
}

int lag_absmax_blocks(const void* g, const void* q, const void* e, void* out,
                      int64_t total_subs, void* stream) {
  if (total_subs == 0) return 0;
  absmax_kernel<<<sub_grid(total_subs), THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)g, (const float4*)q, (const float4*)e, (float*)out,
      total_subs);
  return (int)cudaGetLastError();
}

int lag_laq_encode_blocks(const void* g, const void* q, const void* e,
                          const void* steps, void* p, void* r, void* sq,
                          int64_t total_subs, float qmax, void* stream) {
  if (total_subs == 0) return 0;
  laq_encode_kernel<<<sub_grid(total_subs), THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const float4*)g, (const float4*)q, (const float4*)e,
      (const float*)steps, (float4*)p, (float4*)r, (float*)sq, total_subs,
      qmax);
  return (int)cudaGetLastError();
}

// mode: 0 add, 1 update, 2 select.  vec_per_w = R*128/4; a_ws = vec_per_w
// for a stacked candidate, 0 for an unstacked (R, 128) one.
int lag_masked_combine(const void* a, const void* b, const void* mask,
                       void* out, int64_t W, int64_t vec_per_w, int64_t a_ws,
                       int mode, void* stream) {
  const int64_t total = W * vec_per_w;
  if (total == 0) return 0;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* pa = (const float4*)a;
  const float4* pb = (const float4*)b;
  const float* pm = (const float*)mask;
  float4* po = (float4*)out;
  if (mode == 0)
    masked_kernel<0><<<(unsigned)blocks, THREADS, 0, s>>>(pa, pb, pm, po,
                                                           total, vec_per_w,
                                                           a_ws);
  else if (mode == 1)
    masked_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(pa, pb, pm, po,
                                                           total, vec_per_w,
                                                           a_ws);
  else if (mode == 2)
    masked_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(pa, pb, pm, po,
                                                           total, vec_per_w,
                                                           a_ws);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
