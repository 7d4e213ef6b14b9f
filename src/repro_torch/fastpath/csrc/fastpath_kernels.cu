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
// Operands are the (W, R, 128) flat buffers of
// repro_torch/fastpath/layout.py, float32 or (for a bfloat16 or float16
// model, or 2-byte grad_hat mirrors) bfloat16 or float16; a "sub-block" is
// 8 x 128 = 1024 contiguous elements and never straddles two leaves.  Every
// kernel is one streaming sweep over device memory with a few flops per
// element, so all five are bound by HBM bytes, not by arithmetic: the
// design is coalesced loads and stores of four elements a thread (16 bytes
// of float32, 8 of a 2-byte type), no shared memory, no atomics.
//
//   * Operand dtypes: kernels 1-4 are templated on each operand's type.
//     An element is read at its own dtype and widened to float32 (exact);
//     all arithmetic is float32, in the order of the float32 kernel, and
//     a thread owns the same four-element groups in both dtypes, so a
//     bfloat16-operand kernel is bitwise the float32 kernel on the widened
//     operands.  An output is written at its destination's dtype with one
//     round-to-nearest-even (kernel 4's result at b's dtype; kernel 3's
//     payload and residual stay float32).  The instantiations built are
//     the ones the comm paths use (the *_bb / *_fb entries below for
//     bfloat16, *_hh / *_fh for float16); the Python wrappers raise for
//     any other combination.
//   * float16 is not bfloat16 in two places: its subnormals start at
//     2^-14 (gradients and mirrors of 1e-5 to 1e-8 live there) and it
//     overflows at 65504.  Widening a float16 (subnormals included) is
//     exact; the one rounding on a write is __float22half2_rn, IEEE
//     round-to-nearest-even into the subnormals and to +-inf past 65504,
//     as numpy and XLA round.  Nothing is built with -ftz or
//     --use_fast_math.
//
//   * Per-sub-block reductions: ONE WARP PER SUB-BLOCK.  Lane l reads the
//     four-element groups l, l+32, ..., l+224 of its sub-block (each step
//     of the warp reads 512 contiguous bytes of float32, 256 of bfloat16:
//     8-byte loads keep the float32 kernel's element-to-lane map, and so
//     its sum order), folds them in a fixed sequential order,
//     and a fixed xor-butterfly of shuffles finishes the sub-block.  No
//     partial crosses a sub-block and nothing crosses a block, so the same
//     inputs give the same bits on every launch (the fixed-order contract
//     of the reference plan) and no cross-block pass or atomic is needed.
//   * Kernel 5 at a 2-byte type (sq_half_kernel): the same map and fold
//     with 16-byte loads: for steps 2P and 2P + 1 of a sub-block, an even
//     lane l loads the word of groups l + 64P and l + 1 + 64P (its own at
//     step 2P, lane l + 1's), its odd neighbour the word of groups l + 32
//     + 64P and l + 33 + 64P (lane l's at step 2P + 1, its own); the pair
//     swaps the 8 bytes that belong to the other (two shuffles), and each
//     lane folds its groups l + 32j in order.  One warp's four loads read
//     the sub-block's 2 KB as four 512-byte runs: half the load
//     instructions of 8-byte loads.  (A persistent grid whose warps walk
//     the sub-blocks by a grid stride, each issuing the next sub-block's
//     loads before the current one's folds, ran 5-6 % slower on an H100:
//     PERF.md §6.)
//   * Elementwise folds: four elements per thread, grid-stride.
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
// Strides and vector counts below are in units of four elements (a float4
// of float32, eight bytes of bfloat16 or float16).
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SUB_VEC = 1024 / 4;            // four-element groups a sub-block
constexpr int WARP = 32;
constexpr int VEC_PER_LANE = SUB_VEC / WARP; // 8
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARP * WARPS_PER_BLOCK;
constexpr int64_t MAX_GRID = 132 * 64;       // grid-stride cap (132 SMs)

// Four consecutive elements of a T buffer, as float32: group i is elements
// 4i..4i+3 (one float4 of float32, one 8-byte word of bfloat16).
template <typename T> struct Quad;

template <> struct Quad<float> {
  __device__ __forceinline__ static float4 load(const void* p, int64_t i) {
    return reinterpret_cast<const float4*>(p)[i];
  }
  __device__ __forceinline__ static void store(void* p, int64_t i,
                                               float4 v) {
    reinterpret_cast<float4*>(p)[i] = v;
  }
};

template <> struct Quad<bf16> {
  // widening is exact: a bfloat16 is the high half of its float32
  __device__ __forceinline__ static float4 load(const void* p, int64_t i) {
    const uint2 u = reinterpret_cast<const uint2*>(p)[i];
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  // one round-to-nearest-even per element (NaN stays NaN)
  __device__ __forceinline__ static void store(void* p, int64_t i,
                                               float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    reinterpret_cast<uint2*>(p)[i] = u;
  }
};

template <> struct Quad<__half> {
  // widening is exact, subnormals included
  __device__ __forceinline__ static float4 load(const void* p, int64_t i) {
    const uint2 u = reinterpret_cast<const uint2*>(p)[i];
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  // one round-to-nearest-even per element, into the subnormals and to
  // +-inf past 65504 (NaN stays NaN)
  __device__ __forceinline__ static void store(void* p, int64_t i,
                                               float4 v) {
    const __half2 lo = __float22half2_rn(make_float2(v.x, v.y));
    const __half2 hi = __float22half2_rn(make_float2(v.z, v.w));
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    reinterpret_cast<uint2*>(p)[i] = u;
  }
};

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
template <typename TA, typename TB>
__global__ void delta_sq_kernel(const void* a, const void* b, float* out,
                                int64_t total_subs, int64_t nsubs,
                                int64_t a_ws, int64_t b_ws) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;             // the whole warp leaves
  const int lane = threadIdx.x % WARP;
  const int64_t w = sub / nsubs;
  const int64_t s = sub - w * nsubs;
  const int64_t pa = w * a_ws + s * SUB_VEC;
  const int64_t pb = w * b_ws + s * SUB_VEC;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const float4 x = Quad<TA>::load(a, pa + lane + j * WARP);
    const float4 y = Quad<TB>::load(b, pb + lane + j * WARP);
    acc = sq_diff_acc(acc, x.x, y.x);
    acc = sq_diff_acc(acc, x.y, y.y);
    acc = sq_diff_acc(acc, x.z, y.z);
    acc = sq_diff_acc(acc, x.w, y.w);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[sub] = acc;
}

// a bfloat16 or float16 group of four as float32 (u.x's low half first):
// widening is exact (Quad<T>::load's)
__device__ __forceinline__ float4 widen(uint2 u, bf16) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 widen(uint2 u, __half) {
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float sq_acc(float acc, float4 x) {
  acc = __fadd_rn(acc, __fmul_rn(x.x, x.x));
  acc = __fadd_rn(acc, __fmul_rn(x.y, x.y));
  acc = __fadd_rn(acc, __fmul_rn(x.z, x.z));
  return __fadd_rn(acc, __fmul_rn(x.w, x.w));
}

// per-(worker, sub-block) sum a^2: delta_sq_kernel with one operand
template <typename TA>
__global__ void sq_kernel(const void* a, float* out, int64_t total_subs) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;
  const int lane = threadIdx.x % WARP;
  const int64_t pa = sub * SUB_VEC;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const float4 x = Quad<TA>::load(a, pa + lane + j * WARP);
    acc = __fadd_rn(acc, __fmul_rn(x.x, x.x));
    acc = __fadd_rn(acc, __fmul_rn(x.y, x.y));
    acc = __fadd_rn(acc, __fmul_rn(x.z, x.z));
    acc = __fadd_rn(acc, __fmul_rn(x.w, x.w));
  }
  acc = warp_sum(acc);
  if (lane == 0) out[sub] = acc;
}

// kernel 5 at a 2-byte type T (see the header): sq_kernel<T>'s sums, bit
// for bit, with 16-byte loads; a holds total_subs * 128 words of 16 bytes
template <typename T>
__global__ void sq_half_kernel(const uint4* __restrict__ a,
                               float* __restrict__ out, int64_t total_subs) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;             // the whole warp leaves
  const int lane = threadIdx.x % WARP;
  const bool odd = lane & 1;
  // lane l's word of each 512-byte run: an even lane the word of groups l
  // and l + 1 (its own and lane l + 1's), an odd lane that of groups l + 31
  // and l + 32 (lane l - 1's and its own, one step on)
  const uint4* const w = a + sub * 128 + (lane >> 1) + 16 * (lane & 1);
  uint4 u[4];
#pragma unroll
  for (int P = 0; P < 4; ++P) u[P] = __ldg(w + 32 * P);
  float acc = 0.f;
#pragma unroll
  for (int P = 0; P < 4; ++P) {
    // an even lane gives its neighbour the second group of its word, an
    // odd lane the first
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? u[P].x : u[P].z,
                                        1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? u[P].y : u[P].w,
                                        1);
    const uint2 g0 = odd ? make_uint2(r0, r1) : make_uint2(u[P].x, u[P].y);
    const uint2 g1 = odd ? make_uint2(u[P].z, u[P].w) : make_uint2(r0, r1);
    acc = sq_acc(acc, widen(g0, T()));         // group lane + 64P
    acc = sq_acc(acc, widen(g1, T()));         // group lane + 32 + 64P
  }
  acc = warp_sum(acc);
  if (lane == 0) out[sub] = acc;
}

__device__ __forceinline__ float innovation(float g, float q, float e) {
  return __fadd_rn(__fsub_rn(g, q), e);      // (g - q) + e, in that order
}

// per-(worker, sub-block) max |(g - q) + e|; all operands stacked, the
// residual e always float32
template <typename TG, typename TQ>
__global__ void absmax_kernel(const void* g, const void* q, const float* e,
                              float* out, int64_t total_subs) {
  const int64_t sub = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (sub >= total_subs) return;
  const int lane = threadIdx.x % WARP;
  const int64_t base = sub * SUB_VEC;
  float m = 0.f;                             // |v| >= 0: 0 is the identity
#pragma unroll
  for (int j = 0; j < VEC_PER_LANE; ++j) {
    const int64_t k = base + lane + j * WARP;
    const float4 a = Quad<TG>::load(g, k), b = Quad<TQ>::load(q, k),
                 c = Quad<float>::load(e, k);
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

// fused LAQ encode: payload, residual (both float32) and per-sub-block sum
// payload^2.  ``p`` may alias a float32 ``g`` (the payload overwrites the
// consumed gradient): every element is read and written by the same thread.
template <typename TG, typename TQ>
__global__ void laq_encode_kernel(const void* g, const void* q,
                                  const float* e, const float* steps,
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
    const float4 a = Quad<TG>::load(g, k), b = Quad<TQ>::load(q, k),
                 c = Quad<float>::load(e, k);
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
//   MODE 2 select: m != 0 ? a : b (no arithmetic; bit-exact when a and b
//   share a dtype)
// computed in float32 and written at b's dtype.  ``out`` may alias ``b``
// (in-place state update).
template <int MODE>
__device__ __forceinline__ float fold(float x, float y, float m) {
  if (MODE == 0) return __fadd_rn(y, __fmul_rn(m, x));
  if (MODE == 1) return __fadd_rn(y, __fmul_rn(m, __fsub_rn(x, y)));
  return m != 0.f ? x : y;
}

template <typename TA, typename TB, int MODE>
__global__ void masked_kernel(const void* a, const void* b,
                              const float* mask, void* out,
                              int64_t total_vec, int64_t vec_per_w,
                              int64_t a_ws) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total_vec; i += stride) {
    const int64_t w = i / vec_per_w;
    const float m = mask[w];
    const float4 x = Quad<TA>::load(a, w * a_ws + (i - w * vec_per_w));
    const float4 y = Quad<TB>::load(b, i);
    Quad<TB>::store(out, i, make_float4(
        fold<MODE>(x.x, y.x, m), fold<MODE>(x.y, y.y, m),
        fold<MODE>(x.z, y.z, m), fold<MODE>(x.w, y.w, m)));
  }
}

inline unsigned sub_grid(int64_t total_subs) {
  return (unsigned)((total_subs + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

template <typename TA, typename TB>
int delta_sq(const void* a, const void* b, void* out, int64_t W,
             int64_t nsubs, int64_t a_ws, int64_t b_ws, void* stream) {
  const int64_t total = W * nsubs;
  if (total == 0) return 0;
  delta_sq_kernel<TA, TB><<<sub_grid(total), THREADS, 0,
                            (cudaStream_t)stream>>>(
      a, b, (float*)out, total, nsubs, a_ws, b_ws);
  return (int)cudaGetLastError();
}

template <typename TA>
int sq(const void* a, void* out, int64_t total_subs, void* stream) {
  if (total_subs == 0) return 0;
  sq_kernel<TA><<<sub_grid(total_subs), THREADS, 0, (cudaStream_t)stream>>>(
      a, (float*)out, total_subs);
  return (int)cudaGetLastError();
}

template <typename T>
int sq_half(const void* a, void* out, int64_t total_subs, void* stream) {
  if (total_subs == 0) return 0;
  sq_half_kernel<T><<<sub_grid(total_subs), THREADS, 0,
                      (cudaStream_t)stream>>>((const uint4*)a, (float*)out,
                                              total_subs);
  return (int)cudaGetLastError();
}

template <typename TG, typename TQ>
int absmax(const void* g, const void* q, const void* e, void* out,
           int64_t total_subs, void* stream) {
  if (total_subs == 0) return 0;
  absmax_kernel<TG, TQ><<<sub_grid(total_subs), THREADS, 0,
                          (cudaStream_t)stream>>>(
      g, q, (const float*)e, (float*)out, total_subs);
  return (int)cudaGetLastError();
}

template <typename TG, typename TQ>
int laq_encode(const void* g, const void* q, const void* e,
               const void* steps, void* p, void* r, void* sq,
               int64_t total_subs, float qmax, void* stream) {
  if (total_subs == 0) return 0;
  laq_encode_kernel<TG, TQ><<<sub_grid(total_subs), THREADS, 0,
                              (cudaStream_t)stream>>>(
      g, q, (const float*)e, (const float*)steps, (float4*)p, (float4*)r,
      (float*)sq, total_subs, qmax);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int masked_combine(const void* a, const void* b, const void* mask,
                   void* out, int64_t W, int64_t vec_per_w, int64_t a_ws,
                   int mode, void* stream) {
  const int64_t total = W * vec_per_w;
  if (total == 0) return 0;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  cudaStream_t s = (cudaStream_t)stream;
  const float* pm = (const float*)mask;
  if (mode == 0)
    masked_kernel<TA, TB, 0><<<(unsigned)blocks, THREADS, 0, s>>>(
        a, b, pm, out, total, vec_per_w, a_ws);
  else if (mode == 1)
    masked_kernel<TA, TB, 1><<<(unsigned)blocks, THREADS, 0, s>>>(
        a, b, pm, out, total, vec_per_w, a_ws);
  else if (mode == 2)
    masked_kernel<TA, TB, 2><<<(unsigned)blocks, THREADS, 0, s>>>(
        a, b, pm, out, total, vec_per_w, a_ws);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// One operand-type instantiation (suffix SFX; TA, TB the first and
// second operands' types: none float32, float32; _bb / _hh both bfloat16
// / float16; _fb / _fh a float32 first operand against a bfloat16 /
// float16 second; LAQ's residual e float32 in every one).
//
// delta_sq: a, b (W, R, 128) (b may be (R, 128): b_ws = 0); strides in
// four-element units; out (W, R/8) float32.  absmax: g, q (W, R, 128); e
// float32.  laq_encode: g, q; e, steps, p, r, sq float32.  masked_combine:
// mode 0 add, 1 update, 2 select; vec_per_w = R*128/4; a_ws = vec_per_w for
// a stacked candidate, 0 for an unstacked (R, 128) one; a and b (= out).
#define LAG_PLANE_ENTRIES(SFX, TA, TB)                                       \
  int lag_delta_sq_blocks##SFX(const void* a, const void* b, void* out,     \
                               int64_t W, int64_t nsubs, int64_t a_ws,      \
                               int64_t b_ws, void* stream) {                \
    return delta_sq<TA, TB>(a, b, out, W, nsubs, a_ws, b_ws, stream);       \
  }                                                                         \
  int lag_absmax_blocks##SFX(const void* g, const void* q, const void* e,   \
                             void* out, int64_t total_subs, void* stream) { \
    return absmax<TA, TB>(g, q, e, out, total_subs, stream);                \
  }                                                                         \
  int lag_laq_encode_blocks##SFX(const void* g, const void* q,              \
                                 const void* e, const void* steps, void* p, \
                                 void* r, void* sq, int64_t total_subs,     \
                                 float qmax, void* stream) {                \
    return laq_encode<TA, TB>(g, q, e, steps, p, r, sq, total_subs, qmax,   \
                              stream);                                      \
  }                                                                         \
  int lag_masked_combine##SFX(const void* a, const void* b,                 \
                              const void* mask, void* out, int64_t W,       \
                              int64_t vec_per_w, int64_t a_ws, int mode,    \
                              void* stream) {                               \
    return masked_combine<TA, TB>(a, b, mask, out, W, vec_per_w, a_ws,      \
                                  mode, stream);                            \
  }

extern "C" {

LAG_PLANE_ENTRIES(, float, float)
LAG_PLANE_ENTRIES(_bb, bf16, bf16)
LAG_PLANE_ENTRIES(_fb, float, bf16)
LAG_PLANE_ENTRIES(_hh, __half, __half)
LAG_PLANE_ENTRIES(_fh, float, __half)

// a: (W, R, 128) at the suffix's dtype (none float32, _bf16, _f16); out:
// (W, R/8) float32
int lag_sq_blocks(const void* a, void* out, int64_t total_subs,
                  void* stream) {
  return sq<float>(a, out, total_subs, stream);
}

int lag_sq_blocks_bf16(const void* a, void* out, int64_t total_subs,
                       void* stream) {
  return sq_half<bf16>(a, out, total_subs, stream);
}

int lag_sq_blocks_f16(const void* a, void* out, int64_t total_subs,
                      void* stream) {
  return sq_half<__half>(a, out, total_subs, stream);
}

}  // extern "C"
