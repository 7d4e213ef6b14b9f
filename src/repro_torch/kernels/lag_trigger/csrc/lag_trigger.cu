// Legacy per-leaf LAG-trigger kernels for Hopper (sm_90a).
//
// Hand-written CUDA replacements of the five Pallas kernels of
// src/repro/kernels/lag_trigger/lag_trigger.py:
//
//   lag_sq_2d (b given)   <- delta_sqnorm_2d      (_sqnorm_kernel)
//   lag_sq_2d (b == NULL) <- sqnorm_2d            (_sqnorm1_kernel)
//   lag_masked_update_2d  <- masked_update_2d     (_update_kernel)
//   lag_absmax_2d         <- innovation_absmax_2d (_absmax_kernel)
//   lag_laq_encode_2d     <- laq_encode_2d        (_laq_encode_kernel)
//
// Each takes ONE contiguous leaf of n elements: the trainer's per-leaf
// route (TrainerConfig(use_pallas_comm=True)) launches them once per leaf
// and per worker.  Every kernel is one streaming sweep with a few flops per
// element, so all five are bound by device-memory bytes; the design is
// coalesced vector loads, no shared memory beyond a block's eight warp
// sums, no atomics.
//
//   * No padding.  The TPU kernels want (rows, 128) operands with rows a
//     multiple of 256 and the reference pads every leaf with a copy; here
//     a thread loads 4 consecutive elements at once (float4, or 8 bytes of
//     bfloat16) when the caller says every operand is aligned to that, and
//     the n % 4 tail is folded in by global thread 0.  Unaligned operands
//     take the scalar path.  Nothing is read past n.  Padding zeros would
//     add nothing to a sum or to a max of |v| >= 0, so the results are
//     those of the padded reference.
//   * Sums and maxima without the TPU's sequential grid: pass 1 gives each
//     block a fixed grid-stride share of the leaf (the grid depends on n
//     only); a thread folds its elements in order into four accumulators
//     (one per vector lane), a fixed xor butterfly and a fixed fold of the
//     eight warp results finish the block, and the block writes its
//     partial.  Pass 2, one block, folds the partials in a fixed order into
//     the 0-d result, which stays on the device.  The same inputs give the
//     same bits on every launch.
//   * The LAQ encode reads its scale from the absmax's device output and
//     divides inside the kernel, as the Pallas kernel does: step =
//     scale/qmax and inv = 1/step by IEEE division (__fdiv_rn), rounding
//     half-to-even (rintf), and every other operation an _rn intrinsic (the
//     library is also built with --fmad=false), so v - codes*step is never
//     contracted into an FMA and the payload and residual equal the plain
//     PyTorch version bit for bit.
//   * Offsets are int64: the largest leaf of llama3.2-1b holds 268,435,456
//     elements (1.07 GB), and the loops must not wrap near 2^31.
//   * Operand types: each kernel is a template on its operands' types and
//     every operand is loaded at its own type, bfloat16 widened exactly, so
//     an instantiation with a bfloat16 operand is bit for bit the float32
//     kernel on the widened operands (the same element-to-thread map, the
//     same fold order).  Everything is computed in float32, as the Pallas
//     kernels cast every operand to float32.  The instantiations, one entry
//     point each (suffix: none for float32 operands, _bb / _hh both
//     bfloat16 / float16, _fb / _fh a float32 first operand against a
//     bfloat16 / float16 second; LAQ's residual e is float32 in all five):
//       lag_sq_2d{,_bb,_fb,_hh,_fh}              (a, b)     b NULL: sum a^2
//       lag_masked_update_2d{,_bb,_fb,_hh,_fh}   (a, b)     written at b's
//                                                           type, one
//                                                           rounding
//       lag_absmax_2d{,_bb,_fb,_hh,_fh}          (g, q, e)
//       lag_laq_encode_2d{,_bb,_fb,_hh,_fh}      (g, q, e)  payload and
//                                                           residual float32
//     A float16 is widened exactly (subnormals included) and written with
//     __float2half_rn: IEEE round-to-nearest-even into the subnormals
//     (below 2^-14) and to +-inf past 65504, as numpy and XLA round; the
//     library is built without -ftz or --use_fast_math.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, allocates nothing (the caller passes the
// partials' scratch of `cap` floats), and returns cudaGetLastError() so the
// caller raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned short bf16_t;               // bfloat16 storage

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int64_t MAX_GRID = 132 * 8;        // elementwise grid-stride cap
enum { OP_SUM = 0, OP_MAX = 1 };

// -- loads and stores of 4 consecutive elements (i counts groups of 4) ----

__device__ __forceinline__ float bf16_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);         // exact widening
}

__device__ __forceinline__ uint32_t f32_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 load4(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ float4 load4(const bf16_t* p, int64_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  return make_float4(bf16_to_f32(u.x & 0xffffu), bf16_to_f32(u.x >> 16),
                     bf16_to_f32(u.y & 0xffffu), bf16_to_f32(u.y >> 16));
}

__device__ __forceinline__ float load1(const float* p, int64_t k) {
  return p[k];
}

__device__ __forceinline__ float load1(const bf16_t* p, int64_t k) {
  return bf16_to_f32(p[k]);
}

__device__ __forceinline__ void store4(float* p, int64_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

__device__ __forceinline__ void store4(bf16_t* p, int64_t i, float4 v) {
  uint2 u;
  u.x = f32_to_bf16(v.x) | (f32_to_bf16(v.y) << 16);
  u.y = f32_to_bf16(v.z) | (f32_to_bf16(v.w) << 16);
  reinterpret_cast<uint2*>(p)[i] = u;
}

__device__ __forceinline__ float4 load4(const __half* p, int64_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float load1(const __half* p, int64_t k) {
  return __half2float(p[k]);
}

__device__ __forceinline__ void store4(__half* p, int64_t i, float4 v) {
  const __half2 lo = __float22half2_rn(make_float2(v.x, v.y));
  const __half2 hi = __float22half2_rn(make_float2(v.z, v.w));
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  reinterpret_cast<uint2*>(p)[i] = u;
}

__device__ __forceinline__ void store1(__half* p, int64_t k, float v) {
  p[k] = __float2half_rn(v);
}

__device__ __forceinline__ void store1(float* p, int64_t k, float v) {
  p[k] = v;
}

__device__ __forceinline__ void store1(bf16_t* p, int64_t k, float v) {
  p[k] = (bf16_t)f32_to_bf16(v);
}

// the elements a thread visits one at a time: all of them, grid-strided,
// on the scalar path (vec == 0); on the vector path only the n % 4 tail
// from k0 on, and only in thread 0, which folds it in after its groups
struct Scalars { int64_t first, step; };

__device__ __forceinline__ Scalars scalars(int64_t n, int vec, int64_t tid,
                                           int64_t stride, int64_t k0) {
  if (!vec) return {tid, stride};
  return {tid == 0 ? k0 : n, 1};
}

// -- fixed-order reductions ----------------------------------------------

__device__ __forceinline__ float max_nan(float a, float b) {
  // NaN-propagating max (jnp.maximum / torch.amax semantics)
  return (a != a || a > b) ? a : b;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return OP == OP_SUM ? __fadd_rn(a, b) : max_nan(a, b);
}

template <int OP>
__device__ __forceinline__ float combine4(float4 v) {
  return combine<OP>(combine<OP>(v.x, v.y), combine<OP>(v.z, v.w));
}

// the block's value in thread 0: xor butterfly per warp, then the eight
// warp results in warp order
template <int OP>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float warp_vals[WARPS];
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % WARP == 0) warp_vals[threadIdx.x / WARP] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < WARPS; ++w) v = combine<OP>(v, warp_vals[w]);
  return v;
}

// pass 2: fold the partials of pass 1 into out[0]; 0 is the identity of
// both the sum and the max of |v| (the Pallas kernels start from it)
template <int OP>
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ part, int64_t nparts,
              float* __restrict__ out) {
  float v = 0.f;
  for (int64_t i = threadIdx.x; i < nparts; i += THREADS)
    v = combine<OP>(v, part[i]);
  v = block_reduce<OP>(v);
  if (threadIdx.x == 0) out[0] = v;
}

// -- the sums of squares -------------------------------------------------

__device__ __forceinline__ float sq_acc(float acc, float x) {
  return __fadd_rn(acc, __fmul_rn(x, x));
}

// per-block partials of sum (a - b)^2, or of sum a^2 when b is NULL
template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
sq_partials(const TA* __restrict__ a, const TB* __restrict__ b,
            float* __restrict__ part, int64_t n, int vec) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t k0 = 0;                             // first element of the tail
  if (vec) {
    const int64_t nv = n / 4;
    for (int64_t i = tid; i < nv; i += stride) {
      float4 x = load4(a, i);
      if (b != nullptr) {
        const float4 y = load4(b, i);
        x = make_float4(__fsub_rn(x.x, y.x), __fsub_rn(x.y, y.y),
                        __fsub_rn(x.z, y.z), __fsub_rn(x.w, y.w));
      }
      acc = make_float4(sq_acc(acc.x, x.x), sq_acc(acc.y, x.y),
                        sq_acc(acc.z, x.z), sq_acc(acc.w, x.w));
    }
    k0 = nv * 4;
  }
  const Scalars sc = scalars(n, vec, tid, stride, k0);
  for (int64_t k = sc.first; k < n; k += sc.step) {
    float x = load1(a, k);
    if (b != nullptr) x = __fsub_rn(x, load1(b, k));
    acc.x = sq_acc(acc.x, x);
  }
  const float s = block_reduce<OP_SUM>(combine4<OP_SUM>(acc));
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// -- LAQ: innovation absmax and the fused encode -------------------------

__device__ __forceinline__ float innovation(float g, float q, float e) {
  return __fadd_rn(__fsub_rn(g, q), e);      // (g - q) + e, in that order
}

template <typename TG, typename TQ>
__global__ void __launch_bounds__(THREADS)
absmax_partials(const TG* __restrict__ g, const TQ* __restrict__ q,
                const float* __restrict__ e, float* __restrict__ part,
                int64_t n, int vec) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);  // |v| >= 0: 0 is neutral
  int64_t k0 = 0;
  if (vec) {
    const int64_t nv = n / 4;
    for (int64_t i = tid; i < nv; i += stride) {
      const float4 a = load4(g, i), b = load4(q, i), c = load4(e, i);
      m = make_float4(max_nan(m.x, fabsf(innovation(a.x, b.x, c.x))),
                      max_nan(m.y, fabsf(innovation(a.y, b.y, c.y))),
                      max_nan(m.z, fabsf(innovation(a.z, b.z, c.z))),
                      max_nan(m.w, fabsf(innovation(a.w, b.w, c.w))));
    }
    k0 = nv * 4;
  }
  const Scalars sc = scalars(n, vec, tid, stride, k0);
  for (int64_t k = sc.first; k < n; k += sc.step)
    m.x = max_nan(m.x, fabsf(innovation(load1(g, k), load1(q, k), e[k])));
  const float r = block_reduce<OP_MAX>(combine4<OP_MAX>(m));
  if (threadIdx.x == 0) part[blockIdx.x] = r;
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

// payload p, residual r, and per-block partials of sum p^2; the step is
// divided here from the device scale, as in the Pallas kernel
template <typename TG, typename TQ>
__global__ void __launch_bounds__(THREADS)
laq_encode_partials(const TG* __restrict__ g, const TQ* __restrict__ q,
                    const float* __restrict__ e,
                    const float* __restrict__ scale, float* __restrict__ p,
                    float* __restrict__ r, float* __restrict__ part,
                    int64_t n, float qmax, int vec) {
  const float step = __fdiv_rn(scale[0], qmax);
  const float inv = step > 0.f ? __fdiv_rn(1.0f, step) : 0.f;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t k0 = 0;
  if (vec) {
    const int64_t nv = n / 4;
    for (int64_t i = tid; i < nv; i += stride) {
      const float4 a = load4(g, i), b = load4(q, i), c = load4(e, i);
      const LaqOut ox = laq_one(a.x, b.x, c.x, step, inv, qmax);
      const LaqOut oy = laq_one(a.y, b.y, c.y, step, inv, qmax);
      const LaqOut oz = laq_one(a.z, b.z, c.z, step, inv, qmax);
      const LaqOut ow = laq_one(a.w, b.w, c.w, step, inv, qmax);
      acc = make_float4(sq_acc(acc.x, ox.p), sq_acc(acc.y, oy.p),
                        sq_acc(acc.z, oz.p), sq_acc(acc.w, ow.p));
      store4(p, i, make_float4(ox.p, oy.p, oz.p, ow.p));
      store4(r, i, make_float4(ox.r, oy.r, oz.r, ow.r));
    }
    k0 = nv * 4;
  }
  const Scalars sc = scalars(n, vec, tid, stride, k0);
  for (int64_t k = sc.first; k < n; k += sc.step) {
    const LaqOut o = laq_one(load1(g, k), load1(q, k), e[k], step, inv,
                             qmax);
    acc.x = sq_acc(acc.x, o.p);
    p[k] = o.p;
    r[k] = o.r;
  }
  const float s = block_reduce<OP_SUM>(combine4<OP_SUM>(acc));
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// -- the masked lazy update ----------------------------------------------

__device__ __forceinline__ float update(float x, float y, float m) {
  return __fadd_rn(y, __fmul_rn(m, __fsub_rn(x, y)));   // b + m*(a - b)
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
masked_update_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                     const float* __restrict__ mask, TB* __restrict__ out,
                     int64_t n, int vec) {
  const float m = mask[0];
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t k0 = 0;
  if (vec) {
    const int64_t nv = n / 4;
    for (int64_t i = tid; i < nv; i += stride) {
      const float4 x = load4(a, i), y = load4(b, i);
      store4(out, i, make_float4(update(x.x, y.x, m), update(x.y, y.y, m),
                                 update(x.z, y.z, m), update(x.w, y.w, m)));
    }
    k0 = nv * 4;
  }
  const Scalars sc = scalars(n, vec, tid, stride, k0);
  for (int64_t k = sc.first; k < n; k += sc.step)
    store1(out, k, update(load1(a, k), load1(b, k), m));
}

// blocks of pass 1: enough for one group of 4 (or one element) per thread,
// at least 1 (an empty leaf still writes its partial), at most `cap`
inline unsigned grid_for(int64_t n, int vec, int64_t cap) {
  const int64_t units = vec ? n / 4 : n;
  int64_t blocks = (units + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return (unsigned)blocks;
}

// the entry points of one operand-type instantiation (suffix SFX: TA the
// first operand's type, TB the second's)
template <typename TA, typename TB>
int sq_2d(const void* a, const void* b, void* part, void* out, int64_t n,
          int vec, int64_t cap, cudaStream_t s) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = grid_for(n, vec, cap);
  sq_partials<TA, TB><<<grid, THREADS, 0, s>>>(
      (const TA*)a, (const TB*)b, (float*)part, n, vec);
  finish_kernel<OP_SUM><<<1, THREADS, 0, s>>>((const float*)part, grid,
                                           (float*)out);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int masked_update_2d(const void* a, const void* b, const void* mask,
                     void* out, int64_t n, int vec, cudaStream_t s) {
  if (n == 0) return 0;
  const unsigned grid = grid_for(n, vec, MAX_GRID);
  masked_update_kernel<TA, TB><<<grid, THREADS, 0, s>>>(
      (const TA*)a, (const TB*)b, (const float*)mask, (TB*)out, n, vec);
  return (int)cudaGetLastError();
}

template <typename TG, typename TQ>
int absmax_2d(const void* g, const void* q, const void* e, void* part,
              void* out, int64_t n, int vec, int64_t cap, cudaStream_t s) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = grid_for(n, vec, cap);
  absmax_partials<TG, TQ><<<grid, THREADS, 0, s>>>(
      (const TG*)g, (const TQ*)q, (const float*)e, (float*)part, n, vec);
  finish_kernel<OP_MAX><<<1, THREADS, 0, s>>>((const float*)part, grid,
                                           (float*)out);
  return (int)cudaGetLastError();
}

template <typename TG, typename TQ>
int laq_encode_2d(const void* g, const void* q, const void* e,
                  const void* scale, void* p, void* r, void* part, void* sq,
                  int64_t n, float qmax, int vec, int64_t cap,
                  cudaStream_t s) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = grid_for(n, vec, cap);
  laq_encode_partials<TG, TQ><<<grid, THREADS, 0, s>>>(
      (const TG*)g, (const TQ*)q, (const float*)e, (const float*)scale,
      (float*)p, (float*)r, (float*)part, n, qmax, vec);
  finish_kernel<OP_SUM><<<1, THREADS, 0, s>>>((const float*)part, grid,
                                           (float*)sq);
  return (int)cudaGetLastError();
}

}  // namespace

// sum (a - b)^2 (b != NULL) or sum a^2 (b == NULL) over n elements into the
// 0-d out; part holds cap floats.  out = b + mask[0]*(a - b) over n
// elements.  max |(g - q) + e| over n elements into the 0-d out.  Payload p
// and residual r (n float32 each) and sum p^2 into the 0-d sq; scale is the
// 0-d device absmax, qmax = 2^(bits-1) - 1.
#define LAG_TRIGGER_ENTRIES(SFX, TA, TB)                                     \
  int lag_sq_2d##SFX(const void* a, const void* b, void* part, void* out,   \
                     int64_t n, int vec, int64_t cap, void* stream) {       \
    return sq_2d<TA, TB>(a, b, part, out, n, vec, cap,                      \
                         (cudaStream_t)stream);                             \
  }                                                                         \
  int lag_masked_update_2d##SFX(const void* a, const void* b,               \
                                const void* mask, void* out, int64_t n,     \
                                int vec, void* stream) {                    \
    return masked_update_2d<TA, TB>(a, b, mask, out, n, vec,                \
                                    (cudaStream_t)stream);                  \
  }                                                                         \
  int lag_absmax_2d##SFX(const void* g, const void* q, const void* e,       \
                         void* part, void* out, int64_t n, int vec,         \
                         int64_t cap, void* stream) {                       \
    return absmax_2d<TA, TB>(g, q, e, part, out, n, vec, cap,               \
                             (cudaStream_t)stream);                         \
  }                                                                         \
  int lag_laq_encode_2d##SFX(const void* g, const void* q, const void* e,   \
                             const void* scale, void* p, void* r,           \
                             void* part, void* sq, int64_t n, float qmax,   \
                             int vec, int64_t cap, void* stream) {          \
    return laq_encode_2d<TA, TB>(g, q, e, scale, p, r, part, sq, n, qmax,   \
                                 vec, cap, (cudaStream_t)stream);           \
  }

extern "C" {
LAG_TRIGGER_ENTRIES(, float, float)
LAG_TRIGGER_ENTRIES(_bb, bf16_t, bf16_t)
LAG_TRIGGER_ENTRIES(_fb, float, bf16_t)
LAG_TRIGGER_ENTRIES(_hh, __half, __half)
LAG_TRIGGER_ENTRIES(_fh, float, __half)
}  // extern "C"
