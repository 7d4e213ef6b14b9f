// Fused RMSNorm for Hopper (sm_90a).
//
// Hand-written CUDA replacement of the Pallas kernel rmsnorm_2d
// (_rmsnorm_kernel) of src/repro/kernels/rmsnorm/rmsnorm.py:
//
//   y = (x * rsqrt(mean(x^2) + eps)).astype(out) * scale.astype(out)
//
// row by row over x (rows, d), float32 or bfloat16 (out is x's dtype).  The
// reference's order of operations is kept: the row is multiplied by the
// rsqrt first, then by the scale, two separate roundings to out's dtype.
// In bfloat16 the mean of squares and the rsqrt stay float32 on the widened
// row, each thread holding the same elements as in float32 and summing them
// in the same order, so a row's rsqrt is the float32 kernel's bit for bit
// on the widened row; then y = bf16(bf16(x * r) * scale), scale already at
// x's dtype (the wrapper casts a float32 scale as the reference does).
//
// Bound: bytes.  Each element is read once and written once with three
// flops between, so at prefill (8192 rows x 2048) the kernel moves 134 MB:
// 0.040 ms at the H100's 3.35 TB/s, far above its 0.3 us of arithmetic.
// The design reads every byte of x exactly once from device memory:
//
//   * ONE WARP PER ROW.  Lane l holds the float4s l, l+32, l+64, ... of its
//     row in registers (VPL of them: d <= 128*VPL; bfloat16 packed, widened
//     where used), so the second pass (the write) never re-reads x.  Each
//     step of the warp loads 512 contiguous bytes.
//   * The sum of squares runs in a fixed order: each lane folds its values
//     in sequence, then a fixed xor butterfly of shuffles; no atomics, no
//     shared memory, nothing crosses a row, so the same row gives the same
//     bits on every launch, whatever the number of rows.
//   * Any number of rows: the last block's surplus warps leave.  Widths are
//     multiples of 4 (the wrapper checks it, and 16-byte alignment), so a
//     row is whole groups of four elements (a float4, or 8 bytes of
//     bfloat16: a warp's step then loads 256 contiguous bytes); up to 4096
//     a row fits 32 groups per lane.
//   * Wider rows (up to 8192: command-r-35b's d) take ONE BLOCK PER ROW:
//     thread i of the block's 256 holds the float4s i, i + 256, ... (8 at
//     d 8192) in registers, so x is still read once.  The sum of squares
//     is each warp's butterfly, then the 8 warp sums added in warp order
//     by every thread from shared memory: a fixed order again.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARP * WARPS_PER_BLOCK;
constexpr int MAX_ROW_VPL = 8;       // groups of 4 a thread of a row's block

typedef __nv_bfloat16 bf16;

// four consecutive elements as loaded (a float4, or 8 bytes of bfloat16,
// which a thread keeps packed: half the registers of a row) and widened
template <typename T> struct Raw;
template <> struct Raw<float> { typedef float4 type; };
template <> struct Raw<bf16> { typedef uint2 type; };

__device__ __forceinline__ float4 load_raw(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint2 load_raw(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ float4 widen(float4 v) { return v; }

__device__ __forceinline__ float4 widen(uint2 u) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return widen(load_raw(p));
}

// four values already exact in the element type
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// a float32 value rounded to the element type (to nearest, ties to even)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float round_to(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out = T(T(v * r) * s): the reference kernel's two roundings
template <typename T>
__device__ __forceinline__ float4 normalise(float4 v, float r, float4 s) {
  const T* t = nullptr;
  return make_float4(
      round_to(__fmul_rn(round_to(__fmul_rn(v.x, r), t), s.x), t),
      round_to(__fmul_rn(round_to(__fmul_rn(v.y, r), t), s.y), t),
      round_to(__fmul_rn(round_to(__fmul_rn(v.z, r), t), s.z), t),
      round_to(__fmul_rn(round_to(__fmul_rn(v.w, r), t), s.w), t));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sq4(float acc, float4 v) {
  acc = fmaf(v.x, v.x, acc);
  acc = fmaf(v.y, v.y, acc);
  acc = fmaf(v.z, v.z, acc);
  return fmaf(v.w, v.w, acc);
}

// d = 4 * d4 with d4 <= 32 * VPL; x, scale, y 16-byte aligned
template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS)
rmsnorm_reg_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int64_t rows, int d4, float d,
                   float eps) {
  const int64_t row = (int64_t)blockIdx.x * WARPS_PER_BLOCK
                      + threadIdx.x / WARP;
  if (row >= rows) return;                   // the whole warp leaves
  const int lane = threadIdx.x % WARP;
  const T* xr = x + row * d4 * 4;
  typename Raw<T>::type v[VPL];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + j * WARP;
    v[j] = c < d4 ? load_raw(xr + 4 * c) : typename Raw<T>::type{};
    acc = sq4(acc, widen(v[j]));
  }
  acc = warp_sum(acc);
  const float r = rsqrtf(acc / d + eps);
  T* yr = y + row * d4 * 4;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + j * WARP;
    if (c < d4)
      store4(yr + 4 * c, normalise<T>(widen(v[j]), r, load4(scale + 4 * c)));
  }
}

// one block per row: d = 4 * d4 with d4 <= THREADS * VPL
template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int d4, float d, float eps) {
  __shared__ float part[WARPS_PER_BLOCK];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d4 * 4;
  typename Raw<T>::type v[VPL];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = threadIdx.x + j * THREADS;
    v[j] = c < d4 ? load_raw(xr + 4 * c) : typename Raw<T>::type{};
    acc = sq4(acc, widen(v[j]));
  }
  acc = warp_sum(acc);
  if (threadIdx.x % WARP == 0) part[threadIdx.x / WARP] = acc;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS_PER_BLOCK; ++w) tot += part[w];
  const float r = rsqrtf(tot / d + eps);
  T* yr = y + row * d4 * 4;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if (c < d4)
      store4(yr + 4 * c, normalise<T>(widen(v[j]), r, load4(scale + 4 * c)));
  }
}

template <typename T, int VPL>
void launch_reg(const T* x, const T* scale, T* y, int64_t rows, int64_t d,
                float eps, cudaStream_t s, unsigned blocks) {
  rmsnorm_reg_kernel<T, VPL><<<blocks, THREADS, 0, s>>>(
      x, scale, y, rows, (int)(d / 4), (float)d, eps);
}

template <typename T>
int launch(const T* x, const T* scale, T* y, int64_t rows, int64_t d,
           float eps, cudaStream_t s) {
  if (d % 4 != 0 || d > 4 * MAX_ROW_VPL * THREADS)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || d == 0) return 0;
  if (d > 4 * 32 * WARP) {                   // one block per row
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_row_kernel<T, MAX_ROW_VPL><<<(unsigned)rows, THREADS, 0, s>>>(
        x, scale, y, (int)(d / 4), (float)d, eps);
    return (int)cudaGetLastError();
  }
  const int64_t blocks64 = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks64 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)blocks64;
  const int64_t d4 = d / 4;
  if (d4 <= WARP)
    launch_reg<T, 1>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 2 * WARP)
    launch_reg<T, 2>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 4 * WARP)
    launch_reg<T, 4>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 8 * WARP)
    launch_reg<T, 8>(x, scale, y, rows, d, eps, s, blocks);
  else if (d4 <= 16 * WARP)
    launch_reg<T, 16>(x, scale, y, rows, d, eps, s, blocks);
  else
    launch_reg<T, 32>(x, scale, y, rows, d, eps, s, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (rows, d) float32, contiguous; scale: (d,) float32; all three
// 16-byte aligned; d a multiple of 4, at most 8192.
int lag_rmsnorm_f32(const void* x, const void* scale, void* y, int64_t rows,
                    int64_t d, float eps, void* stream) {
  return launch((const float*)x, (const float*)scale, (float*)y, rows, d, eps,
                (cudaStream_t)stream);
}

// the same in bfloat16: x, y (rows, d), scale (d,), all bfloat16
int lag_rmsnorm_bf16(const void* x, const void* scale, void* y, int64_t rows,
                     int64_t d, float eps, void* stream) {
  return launch((const bf16*)x, (const bf16*)scale, (bf16*)y, rows, d, eps,
                (cudaStream_t)stream);
}

}  // extern "C"
